"""LPIPS (AlexNet backbone) from an external weights file (counterpart of
vqnerf_release_tpu/eval/lpips_net.py).

The npz holds conv{1..5}/kernel [kh, kw, cin, cout], conv{1..5}/bias [cout]
and lin{0..4}/kernel [1, 1, cin, 1] (lpips 0.1's 'alex' linear heads); the
widths are read from it. Inputs in [0, 1] (or [0, 255], told apart by their
maximum) go to [-1, 1] and through the LPIPS shift and scale; each conv is
a correlation with zero padding at its stride (what the JAX module's
subsampled full FFT correlation gives), ReLU after each, a 3/2 max-pool
after the first and second (the JAX module's pool after the fifth feeds
nothing); then the channel-normalised feature differences, squared,
weighted by the linear heads, averaged over space and summed over
layers. All of it in float64 on ``device``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["AlexLpips", "lpips_from_weights"]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float64)
_SCALE = np.array([0.458, 0.448, 0.450], np.float64)

_ALEX = [  # (stride, pad, pool_after)
    (4, 2, True),
    (1, 2, True),
    (1, 1, False),
    (1, 1, False),
    (1, 1, True),
]


class AlexLpips(nn.Module):
    """The LPIPS network of an npz of weights, in float64."""

    def __init__(self, weights):
        super().__init__()
        self.convs = nn.ModuleList()
        self.heads = []
        for li, (stride, pad, _) in enumerate(_ALEX, start=1):
            kernel = np.asarray(weights[f"conv{li}/kernel"], np.float64)
            kh, kw, cin, cout = kernel.shape
            conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                             padding=pad, dtype=torch.float64)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(
                    kernel.transpose(3, 2, 0, 1).copy()))
                conv.bias.copy_(torch.from_numpy(np.asarray(
                    weights[f"conv{li}/bias"], np.float64)))
            self.convs.append(conv)
        for li in range(len(_ALEX)):
            self.register_buffer(f"lin{li}", torch.from_numpy(np.asarray(
                weights[f"lin{li}/kernel"], np.float64).reshape(-1)))

    def features(self, x):
        feats = []
        for li, (conv, (_, _, pool)) in enumerate(zip(self.convs, _ALEX)):
            x = torch.relu(conv(x))
            feats.append(x)
            if pool and li < len(_ALEX) - 1:  # the last pool feeds nothing
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, x):
        """x: [2, 3, H, W], the two images; returns the distance."""
        f1, f2 = zip(*(f.unbind(0) for f in self.features(x)))
        dist = 0.0
        for li, (a, b) in enumerate(zip(f1, f2)):
            n1 = a / torch.clamp(torch.sqrt(torch.sum(a**2, 0)), min=1e-10)
            n2 = b / torch.clamp(torch.sqrt(torch.sum(b**2, 0)), min=1e-10)
            diff = (n1 - n2) ** 2
            lin = getattr(self, f"lin{li}")
            dist += float(torch.mean(torch.sum(diff * lin[:, None, None], 0)))
        return dist


@torch.no_grad()
def lpips_from_weights(im1, im2, weights_path, device="cuda"):
    device = resolve_device(device)
    xs = []
    for im in (im1, im2):
        # as the JAX module: the cast comes first, so only the maximum
        # tells a [0, 255] image
        x = np.asarray(im, np.float64)
        if x.dtype == np.uint8 or x.max() > 1.5:
            x = x / 255.0
        x = x * 2.0 - 1.0
        x = (x - _SHIFT) / _SCALE
        xs.append(x.transpose(2, 0, 1))
    x = torch.as_tensor(np.stack(xs), device=device)
    with np.load(weights_path) as z:
        net = AlexLpips(dict(z)).to(device)
    return net(x)
