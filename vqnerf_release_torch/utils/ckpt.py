"""Checkpoints with ``torch.save`` (counterpart of
vqnerf_release_tpu/utils/ckpt.py, which writes orbax trees).

The layout is the JAX package's: <outdir>/checkpoints/ckpt-<n>, here one
file each. The latest is restored at start-up. A state is a dict such as
{"params": model.state_dict(), "ema": VqEmaState, "opt_state": {...},
"epoch": n}; tensors are saved from the CPU and loaded to the CPU, and the
caller copies them to its device.
"""

import os
import re

import torch

__all__ = ["save_ckpt", "load_ckpt", "latest_ckpt", "list_ckpts"]


def _ckptdir(outdir):
    return os.path.join(outdir, "checkpoints")


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a NamedTuple
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_ckpt(outdir, step, state, keep=None):
    """Write ``state`` as ckpt-<step>; keep: retain only the newest ``keep``
    checkpoints (None keeps all)."""
    path = os.path.join(_ckptdir(outdir), "ckpt-%d" % step)
    os.makedirs(_ckptdir(outdir), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    if keep is not None and keep > 0:
        for old in list_ckpts(outdir)[:-keep]:
            os.remove(old)
    return path


def list_ckpts(outdir):
    d = _ckptdir(outdir)
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        m = re.fullmatch(r"ckpt-(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(d, name)))
    return [p for _, p in sorted(out)]


def latest_ckpt(outdir):
    ckpts = list_ckpts(outdir)
    return ckpts[-1] if ckpts else None


def load_ckpt(path):
    """The saved state, with its tensors on the CPU."""
    if path is None:
        raise FileNotFoundError("no checkpoint found (latest_ckpt is None)")
    return torch.load(path, map_location="cpu", weights_only=False)
