"""The benchmark's inputs, made from ``--seed`` on the device in a few large
calls: stage 2's surface-buffer views of a textured sphere (what stage 1
extracts from a NeRF-synthetic scene: rays, xyz, normal, alpha, RGB and a
light-visibility map over the light sphere), and the relighting probes.

The scene follows the synthetic scene of the repository's smoke script
(a sphere seen from cameras around it, NeRF-synthetic convention, white
background), made here as arrays on the device instead of PNG and .npy files,
so that no run pays for encoding and decoding them.
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .reference.decomp import light_xyz


@dataclass
class View:
    """One view's buffers as host arrays [H*W, C], the layout the program's
    stage-2 views have."""
    id: str
    h: int
    w: int
    rayo: np.ndarray
    rayd: np.ndarray
    rgb: np.ndarray
    alpha: np.ndarray
    pred_alpha: np.ndarray
    xyz: np.ndarray
    normal: np.ndarray
    lvis: Optional[np.ndarray] = None
    ref: Optional[np.ndarray] = None


def seed32(seed, salt):
    """A 32-bit seed of its own for each stream a run draws (``salt``),
    from ``--seed`` (any whole number)."""
    return (int(seed) * 1000003 + salt) % (2 ** 32)


def _look_at(eye):
    """Camera-to-world rotation [3, 3] of a camera at ``eye`` looking at
    the origin (NeRF convention: the camera looks down -z, y up)."""
    z = eye / eye.norm()
    up = torch.tensor([0.0, 0.0, 1.0], device=eye.device)
    x = torch.linalg.cross(up, z)
    x = x / x.norm()
    return torch.stack([x, torch.linalg.cross(z, x), z], dim=1)


def sphere_view_tensors(i, n_views, h, w, light_h, gen, radius=1.0,
                        distance=4.0, fov_deg=40.0, device="cuda"):
    """View ``i`` of ``n_views`` around a sphere of ``radius``: a dict of
    [H*W, C] float32 device tensors. The camera's elevation and a texture
    of four random waves come from ``gen``; lvis is 1 where a light is above
    the surface's horizon, less a random 5% of (row, light) pairs."""
    u = torch.rand((16,), generator=gen, device=device)
    az = 2 * math.pi * (i + 0.5 * u[0]) / n_views
    el = -0.3 + 1.1 * u[1]
    eye = distance * torch.stack([torch.cos(el) * torch.cos(az),
                                  torch.cos(el) * torch.sin(az),
                                  torch.sin(el)])
    rot = _look_at(eye)
    f = 0.5 * w / math.tan(math.radians(fov_deg) / 2)
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    d_cam = torch.stack([(xs + 0.5 - w / 2) / f, -(ys + 0.5 - h / 2) / f,
                         -torch.ones_like(xs)], -1).reshape(-1, 3)
    rayd = d_cam @ rot.T
    rayd = rayd / rayd.norm(dim=-1, keepdim=True)
    rayo = eye.expand_as(rayd).contiguous()
    b = torch.sum(rayo * rayd, -1)
    disc = b * b - (distance ** 2 - radius ** 2)
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    xyz = torch.where(hit[:, None], rayo + t[:, None] * rayd,
                      rayo + 0.1 * rayd)
    normal = torch.where(hit[:, None], xyz / radius,
                         torch.tensor([0.0, 1.0, 0.0], device=device))
    freq = (torch.rand((4, 3), generator=gen, device=device) - 0.5) * 12
    phase = torch.rand((4, 3), generator=gen, device=device) * 2 * math.pi
    waves = torch.sin(xyz[:, None, :] * freq[None] + phase[None]).sum(-1)
    tex = 0.5 + 0.1 * waves[:, :3]
    alpha = hit.to(torch.float32)[:, None]
    rgb = torch.where(hit[:, None], tex, torch.ones_like(tex))
    lxyz = torch.as_tensor(light_xyz(light_h)[0], device=device)
    ldir = lxyz / lxyz.norm(dim=-1, keepdim=True)
    lvis = (normal @ ldir.T > 0) & (torch.rand(
        (xyz.shape[0], ldir.shape[0]), generator=gen, device=device) > 0.05)
    lvis = (lvis & hit[:, None]).to(torch.float32)
    return {"rayo": rayo, "rayd": rayd, "rgb": rgb.clamp(0, 1),
            "alpha": alpha, "pred_alpha": alpha.clone(), "xyz": xyz,
            "normal": normal, "lvis": lvis}


def sphere_views(n_views, h, w, light_h, seed, device):
    """``n_views`` views (host ``View``s) of the seeded sphere scene."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    views = []
    for i in range(n_views):
        t = sphere_view_tensors(i, n_views, h, w, light_h, gen,
                                device=device)
        views.append(View(id="train_%03d" % i, h=h, w=w,
                          **{k: v.cpu().numpy() for k, v in t.items()}))
    return views


def probes(n_probes, n_olats, light_h, seed, device, olat_inten=200.0):
    """(probes [E, L, 3], olats [O, L, 3]) on the device: probes are smooth
    random HDR maps from the seed (a sky gradient plus one bright sun); the
    OLATs are the release's four single lights of ``olat_inten``, on row
    light_h // 4 at a quarter of the width apart."""
    lh, lw = light_h, 2 * light_h
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63)
                                                     ^ 0x5EED)
    rows = torch.linspace(1.0, 0.0, lh, device=device)[None, :, None, None]
    base = torch.rand((n_probes, 1, 1, 3), generator=gen, device=device)
    env = (0.2 + base) * (0.3 + rows) * torch.ones((1, lh, lw, 3),
                                                   device=device)
    sun_i = torch.randint(0, lh // 2, (n_probes,), generator=gen,
                          device=device)
    sun_j = torch.randint(0, lw, (n_probes,), generator=gen, device=device)
    sun = 20.0 * torch.rand((n_probes, 3), generator=gen, device=device)
    env[torch.arange(n_probes, device=device), sun_i, sun_j] += sun
    olats = torch.zeros((n_olats, lh, lw, 3), device=device)
    row = min(lh // 4, lh - 1)
    for k, j in enumerate([0, lw // 4, lw // 2, 3 * lw // 4][:n_olats]):
        olats[k, row, j] = olat_inten
    return env.reshape(n_probes, -1, 3), olats.reshape(n_olats, -1, 3)
