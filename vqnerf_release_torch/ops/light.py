"""Lat-long light-sphere sampling and OLAT envmaps (the port's own copy of
vqnerf_release_tpu/ops/light.py, numpy only; tests hold the two bit for bit).

These run once at setup; their outputs become tensor constants.
"""

import numpy as np

__all__ = ["sph2cart", "gen_light_xyz", "one_hot_img", "olat_envmaps"]


def sph2cart(pts_sph):
    """(r, lat, lng) -> (x, y, z). Lat-long convention of the reference:
    z = r sin(lat); x = r cos(lat) cos(lng); y = r cos(lat) sin(lng).
    """
    pts_sph = np.asarray(pts_sph, dtype=np.float64)
    one = pts_sph.ndim == 1
    if one:
        pts_sph = pts_sph[None]
    r, lat, lng = pts_sph[:, 0], pts_sph[:, 1], pts_sph[:, 2]
    out = np.stack(
        (r * np.cos(lat) * np.cos(lng),
         r * np.cos(lat) * np.sin(lng),
         r * np.sin(lat)),
        axis=-1,
    )
    return out[0] if one else out


def gen_light_xyz(envmap_h, envmap_w, envmap_radius=1e2):
    """Lat-long sphere sample points and per-pixel solid angles.

    Matches gen_light_xyz (models/util.py:84-118): polar rows are excluded by
    stepping in by one lat/lng step; areas are normalized so they sum to 4*pi.
    Returns (xyz [h,w,3], areas [h,w]) as float64 numpy.
    """
    lat_step_size = np.pi / (envmap_h + 2)
    lng_step_size = 2 * np.pi / (envmap_w + 2)
    lats = np.linspace(
        np.pi / 2 - lat_step_size, -np.pi / 2 + lat_step_size, envmap_h)
    lngs = np.linspace(
        np.pi - lng_step_size, -np.pi + lng_step_size, envmap_w)
    lngs, lats = np.meshgrid(lngs, lats)

    rlatlngs = np.dstack((envmap_radius * np.ones_like(lats), lats, lngs))
    xyz = sph2cart(rlatlngs.reshape(-1, 3)).reshape(envmap_h, envmap_w, 3)

    sin_colat = np.sin(np.pi / 2 - lats)
    areas = 4 * np.pi * sin_colat / np.sum(sin_colat)
    assert (areas > 0).all(), "Zero-contribution light pixel"
    return xyz, areas


def one_hot_img(h, w, c, i, j):
    """An [h,w,c] image that is 1 at pixel (i, j) across all channels."""
    img = np.zeros((h, w, c), dtype=np.float32)
    img[i, j, :] = 1.0
    return img


def olat_envmaps(light_h, olat_inten=200.0, ambient_inten=0.0):
    """The 4 OLAT test envmaps of the reference (nfr_unit.py:74-79):
    row i=4, columns j in {0, 8, 16, 24} of a (light_h, 2*light_h) map,
    scaled by olat_inten over an ambient floor. Returns an OrderedDict-like
    dict keyed '%04d-%04d'.
    """
    light_res = (light_h, 2 * light_h)
    ambient = ambient_inten * np.ones(light_res + (3,), dtype=np.float32)
    out = {}
    # Row 4, columns {0, 8, 16, 24} at the reference's light_h=16; scaled
    # proportionally for other resolutions (identical at 16).
    w = light_res[1]
    row = min(light_h // 4, light_h - 1)
    for i in [row]:
        for j in [0, w // 4, w // 2, 3 * w // 4]:
            envmap = olat_inten * one_hot_img(*light_res, 3, i, j) + ambient
            out["%04d-%04d" % (i, j)] = envmap
    return out
