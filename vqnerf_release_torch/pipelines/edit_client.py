"""Headless material-editing client (counterpart of
vqnerf_release_tpu/pipelines/edit_client.py): the 19-material database,
the selection of a material segment from an embed map, and the status-file
protocol of the edit server (pipelines/edit.py) seen from the client's
side.
"""

import os
import time
from os.path import join

import numpy as np

from ..data import io as vio
from .edit import read_status

__all__ = ["MATERIAL_DB", "auto_select_mask", "submit_edit",
           "wait_finished"]

# name -> (diff rgb, spec rgb, rough); negative first channel = keep
MATERIAL_DB = {
    "keep": {"diff": [-1.0, 0, 0], "spec": [-1.0, 0, 0],
             "rough": [-1.0]},
    "gold": {"diff": [0.0, 0.0, 0.0], "spec": [1.0, 0.77, 0.34],
             "rough": [0.2]},
    "silver": {"diff": [0.0, 0.0, 0.0], "spec": [0.97, 0.96, 0.91],
               "rough": [0.15]},
    "copper": {"diff": [0.0, 0.0, 0.0], "spec": [0.95, 0.64, 0.54],
               "rough": [0.25]},
    "iron": {"diff": [0.0, 0.0, 0.0], "spec": [0.56, 0.57, 0.58],
             "rough": [0.3]},
    "aluminum": {"diff": [0.0, 0.0, 0.0], "spec": [0.91, 0.92, 0.92],
                 "rough": [0.2]},
    "chrome": {"diff": [0.0, 0.0, 0.0], "spec": [0.55, 0.56, 0.55],
               "rough": [0.05]},
    "red_plastic": {"diff": [0.8, 0.05, 0.05], "spec": [0.04, 0.04, 0.04],
                    "rough": [0.4]},
    "green_plastic": {"diff": [0.05, 0.7, 0.05],
                      "spec": [0.04, 0.04, 0.04], "rough": [0.4]},
    "blue_plastic": {"diff": [0.05, 0.05, 0.8],
                     "spec": [0.04, 0.04, 0.04], "rough": [0.4]},
    "white_plastic": {"diff": [0.9, 0.9, 0.9],
                      "spec": [0.04, 0.04, 0.04], "rough": [0.4]},
    "black_rubber": {"diff": [0.02, 0.02, 0.02],
                     "spec": [0.02, 0.02, 0.02], "rough": [0.9]},
    "wood": {"diff": [0.45, 0.28, 0.13], "spec": [0.03, 0.03, 0.03],
             "rough": [0.7]},
    "marble": {"diff": [0.85, 0.85, 0.8], "spec": [0.06, 0.06, 0.06],
               "rough": [0.3]},
    "jade": {"diff": [0.25, 0.6, 0.4], "spec": [0.08, 0.08, 0.08],
             "rough": [0.35]},
    "ceramic": {"diff": [0.9, 0.9, 0.88], "spec": [0.05, 0.05, 0.05],
                "rough": [0.1]},
    "leather": {"diff": [0.3, 0.15, 0.08], "spec": [0.03, 0.03, 0.03],
                "rough": [0.8]},
    "fabric": {"diff": [0.5, 0.4, 0.55], "spec": [0.02, 0.02, 0.02],
               "rough": [0.95]},
    "pearl": {"diff": [0.9, 0.88, 0.85], "spec": [0.3, 0.29, 0.28],
              "rough": [0.2]},
}


def auto_select_mask(embed_map, embed_id, dilate=0):
    """[H, W] bool mask of the pixels whose embed id is ``embed_id``,
    grown by ``dilate`` pixels in a (2 dilate + 1)-square window, as
    cv2.dilate grows it."""
    mask = np.asarray(embed_map) == embed_id
    if dilate > 0:
        k = 2 * dilate + 1
        grown = np.pad(mask, dilate)
        for axis in (0, 1):
            grown = np.lib.stride_tricks.sliding_window_view(
                grown, k, axis=axis).any(axis=-1)
        mask = grown
    return mask


def submit_edit(root, material, masks, env="original"):
    """Write the edit request the server polls for: dst.json, illum.json,
    one mask .npy a view, then status "uploaded". ``material`` is a name
    of MATERIAL_DB or a dict of diff/spec/rough lists."""
    update_dir = join(root, "edited")
    os.makedirs(update_dir, exist_ok=True)
    os.makedirs(join(root, "status"), exist_ok=True)
    if isinstance(material, str):
        material = MATERIAL_DB[material]
    vio.write_json(material, join(update_dir, "dst.json"))
    vio.write_json({"env": env}, join(update_dir, "illum.json"))
    for i, mask in enumerate(masks):
        np.save(join(update_dir, "batch%09d.npy" % i), np.asarray(mask))
    vio.write_json({"status": "uploaded"},
                   join(root, "status", "status.json"))


def wait_finished(root, timeout=600.0, poll=0.5):
    """Block until the server marks the round finished; returns the
    pd_edited directory. Raises TimeoutError after ``timeout`` seconds."""
    status_path = join(root, "status", "status.json")
    t0 = time.time()
    while time.time() - t0 < timeout:
        status = read_status(status_path)
        if status is not None and status.get("status") == "finished":
            return join(root, "pd_edited")
        time.sleep(poll)
    raise TimeoutError("edit server did not finish in time")
