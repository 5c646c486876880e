"""Dataset generation and conversion tools (counterpart of
vqnerf_release_tpu/preprocess/data_gen.py, with the port's io in place of
cv2).

  * ``make_real_dataset``: real-capture conversion, captured frames split
    into train_NNN / val_NNN view dirs with a 16-bit rgba.png and a
    metadata.json each, and top-level transforms jsons.
  * ``merl_to_npz``: MERL .binary -> npz.
  * ``blender_render_scene``: the reference renders its CG data inside
    Blender (bpy), which is not installed; it raises.
"""

import os
from os.path import basename, join

import numpy as np

from ..data import io as vio

__all__ = ["make_real_dataset", "merl_to_npz", "blender_render_scene"]


def make_real_dataset(image_paths, c2ws, cam_angle_x, out_root,
                      masks=None, val_every=8, imh=None):
    """Assemble the train_/val_ view-dir layout from captured frames.

    image_paths: RGB(A) frames, PNG or JPEG; c2ws: [N, 4, 4]; masks:
    optional alpha images (white = fg). Writes
    <out_root>/{train,val}_NNN/{rgba.png, metadata.json} and
    transforms_{train,val}.json.
    """
    train_frames, val_frames = [], []
    counters = {"train": 0, "val": 0}
    for i, path in enumerate(image_paths):
        img = vio.load_img_f32(path)
        if img.shape[-1] == 3:
            if masks is not None:
                a = vio.load_img_f32(masks[i])
                if a.ndim == 3:
                    a = a[..., 0]
            else:
                a = np.ones(img.shape[:2], np.float32)
            img = np.dstack([img, a])
        if imh is not None and img.shape[0] != imh:
            img = vio.resize(img, new_h=imh)
        split = "val" if (i % val_every == val_every - 1) else "train"
        vid = "%s_%03d" % (split, counters[split])
        counters[split] += 1
        vdir = join(out_root, vid)
        os.makedirs(vdir, exist_ok=True)
        vio.write_png(join(vdir, "rgba.png"),
                      (np.clip(img, 0, 1) * 65535).astype(np.uint16))
        h, w = img.shape[:2]
        meta = {
            "imh": h, "imw": w, "cam_angle_x": float(cam_angle_x),
            "cam_transform_mat": ",".join(
                str(float(x)) for x in np.asarray(c2ws[i]).reshape(-1)),
        }
        vio.write_json(meta, join(vdir, "metadata.json"))
        frame = {"file_path": vid,
                 "transform_matrix": np.asarray(c2ws[i]).tolist()}
        (train_frames if split == "train" else val_frames).append(frame)

    for split, frames in (("train", train_frames), ("val", val_frames)):
        vio.write_json(
            {"camera_angle_x": float(cam_angle_x), "frames": frames},
            join(out_root, "transforms_%s.json" % split))
    return counters


def merl_to_npz(binary_path, out_npz, subsample=1):
    """MERL .binary -> npz of (cube, name) for the BRDF-dataset tooling
    (data_gen/merl/make_dataset.py contract)."""
    from ..data.merl import read_merl

    cube = read_merl(binary_path)
    if subsample > 1:
        cube = cube[:, ::subsample, ::subsample, ::subsample]
    name = basename(str(binary_path)).split(".")[0]
    os.makedirs(os.path.dirname(str(out_npz)) or ".", exist_ok=True)
    np.savez(out_npz, cube=cube, name=name)
    return cube.shape


def blender_render_scene(*_args, **_kwargs):
    """The reference's CG data generation runs inside Blender 2.83 (bpy)
    rendering rgb/albedo/normal/relit buffers per view
    (data_gen/nerf_synth/render.py:35-144). bpy is not installed in this
    image; run the reference-format script inside Blender and point the
    trainers at its output directory: the loaders here consume that
    layout directly."""
    raise RuntimeError(
        "Blender (bpy) is not available in this environment; render CG "
        "data with Blender externally — see this docstring for the "
        "expected output layout.")
