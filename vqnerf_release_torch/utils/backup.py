"""Per-run source backup: copy the port's Python sources into
<exp_dir>/recording, so that every experiment records the code that
produced it (the counterpart of vqnerf_release_tpu/utils/backup.py)."""

import os
import shutil

__all__ = ["file_backup"]


def file_backup(exp_dir, src_root=None):
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    rec = os.path.join(exp_dir, "recording")
    os.makedirs(rec, exist_ok=True)
    for root, dirs, files in os.walk(src_root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        rel = os.path.relpath(root, src_root)
        for f in files:
            if f.endswith(".py"):
                dst_dir = os.path.join(rec, rel)
                os.makedirs(dst_dir, exist_ok=True)
                shutil.copy2(os.path.join(root, f),
                             os.path.join(dst_dir, f))
    return rec
