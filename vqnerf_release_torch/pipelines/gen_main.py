"""Post-hoc re-selection of the main_<k> code count (counterpart of
vqnerf_release_tpu/pipelines/gen_main.py): the elbow rule run again over
an epoch's saved vq_test_loss.json with another best_thres, and the
main_<k> marker moved to the chosen threshold directory.
"""

import json
import os
import shutil
from os.path import join

import numpy as np

from ..train.loop import elbow_select

__all__ = ["reselect_main"]


def reselect_main(vali_epoch_dir, num_embed, num_drop, best_thres,
                  apply=True):
    """Returns the newly selected code count; with apply=True renames the
    threshold dirs so that exactly the chosen one carries the main_
    prefix."""
    with open(join(vali_epoch_dir, "vq_test_loss.json")) as f:
        scores = json.load(f)
    drop_losses = np.array(scores["chromaticity"])
    main_i = elbow_select(list(drop_losses), best_thres)
    k_main = num_embed - num_drop + main_i

    if apply:
        for name in list(os.listdir(vali_epoch_dir)):
            path = join(vali_epoch_dir, name)
            if not os.path.isdir(path):
                continue
            if name.startswith("main_"):
                k_old = int(name.split("_")[1])
                if k_old != k_main:
                    shutil.move(path, join(vali_epoch_dir, str(k_old)))
        plain = join(vali_epoch_dir, str(k_main))
        if os.path.isdir(plain):
            shutil.move(plain, join(vali_epoch_dir, "main_%d" % k_main))
    return k_main
