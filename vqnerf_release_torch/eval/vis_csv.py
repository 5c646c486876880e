"""JSON score dumps -> CSV tables (counterpart of
vqnerf_release_tpu/eval/vis_csv.py), with the csv module in place of
pandas: columns in order of first appearance, an empty cell for a missing
key, floats written as pandas writes a float64 column (repr, "" for NaN).
The functions return the rows (a list of dicts), not a DataFrame.
"""

import csv
import json
import math

import numpy as np

__all__ = ["metric_json_to_csv", "cluster_json_to_csv", "write_rows"]


def _cell(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def write_rows(rows, csv_path):
    """``DataFrame(rows).to_csv(csv_path, index=False)``'s bytes."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if not columns:
            f.write("\n")
            return
        w.writerow(columns)
        for row in rows:
            w.writerow([_cell(row.get(c)) for c in columns])


def metric_json_to_csv(json_path, csv_path):
    """Per-scene x per-buffer mean PSNR/SSIM/LPIPS table."""
    with open(json_path) as f:
        scores = json.load(f)
    rows = []
    for scene, bufs in scores.items():
        if scene.startswith("_"):  # metadata keys (_lpips_impl)
            continue
        row = {"scene": scene}
        for buf, ms in bufs.items():
            for m, vals in ms.items():
                if vals:
                    row[f"{buf}_{m}"] = float(np.mean(vals))
        rows.append(row)
    write_rows(rows, csv_path)
    return rows


def cluster_json_to_csv(json_path, csv_path):
    """Per-method segmentation score table (cluster_vis.py)."""
    with open(json_path) as f:
        scores = json.load(f)
    rows = []
    for method, ms in scores.items():
        row = {"method": method}
        for k, vals in ms.items():
            row[k] = float(np.mean(vals))
        rows.append(row)
    write_rows(rows, csv_path)
    return rows
