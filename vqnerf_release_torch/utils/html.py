"""HTML comparison pages of the validation renders (the port's own copy of
vqnerf_release_tpu/utils/html.py, standard library only): a table page with
per-batch rows of images and caption cells, white or black themed, written
next to the validation epoch directories for review in a browser.
"""

import os

__all__ = ["write_comparison_html", "compile_batch_vis",
           "write_epoch_html", "write_vali_index"]

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ background: {bg}; color: {fg}; font-family: sans-serif; }}
table {{ border-collapse: collapse; }}
td {{ padding: 4px; text-align: center; vertical-align: top; }}
img {{ max-width: 256px; }}
</style></head><body>
<h2>{title}</h2>
<table>
{rows}
</table></body></html>
"""


def write_comparison_html(out_path, rows, captions, title="Validation",
                          white_bg=True):
    """rows: list of lists of cell strings — image paths (rendered as
    <img>) or plain text; captions: per-row list of labels."""
    html_rows = []
    for row, caps in zip(rows, captions):
        cells = []
        for cell, cap in zip(row, caps):
            if isinstance(cell, str) and cell.endswith(
                    (".png", ".jpg", ".apng", ".gif")):
                rel = os.path.relpath(
                    cell, os.path.dirname(os.path.abspath(out_path)))
                cells.append(
                    f"<td><img src='{rel}'><br>{cap}</td>")
            elif isinstance(cell, str) and cell.endswith(".html"):
                rel = os.path.relpath(
                    cell, os.path.dirname(os.path.abspath(out_path)))
                cells.append(f"<td><a href='{rel}'>{cap}</a></td>")
            else:
                cells.append(f"<td>{cell}<br>{cap}</td>")
        html_rows.append("<tr>" + "".join(cells) + "</tr>")
    page = _PAGE.format(
        title=title, rows="\n".join(html_rows),
        bg="white" if white_bg else "black",
        fg="black" if white_bg else "white")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(page)
    return out_path


def compile_batch_vis(batch_dirs, out_html, white_bg=True,
                      keys=("pred_rgb.png", "pred_albedo.png",
                            "pred_normal.png", "gt_rgb.png")):
    """Compile per-batch vis dirs into one comparison page
    (nfr_unit.py:637-690)."""
    import json

    rows, captions = [], []
    for d in batch_dirs:
        if not os.path.isdir(d):
            continue
        meta_path = os.path.join(d, "metadata.json")
        meta = "{}"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.dumps(json.load(f))
        row = [meta]
        caps = ["metadata"]
        for k in keys:
            p = os.path.join(d, k)
            if os.path.exists(p):
                row.append(p)
                caps.append(k)
        rows.append(row)
        captions.append(caps)
    return write_comparison_html(out_html, rows, captions,
                                 white_bg=white_bg)


_EPOCH_KEYS = ("pred_rgb.png", "pred_basecolor.png", "pred_albedo.png",
               "pred_spec.png", "pred_rough.png", "pred_normal.png",
               "pred_embed_map.png", "gt_rgb.png")


def write_epoch_html(epoch_dir, white_bg=True):
    """Per-epoch comparison page (reference: ref_nfr.py:821-874 writes a
    webpage per validation epoch): every batch dir of the epoch —
    directly under it (nfr_unit/ref_nfr) or under per-threshold subdirs
    (vq_nfr's <k or main_k>/batch*) — plus the epoch's elbow plot
    (vq_num.png) and loss.json / vq_test_loss.json scalars embedded at
    the top. Returns the page path, or None for an empty epoch dir."""
    import glob
    import json

    batch_dirs = sorted(
        glob.glob(os.path.join(epoch_dir, "batch*"))
        + glob.glob(os.path.join(epoch_dir, "*", "batch*")))
    rows, captions = [], []
    head_row, head_caps = [], []
    for name in ("loss.json", "vq_test_loss.json"):
        p = os.path.join(epoch_dir, name)
        if os.path.exists(p):
            with open(p) as f:
                head_row.append(json.dumps(json.load(f)))
            head_caps.append(name)
    elbow = os.path.join(epoch_dir, "vq_num.png")
    if os.path.exists(elbow):
        head_row.append(elbow)
        head_caps.append("vq_num.png (chromaticity drop-loss elbow)")
    if head_row:
        rows.append(head_row)
        captions.append(head_caps)
    if not batch_dirs and not rows:
        return None
    for d in batch_dirs:
        meta_path = os.path.join(d, "metadata.json")
        meta = "{}"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.dumps(json.load(f))
        label = os.path.relpath(d, epoch_dir)
        row, caps = [meta], [label + " metadata"]
        for k in _EPOCH_KEYS:
            p = os.path.join(d, k)
            if os.path.exists(p):
                row.append(p)
                caps.append(k)
        rows.append(row)
        captions.append(caps)
    return write_comparison_html(
        os.path.join(epoch_dir, "index.html"), rows, captions,
        title=os.path.basename(epoch_dir.rstrip(os.sep)),
        white_bg=white_bg)


def write_vali_index(outdir, white_bg=True):
    """vis_vali/index.html: one row per validation epoch — train_log
    scalars (loss, wall_s, skipped steps), metadata PSNR mean, the
    elbow thumbnail when present, and a link to the epoch page
    (written/refreshed here via write_epoch_html). Surfaces
    train_log.jsonl and the vq_num.png elbow history in the HTML
    review flow (r5, VERDICT r4 #8)."""
    import json

    vali_root = os.path.join(outdir, "vis_vali")
    if not os.path.isdir(vali_root):
        return None
    log_by_epoch = {}
    log_path = os.path.join(outdir, "train_log.jsonl")
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                try:
                    js = json.loads(line)
                except ValueError:
                    continue
                if "epoch" in js:
                    log_by_epoch[int(js["epoch"])] = js
    rows, captions = [], []
    for e_dir in sorted(os.listdir(vali_root)):
        if not e_dir.startswith("epoch"):
            continue
        epoch_dir = os.path.join(vali_root, e_dir)
        page = write_epoch_html(epoch_dir, white_bg=white_bg)
        try:
            epoch = int(e_dir.replace("epoch", ""))
        except ValueError:
            epoch = None
        scalars = log_by_epoch.get(epoch, {})
        log_txt = ", ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items() if k != "epoch") or "-"
        psnrs = []
        for root, _, files in os.walk(epoch_dir):
            if "metadata.json" in files:
                with open(os.path.join(root, "metadata.json")) as f:
                    js = json.load(f)
                if isinstance(js.get("psnr"), (int, float)):
                    psnrs.append(float(js["psnr"]))
        psnr_txt = ("%.2f dB" % (sum(psnrs) / len(psnrs))
                    if psnrs else "-")
        row = [e_dir, log_txt, psnr_txt]
        caps = ["epoch", "train_log", "val PSNR"]
        elbow = os.path.join(epoch_dir, "vq_num.png")
        if os.path.exists(elbow):
            row.append(elbow)
            caps.append("elbow")
        if page:
            row.append(page)
            caps.append("open epoch page")
        rows.append(row)
        captions.append(caps)
    if not rows:
        return None
    return write_comparison_html(
        os.path.join(vali_root, "index.html"), rows, captions,
        title=os.path.basename(os.path.abspath(outdir)) + " validation",
        white_bg=white_bg)
