"""One-command parity acceptance run of the PyTorch port (the counterpart
of scripts/acceptance.py, with the same flags and ``--device``).

Given a scene with reference-format stage-2 data (surf buffers + GT) and,
optionally, reference TensorFlow checkpoints, this runs the inference and
evaluation chain of ``vqnerf_release_torch`` and compares its scores with
the reference's own:

  [import]  reference vq_nfr/ref_nfr TF checkpoints -> the port's layout
            (``vqnerf_release_torch.interop.tf_import``; skipped without
            --ref-ckpt)
  [test]    the 4-phase inference driver (``cli test``): raw_test /
            pd_test / pd_relit / pd_vq
  [eval]    metric-eval (PSNR/SSIM/LPIPS over rgb/kd/ks/rough/env) on the
            test tree and, with --label-root, ``cli cluster-eval`` of its
            pd_vq embed maps (through a link <output-root>/
            acceptance_<scene>_pred/<scene>, the layout cluster-eval reads)
  [compare] ours vs --ref-scores (a metric-eval JSON of the reference
            implementation's outputs, an input file: nothing is fetched)
            -> per-buffer dPSNR table with PASS/FAIL at --tol-db; exit 1
            on a FAIL

Usage:

  python scripts/torch_acceptance.py lego_3072 \
      --data-root DATA --output-root OUT --gt-root GT \
      --test-envmap-dir ENVS [--ref-ckpt REF_TRAIN_DIR] \
      [--ref-scores ref_scores.json] [--label-root LABELS] \
      [--preset-override k=v,...] [--tol-db 0.1] [--device cuda]
"""

import argparse
import json
import os
import sys
from os.path import join

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_import(scene, ref_ckpt, output_root, data_type):
    """Import reference vq_nfr + ref_nfr checkpoints into the port's
    layout (on the host: the importer runs no device code)."""
    from vqnerf_release_torch import config as vcfg
    from vqnerf_release_torch.interop import tf_import
    for phase in ("vq_nfr", "ref_nfr"):
        src = join(ref_ckpt, f"{scene}_{phase}")
        if not os.path.isdir(src):
            raise SystemExit(f"[import] missing reference tree: {src}")
        out = vcfg.train_outdir(output_root, scene, phase)
        argv = ["--phase", phase, "--ckpt", src, "--out", out,
                "--data-type", data_type]
        if phase == "ref_nfr":
            argv += ["--vq-ckpt", join(ref_ckpt, f"{scene}_vq_nfr")]
        print("[import] tf_import", " ".join(argv), flush=True)
        tf_import.main(argv)


def load_scores(path):
    with open(path) as f:
        return json.load(f)


def compare(ours, ref, scene, tol_db):
    """Per-buffer PSNR comparison rows; PASS iff ours >= ref - tol."""
    import numpy as np
    rows = []
    ours_s = ours.get(scene, {})
    ref_s = ref.get(scene, {})
    for buf in sorted(set(ours_s) | set(ref_s)):
        o = ours_s.get(buf, {}).get("psnr") or []
        r = ref_s.get(buf, {}).get("psnr") or []
        if not o or not r:
            rows.append((buf, _m(o), _m(r), None, "n/a"))
            continue
        om, rm = float(np.mean(o)), float(np.mean(r))
        d = om - rm
        rows.append((buf, om, rm, d, "PASS" if d >= -tol_db else "FAIL"))
    return rows


def _m(x):
    import numpy as np
    return float(np.mean(x)) if x else None


def discover(root, scene, family):
    """Discovery of acceptance inputs from a conventional root (the layout
    of MIGRATION.md "Acceptance data layout"):

        <root>/data/<scene>/            stage-2 data  -> --data-root
        <root>/data/test_envs/          (or <root>/test_envs) envmaps
        <root>/gt/<scene>/              GT tree       -> --gt-root
                                        (falls back to <root>/data)
        <root>/surf/<family>_surf/<scene>/  stage-1 buffers -> --surf-root
        <root>/ref_train/<scene>_vq_nfr/    reference TF ckpts -> --ref-ckpt
        <root>/ref_scores.json          (or ref_scores_<scene>.json)
        <root>/labels/<scene>/          segmentation GT -> --label-root

    Returns {flag_name: value} for everything found; explicit flags
    always win over discovered values."""
    j, found = os.path.join, {}
    if os.path.isdir(j(root, "data", scene)):
        found["data_root"] = j(root, "data", scene)
    for cand in (j(root, "data", "test_envs"), j(root, "test_envs")):
        if os.path.isdir(cand):
            found["test_envmap_dir"] = cand
            break
    if os.path.isdir(j(root, "gt", scene)):
        found["gt_root"] = j(root, "gt")
    elif "data_root" in found:
        found["gt_root"] = j(root, "data")
    surf = j(root, "surf", f"{family}_surf", scene)
    if os.path.isdir(surf):
        found["surf_root"] = j(root, "surf")
    if os.path.isdir(j(root, "ref_train", f"{scene}_vq_nfr")):
        found["ref_ckpt"] = j(root, "ref_train")
    for cand in (j(root, f"ref_scores_{scene}.json"),
                 j(root, "ref_scores.json")):
        if os.path.isfile(cand):
            found["ref_scores"] = cand
            break
    if os.path.isdir(j(root, "labels", scene)):
        found["label_root"] = j(root, "labels")
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="parity acceptance run of the PyTorch port (import -> "
                    "test -> eval -> compare)")
    ap.add_argument("scene")
    ap.add_argument("--auto", nargs="?", const="", default=None,
                    metavar="ROOT",
                    help="discover inputs from a conventional root "
                         "(ROOT, or $VQNERF_ACCEPTANCE_ROOT when given "
                         "bare) — see MIGRATION.md 'Acceptance data "
                         "layout'; explicit flags win over discovery")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--output-root", default=None)
    ap.add_argument("--gt-root", default=None,
                    help="GT tree: <scene>/val_NNN/rgba.png (+ albedo/"
                         "metal/rough for CG, relit GT for relight)")
    ap.add_argument("--test-envmap-dir", default=None)
    ap.add_argument("--surf-root", default=None,
                    help="stage-1 buffer root (default "
                         "<output-root>/surf; --auto may discover it)")
    ap.add_argument("--ref-ckpt", default=None,
                    help="reference train dir holding <scene>_vq_nfr/ "
                         "and <scene>_ref_nfr/ TF checkpoints")
    ap.add_argument("--ref-scores", default=None,
                    help="metric-eval JSON of the reference's outputs; "
                         "enables the dPSNR table")
    ap.add_argument("--label-root", default=None,
                    help="GT segmentation labels -> also run cluster-eval")
    ap.add_argument("--preset-override", default="")
    ap.add_argument("--skip-test", action="store_true",
                    help="reuse existing vis_test outputs")
    ap.add_argument("--tol-db", type=float, default=0.1)
    ap.add_argument("--out", default=None,
                    help="write the acceptance report JSON here "
                         "(default <output-root>/acceptance_<scene>.json)")
    ap.add_argument("--device", default="cuda",
                    help="the torch device of test and the evaluation "
                         "(default cuda; 'cpu' runs on the CPU); there is "
                         "no fallback")
    args = ap.parse_args(argv)

    from vqnerf_release_torch import config as vcfg
    from vqnerf_release_torch.cli import main as cli
    from vqnerf_release_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"torch_acceptance: {e}")
    family = vcfg.scene_family(args.scene)

    if args.auto is not None:
        root = args.auto or os.environ.get("VQNERF_ACCEPTANCE_ROOT", "")
        if not root:
            raise SystemExit("--auto needs a ROOT argument or "
                             "$VQNERF_ACCEPTANCE_ROOT")
        if not os.path.isdir(root):
            raise SystemExit(f"--auto root does not exist: {root}")
        found = discover(root, args.scene, family)
        print(f"[auto] {root}: discovered "
              + (", ".join(f"{k}={v}" for k, v in sorted(found.items()))
                 or "nothing"), flush=True)
        for k, v in found.items():
            if getattr(args, k, None) in (None, ""):
                setattr(args, k, v)
        if args.output_root is None:
            args.output_root = join(root, "output_torch")
            os.makedirs(args.output_root, exist_ok=True)
    missing = [f"--{k.replace('_', '-')}" for k in
               ("data_root", "output_root", "gt_root", "test_envmap_dir")
               if getattr(args, k) in (None, "")]
    if missing:
        raise SystemExit("missing required inputs (give them explicitly "
                         f"or via --auto): {', '.join(missing)}")

    report = {"scene": args.scene, "family": family, "steps": []}

    if args.ref_ckpt:
        data_type = {"nerf": "nerf", "mat": "nerf", "dtu": "dtu",
                     "ours": "dtu", "hw": "hw"}[family]
        run_import(args.scene, args.ref_ckpt, args.output_root, data_type)
        report["steps"].append("import")

    if not args.skip_test:
        cmd = ["test", args.scene, "--data-root", args.data_root,
               "--output-root", args.output_root,
               "--test-envmap-dir", args.test_envmap_dir,
               "--device", args.device]
        if args.surf_root:
            cmd += ["--surf-root", vcfg.surf_dir(
                args.surf_root, args.scene)]
        if args.preset_override:
            cmd += ["--preset-override", args.preset_override]
        print("[test]", " ".join(cmd), flush=True)
        cli(cmd)
        report["steps"].append("test")

    pred_root = join(
        vcfg.train_outdir(args.output_root, args.scene, "ref_nfr"),
        "vis_test", "latest")
    scores_json = join(
        args.output_root, f"acceptance_{args.scene}_scores.json")
    from vqnerf_release_torch.eval.metric_eval import eval_dataset
    print(f"[eval] metric-eval {pred_root} vs {args.gt_root}", flush=True)
    eval_dataset(
        [args.scene], family, args.output_root, args.gt_root,
        out_json=scores_json,
        scene_dirs={args.scene: (join(pred_root, "pd_test"),
                                 join(pred_root, "pd_relit"))},
        device=args.device)
    report["steps"].append("metric-eval")
    report["scores_json"] = scores_json

    if args.label_root:
        # cluster-eval reads <pred-root>/<scene>/batch*/embed_map.png and
        # test writes <latest>/pd_vq/batch*: a link bridges the two
        # (scripts/acceptance.py points --pred-root at pd_vq itself)
        bridge = join(args.output_root, f"acceptance_{args.scene}_pred")
        os.makedirs(bridge, exist_ok=True)
        link = join(bridge, args.scene)
        if os.path.islink(link):
            os.remove(link)
        os.symlink(os.path.abspath(join(pred_root, "pd_vq")), link)
        cluster_json = scores_json.replace("_scores.json", "_cluster.json")
        cmd = ["cluster-eval", "--scenes", args.scene,
               "--rgba-root", args.gt_root,
               "--label-root", args.label_root,
               "--pred-root", bridge,
               "--out-json", cluster_json, "--device", args.device]
        print("[eval]", " ".join(cmd), flush=True)
        cli(cmd)
        report["steps"].append("cluster-eval")
        report["cluster_json"] = cluster_json

    ours = load_scores(scores_json)
    report["lpips_impl"] = ours.get("_lpips_impl", "proxy")
    if args.ref_scores:
        rows = compare(ours, load_scores(args.ref_scores), args.scene,
                       args.tol_db)
        report["comparison"] = [
            {"buffer": b, "ours_psnr": o, "ref_psnr": r, "delta_db": d,
             "verdict": v} for b, o, r, d, v in rows]
        print(f"\n== acceptance: {args.scene} (tol {args.tol_db} dB, "
              f"lpips_impl={report['lpips_impl']}) ==")
        print(f"{'buffer':8s} {'ours':>8s} {'ref':>8s} {'delta':>8s}  "
              "verdict")
        for b, o, r, d, v in rows:
            print(f"{b:8s} "
                  f"{o if o is None else format(o, '8.2f')!s:>8s} "
                  f"{r if r is None else format(r, '8.2f')!s:>8s} "
                  f"{d if d is None else format(d, '+8.3f')!s:>8s}  {v}")
        fails = [x for x in report["comparison"]
                 if x["verdict"] == "FAIL"]
        report["pass"] = not fails
        print("ACCEPTANCE:", "PASS" if report["pass"] else
              f"FAIL ({len(fails)} buffers below tolerance)")
    else:
        print("[compare] no --ref-scores given; emitted our scores only "
              f"({scores_json})")

    report_path = args.out or join(
        args.output_root, f"acceptance_{args.scene}.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    print("report:", report_path)
    if args.ref_scores and not report.get("pass", True):
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
