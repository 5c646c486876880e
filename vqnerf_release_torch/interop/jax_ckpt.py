"""JAX checkpoints into the port's (the port half; the JAX half is
``scripts/export_jax_ckpt.py``, run where jax and orbax are installed).

The exporter restores the newest orbax checkpoint of a phase against an
example state built by the JAX package's init functions and writes one
``.npz``: every leaf under its path in the state tree, the parts joined by
"/" (dict keys, list indices, ``NamedTuple`` fields by name), so
"params/fine_enc/0/w", "ema/hidden_dw", "opt_state/m/light",
"opt_state/mu/sdf/3/v", "epoch" or "iter_step".

This module reads that file with numpy alone, rebuilds the nested tree
(a level whose keys are all digits is a list) and turns it into the port's
checkpoint with the converters of ``interop/jax_params.py``:

  * nfr_unit: {"params", "opt_state" (amsgrad), "epoch"}
  * vq_nfr:   the same and "ema" (VqEmaState)
  * ref_nfr:  {"params", "opt_state" over the trainable part, "epoch"}
  * neus:     {"params", "opt_state" (Adam: count, mu, nu), "iter_step"}

It writes ``ckpt-<n>`` with ``utils/ckpt.py::save_ckpt`` into a phase's
output directory, where ``test``, ``gen-geo`` and a resumed
``decomp-train`` or ``geo-train`` of the CLI read it. The flat optimizer
vectors follow the parameter order of the model the port's trainer builds,
so the config (the scene's preset or an INI) is an input. A JAX
checkpoint holds no random-stream state: a resumed loop starts fresh
streams, as the JAX loops do. For a vq_nfr checkpoint the light that its
validation writes (``vis_vali/np_light.npy``, ref_nfr's input) is written
too where the directory has none.

    python -m vqnerf_release_torch.interop.jax_ckpt <npz> <outdir> \\
        --kind {nfr_unit,vq_nfr,ref_nfr,neus} (--scene S | --config INI)
"""

import argparse
import json
import os

import numpy as np

__all__ = ["KINDS", "flatten_tree", "unflatten_tree", "read_npz",
           "write_npz", "port_state", "import_npz", "main"]

KINDS = ("nfr_unit", "vq_nfr", "ref_nfr", "neus")


def flatten_tree(tree, prefix=""):
    """{path: numpy array} of a tree of dicts, lists, tuples and
    NamedTuples (fields by name); the exporter's key format."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat):
    """The nested tree of ``flatten_tree``'s output: dicts, and lists where
    every key of a level is a digit."""
    root = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            # a state without leaves (optax's EmptyState) leaves a gap
            return [node.get(str(i))
                    for i in range(max(map(int, node)) + 1)]
        return node

    return lists(root)


def read_npz(path):
    with np.load(path, allow_pickle=False) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def write_npz(path, state):
    """Write a state tree with numpy leaves in the exporter's format."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_tree(state))
    return path


def _amsgrad_state(opt_state):
    """The amsgrad {"count", "m", "v", "vhat"} of a JAX optimizer state,
    also where a clip transform chains before it (a list of states)."""
    if isinstance(opt_state, dict) and "count" in opt_state:
        return opt_state
    if isinstance(opt_state, list):
        for s in opt_state:
            if isinstance(s, dict) and "vhat" in s:
                return s
    raise ValueError("no amsgrad state (count, m, v, vhat) in opt_state")


def port_state(tree, kind, cfg):
    """(the port's checkpoint dict, its step number) of an exported JAX
    state tree; ``cfg`` is the DecompConfig (NeuSConfig for "neus") that
    the phase trained under."""
    from . import jax_params as jp

    if kind == "neus":
        from ..models.neus import init_neus
        model = init_neus(0, cfg)
        model.load_state_dict(jp.from_jax(tree["params"], "neus")
                              .state_dict())
        opt = tree["opt_state"]
        n = int(tree["iter_step"])
        return {"params": model.state_dict(),
                "opt_state": jp.adam_state_from_jax(
                    (opt["count"], opt["mu"], opt["nu"]), model),
                "iter_step": n}, n
    from ..ops.vq import VqEmaState
    from ..train.loop import phase_model

    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    model = phase_model(cfg, kind)
    model.load_state_dict(jp.from_jax(tree["params"], kind).state_dict())
    if kind == "ref_nfr":
        opt_model, opt_kind = model.trainable, "ref_nfr/train"
    else:
        opt_model, opt_kind = model, kind
    n = int(tree["epoch"])
    state = {"params": model.state_dict(),
             "opt_state": jp.opt_state_from_jax(
                 _amsgrad_state(tree["opt_state"]), opt_model, opt_kind),
             "epoch": n}
    if kind == "vq_nfr":
        state["ema"] = jp.ema_from_jax(
            tuple(tree["ema"][f] for f in VqEmaState._fields))
    return state, n


def import_npz(npz_path, outdir, kind, cfg):
    """Write the port's checkpoint of an exported JAX state into the phase
    directory ``outdir``; returns its path."""
    from ..utils import ckpt as ckpt_util

    state, n = port_state(read_npz(npz_path), kind, cfg)
    path = ckpt_util.save_ckpt(outdir, n, state)
    if kind == "vq_nfr":
        light = os.path.join(outdir, "vis_vali", "np_light.npy")
        if not os.path.exists(light):
            os.makedirs(os.path.dirname(light), exist_ok=True)
            # the clipped light, as vq_nfr's validation writes it
            np.save(light, np.maximum(
                state["params"]["light"].numpy(), 0.0))
    return path


def _config(args):
    from .. import config as vcfg
    from ..cli import _apply_preset_overrides

    if args.kind == "neus":
        if not args.scene:
            raise SystemExit("--kind neus takes its config from --scene")
        return vcfg.neus_configs_for_scene(args.scene)[0]
    if args.config:
        return vcfg.decomp_config_from_ini(args.config,
                                           args.config_override)[0]
    if not args.scene:
        raise SystemExit("give --scene or --config")
    cfg, _ = vcfg.decomp_config_for_scene(args.scene)
    return _apply_preset_overrides(cfg, args.preset_override)


def main(argv=None):
    ap = argparse.ArgumentParser(
        "python -m vqnerf_release_torch.interop.jax_ckpt",
        description="Write the port's checkpoint of a JAX checkpoint "
                    "exported by scripts/export_jax_ckpt.py.")
    ap.add_argument("npz", help="the exporter's .npz")
    ap.add_argument("outdir", help="the phase's output directory, e.g. "
                    "output/train/<scene>_vq_nfr/lr5e-4 or "
                    "output/exp/<scene>/<family>")
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--scene", default=None,
                    help="take the config from the scene's family preset")
    ap.add_argument("--preset-override", default="",
                    help="k=v,... onto the scene's decomposition preset")
    ap.add_argument("--config", default=None,
                    help="take the config from a reference-format INI")
    ap.add_argument("--config-override", default="")
    args = ap.parse_args(argv)
    path = import_npz(args.npz, args.outdir, args.kind, _config(args))
    print(json.dumps({"source": args.npz, "written": path,
                      "kind": args.kind}))
    return path


if __name__ == "__main__":
    main()
