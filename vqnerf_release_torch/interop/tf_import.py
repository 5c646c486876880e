"""Reference TensorFlow checkpoints into the port (counterpart of
vqnerf_release_tpu/interop/tf_import.py and
scripts/import_tf_checkpoint.py), read with ``interop/tf_bundle.py`` in
place of TensorFlow.

The reference saves the decomposition stage with
``tf.train.Checkpoint(step, optimizer, net=model)``. The only layer weights
in it are the keras Dense layers aliased onto the model as
``net_<name>_layer<i>`` (their weight "kernel", or "_kernel" in later
keras), the lazily created variables ``_light``, ``_gamma_bias`` and
``_gamma_index`` (data_type != 'nerf'), ``_codebook`` ([z_dim, K]) and the
sonnet EMA modules of ``vq_layer``, under object-graph keys such as::

    net/net_fine_enc_layer0/kernel/.ATTRIBUTES/VARIABLE_VALUE
    net/_light/.ATTRIBUTES/VARIABLE_VALUE
    net/vq_layer/ema_cluster_size/_hidden/.ATTRIBUTES/VARIABLE_VALUE

The importer matches those keys with patterns, as the JAX one does, and
builds the JAX package's parameter tree in numpy (a skip-MLP a list of
{"w": [d_in, d_out], "b": [d_out]}, float32). ``as_train_state`` wraps it
in the JAX loops' state with a fresh amsgrad state, and
``interop/jax_ckpt.py::port_state`` (``interop/jax_params.py``'s
converters) turns that into the port's checkpoint. A ref_nfr checkpoint
holds only its fresh heads (rgb_enc, diff_out, rough_out), the light and
the gamma: its frozen encoder and specular head come from the vq_nfr
checkpoint.

    python -m vqnerf_release_torch.interop.tf_import --phase vq_nfr \\
        --ckpt .../lego_vq_nfr --out out/train/lego_3072_vq_nfr/lr5e-4 \\
        --main-k 5
    python -m vqnerf_release_torch.interop.tf_import --phase ref_nfr \\
        --ckpt .../lego_ref_nfr --vq-ckpt .../lego_vq_nfr \\
        --out out/train/lego_3072_ref_nfr/lr5e-4

For vq_nfr it also writes vis_vali/np_light.npy (the imported light, not
clipped, as the JAX script writes it) and, with --main-k, the
vis_vali/epoch<N>/main_<k> marker that ``test`` reads.
"""

import argparse
import dataclasses
import json
import os
import re

import numpy as np

from ..models import decomp_common as dc
from ..ops.vq import VqEmaState
from . import tf_bundle

__all__ = [
    "import_nfr_unit", "import_vq_nfr", "import_ref_nfr",
    "infer_decomp_config", "as_train_state", "main",
]

_SUFFIX = r"/\.ATTRIBUTES/VARIABLE_VALUE$"


def _reader(path):
    """(reader, prefix) of a prefix, or of the latest prefix in a
    directory (also looked for under <path>/checkpoints, the reference's
    layout)."""
    prefix = path
    if os.path.isdir(path):
        prefix = tf_bundle.latest_checkpoint(path)
        if prefix is None:
            prefix = tf_bundle.latest_checkpoint(
                os.path.join(path, "checkpoints"))
        if prefix is None:
            raise FileNotFoundError(
                f"no TF checkpoint under {path} (need a 'checkpoint' index "
                "file; pass an explicit ckpt-N prefix otherwise)")
    return tf_bundle.load_checkpoint(prefix), prefix


def _value_keys(reader):
    return [k for k in reader.get_variable_to_shape_map()
            if re.search(_SUFFIX, k)]


def _collect_mlp(reader, keys, name, n_layers):
    """[{'w','b'}] for the ``net_<name>_layer<i>`` Dense aliases."""
    pat = re.compile(
        r"(?:^|/)net_%s_layer(\d+)/_?(kernel|bias)%s"
        % (re.escape(name), _SUFFIX))
    found = {}
    for k in keys:
        m = pat.search(k)
        if m:
            found.setdefault(int(m.group(1)), {})[m.group(2)] = k
    if sorted(found) != list(range(n_layers)):
        raise KeyError(
            f"net '{name}': expected layers 0..{n_layers - 1}, found "
            f"{sorted(found)} — is this the right phase's checkpoint?")
    out = []
    for i in range(n_layers):
        if set(found[i]) != {"kernel", "bias"}:
            raise KeyError(f"net '{name}' layer {i}: missing kernel or bias")
        out.append({
            "w": np.asarray(reader.get_tensor(found[i]["kernel"]),
                            np.float32),
            "b": np.asarray(reader.get_tensor(found[i]["bias"]),
                            np.float32),
        })
    return out


def _var(reader, keys, attr, required=True):
    pat = re.compile(r"(?:^|/)%s%s" % (re.escape(attr), _SUFFIX))
    hits = [k for k in keys if pat.search(k)]
    if len(hits) > 1:
        raise KeyError(f"variable '{attr}' is ambiguous: {hits}")
    if not hits:
        if required:
            raise KeyError(f"variable '{attr}' not found in checkpoint")
        return None
    return np.asarray(reader.get_tensor(hits[0]))


def _ema_field(reader, keys, which, field):
    """A sonnet ExponentialMovingAverage variable under vq_layer: ``which``
    is 'cluster_size' or 'dw', ``field`` hidden, average or counter (the
    underscore of sonnet's private attributes optional)."""
    pat = re.compile(r"(?:^|/)_?%s%s" % (re.escape(field), _SUFFIX))
    hits = [k for k in keys
            if ("vq_layer" in k and which in k and pat.search(k))]
    if len(hits) != 1:
        return None
    return np.asarray(reader.get_tensor(hits[0]))


def _check_like(expected, got, what):
    e, g = np.shape(expected), np.shape(got)
    if tuple(e) != tuple(g):
        raise ValueError(f"{what}: checkpoint shape {g} != expected {e} "
                         "(config mismatch?)")
    return np.asarray(got, np.float32)


def _check_mlp(expected, got, what):
    return [
        {k: _check_like(e[k], g[k], f"{what}[{i}].{k}") for k in ("w", "b")}
        for i, (e, g) in enumerate(zip(expected, got))
    ]


def infer_decomp_config(path, phase="vq_nfr", data_type=None, **overrides):
    """A DecompConfig from the checkpoint's tensor shapes: mlp_width and
    z_dim from the encoder kernels (rgb_enc for ref_nfr, which has no
    encoder of its own), light_h from ``_light``, num_embed from
    ``_codebook``; data_type 'hw' where gamma variables are present, else
    'nerf' ('dtu' looks like 'hw' here; override it)."""
    reader, _ = _reader(path)
    keys = _value_keys(reader)
    shapes = reader.get_variable_to_shape_map()

    def shape_of(regex):
        pat = re.compile(regex)
        hits = [k for k in keys if pat.search(k)]
        if len(hits) != 1:
            raise KeyError(f"want exactly one key matching {regex}, got "
                           f"{hits}")
        return shapes[hits[0]]

    cfg_kw = {}
    if phase == "ref_nfr":
        cfg_kw["z_dim"] = shape_of(
            r"(?:^|/)net_rgb_enc_layer0/_?kernel" + _SUFFIX)[1]
        # the reference's ref_nfr light is a plain tensor, so its
        # checkpoints carry no _light: import_ref_nfr passes the vq one's
        try:
            cfg_kw["light_h"] = shape_of(r"(?:^|/)_light" + _SUFFIX)[0]
        except KeyError:
            pass
    else:
        cfg_kw["mlp_width"] = shape_of(
            r"(?:^|/)net_fine_enc_layer0/_?kernel" + _SUFFIX)[1]
        cfg_kw["z_dim"] = shape_of(
            r"(?:^|/)net_bottleneck_layer2/_?kernel" + _SUFFIX)[1]
        cfg_kw["light_h"] = shape_of(r"(?:^|/)_light" + _SUFFIX)[0]
    if phase == "vq_nfr":
        num_embed = shape_of(r"(?:^|/)_codebook" + _SUFFIX)[1]
        num_drop = min(dc.DecompConfig.num_drop, max(num_embed - 1, 0))
        cfg_kw["num_embed"] = num_embed
        cfg_kw["num_drop"] = num_drop
        # keep train_thres() consistent for any num_drop
        cfg_kw["thres_str"] = ";".join(
            "%.4f" % t for t in np.linspace(0.1, 0.65, num_drop))
    if data_type is None:
        has_gamma = any(re.search(r"(?:^|/)_gamma_bias" + _SUFFIX, k)
                        for k in keys)
        data_type = "hw" if has_gamma else "nerf"
    cfg_kw["data_type"] = data_type
    cfg_kw.update(overrides)
    return dc.DecompConfig(**cfg_kw)


def _expected(cfg, kind, light=None):
    """The JAX-layout tree of a blank model of ``kind``: the shapes the
    checkpoint must have."""
    from ..train.loop import phase_model
    from .jax_params import to_jax
    return to_jax(phase_model(cfg, kind, light=light), kind)


def _import_gamma(reader, keys, params, cfg):
    gb = _var(reader, keys, "_gamma_bias", required=not cfg.is_nerf)
    gi = _var(reader, keys, "_gamma_index", required=not cfg.is_nerf)
    if gb is not None and gi is not None:
        one = np.zeros((1,), np.float32)
        params["gamma_bias"] = _check_like(one, gb, "gamma_bias")
        params["gamma_index"] = _check_like(one, gi, "gamma_index")


def import_nfr_unit(path, cfg=None):
    """Reference nfr_unit checkpoint -> (params, cfg): fine_enc,
    bottleneck, diff_out, spec_out, rough_out, light (and gamma)."""
    if cfg is None:
        cfg = infer_decomp_config(path, "nfr_unit")
    reader, _ = _reader(path)
    keys = _value_keys(reader)
    expected = _expected(cfg, "nfr_unit")
    params = {
        name: _check_mlp(expected[name],
                         _collect_mlp(reader, keys, name, len(expected[name])),
                         name)
        for name in ("fine_enc", "bottleneck",
                     "diff_out", "spec_out", "rough_out")
    }
    params["light"] = _check_like(
        expected["light"], _var(reader, keys, "_light"), "light")
    _import_gamma(reader, keys, params, cfg)
    return params, cfg


def _import_ema(reader, keys, cfg):
    """VqEmaState (numpy) from the sonnet EMA variables; where only the
    debiased ``average`` is there, hidden = average * (1 - decay^counter)."""
    counter = _ema_field(reader, keys, "cluster_size", "counter")
    counter_i = int(counter) if counter is not None else 1_000_000

    def hidden_of(which, shape):
        h = _ema_field(reader, keys, which, "hidden")
        if h is None:
            avg = _ema_field(reader, keys, which, "average")
            if avg is None:
                raise KeyError(
                    f"vq_layer ema_{which}: neither hidden nor average "
                    "found in checkpoint")
            h = avg * (1.0 - cfg.vq_decay ** min(counter_i, 1_000_000))
        return _check_like(np.zeros(shape, np.float32), h, f"ema_{which}")

    return VqEmaState(
        hidden_cluster_size=hidden_of("cluster_size", (cfg.num_embed,)),
        hidden_dw=hidden_of("dw", (cfg.z_dim, cfg.num_embed)),
        counter=np.asarray(counter_i, np.int32),
    )


def import_vq_nfr(path, cfg=None):
    """Reference vq_nfr checkpoint -> (params, VqEmaState, cfg): the three
    *_vq heads, the borrowed nfr nets as fine_enc/bottleneck/diff_main/
    spec_main/rough_main, the codebook [z_dim, K], the light, the EMA
    statistics (and gamma)."""
    if cfg is None:
        cfg = infer_decomp_config(path, "vq_nfr")
    reader, _ = _reader(path)
    keys = _value_keys(reader)
    expected = _expected(cfg, "vq_nfr")
    params = {
        name: _check_mlp(expected[name],
                         _collect_mlp(reader, keys, name, len(expected[name])),
                         name)
        for name in ("fine_enc", "bottleneck", "diff_main", "spec_main",
                     "rough_main", "diff_vq", "spec_vq", "rough_vq")
    }
    params["light"] = _check_like(
        expected["light"], _var(reader, keys, "_light"), "light")
    params["codebook"] = _check_like(
        expected["codebook"], _var(reader, keys, "_codebook"), "codebook")
    _import_gamma(reader, keys, params, cfg)
    return params, _import_ema(reader, keys, cfg), cfg


def import_ref_nfr(ref_path, vq_path, cfg=None):
    """Reference ref_nfr checkpoint -> ({'frozen', 'train'} params, cfg):
    the fresh heads, light and gamma from the ref checkpoint, the frozen
    encoder and specular head from the vq checkpoint (the light from the
    vq checkpoint where the ref one has none)."""
    vq_params, _, vq_cfg = import_vq_nfr(vq_path, cfg)
    if cfg is None:
        cfg = infer_decomp_config(
            ref_path, "ref_nfr", data_type=vq_cfg.data_type,
            mlp_width=vq_cfg.mlp_width, light_h=vq_cfg.light_h,
            num_embed=vq_cfg.num_embed, num_drop=vq_cfg.num_drop)
    if cfg.z_dim != vq_cfg.z_dim:
        raise ValueError(
            f"ref z_dim {cfg.z_dim} != vq z_dim {vq_cfg.z_dim}")
    reader, _ = _reader(ref_path)
    keys = _value_keys(reader)
    light = _var(reader, keys, "_light", required=False)
    if light is None:  # pre-refinement export: keep the vq light
        light = vq_params["light"]
    expected = _expected(cfg, "ref_nfr", light=np.asarray(light))
    train = {
        name: _check_mlp(expected["train"][name],
                         _collect_mlp(reader, keys, name,
                                      len(expected["train"][name])),
                         name)
        for name in ("rgb_enc", "diff_out", "rough_out")
    }
    _import_gamma(reader, keys, train, cfg)
    params = {
        "frozen": {
            "fine_enc": vq_params["fine_enc"],
            "bottleneck": vq_params["bottleneck"],
            "spec_out": vq_params["spec_main"],
            "light": _check_like(expected["frozen"]["light"], light,
                                 "light"),
        },
        "train": train,
    }
    return params, cfg


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return np.zeros_like(tree)


def as_train_state(phase, cfg, params, ema_state=None, epoch=0):
    """The state the JAX training loop of ``phase`` checkpoints, with a
    fresh amsgrad state (count 0, m, v and vhat zeros) over the trainable
    parameters, numpy leaves: what ``jax_ckpt.port_state`` takes."""
    if phase not in ("nfr_unit", "vq_nfr", "ref_nfr"):
        raise ValueError(f"unknown phase {phase!r}")
    trainable = params["train"] if phase == "ref_nfr" else params
    zeros = _zeros_like(trainable)
    state = {"params": params,
             "opt_state": {"count": np.zeros((), np.int32), "m": zeros,
                           "v": _zeros_like(zeros),
                           "vhat": _zeros_like(zeros)},
             "epoch": epoch}
    if phase == "vq_nfr":
        if ema_state is None:
            raise ValueError("vq_nfr state needs ema_state")
        state["ema"] = {k: np.asarray(v)
                        for k, v in zip(VqEmaState._fields, ema_state)}
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(
        "python -m vqnerf_release_torch.interop.tf_import",
        description="Write the port's checkpoint of a reference "
                    "TensorFlow checkpoint (a ckpt-N prefix, or a directory "
                    "holding one or checkpoints/).")
    ap.add_argument("--phase", required=True,
                    choices=["nfr_unit", "vq_nfr", "ref_nfr"])
    ap.add_argument("--ckpt", required=True,
                    help="TF ckpt prefix or directory")
    ap.add_argument("--vq-ckpt", default=None,
                    help="vq_nfr TF ckpt (required for --phase ref_nfr)")
    ap.add_argument("--out", required=True, help="output train dir")
    ap.add_argument("--data-type", default=None,
                    choices=["nerf", "dtu", "hw"],
                    help="override the inferred data type (dtu and hw are "
                         "indistinguishable from checkpoint contents)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch number for the written checkpoint "
                         "(default: the reference ckpt-N counter)")
    ap.add_argument("--main-k", type=int, default=None,
                    help="vq_nfr only: also create vis_vali/epoch<N>/"
                         "main_<k> so the test driver can prune codes")
    args = ap.parse_args(argv)

    from ..utils import ckpt as ckpt_util
    from .jax_ckpt import port_state

    _, prefix = _reader(args.ckpt)
    if args.epoch is not None:
        epoch = args.epoch
    else:
        m = re.search(r"-(\d+)$", os.path.basename(prefix))
        epoch = int(m.group(1)) if m else 1

    ema = None
    if args.phase == "nfr_unit":
        cfg = (infer_decomp_config(args.ckpt, "nfr_unit", args.data_type)
               if args.data_type else None)
        params, cfg = import_nfr_unit(args.ckpt, cfg)
    elif args.phase == "vq_nfr":
        cfg = (infer_decomp_config(args.ckpt, "vq_nfr", args.data_type)
               if args.data_type else None)
        params, ema, cfg = import_vq_nfr(args.ckpt, cfg)
    else:
        if not args.vq_ckpt:
            ap.error("--phase ref_nfr requires --vq-ckpt")
        params, cfg = import_ref_nfr(args.ckpt, args.vq_ckpt)
        if args.data_type:
            cfg = dataclasses.replace(cfg, data_type=args.data_type)

    tree = as_train_state(args.phase, cfg, params, ema_state=ema,
                          epoch=epoch)
    state, _ = port_state(tree, args.phase, cfg)
    path = ckpt_util.save_ckpt(args.out, epoch, state)

    if args.phase == "vq_nfr":
        vali = os.path.join(args.out, "vis_vali")
        os.makedirs(vali, exist_ok=True)
        np.save(os.path.join(vali, "np_light.npy"), params["light"])
        if args.main_k is not None:
            os.makedirs(os.path.join(vali, "epoch%09d" % epoch,
                                     "main_%d" % args.main_k),
                        exist_ok=True)

    print(json.dumps({
        "phase": args.phase, "source": prefix, "written": path,
        "epoch": epoch,
        "config": {"data_type": cfg.data_type, "light_h": cfg.light_h,
                   "mlp_width": cfg.mlp_width, "z_dim": cfg.z_dim,
                   "num_embed": cfg.num_embed},
    }))
    return path


if __name__ == "__main__":
    main()
