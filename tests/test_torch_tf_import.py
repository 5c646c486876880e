"""The port's TensorFlow-checkpoint reader and importer
(vqnerf_release_torch/interop/tf_bundle.py, tf_import.py) against
TensorFlow and the JAX importer (vqnerf_release_tpu/interop/tf_import.py).

The checkpoints are written by TensorFlow itself: tf.train.Checkpoint of a
tf.Module mimic of the reference's object graph, as tests/test_tf_import.py
builds it. The reader is held to tf.train.load_checkpoint key for key and
bit for bit; the importer to the JAX importer bit for bit, for data_type
"hw" (gamma variables) and "nerf" (none). chip_smoke.py's own writer
(there is no TensorFlow on the card) is held to TensorFlow's reader.
"""

import os
import struct
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from vqnerf_release_tpu.interop import tf_import as jti  # noqa: E402
from vqnerf_release_tpu.models import decomp_common as jdc  # noqa: E402
from vqnerf_release_tpu.models.nfr_unit import init_nfr_unit  # noqa: E402
from vqnerf_release_tpu.models.ref_nfr import init_ref_nfr  # noqa: E402
from vqnerf_release_tpu.models.vq_nfr import init_vq_nfr  # noqa: E402
from vqnerf_release_torch.interop import jax_ckpt  # noqa: E402
from vqnerf_release_torch.interop import tf_bundle  # noqa: E402
from vqnerf_release_torch.interop import tf_import as tti  # noqa: E402
from vqnerf_release_torch.utils import ckpt as ckpt_util  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

SMALL = dict(light_h=4, num_embed=6, num_drop=5, z_dim=32, mlp_width=16,
             thres_str="0.1;0.2;0.3;0.4;0.5")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want, path="tree"):
    """Equal structure, dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def _save_reference_style_ckpt(outdir, nets, variables, ema=None,
                               keras_private=False):
    """tests/test_tf_import.py's mimic: nets {name: [(w, b), ...]};
    variables {attr: array}; ema {'cluster_size'|'dw': (hidden, average,
    counter)}. keras_private names the Dense weight "_kernel"."""
    root = tf.Module()
    for name, layers in nets.items():
        for i, (w, b) in enumerate(layers):
            lay = tf.Module()
            setattr(lay, "_kernel" if keras_private else "kernel",
                    tf.Variable(w))
            lay.bias = tf.Variable(b)
            setattr(root, "net_%s_layer%d" % (name, i), lay)
    for attr, v in variables.items():
        setattr(root, attr, tf.Variable(v))
    if ema is not None:
        vq_layer = tf.Module()
        for which, (hidden, average, counter) in ema.items():
            m = tf.Module()
            m._counter = tf.Variable(int(counter), dtype=tf.int64)
            if hidden is not None:
                m._hidden = tf.Variable(hidden)
            m.average = tf.Variable(average)
            setattr(vq_layer, "ema_%s" % which, m)
        root.vq_layer = vq_layer
    ckpt = tf.train.Checkpoint(step=tf.Variable(3, dtype=tf.int64), net=root)
    return tf.train.CheckpointManager(ckpt, str(outdir),
                                      max_to_keep=1).save()


def _rand_mlp_like(mlp, rs):
    return [(rs.rand(*np.shape(l["w"])).astype(np.float32),
             rs.rand(*np.shape(l["b"])).astype(np.float32)) for l in mlp]


def _gamma(rs, data_type):
    if data_type == "nerf":
        return {}
    return {"_gamma_bias": rs.rand(1).astype(np.float32),
            "_gamma_index": rs.rand(1).astype(np.float32)}


@pytest.fixture(scope="module", params=["hw", "nerf"])
def reference_ckpts(request, tmp_path_factory):
    """nfr_unit, vq_nfr and ref_nfr checkpoints of random weights, written
    by TensorFlow, for one data_type."""
    data_type = request.param
    cfg = jdc.DecompConfig(data_type=data_type, **SMALL)
    rs = np.random.RandomState(0 if data_type == "hw" else 1)
    root = tmp_path_factory.mktemp("tf_" + data_type)
    nfr = init_nfr_unit(0, cfg)
    _save_reference_style_ckpt(
        root / "nfr_unit",
        {n: _rand_mlp_like(nfr[n], rs) for n in
         ("fine_enc", "bottleneck", "diff_out", "spec_out", "rough_out")},
        {"_light": rs.rand(*np.shape(nfr["light"])).astype(np.float32),
         **_gamma(rs, data_type)})
    vq, _ = init_vq_nfr(0, cfg, nfr,
                        np.zeros((cfg.num_embed, cfg.z_dim), np.float32))
    _save_reference_style_ckpt(
        root / "vq_nfr",
        {n: _rand_mlp_like(vq[n], rs) for n in
         ("fine_enc", "bottleneck", "diff_main", "spec_main", "rough_main",
          "diff_vq", "spec_vq", "rough_vq")},
        {"_light": rs.randn(*np.shape(vq["light"])).astype(np.float32),
         "_codebook": rs.rand(cfg.z_dim, cfg.num_embed).astype(np.float32),
         **_gamma(rs, data_type)},
        ema={"cluster_size": (rs.rand(cfg.num_embed).astype(np.float32),
                              rs.rand(cfg.num_embed).astype(np.float32), 7),
             "dw": (rs.rand(cfg.z_dim, cfg.num_embed).astype(np.float32),
                    rs.rand(cfg.z_dim, cfg.num_embed).astype(np.float32),
                    7)},
        keras_private=data_type == "nerf")
    ref = init_ref_nfr(0, cfg, vq, np.zeros(cfg.light_res + (3,),
                                            np.float32))
    _save_reference_style_ckpt(
        root / "ref_nfr",
        {n: _rand_mlp_like(ref["train"][n], rs) for n in
         ("rgb_enc", "diff_out", "rough_out")},
        {"_light": rs.rand(*cfg.light_res, 3).astype(np.float32),
         **_gamma(rs, data_type)})
    return root, data_type


# ---- the reader ----------------------------------------------------------


def _crc32c_bitwise(buf):
    """CRC-32C a bit at a time, without a table."""
    reg = 0xFFFFFFFF
    for b in buf:
        reg ^= b
        for _ in range(8):
            reg = (reg >> 1) ^ (0x82F63B78 if reg & 1 else 0)
    return reg ^ 0xFFFFFFFF


def test_crc32c_known_values():
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283
    assert tf_bundle.crc32c(b"") == 0
    rs = np.random.RandomState(0)
    for n in (1, 100, 4099):
        buf = rs.randint(0, 256, n).astype(np.uint8).tobytes()
        assert tf_bundle.crc32c(buf) == _crc32c_bitwise(buf), n
    c = tf_bundle.crc32c(b"abc")
    assert tf_bundle.masked_crc32c(b"abc") == (
        (((c >> 15) | (c << 17)) + 0xA282EAD8) % 2**32)


def test_reader_equals_tf_load_checkpoint(tmp_path):
    """Every key, shape, dtype and value of a TF-written checkpoint of
    every covered dtype, many keys (prefix-compressed runs) and a tensor
    of 84,000 bytes."""
    rs = np.random.RandomState(2)
    root = tf.Module()
    values = {
        "f32": rs.rand(300, 70).astype(np.float32),
        "f64": rs.rand(5, 3),
        "f16": rs.rand(9).astype(np.float16),
        "i32": rs.randint(-9, 9, (4, 4)).astype(np.int32),
        "i64": np.asarray(-123456789012, np.int64),
        "flag": np.array([True, False, True]),
        "empty": np.zeros((0, 4), np.float32),
    }
    for k, v in values.items():
        setattr(root, k, tf.Variable(v))
    for i in range(150):
        setattr(root, "layer_%03d" % i, tf.Variable(rs.rand(i % 7 + 1)))
    prefix = tf.train.CheckpointManager(
        tf.train.Checkpoint(net=root), str(tmp_path), max_to_keep=1).save()
    want = tf.train.load_checkpoint(prefix)
    got = tf_bundle.load_checkpoint(str(tmp_path))
    assert tf_bundle.latest_checkpoint(str(tmp_path)) == \
        tf.train.latest_checkpoint(str(tmp_path))
    shapes = want.get_variable_to_shape_map()
    assert got.get_variable_to_shape_map() == shapes
    dtypes = want.get_variable_to_dtype_map()
    for key in shapes:
        if dtypes[key] == tf.string:
            with pytest.raises(NotImplementedError, match="string tensor"):
                got.get_tensor(key)
            continue
        w, g = want.get_tensor(key), got.get_tensor(key)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key
    assert "_CHECKPOINTABLE_OBJECT_GRAPH" in shapes
    # TF's keys share prefixes within a restart run (16 entries)
    with open(prefix + ".index", "rb") as f:
        index = f.read()
    footer = index[-48:]
    _, pos = tf_bundle._handle(footer)
    handle, _ = tf_bundle._handle(footer, pos)
    (_, value), = tf_bundle._block_entries(
        tf_bundle._block(index, handle, "index"))
    (off, size), _ = tf_bundle._handle(value)
    block = index[off:off + size]
    end = len(block) - 4 * (struct.unpack("<I", block[-4:])[0] + 1)
    pos, n_shared = 0, 0
    while pos < end:
        shared, pos = tf_bundle._varint(block, pos)
        unshared, pos = tf_bundle._varint(block, pos)
        n, pos = tf_bundle._varint(block, pos)
        pos += unshared + n
        n_shared += shared > 0
    assert n_shared > 100


def test_reader_raises_on_crc_mismatch_snappy_and_slices(tmp_path):
    rs = np.random.RandomState(3)
    arr = rs.rand(64, 64).astype(np.float32)
    prefix = chip_smoke.write_tf_checkpoint(str(tmp_path / "a"),
                                            {"net/w": arr})
    data = prefix + ".data-00000-of-00001"
    with open(data, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ValueError, match="CRC-32C"):
        tf_bundle.load_checkpoint(prefix).get_tensor("net/w")

    index = open(prefix + ".index", "rb").read()
    bad = bytearray(index)
    bad[5] ^= 0xFF  # inside the data block
    open(prefix + ".index", "wb").write(bytes(bad))
    with pytest.raises(ValueError, match="CRC-32C"):
        tf_bundle.load_checkpoint(prefix)

    # the index block marked Snappy, its CRC made right again
    footer = index[-48:]
    _, pos = tf_bundle._handle(footer)
    (off, size), _ = tf_bundle._handle(footer, pos)
    snappy = bytearray(index)
    snappy[off + size] = 1
    snappy[off + size + 1:off + size + 5] = struct.pack(
        "<I", tf_bundle.masked_crc32c(bytes(snappy[off:off + size + 1])))
    open(prefix + ".index", "wb").write(bytes(snappy))
    with pytest.raises(NotImplementedError, match="Snappy"):
        tf_bundle.load_checkpoint(prefix)

    # a sliced (partitioned) entry: BundleEntryProto field 7
    entry = chip_smoke.tf_bundle_entry(1, [2], 0, 8, 1) + \
        chip_smoke._pb_field(7, 2, b"")
    sliced = tmp_path / "s"
    os.makedirs(sliced)
    open(str(sliced / "ckpt-1.index"), "wb").write(
        chip_smoke.tf_index_file({"net/part": entry}))
    open(str(sliced / "ckpt-1.data-00000-of-00001"), "wb").write(b"\0" * 8)
    with pytest.raises(NotImplementedError, match="sliced"):
        tf_bundle.load_checkpoint(str(sliced / "ckpt-1")).get_tensor(
            "net/part")


def test_chip_smoke_writer_read_back_by_tf(tmp_path):
    """chip_smoke.write_tf_checkpoint's files, read by TensorFlow: every
    key, shape, dtype and bit, and the checkpoint file found."""
    rs = np.random.RandomState(4)
    tensors = {
        "net/net_fine_enc_layer0/kernel/.ATTRIBUTES/VARIABLE_VALUE":
            rs.rand(63, 128).astype(np.float32),
        "net/_light/.ATTRIBUTES/VARIABLE_VALUE":
            rs.randn(16, 32, 3).astype(np.float32),
        "net/vq_layer/ema_dw/_counter/.ATTRIBUTES/VARIABLE_VALUE":
            np.asarray(11, np.int64),
        "f64": rs.rand(3), "f16": rs.rand(5).astype(np.float16),
        "i32": np.arange(4, dtype=np.int32), "flag": np.array([False, True]),
        "empty": np.zeros((0,), np.float32),
    }
    prefix = chip_smoke.write_tf_checkpoint(str(tmp_path), tensors, step=4)
    assert tf.train.latest_checkpoint(str(tmp_path)) == prefix
    r = tf.train.load_checkpoint(prefix)
    assert r.get_variable_to_shape_map() == {
        k: list(v.shape) for k, v in tensors.items()}
    for k, v in tensors.items():
        g = np.asarray(r.get_tensor(k))
        assert g.dtype == v.dtype and g.tobytes() == v.tobytes(), k


# ---- the importer --------------------------------------------------------


def test_import_nfr_unit_equals_jax(reference_ckpts):
    root, data_type = reference_ckpts
    j_params, j_cfg = jti.import_nfr_unit(str(root / "nfr_unit"))
    t_params, t_cfg = tti.import_nfr_unit(str(root / "nfr_unit"))
    assert t_cfg.data_type == j_cfg.data_type == data_type
    assert vars(t_cfg) == vars(j_cfg)
    _assert_trees_equal(t_params, _np(j_params))


def test_import_vq_nfr_equals_jax(reference_ckpts):
    root, _ = reference_ckpts
    j_params, j_ema, j_cfg = jti.import_vq_nfr(str(root / "vq_nfr"))
    t_params, t_ema, t_cfg = tti.import_vq_nfr(str(root / "vq_nfr"))
    assert vars(t_cfg) == vars(j_cfg)
    _assert_trees_equal(t_params, _np(j_params))
    _assert_trees_equal(tuple(t_ema), tuple(_np(tuple(j_ema))))


def test_import_ref_nfr_equals_jax(reference_ckpts):
    root, _ = reference_ckpts
    j_params, j_cfg = jti.import_ref_nfr(str(root / "ref_nfr"),
                                         str(root / "vq_nfr"))
    t_params, t_cfg = tti.import_ref_nfr(str(root / "ref_nfr"),
                                         str(root / "vq_nfr"))
    assert vars(t_cfg) == vars(j_cfg)
    _assert_trees_equal(t_params, _np(j_params))


def test_as_train_state_ports_as_the_jax_state(reference_ckpts):
    """The port's checkpoint of the port's wrapped tree equals the one of
    the JAX package's as_train_state (its optax amsgrad init, in the
    exporter's format), for every phase."""
    root, _ = reference_ckpts
    nfr, vq, ref = (str(root / p) for p in ("nfr_unit", "vq_nfr", "ref_nfr"))

    def normalised(mod):
        params, cfg = mod.import_nfr_unit(nfr)
        out = {"nfr_unit": (params, None, cfg)}
        out["vq_nfr"] = mod.import_vq_nfr(vq)
        params, cfg = mod.import_ref_nfr(ref, vq)
        out["ref_nfr"] = (params, None, cfg)
        return out

    jax_side, port_side = normalised(jti), normalised(tti)
    for phase in ("nfr_unit", "vq_nfr", "ref_nfr"):
        jp, je, jc = jax_side[phase]
        tp, te, tc = port_side[phase]
        j_tree = jax_ckpt.unflatten_tree(jax_ckpt.flatten_tree(_np(
            jti.as_train_state(phase, jc, jp, ema_state=je, epoch=3))))
        t_tree = tti.as_train_state(phase, tc, tp, ema_state=te, epoch=3)
        got, n = jax_ckpt.port_state(t_tree, phase, tc)
        want, m = jax_ckpt.port_state(j_tree, phase, tc)
        assert n == m == 3
        for key in ("params", "opt_state"):
            assert set(got[key]) == set(want[key])
            for k in want[key]:
                assert got[key][k].dtype == want[key][k].dtype, (phase, k)
                assert np.array_equal(got[key][k].numpy(),
                                      want[key][k].numpy()), (phase, k)
        if phase == "vq_nfr":
            for g, w in zip(got["ema"], want["ema"]):
                assert g.dtype == w.dtype
                assert np.array_equal(g.numpy(), w.numpy())
    tp, te, tc = port_side["vq_nfr"]
    with pytest.raises(ValueError, match="ema_state"):
        tti.as_train_state("vq_nfr", tc, tp)
    with pytest.raises(ValueError, match="unknown phase"):
        tti.as_train_state("bogus", tc, tp)


def test_import_wrong_phase_and_average_only_ema(tmp_path):
    cfg = jdc.DecompConfig(data_type="hw", **SMALL)
    rs = np.random.RandomState(5)
    nfr = init_nfr_unit(0, cfg)
    vq, _ = init_vq_nfr(0, cfg, nfr,
                        np.zeros((cfg.num_embed, cfg.z_dim), np.float32))
    nets = {n: _rand_mlp_like(vq[n], rs) for n in
            ("fine_enc", "bottleneck", "diff_main", "spec_main",
             "rough_main", "diff_vq", "spec_vq", "rough_vq")}
    variables = {"_light": rs.rand(*cfg.light_res, 3).astype(np.float32),
                 "_codebook": rs.rand(cfg.z_dim, cfg.num_embed).astype(
                     np.float32), **_gamma(rs, "hw")}
    ema = {"cluster_size": (None, rs.rand(cfg.num_embed).astype(np.float32),
                            1000),
           "dw": (None, rs.rand(cfg.z_dim, cfg.num_embed).astype(np.float32),
                  1000)}
    _save_reference_style_ckpt(tmp_path / "vq", nets, variables, ema=ema)
    _, j_ema, _ = jti.import_vq_nfr(str(tmp_path / "vq"))
    _, t_ema, _ = tti.import_vq_nfr(str(tmp_path / "vq"))
    _assert_trees_equal(tuple(t_ema), tuple(_np(tuple(j_ema))))
    with pytest.raises(KeyError, match="diff_out"):
        tti.import_nfr_unit(str(tmp_path / "vq"), cfg)
    with pytest.raises(FileNotFoundError, match="no TF checkpoint"):
        tti.import_vq_nfr(str(tmp_path))


def test_module_entry_writes_the_phase_directory(reference_ckpts, tmp_path,
                                                 capsys):
    """python -m vqnerf_release_torch.interop.tf_import (its main): the
    port's checkpoint of each phase under --out, the unclipped light and
    the main_<k> marker of vq_nfr, and `test`'s loader reading them."""
    root, data_type = reference_ckpts
    out = tmp_path / "out"
    vq_out, ref_out = str(out / "vq"), str(out / "ref")
    tti.main(["--phase", "vq_nfr", "--ckpt", str(root / "vq_nfr"),
              "--out", vq_out, "--main-k", "4"])
    tti.main(["--phase", "ref_nfr", "--ckpt", str(root / "ref_nfr"),
              "--vq-ckpt", str(root / "vq_nfr"), "--out", ref_out])
    tti.main(["--phase", "nfr_unit", "--ckpt", str(root / "nfr_unit"),
              "--out", str(out / "nfr"), "--epoch", "9"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and '"epoch": 9' in lines[2]
    t_vq, _, cfg = tti.import_vq_nfr(str(root / "vq_nfr"))
    assert ckpt_util.latest_ckpt(vq_out).endswith("ckpt-1")
    assert ckpt_util.latest_ckpt(str(out / "nfr")).endswith("ckpt-9")
    light = np.load(os.path.join(vq_out, "vis_vali", "np_light.npy"))
    assert light.tobytes() == t_vq["light"].tobytes() and light.min() < 0
    assert os.path.isdir(os.path.join(vq_out, "vis_vali", "epoch%09d" % 1,
                                      "main_4"))
    from vqnerf_release_torch import cli
    from vqnerf_release_torch.interop import jax_params
    vq = cli._load_phase_model(vq_out, cfg, "vq_nfr", "cpu")
    _assert_trees_equal(jax_params.to_jax(vq, "vq_nfr"), t_vq)
    ref = cli._load_phase_model(ref_out, cfg, "ref_nfr", "cpu", vq=vq)
    t_ref, _ = tti.import_ref_nfr(str(root / "ref_nfr"),
                                  str(root / "vq_nfr"))
    _assert_trees_equal(jax_params.to_jax(ref, "ref_nfr"), t_ref)


def test_chip_smoke_reference_tensors_import_bit_for_bit(tmp_path):
    """The smoke's path at a small width: a port model written as a
    reference-layout checkpoint by chip_smoke's writer, imported by the
    JAX importer (through TensorFlow) and by the port's, both equal to the
    model bit for bit."""
    from vqnerf_release_torch.interop import jax_params
    from vqnerf_release_torch.models import decomp_common as tdc
    from vqnerf_release_torch.ops.vq import init_vq_ema_state
    from vqnerf_release_torch.train.loop import phase_model
    import torch

    cfg = tdc.DecompConfig(**SMALL)
    vq = phase_model(cfg, "vq_nfr")
    with torch.no_grad():
        for p in vq.parameters():
            p.copy_(torch.randn_like(p))
    ema = init_vq_ema_state(cfg.z_dim, cfg.num_embed)
    ema = ema._replace(hidden_cluster_size=torch.rand(cfg.num_embed),
                       counter=torch.tensor(5, dtype=torch.int32))
    chip_smoke.write_tf_checkpoint(
        str(tmp_path / "vq"),
        chip_smoke.reference_tf_tensors(vq, "vq_nfr", ema, cfg.vq_decay))
    ref = phase_model(cfg, "ref_nfr", vq=vq, light=np.asarray(
        vq.light.detach()))
    chip_smoke.write_tf_checkpoint(
        str(tmp_path / "ref"), chip_smoke.reference_tf_tensors(ref,
                                                               "ref_nfr"))
    want_vq = jax_params.to_jax(vq, "vq_nfr")
    for mod in (tti, jti):
        params, got_ema, _ = mod.import_vq_nfr(str(tmp_path / "vq"))
        _assert_trees_equal(_np(params), want_vq)
        _assert_trees_equal(tuple(_np(tuple(got_ema))),
                            tuple(jax_params.ema_to_jax(ema).values()))
        params, _ = mod.import_ref_nfr(str(tmp_path / "ref"),
                                       str(tmp_path / "vq"))
        _assert_trees_equal(_np(params), jax_params.to_jax(ref, "ref_nfr"))
