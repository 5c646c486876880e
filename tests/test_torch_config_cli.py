"""The port's stage-2 config, CLI surface and side pipelines against the
JAX package's, on the CPU:

  * ``decomp_config_for_scene`` for one scene of each family, field by
    field; ``train_outdir``; ``decomp_config_from_ini`` with overrides;
    ``rewrite_ini_paths``;
  * the argparse surface of every ported subcommand, read from
    ``main([sub, "--help"])`` of both CLIs: the same option strings,
    defaults, choices and required flags, plus the port's ``--device``;
  * ``export_materials`` on a tiny NfrUnit carried across with
    ``from_jax``: the .npy files at rtol 1e-5 / atol 1e-6, the PNGs equal;
  * ``reselect_main`` on a validation directory the test writes: the same
    k and the same moved marker;
  * ``utils/profiling``: the trace written, ``None`` a no-op;
  * ``scripts/torch_{geo,train,test}.sh``: the JAX scripts' commands on
    the port's CLI.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import types
from os.path import join

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_models import SMALL
from vqnerf_release_tpu import cli as j_cli
from vqnerf_release_tpu import config as j_config
from vqnerf_release_tpu.models import nfr_unit as j_nfr
from vqnerf_release_tpu.pipelines import gen_main as j_gen_main
from vqnerf_release_tpu.pipelines import gen_z as j_gen_z
from vqnerf_release_torch import cli as t_cli
from vqnerf_release_torch import config as t_config
from vqnerf_release_torch.data import io as t_io
from vqnerf_release_torch.interop.jax_params import from_jax
from vqnerf_release_torch.pipelines import gen_main as t_gen_main
from vqnerf_release_torch.pipelines import gen_z as t_gen_z
from vqnerf_release_torch.utils import profiling

SUBCOMMANDS = ["geo-train", "gen-geo", "decomp-train", "test", "ini-train",
               "gen-z", "reselect-main"]
FAMILY_SCENES = ["lego_3072", "chair0_3072", "dtu_scan24", "colmap_bottle",
                 "rabbit_-1"]


@pytest.mark.parametrize("scene", FAMILY_SCENES)
def test_decomp_config_for_scene_equals_jax(scene):
    j_cfg, j_light = j_config.decomp_config_for_scene(scene)
    t_cfg, t_light = t_config.decomp_config_for_scene(scene)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_light == j_light
    j_cfg, _ = j_config.decomp_config_for_scene(scene, imh=64, epochs=3)
    t_cfg, _ = t_config.decomp_config_for_scene(scene, imh=64, epochs=3)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)


def test_output_layout_and_all_equal_jax():
    assert sorted(t_config.__all__) == sorted(j_config.__all__)
    for args in (("/o", "lego_3072", "vq_nfr"),
                 ("o", "dtu_scan24", "ref_nfr", "1e-3")):
        assert t_config.train_outdir(*args) == j_config.train_outdir(*args)
    for scene in FAMILY_SCENES:
        assert (t_config.surf_dir("/o", scene)
                == j_config.surf_dir("/o", scene))


_INI = """[DEFAULT]
model = vq_nfr
data_type = nerf
data_root = /data/lego
data_nerf_root = /data/surf/lego
outroot = /out/lego_vq
xname = lr{lr}
imh = 16
light_h = 2
white_bg = True
mlp_width = 8
conv_width = 16
num_embed = 4
num_drop = 2
thres_str = 0.1;0.2
n_rays_per_step = 32
epochs = 2
lr = 5e-4
lr_decay_steps = 500_000
random_seed = 1
commitment_cost = 0.25
"""


@pytest.mark.parametrize("override", ["", "epochs=1,imh=8,num_embed=6,"
                                          "num_drop=4,white_bg=False"])
def test_decomp_config_from_ini_equals_jax(tmp_path, override):
    ini = tmp_path / "vq_nfr.ini"
    ini.write_text(_INI)
    j_cfg, j_raw = j_config.decomp_config_from_ini(str(ini), override)
    t_cfg, t_raw = t_config.decomp_config_from_ini(str(ini), override)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_raw == j_raw
    assert t_config.load_ini(str(ini)) == j_config.load_ini(str(ini))
    assert (t_config.apply_overrides({"a": "1"}, override)
            == j_config.apply_overrides({"a": "1"}, override))


def test_rewrite_ini_paths_equals_jax(tmp_path):
    for mod in ("j", "t"):
        (tmp_path / mod).mkdir()
        (tmp_path / mod / "c.ini").write_text(_INI)
    j_out = j_config.rewrite_ini_paths(str(tmp_path / "j" / "c.ini"),
                                       "/data", "/local/data",
                                       str(tmp_path / "j" / "o.ini"))
    t_out = t_config.rewrite_ini_paths(str(tmp_path / "t" / "c.ini"),
                                       "/data", "/local/data",
                                       str(tmp_path / "t" / "o.ini"))
    assert open(t_out).read() == open(j_out).read()
    assert "/local/data/surf/lego" in open(t_out).read()
    t_config.rewrite_ini_paths(str(tmp_path / "t" / "c.ini"), "/out", "/x")
    assert "outroot = /x/lego_vq" in open(tmp_path / "t" / "c.ini").read()


def _surface(main, sub, monkeypatch):
    """(help text, {option strings: (default, required, choices, is a
    flag)}) of a subcommand, from ``main([sub, "--help"])``."""
    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *a, **kw):
        parsers.append(self)
        return parse(self, *a, **kw)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    out = io.StringIO()
    with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(out):
        main([sub, "--help"])
    monkeypatch.undo()
    assert e.value.code == 0
    subs = next(a for a in parsers[0]._actions
                if isinstance(a, argparse._SubParsersAction))
    actions = {}
    for a in subs.choices[sub]._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple(a.option_strings) or (a.dest,)
        actions[key] = (a.default, a.required,
                        tuple(a.choices) if a.choices else None,
                        a.nargs == 0, a.type)
    return out.getvalue(), actions


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_cli_surface_equals_jax(sub, monkeypatch):
    j_help, j_actions = _surface(j_cli.main, sub, monkeypatch)
    t_help, t_actions = _surface(t_cli.main, sub, monkeypatch)
    assert t_actions.pop(("--device",))[:2] == ("cuda", False)
    assert t_actions == j_actions
    for opts in list(t_actions) + [("--device",)]:
        if opts[0].startswith("-"):
            assert all(o in t_help for o in opts), opts


def test_cli_registers_only_the_ported_subcommands(monkeypatch):
    parsers = []
    parse = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, *a, **kw: parsers.append(self)
                        or parse(self, *a, **kw))
    with pytest.raises(SystemExit), \
            contextlib.redirect_stdout(io.StringIO()):
        t_cli.main(["--help"])
    subs = next(a for a in parsers[0]._actions
                if isinstance(a, argparse._SubParsersAction))
    assert sorted(subs.choices) == sorted(SUBCOMMANDS)


def _view(vid, h, w, seed):
    rs = np.random.RandomState(seed)
    alpha = (rs.rand(h * w, 1) > 0.3).astype(np.float32)
    return types.SimpleNamespace(
        id=vid, h=h, w=w, alpha=alpha,
        xyz=rs.uniform(-1, 1, (h * w, 3)).astype(np.float32))


def test_export_materials_equals_jax(tmp_path):
    j_cfg = j_config.decomp_config_for_scene("lego_3072", **SMALL)[0]
    t_cfg = t_config.decomp_config_for_scene("lego_3072", **SMALL)[0]
    params = jax.tree_util.tree_map(np.asarray,
                                    j_nfr.init_nfr_unit(3, j_cfg))
    model = from_jax(params, "nfr_unit")
    views = [_view("val_000", 6, 5, 0), _view("val_001", 4, 4, 1)]
    j_dirs = j_gen_z.export_materials(params, j_cfg, views,
                                      str(tmp_path / "j"), gen_z=True)
    t_dirs = t_gen_z.export_materials(model, t_cfg, views,
                                      str(tmp_path / "t"), gen_z=True)
    assert [os.path.relpath(d, tmp_path / "t") for d in t_dirs] == \
        [os.path.relpath(d, tmp_path / "j") for d in j_dirs]
    for jd, td in zip(j_dirs, t_dirs):
        assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
        for name in sorted(os.listdir(jd)):
            if name.endswith(".npy"):
                np.testing.assert_allclose(np.load(join(td, name)),
                                           np.load(join(jd, name)),
                                           rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(
                    t_io.read_png(join(td, name)),
                    t_io.read_png(join(jd, name)))


def _vali_epoch(root, num_embed, num_drop, losses, main_k):
    os.makedirs(root)
    with open(join(root, "vq_test_loss.json"), "w") as f:
        json.dump({"chromaticity": losses, "vqrgb": losses}, f)
    for k in range(num_embed - num_drop, num_embed + 1):
        name = ("main_%d" % k) if k == main_k else str(k)
        os.makedirs(join(root, name, "batch000000000"))
    return root


@pytest.mark.parametrize("best_thres,apply", [(0.002, True), (0.5, True),
                                              (0.002, False)])
def test_reselect_main_equals_jax(tmp_path, best_thres, apply):
    losses = [0.9, 0.5, 0.2, 0.19, 0.185, 0.05, 0.049, 0.048]
    num_embed, num_drop = 10, 7
    got = {}
    for name, fn in (("j", j_gen_main.reselect_main),
                     ("t", t_gen_main.reselect_main)):
        d = _vali_epoch(str(tmp_path / name), num_embed, num_drop, losses,
                        num_embed)
        got[name] = (fn(d, num_embed, num_drop, best_thres, apply=apply),
                     sorted(os.listdir(d)))
    assert got["t"] == got["j"]
    assert got["t"][0] != num_embed or not apply  # the marker moved


def test_profiling_trace_and_step_timer(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert (tmp_path / "prof" / "key_averages.txt").exists()
    timer = profiling.StepTimer(str(tmp_path / "t" / "steps.json"))
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(()))
    s = timer.summary()
    assert s["steps"] == 3 and s["best_ms"] <= s["p50_ms"] <= s["p90_ms"]
    assert json.load(open(tmp_path / "t" / "steps.json")) == s


@pytest.mark.parametrize("name", ["geo", "train", "test"])
def test_shell_scripts_are_the_jax_ones_on_the_port(name):
    """scripts/torch_<name>.sh runs the port's CLI with the arguments and
    defaults of scripts/<name>.sh."""
    def body(path):
        lines = [ln for ln in open(path).read().splitlines()
                 if ln and not ln.startswith("#")]
        return [ln.replace("vqnerf_release_tpu", "PKG") for ln in lines]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = [ln.replace("vqnerf_release_torch", "PKG") for ln in body(
        join(repo, "scripts", "torch_%s.sh" % name))]
    assert got == body(join(repo, "scripts", "%s.sh" % name))
    assert os.access(join(repo, "scripts", "torch_%s.sh" % name), os.X_OK)
