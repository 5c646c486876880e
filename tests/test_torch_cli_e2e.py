"""The port's CLI end to end on the CPU (``--device cpu``), through its
argparse surface: geo-train -> gen-geo --no-vis -> decomp-train --phase
all -> test -> gen-z -> reselect-main --dry-run -> ini-train, on a tiny
written scene, with the output tree of the JAX CLI checked file by file
(the pattern of tests/test_cli_e2e.py). Also: ``--device cuda`` without a
card exits with an error and writes nothing, and gen-geo's multi-device
flags exit.
"""

import json
import os
from os.path import join

import numpy as np
import pytest
import torch

import chip_smoke
from vqnerf_release_torch.cli import main
from vqnerf_release_torch.data import io as vio

SCENE = "lego_3072"  # the nerf family's preset
# NeuS at the shipped widths with 8+8 samples, 3 steps of 32 rays, a 16^3
# grid and no tail; stage 2 at tiny widths on 12x12 views without lvis
GEO_SMALL = ("batch_size=32,warm_up_end=2,save_freq=1000000000,"
             "val_freq=1000000000,mesh_freq=0,occ_res=16,tail_frac=0")
SMALL = ("imh=12,light_h=2,num_embed=4,num_drop=2,thres_str=0.1;0.2,"
         "z_dim=16,mlp_width=8,n_rays_per_step=16,epochs=1,"
         "total_sample_vq=40,data_type=hw,white_bg=True")


def _write_metadata(data_root, imh):
    """The stage-2 interface: a metadata.json beside each view's rgba."""
    for mode in ("train", "val"):
        tj = vio.read_json(join(data_root, "transforms_%s.json" % mode))
        for i, fr in enumerate(tj["frames"]):
            c2w = np.asarray(fr["transform_matrix"])
            vio.write_json({"imh": imh, "imw": imh,
                            "cam_angle_x": tj["camera_angle_x"],
                            "cam_transform_mat": ",".join(
                                str(x) for x in c2w.reshape(-1))},
                           join(data_root, "%s_%03d" % (mode, i),
                                "metadata.json"))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The chain run once; returns its roots."""
    root = str(tmp_path_factory.mktemp("cli"))
    data_root = join(root, "data")
    out = join(root, "output")
    chip_smoke.write_stage1_scene(data_root, 12, 2, 1, 0)
    _write_metadata(data_root, 12)
    env_dir = join(root, "envs")
    vio.write_hdr(join(env_dir, "city.hdr"),
                  np.random.RandomState(0).rand(2, 4, 3))
    common = ["--data-root", data_root, "--output-root", out,
              "--device", "cpu"]
    main(["geo-train", SCENE, *common, "--end-iter", "3",
          "--geo-override", GEO_SMALL, "--n-samples", "8"])
    main(["gen-geo", SCENE, *common, "--no-vis", "--n-samples", "8"])
    main(["decomp-train", SCENE, *common, "--phase", "all",
          "--preset-override", SMALL])
    main(["test", SCENE, *common, "--test-envmap-dir", env_dir,
          "--preset-override", SMALL])
    return {"root": root, "data": data_root, "out": out, "env": env_dir,
            "common": common}


def test_geometry_tree(chain):
    out = chain["out"]
    ckpts = os.listdir(join(out, "exp", SCENE, "nerf", "checkpoints"))
    assert ckpts == ["ckpt-3"]
    surf = join(out, "surf", "nerf_surf", SCENE)
    for view in ("train_000", "train_001", "val_000"):
        for name in ("xyz.npy", "normal.npy", "alpha.png", "rgb.png"):
            assert os.path.exists(join(surf, view, name)), (view, name)
        assert np.isfinite(np.load(join(surf, view, "xyz.npy"))).all()
        assert not os.path.exists(join(surf, view, "lvis.npy"))


def test_decomposition_tree(chain):
    out = chain["out"]
    for model in ("nfr_unit", "vq_nfr", "ref_nfr"):
        d = join(out, "train", "%s_%s" % (SCENE, model), "lr5e-4")
        assert os.listdir(join(d, "checkpoints")) == ["ckpt-1"]
        rows = [json.loads(x) for x in open(join(d, "train_log.jsonl"))]
        assert len(rows) == 1 and np.isfinite(rows[0]["wall_s"])
        assert os.path.exists(join(d, "vis_vali", "metas.json"))
    vq = join(out, "train", SCENE + "_vq_nfr", "lr5e-4", "vis_vali")
    assert os.path.exists(join(vq, "np_light.npy"))
    epoch = join(vq, "epoch000000001")
    assert os.path.exists(join(epoch, "vq_test_loss.json"))
    assert any(d.startswith("main_") for d in os.listdir(epoch))


def test_test_tree(chain):
    outroot = join(chain["out"], "train", SCENE + "_ref_nfr", "lr5e-4",
                   "vis_test", "latest")
    b = "batch000000000"
    for rel in (("raw_test", b, "pred_rgb.png"),
                ("raw_test", b, "pred_albedo.npy"),
                ("pd_test", b, "pred_albedo.png"),
                ("pd_relit", b, "pred_rgb_probes_city.png"),
                ("pd_vq", b, "embed_map.png"),
                ("pd_vq", b, "pred_embed.npy")):
        path = join(outroot, *rel)
        assert os.path.exists(path), rel
        if path.endswith(".npy"):
            assert np.isfinite(np.load(path)).all()


def test_gen_z_and_reselect_main(chain, capsys):
    """gen-z takes the family preset, as the JAX command does (no preset
    override): CG data at 512x512, whose views need an lvis.npy. The chain
    extracted with --no-vis, so stand-ins are written; gen-z reads only
    xyz and the mask, and the checkpoint decides the model's widths."""
    out = chain["out"]
    surf = join(out, "surf", "nerf_surf", SCENE)
    np.save(join(surf, "val_000", "lvis.npy"), np.ones((12, 12, 2),
                                                       np.float16))
    main(["gen-z", SCENE, *chain["common"], "--gen-z", "--mode", "vali"])
    gz = join(out, "train", SCENE + "_nfr_unit", "lr5e-4", "gen_z",
              "val_000")
    for name in ("albedo.npy", "albedo.png", "spec.npy", "spec.png",
                 "rough.npy", "rough.png", "z_bias.npy"):
        assert os.path.exists(join(gz, name)), name
    albedo = np.load(join(gz, "albedo.npy"))
    assert albedo.shape == (512, 512, 3) and np.isfinite(albedo).all()
    assert np.load(join(gz, "z_bias.npy")).shape == (512, 512, 16)
    os.remove(join(surf, "val_000", "lvis.npy"))

    epoch = join(out, "train", SCENE + "_vq_nfr", "lr5e-4", "vis_vali",
                 "epoch000000001")
    before = sorted(os.listdir(epoch))
    capsys.readouterr()
    main(["reselect-main", SCENE, "--output-root", out, "--dry-run",
          "--device", "cpu", "--best-thres", "1.0"])
    said = capsys.readouterr().out
    assert "reselect-main: k=" in said and "dry run" in said
    assert sorted(os.listdir(epoch)) == before


def test_ini_train_from_the_chain(chain, tmp_path):
    """ini-train resumes vq_nfr from the chain's nfr_unit checkpoint."""
    out = chain["out"]
    nfr = join(out, "train", SCENE + "_nfr_unit", "lr5e-4")
    ini = tmp_path / "vq_nfr.ini"
    ini.write_text(f"""[DEFAULT]
model = vq_nfr
data_type = hw
data_root = {chain["data"]}
data_nerf_root = {join(out, "surf", "nerf_surf", SCENE)}
nfr_model_ckpt = {join(nfr, "checkpoints", "ckpt-1")}
outroot = {tmp_path / "ini_out"}
xname = lr{{lr}}
imh = 12
light_h = 2
white_bg = True
mlp_width = 8
conv_width = 16
num_embed = 4
num_drop = 2
thres_str = 0.1;0.2
n_rays_per_step = 16
total_sample_vq = 40
epochs = 2
lr = 5e-4
""")
    main(["ini-train", "--config", str(ini), "--config-override",
          "epochs=1", "--device", "cpu"])
    d = tmp_path / "ini_out" / "lr5e-4"
    assert sorted(os.listdir(d / "checkpoints")) == ["ckpt-1"]
    assert (d / "vis_vali" / "np_light.npy").exists()


def test_debug_flag_runs_one_view(chain, tmp_path):
    dbg = str(tmp_path / "dbg")
    main(["decomp-train", SCENE, "--data-root", chain["data"],
          "--output-root", dbg, "--surf-root",
          join(chain["out"], "surf", "nerf_surf", SCENE),
          "--preset-override", SMALL.replace("epochs=1", "epochs=3"),
          "--debug", "--device", "cpu"])
    d = join(dbg, "train", SCENE + "_ref_nfr", "lr5e-4")
    rows = [json.loads(x) for x in open(join(d, "train_log.jsonl"))]
    assert len(rows) == 1  # --debug: one epoch
    state = torch.load(join(dbg, "train", SCENE + "_vq_nfr", "lr5e-4",
                            "checkpoints", "ckpt-1"), weights_only=False)
    assert int(state["ema"].counter) == 1  # one view, one step


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_without_a_card_exits(tmp_path):
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit) as e:
        main(["decomp-train", SCENE, "--data-root", str(tmp_path),
              "--output-root", out])
    assert "torch.cuda.is_available() is false" in str(e.value.code)
    assert not os.path.exists(out)


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--num-hosts", "2"],
                                   ["--coordinator", "h:1234"]])
def test_gen_geo_multi_device_exits(tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        main(["gen-geo", SCENE, "--data-root", str(tmp_path),
              "--output-root", str(tmp_path / "o"), "--device", "cpu",
              *flags])
    assert "Queue 1, item 11" in str(e.value.code)
