"""scripts/torch_acceptance.py, the port's acceptance run, against
scripts/acceptance.py on the CPU: the same smoke artifacts as
tests/test_acceptance.py (a prediction tree in the test driver's layout, a
GT tree, reference scores), the same scores (the 16x16 views are
upscaled to the nerf family's 512, where cv2 hands a float bilinear resize
to Intel IPP: within 1e-5 relative, as tests/test_torch_eval.py holds
upscaled scores), the same report steps, the
same discovery, and the same dPSNR table with PASS/FAIL, exit code 1 on a
FAIL; with --label-root, cluster-eval of the pd_vq embed maps equals the
JAX CLI's cluster-eval. Each script's evaluation runs once a module; the
tests of the table, the discovery and cluster-eval reuse the port's scores
(its metric-eval is held to the JAX one once). The import and test steps
of the port's run are driven on the card by chip_smoke.py.
"""

import importlib.util
import json
import os
from os.path import join

import numpy as np
import pytest
import torch

from tests import test_acceptance as j_test


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCENE = j_test.SCENE
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _script("acceptance"), _script("torch_acceptance")


@pytest.fixture(scope="module")
def smoke_artifacts(tmp_path_factory):
    return j_test.smoke_artifacts.__wrapped__(
        tmp_path_factory.mktemp("acceptance"))


@pytest.fixture(scope="module")
def evaluated(scripts, smoke_artifacts):
    """Each script's report and scores on the artifacts, run once."""
    out = {}
    for name, acc in zip(("jax", "port"), scripts):
        report = _run(acc, *smoke_artifacts, [], name == "port")
        with open(report["scores_json"]) as f:
            out[name] = (report, json.load(f))
    return out


@pytest.fixture()
def port_scores(monkeypatch, evaluated):
    """The port's metric-eval replaced by its scores from ``evaluated``."""
    from vqnerf_release_torch.eval import metric_eval

    scores = evaluated["port"][1]

    def eval_dataset(scenes, family, pred_root, data_root, out_json=None,
                     **kw):
        with open(out_json, "w") as f:
            json.dump(scores, f)
        return scores
    monkeypatch.setattr(metric_eval, "eval_dataset", eval_dataset)
    return scores


def _run(acc, out_root, gt_root, env_dir, extra, port):
    argv = [SCENE, "--data-root", "/nonexistent", "--output-root", out_root,
            "--gt-root", gt_root, "--test-envmap-dir", env_dir,
            "--skip-test"] + extra
    acc.main(argv + (["--device", "cpu"] if port else []))
    with open(join(out_root, f"acceptance_{SCENE}.json")) as f:
        return json.load(f)


UPSCALE_REL = 1e-5


def _same_scores(got, want):
    assert set(got) == set(want)
    for scene in (k for k in want if not k.startswith("_")):
        assert set(got[scene]) == set(want[scene])
        for buf, metrics in want[scene].items():
            for name, vals in metrics.items():
                np.testing.assert_allclose(got[scene][buf][name], vals,
                                           rtol=UPSCALE_REL, atol=0,
                                           err_msg=f"{buf}.{name}")


def test_eval_and_report_equal_the_jax_scripts(evaluated):
    want, want_scores = evaluated["jax"]
    got, got_scores = evaluated["port"]
    assert got["steps"] == want["steps"] == ["metric-eval"]
    assert got["lpips_impl"] == want["lpips_impl"]
    _same_scores(got_scores, want_scores)
    assert np.mean(got_scores[SCENE]["rgb"]["psnr"]) > 40


def test_compare_table_equals_the_jax_compare(scripts, smoke_artifacts,
                                              port_scores, tmp_path, capsys):
    """On one scores file: the port's rows are the JAX ``compare``'s, a
    reference slightly worse passes, one far better buffer fails with exit
    code 1, and a buffer on one side only is n/a."""
    j_acc, t_acc = scripts
    out_root, gt_root, env_dir = smoke_artifacts
    ours = port_scores
    ref_pass = {SCENE: {
        b: {"psnr": [np.mean(m["psnr"]) - 0.05]}
        for b, m in ours[SCENE].items() if isinstance(m, dict)}}
    ref_fail = json.loads(json.dumps(ref_pass))
    ref_fail[SCENE]["kd"]["psnr"] = [
        float(np.mean(ours[SCENE]["kd"]["psnr"])) + 10.0]
    ref_fail[SCENE]["extra"] = {"psnr": [30.0]}
    for ref in (ref_pass, ref_fail):
        for tol in (0.0, 0.1, 20.0):
            assert t_acc.compare(ours, ref, SCENE, tol) == \
                j_acc.compare(ours, ref, SCENE, tol)

    ref_path = str(tmp_path / "ref.json")
    with open(ref_path, "w") as f:
        json.dump(ref_pass, f)
    report = _run(t_acc, out_root, gt_root, env_dir,
                  ["--ref-scores", ref_path], True)
    assert report["pass"] is True
    assert all(r["verdict"] == "PASS" for r in report["comparison"])
    with open(ref_path, "w") as f:
        json.dump(ref_fail, f)
    with pytest.raises(SystemExit) as e:
        _run(t_acc, out_root, gt_root, env_dir, ["--ref-scores", ref_path],
             True)
    assert e.value.code == 1
    with open(join(out_root, f"acceptance_{SCENE}.json")) as f:
        report = json.load(f)
    assert report["pass"] is False
    rows = j_acc.compare(ours, ref_fail, SCENE, 0.1)
    assert report["comparison"] == [
        {"buffer": b, "ours_psnr": o, "ref_psnr": r, "delta_db": d,
         "verdict": v} for b, o, r, d, v in rows]
    verdicts = {r["buffer"]: r["verdict"] for r in report["comparison"]}
    assert verdicts["kd"] == "FAIL" and verdicts["extra"] == "n/a"
    assert "ACCEPTANCE: FAIL (1 buffers below tolerance)" in \
        capsys.readouterr().out


def test_discovery_and_missing_inputs_equal_the_jax_scripts(
        scripts, smoke_artifacts, port_scores, tmp_path):
    j_acc, t_acc = scripts
    out_root, gt_root, _ = smoke_artifacts
    root = str(tmp_path / "conv_root")
    for d in (("data", SCENE), ("data", "test_envs"), ("gt", SCENE),
              ("surf", "nerf_surf", SCENE), ("ref_train", f"{SCENE}_vq_nfr"),
              ("labels", SCENE)):
        os.makedirs(join(root, *d))
    with open(join(root, "ref_scores.json"), "w") as f:
        json.dump({}, f)
    for name in ("ref_scores.json", f"ref_scores_{SCENE}.json"):
        with open(join(root, name), "w") as f:
            json.dump({}, f)
        assert t_acc.discover(root, SCENE, "nerf") == \
            j_acc.discover(root, SCENE, "nerf")
    os.rename(join(root, "gt"), join(root, "gt_hidden"))
    assert t_acc.discover(root, SCENE, "nerf") == \
        j_acc.discover(root, SCENE, "nerf")

    root2 = str(tmp_path / "conv_root2")
    os.makedirs(join(root2, "data", SCENE))
    os.makedirs(join(root2, "data", "test_envs"))
    t_acc.main([SCENE, "--auto", root2, "--output-root", out_root,
                "--gt-root", gt_root, "--skip-test", "--device", "cpu"])
    with open(join(out_root, f"acceptance_{SCENE}.json")) as f:
        assert json.load(f)["steps"] == ["metric-eval"]
    os.environ.pop("VQNERF_ACCEPTANCE_ROOT", None)
    with pytest.raises(SystemExit, match="--auto needs"):
        t_acc.main([SCENE, "--auto", "--skip-test", "--device", "cpu"])
    with pytest.raises(SystemExit, match="missing required inputs"):
        t_acc.main([SCENE, "--skip-test", "--device", "cpu"])


def test_port_script_imports_nothing_of_jax():
    with open(join(REPO, "scripts", "torch_acceptance.py")) as f:
        src = f.read()
    assert "vqnerf_release_tpu" not in src and "import jax" not in src


def test_cluster_eval_step_equals_the_jax_cli(scripts, smoke_artifacts,
                                              port_scores, tmp_path):
    """--label-root: the port's script scores test's pd_vq embed maps
    (reached through its link) as the JAX CLI's cluster-eval scores the
    same maps."""
    from vqnerf_release_torch.eval import cluster_eval as t_cluster
    from vqnerf_release_tpu.cli import main as j_cli
    from vqnerf_release_torch.data import io as t_io
    _, t_acc = scripts
    out_root, gt_root, env_dir = smoke_artifacts
    rs = np.random.RandomState(4)
    h, w = j_test.H, j_test.W
    latest = join(j_test.vcfg.train_outdir(out_root, SCENE, "ref_nfr"),
                  "vis_test", "latest")
    pal_gt = np.array(t_cluster.SEL_COLORS[:4], np.uint8)
    pal_pd = np.array(t_cluster.EMBED_C[:3], np.uint8)
    labels = str(tmp_path / "labels")
    os.makedirs(join(labels, SCENE, "val_000"))
    t_io.write_png(join(labels, SCENE, "val_000", "idx.png"),
                   pal_gt[rs.randint(0, 4, (h, w))])
    embed = join(latest, "pd_vq", "batch000000000")
    os.makedirs(embed)
    t_io.write_png(join(embed, "embed_map.png"),
                   pal_pd[rs.randint(0, 3, (h, w))])
    report = _run(t_acc, out_root, gt_root, env_dir,
                  ["--label-root", labels], True)
    assert report["steps"] == ["metric-eval", "cluster-eval"]
    with open(report["cluster_json"]) as f:
        got = json.load(f)
    bridge = str(tmp_path / "bridge")
    os.makedirs(bridge)
    os.symlink(join(latest, "pd_vq"), join(bridge, SCENE))
    want_json = str(tmp_path / "jax_cluster.json")
    j_cli(["cluster-eval", "--scenes", SCENE, "--rgba-root", gt_root,
           "--label-root", labels, "--pred-root", bridge, "--out-json",
           want_json])
    with open(want_json) as f:
        want = json.load(f)
    assert set(got["vq"][SCENE]) == set(want["vq"][SCENE])
    for k, v in want["vq"][SCENE].items():
        np.testing.assert_allclose(got["vq"][SCENE][k], v, rtol=1e-9,
                                   err_msg=k)

