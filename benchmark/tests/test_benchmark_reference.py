"""The plain reference at tiny sizes: its pieces against values worked
out by hand, and one training step against the program's on the CPU."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import decomp as ref

from .conftest import TINY_MODEL


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, 1.0 + 2 ** -10,
                      -(1.0 + 3 * 2 ** -12)])
    assert ref.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                    1.0 + 2 ** -10, -(1.0 + 2 ** -10)]


def test_light_areas_cover_the_sphere():
    xyz, areas = ref.light_xyz(16)
    assert xyz.shape == (512, 3) and areas.shape == (512,)
    assert float(areas.sum()) == pytest.approx(4 * math.pi, rel=1e-6)
    assert np.allclose(np.linalg.norm(xyz, axis=1), 100.0, rtol=1e-6)


def test_microfacet_diffuse_only_at_zero_f0():
    # f0 = 0 and grazing-free geometry: glossy > 0 still, but with rough 1
    # the GGX D is 1/pi and the result is finite and non-negative
    n = torch.tensor([[0.0, 0.0, 1.0]])
    v = torch.tensor([[0.0, 0.0, 1.0]])
    l = torch.tensor([[[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]])
    albedo = torch.tensor([[0.5, 0.25, 1.0]])
    out = ref.microfacet(l, v, n, albedo, torch.ones((1, 1)),
                         torch.zeros((1, 3)), ref.Prec())
    # head-on: h = n, cos terms 1, F = f0 + (1 - f0)(1 - 1)^5 = 0
    assert torch.allclose(out[0, 0], albedo[0] / math.pi)
    # grazing light: cos_ln = 0, the glossy term divides by zero -> 0
    assert torch.allclose(out[0, 1], albedo[0] / math.pi)


def test_amsgrad_first_step_is_lr_times_sign():
    p = {"w": torch.tensor([1.0, 2.0, 3.0])}
    opt = ref.Amsgrad(p)
    g = {"w": torch.tensor([0.5, -2.0, 0.0])}
    assert opt.step(p, g, 0.1, torch.tensor(1.0))
    # m = 0.1 g, vhat = 0.001 g^2, corr = sqrt(0.001) / 0.1
    want = [1.0 - 0.1 * 0.5 / (0.5 + 1e-7 / math.sqrt(0.001)),
            2.0 + 0.1 * 2.0 / (2.0 + 1e-7 / math.sqrt(0.001)), 3.0]
    assert torch.allclose(p["w"], torch.tensor(want), atol=1e-6)


def test_amsgrad_skips_a_non_finite_step():
    p = {"w": torch.tensor([1.0])}
    opt = ref.Amsgrad(p)
    assert not opt.step(p, {"w": torch.tensor([float("nan")])}, 0.1,
                        torch.tensor(1.0))
    assert p["w"].item() == 1.0 and opt.count == 0


def test_lowp_moves_the_loss_but_not_far():
    cfg = dict(_full_cfg(), **TINY_MODEL)
    w = ref.make_weights(cfg, 5, "cpu")
    b = _batch(cfg, 64)
    roll = torch.rand((1, cfg["num_embed"]),
                      generator=torch.Generator().manual_seed(1))
    exact = ref.train_steps(w, [b], [1e-3], [roll], cfg)["loss"][0]
    low = ref.train_steps(w, [b], [1e-3], [roll], cfg, lowp=True)["loss"][0]
    assert exact != low
    assert abs(exact - low) / exact < 0.05


def test_one_step_against_the_program():
    """The reference's loss and gradients against the program's step on the
    CPU, at the tiny size (the benchmark's check does this on the card)."""
    from vqnerf_release_torch.models import decomp_common as dc
    from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
    from vqnerf_release_torch.models.vq_nfr import init_vq_nfr
    from vqnerf_release_torch.ops.vq import init_vq_ema_state
    from vqnerf_release_torch.train import decomp_trainer as dt
    cfg = dict(_full_cfg(), **TINY_MODEL)
    dcfg = dc.DecompConfig(**{k: v for k, v in cfg.items()
                              if k in dc.DecompConfig.__dataclass_fields__})
    w = ref.make_weights(cfg, 11, "cpu")
    g = torch.Generator().manual_seed(0)
    model = init_vq_nfr(g, dcfg, init_nfr_unit(g, dcfg),
                        np.zeros((6, 16), np.float32))[0]
    model.load_state_dict(w)
    lxyz, lareas = dc.light_constants(dcfg, "cpu")
    opt, step = dt.make_vq_nfr_step(model, dcfg, lxyz, lareas)
    b = _batch(cfg, 64)
    roll = torch.rand((1, 6), generator=torch.Generator().manual_seed(2))
    thres = torch.as_tensor(dcfg.train_thres())
    _, ld = step(init_vq_ema_state(16, 6), dict(b, _roll=roll), thres, None,
                 0, lr=1e-3)
    want = ref.train_steps(w, [b], [1e-3], [roll], cfg)
    assert float(ld["loss"]) == pytest.approx(want["loss"][0], rel=1e-5)
    for k, p in model.named_parameters():
        assert torch.allclose(p.detach(), want["params"][k], atol=1e-6), k


def _full_cfg():
    import json
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "configs" / \
        "decomp_nerf.json"
    return json.loads(path.read_text())["model"]


def _batch(cfg, n):
    from benchmark import inputs
    gen = torch.Generator().manual_seed(3)
    t = inputs.sphere_view_tensors(0, 4, 16, 16, cfg["light_h"], gen,
                                   device="cpu")
    fg = torch.nonzero(t["alpha"][:, 0] > 0)[:, 0]
    idx = fg[torch.randint(0, len(fg), (n,), generator=gen)]
    return {k: v[idx] for k, v in t.items()
            if k in ("rayo", "rgb", "alpha", "xyz", "normal", "lvis")}
