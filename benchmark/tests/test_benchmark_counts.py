"""The work counts against cases worked by hand."""

import pytest

from benchmark.counts import decomp, peaks

CFG = dict(mlp_width=4, z_dim=6, n_freqs_xyz=1, light_h=2, num_embed=3)


def test_encoder_layers_by_hand():
    # posenc 3 + 6 = 9 inputs; fine_enc 9->4, 4->4, 4->4 (skip: +9), 13->4;
    # bottleneck 4->4, 4->6, 6->6
    assert decomp.encoder_layers(CFG) == [36, 16, 16, 52, 16, 24, 36]


def test_head_macs_by_hand():
    # 6->6, 6->3 (skip: +6), 9->d_out
    assert decomp.head_macs(CFG, 3) == 36 + 18 + 27
    assert decomp.head_macs(CFG, 1) == 36 + 18 + 9


def test_vq_train_step_flops_by_hand():
    enc = 36 + 16 + 16 + 52 + 16 + 24 + 36
    heads = 2 * 81 + 2 * 63 + 81 + 63
    fwd = 2 * (enc + heads)
    bwd = 2 * fwd - 2 * 36
    lights = 8
    elem = 3 * (12 + 2 * (75 + 12 + 6)) * lights
    vq = 2 * 6 * 3
    assert decomp.vq_train_step_flops(CFG, 10) == 10 * (fwd + bwd + elem + vq)


def test_relight_view_flops_by_hand():
    fwd = 2 * (196 + 81 + 2 * 63)
    per_light = 12 + 75 + 3 * 12 + 6 * (1 + 5)
    assert decomp.relight_view_flops(CFG, 7, 5) == 7 * (fwd + 8 * per_light)


def test_vq_kernel_work_by_hand():
    flops, nbytes = decomp.vq_kernel_work(CFG, 2)
    assert flops == 2 * 2 * 6 * 3 + 2 * 6 + 2 + 10 * 6 * 3
    read = 4 * (2 * 6 + 6 * 3 + 2 + 3 + 3 + 6 * 3 + 1)
    written = 4 * (2 * 6 + 3 + 3 + 6 * 3 + 6 * 3) + 2 * 4
    assert nbytes == read + written


def test_vq_kernel_bytes_at_the_cell():
    # the smoke script's count of the kernel's bytes at 2048 x 256 x 15
    cfg = dict(CFG, z_dim=256, num_embed=15)
    assert decomp.vq_kernel_work(cfg, 2048)[1] == 4_272_372


def test_render_kernel_work_by_hand():
    flops, nbytes = decomp.render_kernel_work(CFG, 5)
    assert flops == 5 * 8 * (12 + 75 + 12 + 6)
    assert nbytes == 4 * (5 * 16 + 5 * 8 + 8 * 8 + 5 * 3)


def test_render_kernel_bytes_at_the_cell():
    # the smoke script's count at 49,152 rays x 512 lights
    cfg = dict(CFG, light_h=16)
    assert decomp.render_kernel_work(cfg, 49152)[1] == 104_415_232


@pytest.mark.parametrize("flops, nbytes, want", [
    (495e12, 0, 1.0), (0, 3.35e12, 1.0), (990e12, 3.35e12, 2.0)])
def test_roofline_is_the_larger_bound(flops, nbytes, want):
    assert peaks.roofline_s(flops, nbytes, peaks.TF32_FLOPS_PER_S) == \
        pytest.approx(want)
