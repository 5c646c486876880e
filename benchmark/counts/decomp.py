"""Operations and bytes of stage 2's work, counted once from the shapes of
the configuration (a dict of the configuration file's ``model`` keys), the
way the algorithm needs them and whatever route computes them.

Conventions (the benchmark's own; the repository's smoke script counted the
render and VQ kernels' bytes alike, and is the origin of these formulas):
  * a dense layer of d_in x d_out is 2 d_in d_out operations a row forward;
    its backward twice that (the input's and the weight's gradients), but
    the first encoder layer's, whose input needs no gradient, once;
  * element-wise work per (row, light) as the equations write it: the light
    directions 12 operations, the GGX BRDF 75, the render equation's
    weights 12 and its sum 6 a map; a backward costs twice its forward;
  * a kernel's bytes are every input byte read once, at the dtype the
    benchmark hands the entry, and every output byte written once.
"""

LDIR_OPS = 12
BRDF_OPS = 75
RENDER_WEIGHT_OPS = 12
RENDER_SUM_OPS = 6  # 3 channels, a product and an add each, per map


def posenc_dim(n_freqs):
    return 3 + 6 * n_freqs


def _mlp_macs(d_in, widths, skip_at):
    cur, layers = d_in, []
    for i, w in enumerate(widths):
        layers.append(cur * w)
        cur = w + (d_in if i in skip_at else 0)
    return layers


def encoder_layers(cfg):
    """MACs a row of each dense layer of the encoder (fine_enc then
    bottleneck)."""
    w, z = cfg["mlp_width"], cfg["z_dim"]
    return (_mlp_macs(posenc_dim(cfg["n_freqs_xyz"]), [w] * 4, (2,))
            + _mlp_macs(w, [w, z, z], ()))


def head_macs(cfg, d_out):
    z = cfg["z_dim"]
    return sum(_mlp_macs(z, [z, z // 2, d_out], (1,)))


def n_lights(cfg):
    return 2 * cfg["light_h"] ** 2


def vq_train_step_flops(cfg, rows):
    """Forward and backward of one vq_nfr training step of ``rows`` rows:
    the encoder, the three main and three VQ heads, the two BRDFs and
    renders over every light, the VQ distances."""
    enc = encoder_layers(cfg)
    fwd_mlp = 2 * (sum(enc) + head_macs(cfg, 3) + 2 * head_macs(cfg, 1)
                   + 2 * head_macs(cfg, 3) + head_macs(cfg, 1))
    bwd_mlp = 2 * fwd_mlp - 2 * enc[0]
    per_light = LDIR_OPS + 2 * (BRDF_OPS + RENDER_WEIGHT_OPS
                                + RENDER_SUM_OPS)
    elem = 3 * per_light * n_lights(cfg)  # forward and a backward of twice it
    vq = 2 * cfg["z_dim"] * cfg["num_embed"]
    return rows * (fwd_mlp + bwd_mlp + elem + vq)


def relight_view_flops(cfg, rows, n_envs):
    """Forward of the relighting render of ``rows`` rows: the encoder, the
    three main heads, one BRDF over every light, and the render under the
    learned light and under ``n_envs`` probe and OLAT maps (the weights
    once a call, of three calls, and the sum once a map)."""
    fwd_mlp = 2 * (sum(encoder_layers(cfg)) + head_macs(cfg, 3)
                   + 2 * head_macs(cfg, 1))
    per_light = (LDIR_OPS + BRDF_OPS + 3 * RENDER_WEIGHT_OPS
                 + RENDER_SUM_OPS * (1 + n_envs))
    return rows * (fwd_mlp + per_light * n_lights(cfg))


def vq_kernel_work(cfg, rows):
    """(operations, bytes) of one fused VQ-EMA training call over ``rows``
    latents: the distances to every code, the assignment's dw and counts,
    the EMA epilogue over the codebook; float32 in and out, int32 indices."""
    d, k = cfg["z_dim"], cfg["num_embed"]
    flops = 2 * rows * d * k + rows * d + rows + 10 * d * k
    f32 = 4
    read = (rows * d + d * k + rows + k + k + d * k + 1) * f32
    written = (rows * d + k + k + d * k + d * k) * f32 + rows * 4
    return flops, read + written


def render_kernel_work(cfg, rows):
    """(operations, bytes) of one fused BRDF-and-render call over ``rows``
    rows and every light: xyz, normal, view direction, albedo, roughness,
    f0 and lvis read, the [8, L] light table read, RGB written."""
    lights = n_lights(cfg)
    flops = rows * lights * (LDIR_OPS + BRDF_OPS + RENDER_WEIGHT_OPS
                             + RENDER_SUM_OPS)
    nbytes = 4 * (rows * (3 + 3 + 3 + 3 + 1 + 3) + rows * lights
                  + 8 * lights + rows * 3)
    return flops, nbytes
