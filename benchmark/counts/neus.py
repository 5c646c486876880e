"""Operations and bytes of stage 1's NeuS training, counted once from the
shapes of the model configuration (the configuration file's ``model``, with
its sampler), the way the algorithm needs them and whatever route computes
them. A dense layer is 2 d_in d_out operations a point (the weight norm's
fold is once a step and left out).

A training point, at which the loss needs the SDF, its spatial gradient and
the colour (F: the SDF net's multiply-adds a point, C: the colour net's):
  * forward F + C, the spatial gradient (a backward to the input) F;
  * the loss's backward: the colour net's 2C (input and weights), and, for
    the Eikonal term and the colour's normal input, the double backward: 2F
    through the gradient's graph and 2F through the forward it depends on;
so 6F + 3C multiply-adds. A point of the up-sample chain, and a cell of
the occupancy grid, needs the SDF channel alone, without gradient. The chain evaluates the n_samples first points and each round's
new points but the last round's.

The smoke script counted kernel 3 as three TF32 products a product (the
route the kernel takes today); here each product counts once, against the
TF32 peak, so its share reads about a third of the script's.
"""


def _dims(m):
    s = m["sdf"]
    d0 = s["d_in"] * (1 + 2 * s["multires"])
    return d0, [d0] + [s["d_hidden"]] * s["n_layers"] + [s["d_out"]]


def sdf_macs(m, feature=True):
    """Multiply-adds a point of the SDF net (the skip layer's input is the
    full width; the layer before it outputs the width less the encoding).
    Without ``feature`` the last layer computes the SDF channel alone, all
    that the up-sample chain and the occupancy grid need."""
    d0, dims = _dims(m)
    skip = m["sdf"]["skip_in"]
    outs = [dims[l + 1] - (d0 if l + 1 in skip else 0)
            for l in range(len(dims) - 1)]
    if not feature:
        outs[-1] = 1
    return sum(dims[l] * o for l, o in enumerate(outs))


def color_macs(m):
    c = m["color"]
    d0 = c["d_in"] + c["d_feature"] + 6 * c["multires_view"]
    dims = [d0] + [c["d_hidden"]] * c["n_layers"] + [c["d_out"]]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def sdf_weight_floats(m):
    """The SDF net's weights and biases, as a kernel reads them."""
    d0, dims = _dims(m)
    skip = m["sdf"]["skip_in"]
    outs = [dims[l + 1] - (d0 if l + 1 in skip else 0)
            for l in range(len(dims) - 1)]
    return sum(dims[l] * o + o for l, o in enumerate(outs))


def render_points(m):
    return m["n_samples"] + m["n_importance"]


def chain_points(m):
    """Points a ray of the up-sample chain evaluates the SDF at."""
    if m["n_importance"] == 0:
        return 0
    steps = m["up_sample_steps"]
    return m["n_samples"] + m["n_importance"] // steps * (steps - 1)


def train_step_flops(m, rays):
    """One training step of ``rays`` rays under the sampler of ``m``."""
    f, c = sdf_macs(m), color_macs(m)
    return 2 * rays * (render_points(m) * (6 * f + 3 * c)
                       + chain_points(m) * sdf_macs(m, feature=False))


def grid_flops(m, res):
    """One occupancy rebuild: the SDF at res^3 cell centres."""
    return 2 * res ** 3 * sdf_macs(m, feature=False)


def sdf_fwd_work(m, points, calls):
    """(operations, bytes) of ``calls`` calls of the SDF forward kernel over
    ``points`` points in all: xyz read and the SDF written a point, the
    weights read once a call."""
    return (2 * points * sdf_macs(m, feature=False),
            4 * (points * 4 + calls * sdf_weight_floats(m)))
