"""The comparison that decides a training cell's ``correct``: the program's
first steps against the plain reference's, from the same weights and
inputs."""

import numpy as np
import torch


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def compare(prog, exact, w0, change_by="worst", detail=None):
    """loss_gap: the relative gap of the first step's loss (a later step's
    reads the near-ties of the codes that the first update leaves, which
    round either way: the loss of steps 2 and 3 is held through the change
    of the parameters); grad_gap and
    change_gap: by the worst leaf, the gap between the program's norm and
    the reference's of the first gradient and of the change of the
    parameters over the steps, against the larger of that leaf's reference
    norm and the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam and
    are left out of the change. ``change_by`` "median" takes the median
    leaf's gap of the change in place of the worst leaf's, where single
    elements of near-zero gradient flip their Adam step's sign between two
    sound runs (see PERF.md). A dict ``detail`` is filled with what the
    limits are set from: both readings of the change, the leaves of the
    largest gaps and every step's loss gap."""
    loss_gap = abs(prog["loss"][0] - exact["loss"][0]) / abs(exact["loss"][0])
    g_p, g_r = _norms(prog["grad1"]), _norms(exact["grad1"])
    g_med = float(np.median(list(g_r.values())))
    grad_gap = max(abs(g_p[k] - g_r[k]) / max(g_r[k], g_med) for k in g_r)
    moved = [k for k in g_r if g_r[k] >= 1e-3 * g_med]
    d_p = _norms({k: prog["params"][k] - w0[k] for k in moved})
    d_r = _norms({k: exact["params"][k] - w0[k] for k in moved})
    d_med = float(np.median(list(d_r.values())))
    gaps = [abs(d_p[k] - d_r[k]) / max(d_r[k], d_med) for k in moved]
    change_gap = (float(np.median(gaps)) if change_by == "median"
                  else max(gaps))
    if detail is not None:
        top = sorted(zip(gaps, moved), reverse=True)[:3]
        detail.update({
            "change_worst": max(gaps), "change_median": float(np.median(gaps)),
            "worst_leaves": [[k, g, d_r[k]] for g, k in top],
            "loss_gaps": [abs(a - b) / abs(b) for a, b in
                          zip(prog["loss"], exact["loss"])]})
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
