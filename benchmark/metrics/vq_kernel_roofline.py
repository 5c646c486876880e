"""vq_kernel_roofline: the fused VQ-EMA kernel's (``csrc/vq_kernel.cu``,
``vq_fused``) share of its roofline in the traced slice: the least time its
calls could take (bytes over the HBM bandwidth or operations over the TF32
peak, whichever is larger, counted once from the shapes) over their summed
device time, in percent."""

from benchmark.counts.decomp import vq_kernel_work
from benchmark.counts.peaks import TF32_FLOPS_PER_S, roofline_s
from benchmark.trace import kernel_time

UNIT = "%"
SOURCE = "device_trace"
KERNEL = "vq_fused"


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    calls, secs = kernel_time(s, KERNEL)
    if not calls or secs <= 0:
        return None
    cfg = ctx["config"]
    flops, nbytes = vq_kernel_work(cfg, 2 * cfg["n_rays_per_step"])
    return 100.0 * calls * roofline_s(flops, nbytes, TF32_FLOPS_PER_S) / secs
