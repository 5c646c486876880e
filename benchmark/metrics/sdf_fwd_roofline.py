"""sdf_fwd_roofline: the fused SDF forward kernel's (``csrc/sdf_kernel.cu``,
``sdf_mlp_kernel<1>``, the up-sample chain's SDF) share of its roofline in
the traced slice: the least time its calls could take (their operations
counted once over the TF32 peak, or their bytes over the HBM bandwidth,
whichever is larger) over their summed device time, in percent."""

from benchmark.counts.neus import sdf_fwd_work
from benchmark.counts.peaks import TF32_FLOPS_PER_S, roofline_s
from benchmark.trace import kernel_time

UNIT = "%"
SOURCE = "device_trace"
KERNEL = "sdf_mlp_kernel<1>"


def read(ctx):
    s = ctx["summary"]
    if s is None or not s["work"].get("sdf_fwd_points"):
        return None
    calls, secs = kernel_time(s, KERNEL)
    if not calls or secs <= 0:
        return None
    flops, nbytes = sdf_fwd_work(ctx["config"], s["work"]["sdf_fwd_points"],
                                 calls)
    return 100.0 * roofline_s(flops, nbytes, TF32_FLOPS_PER_S) / secs
