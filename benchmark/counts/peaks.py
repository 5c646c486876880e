"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates without sparsity). A share of a peak is stated against
these whatever the card's power limit is; the harness prints that limit
beside it."""

HBM_BYTES_PER_S = 3.35e12
# the tensor cores in TF32: the ceiling of any float32 route, since a route
# that keeps float32 accuracy on the tensor cores spends more than one TF32
# product per product
TF32_FLOPS_PER_S = 495e12
# float32 outside the tensor cores: the ceiling of element-wise work
FP32_FLOPS_PER_S = 67e12


def roofline_s(flops, nbytes, flops_per_s):
    """The least time a call can take: the larger of its operations over
    the compute peak and its bytes over the memory bandwidth."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)
