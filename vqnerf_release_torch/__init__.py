"""vqnerf_release_torch: the PyTorch/CUDA port of vqnerf_release_tpu.

The JAX package beside it is the reference. This package imports torch and
never jax; its kernels are hand-written for NVIDIA Hopper (``csrc/``) and
built at first use. The port covers stage 2's inference path so far: the
four-pass test driver (``pipelines/test_driver.py``) over vq_nfr and
ref_nfr models.
"""

__version__ = "0.1.0"
