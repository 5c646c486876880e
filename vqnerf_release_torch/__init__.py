"""vqnerf_release_torch: the PyTorch/CUDA port of vqnerf_release_tpu.

The JAX package beside it is the reference. This package imports torch and
never jax, nor anything of the JAX package; its kernels are hand-written for
NVIDIA Hopper (``csrc/``) and built at first use. The port covers so far:
stage 2's main path, that is training of nfr_unit and vq_nfr
(``train/loop.py``) and the four test passes
(``pipelines/test_driver.py``) over vq_nfr and ref_nfr models; and stage 1's
geometry extraction (``pipelines/gen_geo.py``) from a NeuS model
(``models/neus.py``).
"""

__version__ = "0.3.0"
