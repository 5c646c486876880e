"""vqnerf_release_torch: the PyTorch/CUDA port of vqnerf_release_tpu.

The JAX package beside it is the reference. This package imports torch and
never jax, nor anything of the JAX package; its kernels are hand-written for
NVIDIA Hopper (``csrc/``) and built at first use. The port covers so far:
NeuS geometry training (``train/neus_loop.py``) and extraction
(``pipelines/gen_geo.py``), the three decomposition phases
(``train/loop.py``), the four test passes (``pipelines/test_driver.py``),
the side pipelines of stage 2, the command line with the JAX CLI's
pipeline subcommands (``python -m vqnerf_release_torch.cli``), and the
import of the JAX package's checkpoints (``interop/jax_ckpt.py``).
"""

__version__ = "0.3.0"
