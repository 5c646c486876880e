"""Numeric ops: plain PyTorch counterparts of vqnerf_release_tpu.ops."""
