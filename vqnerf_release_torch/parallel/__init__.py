"""Parallelism: ray-axis data parallelism over a list of devices, and a
process group for extraction over several processes or hosts (counterpart
of vqnerf_release_tpu/parallel/).

The reference's distribution surface is data parallelism over the ray
batch (tf.distribute.MirroredStrategy) plus independent extraction
processes, each with its share of the views. Here a mesh is a list of torch
devices in the ray axis's order (repeats allowed: several replicas on one
card); batches are split in contiguous row blocks over it, params are kept
as one copy per device, and the per-device partial sums of a loss are
reduced on the first device (``train/decomp_trainer.py``). On a card each
mesh entry's work runs on a stream of its own (``MeshStreams``), so that a
CUDA graph captures the whole mesh step.
"""

from .mesh import MeshStreams, get_mesh, pad_to_multiple, shard_batch

__all__ = ["get_mesh", "shard_batch", "pad_to_multiple", "MeshStreams"]
