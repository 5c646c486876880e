"""The device an entry point runs on."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device):
    """``device`` as a torch.device, with a CUDA device's index filled in.
    Raises RuntimeError when a CUDA device is asked for and none is
    available: the entry points run on the card unless the caller asks for
    the CPU, and never fall back to it. Pins TF32 off for matmuls, since the
    reference computes in fp32 and TF32 keeps three digits."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} (a CUDA device) was asked for but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    return device
