"""Device choice for the port's entry points."""

import torch


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller names one.

    Without a GPU the caller must ask for the CPU explicitly; nothing falls
    back to it silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda")
