"""The device an entry point places its tensors on when the caller names
none: the CUDA card. Without one it raises rather than carry on on the
CPU; a caller who wants the CPU says so with ``device="cpu"``."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the current CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "romis_tpu_torch places its tensors on the CUDA device by "
            "default and none is available; pass device=\"cpu\" to run on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())
