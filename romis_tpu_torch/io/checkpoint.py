"""Checkpoint and resume of animated multi-frame renders (reference
``romis_tpu/io/checkpoint.py``): the whole temporal carry (reservoirs, the
previous frame's receivers, its camera, ``has_prev``), the frame index and
the random state go to one ``.npz``, so that a resumed run renders exactly
what the uninterrupted run would.

The reference's JAX key becomes the ``torch.Generator``'s state
(``get_state``): every draw of a frame, the Philox keys of the kernels
included (``ops.spatial.philox_key``, ``ops.ris._seed``), comes from that
generator, so a resumed run consumes the same draws.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ..core.camera import CameraParams
from ..core.types import Reservoirs, ShadeCtx
from ..render.restir import TemporalState

_PARTS = (("reservoirs", Reservoirs), ("ctx", ShadeCtx), ("cam", CameraParams))


def _leaves(state: TemporalState) -> dict:
    """The state's tensors by name ("reservoirs.pos", ...)."""
    return {f"{part}.{f.name}": getattr(getattr(state, part), f.name)
            for part, cls in _PARTS for f in fields(cls)}


def save_checkpoint(path: str, state: TemporalState,
                    generator: torch.Generator, frame: int) -> None:
    """Write ``state``, ``generator``'s state and the index of the last
    frame rendered to ``path`` (.npz)."""
    data = {k: v.detach().cpu().numpy() for k, v in _leaves(state).items()}
    data["has_prev"] = np.asarray(bool(state.has_prev))
    data["generator"] = generator.get_state().numpy()
    data["frame"] = np.asarray(frame, np.int64)
    np.savez_compressed(path, **data)


def load_checkpoint(path: str, template: TemporalState):
    """→ (TemporalState on the template's device, generator state as a
    uint8 tensor for ``torch.Generator.set_state``, frame). The template
    fixes the shapes (the same resolution and K as the saved run); a
    mismatch raises."""
    with np.load(path) as z:
        parts = {}
        for part, cls in _PARTS:
            kw = {}
            for f in fields(cls):
                old = getattr(getattr(template, part), f.name)
                new = z[f"{part}.{f.name}"]
                if tuple(old.shape) != new.shape:
                    raise ValueError(f"checkpoint shape mismatch at "
                                     f"{part}.{f.name}: {new.shape} vs "
                                     f"{tuple(old.shape)}")
                kw[f.name] = torch.as_tensor(new, dtype=old.dtype,
                                             device=old.device)
            parts[part] = cls(**kw)
        state = TemporalState(has_prev=bool(z["has_prev"]), **parts)
        gen_state = torch.as_tensor(z["generator"], dtype=torch.uint8)
        frame = int(z["frame"])
    return state, gen_state, frame
