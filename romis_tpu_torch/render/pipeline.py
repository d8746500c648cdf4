"""Render-mode dispatch (reference ``romis_tpu/render/pipeline.py``)."""

from __future__ import annotations

import torch

from romis_tpu.core.features import Features, RayTraceMode
from romis_tpu.io.image import write_image

from ..core.camera import CameraParams
from .restir import (
    KERNELS,
    FrameOps,
    TemporalState,
    initial_temporal_state,
    render_restir_frame,
)


def render_frame(generator, cam: CameraParams, scene, height: int, width: int,
                 features: Features, prev: TemporalState | None = None,
                 noise=None, ops: FrameOps = KERNELS):
    """Render one frame with the configured mode → (image [H, W, 3],
    TemporalState). Only ReSTIR is ported so far. ``noise`` replaces every
    random draw of the frame: (RIS uniforms, temporal Gumbel noise, and per
    spatial pass (offsets, Gumbel noise)), see ``render_restir_frame``."""
    if features.ray_trace_mode != RayTraceMode.RESTIR:
        raise NotImplementedError(
            f"{features.ray_trace_mode.value}: R-MIS and R-OMIS need the MIS "
            "sweep kernels, ported in a later slice")
    if prev is None:
        prev = initial_temporal_state(height, width,
                                      features.num_samples_in_reservoir, cam)
    return render_restir_frame(generator, cam, scene.geometry, scene.lights,
                               scene.num_lights, height, width, features,
                               prev, noise=noise, ops=ops)


def save_image(path: str, image: torch.Tensor) -> None:
    """Write an [H, W, 3] image tensor as BMP or PNG (by extension)."""
    write_image(path, image.detach().float().cpu().numpy())
