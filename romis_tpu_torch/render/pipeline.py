"""Render-mode dispatch: ReSTIR, R-MIS or R-OMIS (reference
``romis_tpu/render/pipeline.py``), and the per-render Features provenance
JSON (the reference's cereal archive, render.cpp:282-288)."""

from __future__ import annotations

import datetime
import os

import torch

from ..core.features import Features, RayTraceMode
from ..io.image import write_image
from ..utils import stats

from ..core.camera import CameraParams
from .restir import (
    KERNELS,
    FrameOps,
    TemporalState,
    initial_temporal_state,
    render_restir_frame,
)
from .rmis import render_rmis
from .romis import render_romis


def render_frame(generator, cam: CameraParams, scene, height: int, width: int,
                 features: Features, prev: TemporalState | None = None,
                 noise=None, ops: FrameOps = KERNELS):
    """Render one frame with the configured mode → (image [H, W, 3],
    TemporalState for ReSTIR, None for R-MIS and R-OMIS). ``noise`` replaces
    every random draw of the frame: for ReSTIR (RIS uniforms, temporal
    Gumbel noise, and per spatial pass (offsets, Gumbel noise)), see
    ``render_restir_frame``; for R-MIS and R-OMIS (the neighbour
    selection's noise, RIS uniforms per iteration), see
    ``render.rmis.render_rmis``. The frame is the span ``stats.FRAME``."""
    g, li, nl = scene.geometry, scene.lights, scene.num_lights
    mode = features.ray_trace_mode
    with stats.span(stats.FRAME):
        if mode == RayTraceMode.RMIS:
            return render_rmis(generator, cam, g, li, nl, height, width,
                               features, noise=noise, ops=ops), None
        if mode == RayTraceMode.ROMIS:
            return render_romis(generator, cam, g, li, nl, height, width,
                                features, noise=noise, ops=ops), None
        if prev is None:
            prev = initial_temporal_state(
                height, width, features.num_samples_in_reservoir, cam)
        return render_restir_frame(generator, cam, g, li, nl, height, width,
                                   features, prev, noise=noise, ops=ops)


def save_image(path: str, image: torch.Tensor) -> None:
    """Write an [H, W, 3] image tensor as BMP or PNG (by extension)."""
    write_image(path, image.detach().float().cpu().numpy())


def write_provenance(features: Features, out_dir: str) -> str:
    """A timestamped ``Features.to_json()`` dump in ``out_dir`` → its
    path."""
    os.makedirs(out_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    path = os.path.join(out_dir, f"{stamp}.json")
    with open(path, "w") as f:
        f.write(features.to_json())
    return path
