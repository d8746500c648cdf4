"""Animated multi-frame and multi-camera rendering (reference
``romis_tpu/render/animation.py``).

The reference scans a jitted frame over a stacked camera pytree and vmaps
over cameras; here a frame loop carries the ``TemporalState`` and a camera
batch is a loop of independent first frames. A stacked ``CameraParams``
holds each field with a leading frame (or camera) axis.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..core.features import Features

from ..core.camera import CameraParams
from .restir import (
    KERNELS,
    FrameOps,
    TemporalState,
    initial_temporal_state,
    render_restir_frame,
)


def stack_cameras(cams: list[CameraParams]) -> CameraParams:
    """Stack cameras along a leading frame axis."""
    return CameraParams(**{f.name: torch.stack([getattr(c, f.name)
                                                for c in cams])
                           for f in fields(CameraParams)})


def camera_at(cams: CameraParams, i: int) -> CameraParams:
    """Camera ``i`` of a stacked camera path."""
    return CameraParams(**{f.name: getattr(cams, f.name)[i]
                           for f in fields(CameraParams)})


def num_cameras(cams: CameraParams) -> int:
    return cams.look_at.shape[0]


def interpolate_cameras(cam_a: CameraParams, cam_b: CameraParams,
                        n_frames: int) -> CameraParams:
    """Linear camera path from cam_a to cam_b (inclusive), stacked: the
    animated camera workload of BASELINE config 4."""
    ts = torch.linspace(0.0, 1.0, n_frames, device=cam_a.look_at.device)

    def lerp(a, b):
        t = ts.reshape((-1,) + (1,) * a.dim())
        return a[None] * (1.0 - t) + b[None] * t

    return CameraParams(**{f.name: lerp(getattr(cam_a, f.name),
                                        getattr(cam_b, f.name))
                           for f in fields(CameraParams)})


def render_animation(generator, cams: CameraParams, geometry, lights,
                     num_lights: int, height: int, width: int,
                     features: Features, prev: TemporalState | None = None,
                     noises=None, ops: FrameOps = KERNELS):
    """Render F temporally reused frames along a stacked camera path →
    (images [F, H, W, 3], final TemporalState). Use
    ``features.temporal_reprojection=True`` for moving cameras. ``noises``
    (one ``noise`` per frame, see ``render_restir_frame``) replaces the
    random draws."""
    n_frames = num_cameras(cams)
    if prev is None:
        prev = initial_temporal_state(
            height, width, features.num_samples_in_reservoir,
            camera_at(cams, 0))
    images = []
    for f in range(n_frames):
        img, prev = render_restir_frame(
            generator, camera_at(cams, f), geometry, lights, num_lights,
            height, width, features, prev,
            noise=None if noises is None else noises[f], ops=ops)
        images.append(img)
    return torch.stack(images), prev


def render_camera_batch(generator, cams: CameraParams, geometry, lights,
                        num_lights: int, height: int, width: int,
                        features: Features, ops: FrameOps = KERNELS):
    """Render independent cameras, each as a first frame with no temporal
    history (the reference's per-camera fan-out, main.cpp:213-230) →
    images [C, H, W, 3]."""
    images = []
    for i in range(num_cameras(cams)):
        cam = camera_at(cams, i)
        prev = initial_temporal_state(
            height, width, features.num_samples_in_reservoir, cam)
        img, _ = render_restir_frame(generator, cam, geometry, lights,
                                     num_lights, height, width, features,
                                     prev, ops=ops)
        images.append(img)
    return torch.stack(images)
