"""The ReSTIR frame: trace → RIS → temporal reuse → shade → tone map
(reference ``romis_tpu/render/restir.py``).

This slice renders the frame with ``Features(spatial_reuse=False)``:
primary rays, closest hit (kernel 1), hit attributes and materials (kernel
2, twice), canonical RIS (kernel 3), temporal reuse without reprojection
(plain tensor code), final shade (kernel 4) and tone mapping. The spatial
pass, reprojection, the unbiased combine and the initial visibility check
belong to later slices and raise ``NotImplementedError``.

``FrameOps`` names the four kernel entry points a frame calls. ``KERNELS``
(the default) holds the wrappers, which launch the CUDA kernels for CUDA
tensors and run the plain versions for CPU tensors; ``PLAIN`` holds the
plain versions, for running the same frame without the kernels on any
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from romis_tpu.core.features import Features

from ..core.camera import CameraParams, generate_rays
from ..core.types import Rays, Reservoirs, ShadeCtx, empty_reservoirs
from ..ops import rows, shade, trace
from ..ops.intersect import make_hit_record, make_shade_ctx
from ..ops.ris import gen_canonical_samples_ris
from ..ops.shading import exposure_tone_mapping
from ..ops.wrs import (
    clamp_temporal_m,
    combine_biased,
    gen_canonical_samples_plain,
    gumbel_noise,
)


@dataclass(frozen=True)
class FrameOps:
    closest_hit: Callable  # (rays, geometry) → (t, tri, u, v)
    gather_rows: Callable  # (table, idx) → [C, ..., H, W]
    ris: Callable  # (ctx, lights, num_lights, features, generator, uniforms)
    final_shade: Callable  # (ctx, reservoirs, geometry, features) → [3, H, W]


KERNELS = FrameOps(trace.closest_hit, rows.gather_rows,
                   gen_canonical_samples_ris, shade.final_shade_fused)
PLAIN = FrameOps(trace.closest_hit_plain, rows.gather_rows_plain,
                 gen_canonical_samples_plain, shade.final_shade_plain)


@dataclass
class TemporalState:
    """Frame-to-frame carry for temporal reuse."""

    reservoirs: Reservoirs  # [K, ..., H, W]
    ctx: ShadeCtx  # previous frame's receiver geometry
    cam: CameraParams  # previous frame's camera
    has_prev: bool


def initial_temporal_state(height: int, width: int, k: int,
                           cam: CameraParams) -> TemporalState:
    """Zero-filled carry for the first frame (has_prev=False), on the
    camera's device."""
    dev = cam.look_at.device
    z3 = torch.zeros((3, height, width), device=dev)
    zs = torch.zeros((height, width), device=dev)
    ctx = ShadeCtx(
        valid=torch.zeros((height, width), dtype=torch.bool, device=dev),
        position=z3, normal=z3, view_origin=z3, kd=z3, ks=z3, shininess=zs,
        geom_id=torch.full((height, width), -1, dtype=torch.int32,
                           device=dev),
        depth_t=zs)
    return TemporalState(reservoirs=empty_reservoirs(height, width, k, dev),
                         ctx=ctx, cam=cam, has_prev=False)


def trace_primary(rays: Rays, geometry, features: Features,
                  ops: FrameOps = KERNELS):
    """Primary hits and the receiver context for the full ray grid."""
    t, tri, u, v = ops.closest_hit(rays, geometry)
    hits = make_hit_record(rays, geometry, t, tri, u, v,
                           gather=ops.gather_rows)
    ctx = make_shade_ctx(rays, hits, geometry, features,
                         gather=ops.gather_rows)
    return hits, ctx


def temporal_reuse(gumbel: torch.Tensor, ctx: ShadeCtx, current: Reservoirs,
                   prev: TemporalState, height: int, width: int,
                   features: Features) -> Reservoirs:
    """Temporal reuse with M-clamping, without reprojection: clamp the
    predecessor's history, then a 2-way biased combine of {current,
    predecessor} at the same pixel. ``gumbel`` [2, K, H, W] is the race
    noise."""
    if features.temporal_reprojection:
        raise NotImplementedError(
            "temporal_reprojection needs the halo offset gather "
            "(halo_offset_gather_pallas), ported in a later slice")
    dev = ctx.position.device
    pred = clamp_temporal_m(prev.reservoirs, current.total_m(),
                            float(features.temporal_clamp_m))
    inputs = Reservoirs(*(torch.stack([a, b], dim=0) for a, b in zip(
        (current.pos, current.color, current.w_sum, current.m,
         current.big_w, current.chosen_w),
        (pred.pos, pred.color, pred.w_sum, pred.m, pred.big_w,
         pred.chosen_w))))
    in_mask = torch.stack([
        torch.ones((height, width), dtype=torch.bool, device=dev),
        torch.full((height, width), bool(prev.has_prev), device=dev)])
    return combine_biased(ctx, inputs, in_mask, features, gumbel)


def final_shade(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                features: Features, ops: FrameOps = KERNELS) -> torch.Tensor:
    """Per lane, shadow ray x Phong x W, averaged over the K lanes →
    [3, H, W] pre-tone-map."""
    return ops.final_shade(ctx, reservoirs, geometry, features)


def _check_slice(features: Features) -> None:
    later = {
        "spatial_reuse": "the fused spatial pass (spatial_pass_pallas)",
        "temporal_reprojection": "the halo offset gather",
        "unbiased_combination": "the unbiased spatial pass and Z-count "
                                "occlusion",
        "initial_samples_visibility_check": "the any-hit kernel",
    }
    for flag, what in later.items():
        if getattr(features, flag):
            raise NotImplementedError(
                f"Features({flag}=True) needs {what}, ported in a later "
                f"slice; this slice renders with {flag}=False")


def render_restir_frame(generator, cam: CameraParams, geometry, lights,
                        num_lights: int, height: int, width: int,
                        features: Features, prev: TemporalState,
                        noise=None, ops: FrameOps = KERNELS):
    """One ReSTIR frame → (image [H, W, 3], TemporalState for the next
    frame).

    ``generator`` (a ``torch.Generator`` on the scene's device) takes the
    place of the reference's key. ``noise`` is the test hook that replaces
    every random draw: (RIS uniforms [S/K, 4, K, H, W], temporal race
    Gumbel noise [2, K, H, W]); it is None on the main path."""
    _check_slice(features)
    k = features.num_samples_in_reservoir
    ris_u, temporal_g = (None, None) if noise is None else noise

    rays = generate_rays(cam, height, width)
    _, ctx = trace_primary(rays, geometry, features, ops)
    res = ops.ris(ctx, lights, num_lights, features, generator=generator,
                  uniforms=ris_u)
    if features.temporal_reuse:
        if temporal_g is None:
            temporal_g = gumbel_noise(generator, (2, k, height, width))
        res = temporal_reuse(temporal_g, ctx, res, prev, height, width,
                             features)
    color = final_shade(ctx, res, geometry, features, ops)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    image = color.permute(1, 2, 0)  # [H, W, 3] for display/output
    return image, TemporalState(reservoirs=res, ctx=ctx, cam=cam,
                                has_prev=True)
