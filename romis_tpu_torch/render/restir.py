"""The ReSTIR frame: trace → RIS → temporal reuse → spatial reuse → shade →
tone map (reference ``romis_tpu/render/restir.py``).

A frame runs primary rays, the closest hit (kernel 1), hit attributes and
materials (kernel 2, twice), canonical RIS (kernel 3) with the optional
initial visibility check (any-hit, kernel 6), temporal reuse with
M-clamping (plain tensor code; with ``temporal_reprojection`` the
predecessor is fetched by the halo offset gather, kernel 9), the spatial
passes (biased: kernel 5; unbiased: kernel 11), the final shade (kernel 4)
and tone mapping. Still refused, naming the slice that brings it: the
unbiased combine with ``spatial_reuse_visibility_check`` (Z-count
occlusion).

The frame is differentiable in the scene's tables (``diff.grad``). The
closest hit, the row and halo gathers and the final shade carry
re-evaluation or scatter backwards (kernels 13 and 10 and a second any-hit
on CUDA). ``Features.fused_resampling`` keeps the reference's meaning: True
runs the resampling phases (RIS, spatial passes) as the fused kernels,
which have no backward, for CUDA tensors; False runs their differentiable
formulation. Its branches mirror the reference's, with "CUDA tensors"
where the reference tests for Pallas on a TPU: with
``surrogate_resampling_grad`` the detached replay RIS (kernel 14) and the
winner-replay combines, with replay records through the reuse phases on
the biased non-fused path; with ``coherent_spatial_offsets`` one offset per
(pass, neighbour) instead of per pixel.

``FrameOps`` names the kernel entry points a frame calls. ``KERNELS`` (the
default) holds the wrappers, which launch the CUDA kernels for CUDA tensors
and run the plain versions for CPU tensors; ``PLAIN`` holds the plain
versions, for running the same frame without the kernels on any device.
Under autograd the plain versions are differentiated by PyTorch directly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch

from romis_tpu.core.features import Features

from ..core.camera import CameraParams, generate_rays, project_to_pixel
from ..core.types import (
    Rays, Reservoirs, ShadeCtx, detached, empty_reservoirs,
    pack_reservoir_planes, unpack_reservoir_planes,
)
from ..core.vec import vdot
from ..ops import rows, shade, spatial, trace
from ..ops.intersect import intersect_any, make_hit_record, make_shade_ctx
from ..ops.ris import gen_canonical_replay, gen_canonical_samples_ris
from ..ops.shading import exposure_tone_mapping
from ..ops.wrs import (
    clamp_temporal_m,
    combine_biased,
    combine_biased_surrogate,
    combine_unbiased,
    gen_canonical_replay_plain,
    gen_canonical_samples,
    gen_canonical_samples_plain,
    gen_canonical_surrogate,
    gumbel_noise,
    no_record,
)

# Spatial-reuse similarity gates (reference render_utils.cpp:113-118): more
# than 10 % depth difference or 25° normal difference rejects a neighbour.
SPATIAL_DEPTH_FRAC = 0.1
SPATIAL_NORMAL_COS = 0.90630778703  # cos(25°)


@dataclass(frozen=True)
class FrameOps:
    closest_hit: Callable  # (rays, geometry) → (t, tri, u, v)
    gather_rows: Callable  # (table, idx) → [C, ..., H, W]
    ris: Callable  # (ctx, lights, num_lights, features, generator, uniforms)
    final_shade: Callable  # (ctx, reservoirs, geometry, features) → [3, H, W]
    any_hit: Callable  # (origins, dirs, t_max, geometry) → bool [..., H, W]
    halo_gather: Callable  # (planes, dy, dx) → [D, C, H, W]
    spatial_pass: Callable  # (res, gates, cen, k, R, radius, features, ...)
    spatial_pass_unbiased: Callable  # (res, cen, k, R, radius, features, ...)
    ris_replay: Callable  # (ctx, lights, num_lights, features, generator,
    #                        uniforms) → (w_sum, replay1, replay2)


KERNELS = FrameOps(trace.closest_hit, rows.gather_rows,
                   gen_canonical_samples_ris, shade.final_shade_fused,
                   trace.any_hit, spatial.halo_offset_gather,
                   spatial.spatial_pass_fused,
                   spatial.spatial_pass_unbiased_fused, gen_canonical_replay)
PLAIN = FrameOps(trace.closest_hit_plain, rows.gather_rows_plain,
                 gen_canonical_samples_plain, shade.final_shade_plain,
                 trace.any_hit_plain, spatial.halo_offset_gather_plain,
                 spatial.spatial_pass_plain,
                 spatial.spatial_pass_unbiased_plain,
                 gen_canonical_replay_plain)


def _fused(features: Features, t: torch.Tensor) -> bool:
    """The reference's gate for the fused resampling kernels (Pallas on a
    TPU): ``fused_resampling`` and CUDA tensors."""
    return features.fused_resampling and t.is_cuda


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


def _similar(ctx: ShadeCtx, depth, normal) -> torch.Tensor:
    """The similarity gates: depth within SPATIAL_DEPTH_FRAC of the
    receiver's and normal within 25° of it."""
    depth_ok = (torch.abs(1.0 - depth / torch.clamp_min(ctx.depth_t, 1e-20))
                <= SPATIAL_DEPTH_FRAC)
    return depth_ok & (vdot(normal, ctx.normal) >= SPATIAL_NORMAL_COS)


def temporal_reuse(gumbel: torch.Tensor, ctx: ShadeCtx, current: Reservoirs,
                   prev: TemporalState, height: int, width: int,
                   features: Features, ops: FrameOps = KERNELS,
                   records=None):
    """Temporal reuse with M-clamping: clamp the predecessor's history, then
    a 2-way biased combine of {current, predecessor}. ``gumbel``
    [2, K, H, W] is the race noise.

    With ``temporal_reprojection`` the predecessor is fetched at the pixel
    where the previous camera saw the current hit point, within
    ±``reprojection_radius`` pixels (``ops.halo_gather``), and kept only if
    it is on screen, in front, in the band, valid, and within the depth and
    normal gates; otherwise it is rejected.

    With the current reservoirs' replay ``records`` [K, 3, H, W] it returns
    (Reservoirs, the winners' records): the exact combine, which also
    selects the record (the predecessor has none: its sample is
    previous-frame data)."""
    dev = ctx.position.device
    if features.temporal_reprojection:
        rows_f, cols_f, in_front = project_to_pixel(prev.cam, ctx.position,
                                                    height, width)
        # Round half to even (as jnp.round); clamping before the cast keeps
        # far-off projections defined.
        ri = torch.round(rows_f).clamp(0, height - 1).int()
        ci = torch.round(cols_f).clamp(0, width - 1).int()
        in_bounds = ((rows_f >= -0.5) & (rows_f <= height - 0.5)
                     & (cols_f >= -0.5) & (cols_f <= width - 0.5) & in_front)
        dy = ri - torch.arange(height, dtype=torch.int32, device=dev)[:, None]
        dx = ci - torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        rr = features.reprojection_radius
        in_band = (dy.abs() <= rr) & (dx.abs() <= rr)
        dy = dy.clamp(-rr, rr)
        dx = dx.clamp(-rr, rr)
        k = prev.reservoirs.k
        # Reservoir planes + the 5 gate planes (normal, depth, valid).
        planes = torch.cat([
            pack_reservoir_planes(prev.reservoirs), prev.ctx.normal,
            prev.ctx.depth_t[None], prev.ctx.valid.float()[None]], dim=0)
        g = ops.halo_gather(planes, dy[None], dx[None])[0]
        pred = unpack_reservoir_planes(g[:10 * k], k)
        p_normal = g[10 * k:10 * k + 3]
        p_depth = g[10 * k + 3]
        p_valid = g[10 * k + 4] > 0.5
        pred_mask = (in_bounds & in_band & ctx.valid & p_valid
                     & _similar(ctx, p_depth, p_normal))
    else:
        pred = prev.reservoirs
        pred_mask = torch.ones((height, width), dtype=torch.bool, device=dev)
    pred_mask = pred_mask & bool(prev.has_prev)

    pred = clamp_temporal_m(pred, current.total_m(),
                            float(features.temporal_clamp_m))
    inputs = Reservoirs(*(torch.stack([a, b], dim=0) for a, b in zip(
        (current.pos, current.color, current.w_sum, current.m,
         current.big_w, current.chosen_w),
        (pred.pos, pred.color, pred.w_sum, pred.m, pred.big_w,
         pred.chosen_w))))
    in_mask = torch.stack([
        torch.ones((height, width), dtype=torch.bool, device=dev), pred_mask])
    if records is not None:
        records = torch.stack([records, no_record(records)])
    return combine_biased(ctx, inputs, in_mask, features, gumbel, records)


def spatial_pass(ctx: ShadeCtx, reservoirs: Reservoirs, nbr: Reservoirs,
                 nbr_ctx: ShadeCtx, features: Features, gumbel: torch.Tensor,
                 geometry=None, any_hit=intersect_any, gumbel2=None,
                 records=None, lights=None, gather=None):
    """One spatial-reuse combine given gathered neighbours (fields
    [R, K, ..., H, W] and [R, ..., H, W]): the depth/normal gates (biased
    combine only), then the combine of {neighbours..., self} in that stream
    order with the race noise ``gumbel`` [R+1, K, H, W]. With
    ``surrogate_resampling_grad`` the biased combine is the winner-replay
    surrogate, whose second race takes ``gumbel2``; with ``records``
    (self [K, 3, H, W], neighbours [R, K, 3, H, W]) it re-derives the
    winners from ``lights`` and returns (Reservoirs, records)."""
    hw = ctx.depth_t.shape[-2:]
    r = nbr.m.shape[0]
    dev = ctx.depth_t.device
    if features.unbiased_combination:
        nbr_mask = torch.ones((r,) + tuple(hw), dtype=torch.bool, device=dev)
    else:
        nbr_mask = (_similar(ctx, nbr_ctx.depth_t, nbr_ctx.normal)
                    & ctx.valid & nbr_ctx.valid)
    inputs = Reservoirs(*(torch.cat([getattr(nbr, f), getattr(
        reservoirs, f)[None]]) for f in ("pos", "color", "w_sum", "m",
                                         "big_w", "chosen_w")))
    in_mask = torch.cat([nbr_mask, torch.ones((1,) + tuple(hw),
                                              dtype=torch.bool, device=dev)])
    if features.unbiased_combination:
        input_ctxs = ShadeCtx(**{f: torch.cat([getattr(nbr_ctx, f), getattr(
            ctx, f)[None]]) for f in ("valid", "position", "normal",
                                      "view_origin", "kd", "ks", "shininess",
                                      "geom_id", "depth_t")})
        return combine_unbiased(ctx, inputs, in_mask, input_ctxs, features,
                                gumbel, geometry, any_hit)
    if features.surrogate_resampling_grad:
        rec_in = None
        if records is not None:
            rec_in = torch.cat([records[1], records[0][None]])
        return combine_biased_surrogate(ctx, inputs, in_mask, features,
                                        gumbel, gumbel2, rec_in, lights,
                                        gather)
    return combine_biased(ctx, inputs, in_mask, features, gumbel)


def pack_pixel_planes(res: Reservoirs, ctx: ShadeCtx) -> torch.Tensor:
    """Reservoirs and ShadeCtx → [10K + 19, H, W]: the reservoir planes,
    then position3 | normal3 | view3 | kd3 | ks3 | shininess | depth |
    geom_id | valid."""
    return torch.cat([
        pack_reservoir_planes(res), ctx.position, ctx.normal,
        ctx.view_origin, ctx.kd, ctx.ks, ctx.shininess[None],
        ctx.depth_t[None], ctx.geom_id.float()[None],
        ctx.valid.float()[None]], dim=0)


def unpack_pixel_planes(g: torch.Tensor, k: int):
    """Inverse of pack_pixel_planes for gathered planes [N, C, H, W] →
    (Reservoirs [N, K, ..., H, W], ShadeCtx [N, ..., H, W])."""
    res = unpack_reservoir_planes(g[:, :10 * k], k)
    c = g[:, 10 * k:]
    ctx = ShadeCtx(position=c[:, 0:3], normal=c[:, 3:6],
                   view_origin=c[:, 6:9], kd=c[:, 9:12], ks=c[:, 12:15],
                   shininess=c[:, 15], depth_t=c[:, 16],
                   geom_id=c[:, 17].int(), valid=c[:, 18] > 0.5)
    return res, ctx


def coherent_gather(planes: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """planes [C, H, W] at ONE offset per neighbour, offs [2, R] →
    [R, C, H, W], coordinates clamped into the image: the reference's
    edge-padded dynamic slice."""
    h, w = planes.shape[-2:]
    dev = planes.device
    rows_i = torch.arange(h, device=dev)
    cols_i = torch.arange(w, device=dev)
    return torch.stack([
        planes.index_select(-2, torch.clamp(rows_i + offs[0, n], 0, h - 1))
        .index_select(-1, torch.clamp(cols_i + offs[1, n], 0, w - 1))
        for n in range(offs.shape[1])])


def _pass_noise(generator, inject, p: int, features: Features, h: int,
                w: int):
    """One pass's draws → (offsets: [2, R] coherent, else [2, R, H, W];
    Gumbel [R+1, K, H, W]; the surrogate's second race's Gumbel or None).
    ``inject[p]`` = (offsets, gumbel[, gumbel2]) replaces them."""
    if inject is not None:
        offs, gumbel, *rest = inject[p]
        return offs, gumbel, rest[0] if rest else None
    if generator is None:
        raise ValueError("spatial reuse needs a torch.Generator or the "
                         "injected noise")
    r = features.num_neighbours_to_sample
    k = features.num_samples_in_reservoir
    radius = features.spatial_resample_radius
    if features.coherent_spatial_offsets:
        offs = torch.randint(-radius, radius + 1, (2, r), generator=generator,
                             dtype=torch.int32, device=generator.device)
        gumbel = gumbel_noise(generator, (r + 1, k, h, w))
    else:
        offs, gumbel = spatial.spatial_noise(generator, r, k, radius, h, w)
    gumbel2 = None
    if (features.surrogate_resampling_grad
            and not features.unbiased_combination):
        gumbel2 = gumbel_noise(generator, (r + 1, k, h, w))
    return offs, gumbel, gumbel2


def spatial_reuse(generator, ctx: ShadeCtx, reservoirs: Reservoirs,
                  height: int, width: int, features: Features,
                  ops: FrameOps = KERNELS, inject=None, records=None,
                  lights=None, geometry=None):
    """Spatial reuse (reference spatialReuse, render_utils.cpp:87-140):
    ``spatial_resampling_passes`` passes, each drawing R offsets in the
    ±radius box (clamped to the screen) and combining {neighbours...,
    self}. ``inject`` (per pass: offsets, Gumbel noise [R+1, K, H, W] and,
    for the surrogate combine, its second race's noise) replaces the draws.

    The branches follow the reference's order. Fused (CUDA tensors with
    ``fused_resampling``): the pass kernels, with the state in the
    [10K, H, W] plane layout across the passes. Replay ``records``
    [K, 3, H, W] (returns (Reservoirs, records)): every gathered plane
    detached except big_w, the winners re-derived from ``lights``.
    Otherwise the differentiable gather (``coherent_gather`` or
    ``ops.halo_gather``) and ``spatial_pass``."""
    k = features.num_samples_in_reservoir
    if _fused(features, reservoirs.w_sum):
        r = features.num_neighbours_to_sample
        radius = features.spatial_resample_radius
        key = None if inject is not None else spatial.philox_key(generator)
        cen = shade.pack_center_ctx(ctx)
        res_planes = pack_reservoir_planes(reservoirs)
        gates = None if features.unbiased_combination \
            else spatial.pack_gates(ctx)
        for p in range(features.spatial_resampling_passes):
            noise = dict(generator=generator, key=key, pass_index=p,
                         inject=None if inject is None else inject[p][:2])
            if features.unbiased_combination:
                res_planes = ops.spatial_pass_unbiased(
                    res_planes, cen, k, r, radius, features, **noise)
            else:
                res_planes = ops.spatial_pass(res_planes, gates, cen, k, r,
                                              radius, features, **noise)
        return unpack_reservoir_planes(res_planes, k)

    def gather(planes, offs):
        if features.coherent_spatial_offsets:
            return coherent_gather(planes, offs)
        dy, dx = spatial.clamped_offsets(offs, height, width)
        return ops.halo_gather(planes, dy, dx)

    for p in range(features.spatial_resampling_passes):
        offs, gumbel, gumbel2 = _pass_noise(generator, inject, p, features,
                                            height, width)
        planes = pack_pixel_planes(reservoirs, ctx)
        if records is None:
            nbr, nbr_ctx = unpack_pixel_planes(gather(planes, offs), k)
            reservoirs = spatial_pass(ctx, reservoirs, nbr, nbr_ctx, features,
                                      gumbel, geometry, ops.any_hit, gumbel2)
            continue
        c_main = planes.shape[0]
        g = gather(torch.cat([planes, records.reshape(3 * k, height, width)])
                   .detach(), offs)
        nbr, nbr_ctx = unpack_pixel_planes(g[:, :c_main], k)
        # The one differentiable gather: K planes of big_w.
        nbr = replace(nbr, big_w=gather(reservoirs.big_w, offs))
        nbr_rec = g[:, c_main:].reshape(-1, k, 3, height, width)
        reservoirs, records = spatial_pass(
            ctx, reservoirs, nbr, nbr_ctx, features, gumbel, geometry,
            ops.any_hit, gumbel2, (records, nbr_rec), lights,
            ops.gather_rows)
    return reservoirs if records is None else (reservoirs, records)


def final_shade(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                features: Features, ops: FrameOps = KERNELS) -> torch.Tensor:
    """Per lane, shadow ray x Phong x W, averaged over the K lanes →
    [3, H, W] pre-tone-map."""
    return ops.final_shade(ctx, reservoirs, geometry, features)


def _check_slice(features: Features) -> None:
    """Refuse the option whose kernel belongs to a later slice."""
    if (features.spatial_reuse and features.unbiased_combination
            and features.spatial_reuse_visibility_check):
        raise NotImplementedError(
            "Features(spatial_reuse_visibility_check=True) with the unbiased "
            "combine needs the Z-count occlusion kernel (pallas_zcount_occ), "
            "ported in the next slice")


def render_restir_frame(generator, cam: CameraParams, geometry, lights,
                        num_lights: int, height: int, width: int,
                        features: Features, prev: TemporalState,
                        noise=None, ops: FrameOps = KERNELS):
    """One ReSTIR frame → (image [H, W, 3], TemporalState for the next
    frame, detached).

    ``generator`` (a ``torch.Generator`` on the scene's device) takes the
    place of the reference's key. ``noise`` is the test hook that replaces
    every random draw: (RIS uniforms [S/K, 4, K, H, W] (with
    ``surrogate_resampling_grad`` the replay's [S/K, 5, K, H, W]), temporal
    race Gumbel noise [2, K, H, W], and with spatial reuse, per pass
    (offsets [2, R, H, W] ([2, R] with ``coherent_spatial_offsets``),
    Gumbel [R+1, K, H, W][, the surrogate's second Gumbel])); it is None on
    the main path."""
    _check_slice(features)
    k = features.num_samples_in_reservoir
    ris_u, temporal_g, spatial_inject = (None, None, None) if noise is None \
        else (tuple(noise) + (None,))[:3]
    # Replay records ride through the reuse phases on the surrogate
    # gradient path when the reuse runs its differentiable formulation.
    use_records = (features.surrogate_resampling_grad
                   and not features.unbiased_combination
                   and not features.fused_resampling)

    rays = generate_rays(cam, height, width)
    _, ctx = trace_primary(rays, geometry, features, ops)
    rec = None
    if features.surrogate_resampling_grad:
        res, rec = gen_canonical_surrogate(
            ctx, lights, num_lights, geometry, features, generator=generator,
            uniforms=ris_u, replay=ops.ris_replay, gather=ops.gather_rows,
            any_hit=ops.any_hit)
        if not use_records:
            rec = None
    else:
        ris = ops.ris if _fused(features, ctx.position) \
            else gen_canonical_samples_plain
        res = gen_canonical_samples(ctx, lights, num_lights, geometry,
                                    features, generator=generator,
                                    uniforms=ris_u, ris=ris,
                                    any_hit=ops.any_hit)
    if features.temporal_reuse:
        if temporal_g is None:
            temporal_g = gumbel_noise(generator, (2, k, height, width))
        res = temporal_reuse(temporal_g, ctx, res, prev, height, width,
                             features, ops, rec)
        if rec is not None:
            res, rec = res
    if features.spatial_reuse:
        res = spatial_reuse(generator, ctx, res, height, width, features,
                            ops, spatial_inject, rec, lights, geometry)
        if rec is not None:
            res, rec = res
    color = final_shade(ctx, res, geometry, features, ops)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    image = color.permute(1, 2, 0)  # [H, W, 3] for display/output
    # The carry holds no autograd graph: a caller's next frame starts clean.
    return image, TemporalState(reservoirs=detached(res), ctx=detached(ctx),
                                cam=cam, has_prev=True)
