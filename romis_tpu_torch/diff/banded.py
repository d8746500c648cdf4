"""Band-sequential R-MIS / R-OMIS rendering (reference
``romis_tpu/diff/banded.py``): the frame as ``n_bands`` row bands, each
rendered with a halo of ``spatial_resample_radius`` rows under one
``torch.utils.checkpoint``, and each of a band's iterations under a
checkpoint nested in it, as the reference nests its checkpoints: a
gradient step's backward holds one band-iteration's intermediates at a
time. A band's forward runs again in the backward, and an iteration's
twice more (in its band's recompute and in its own).

A neighbourhood reaches at most ±radius rows (the reference parallelises
its MIS loops over rows, render.cpp:76-78, 145-147), so a band's receivers
read only its rows and its halo. Halo rows gather themselves (offset 0):
every gather has the band's [D1, h_loc + 2·radius, W] shape, through the
same ``ops.halo_gather`` (kernel 9, kernel 10 its backward) as the
whole frame. A band draws its canonical reservoirs for its rows and halo
rows from its own generator, seeded from a seed drawn from the caller's
generator before any band runs; that generator gives each iteration the
seed of its own (``render.rmis.canonical_draws``), so every recompute
draws what its forward drew; the image is the same estimator as the
single-pass frame's, sample for sample another. With ``inject`` the bands read the frame's
reservoirs, and the banded frame is the single-pass frame re-read through
band slices. The reference's records arm is dead there (``use_rec =
False``) and is not ported: a band gathers the stored planes.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..core.camera import CameraParams
from ..core.features import Features, MISWeight, RayTraceMode
from ..core.types import Reservoirs, ShadeCtx
from ..ops.mis import resolve_neighbour_ctx
from ..ops.shade import pack_center_ctx
from ..ops.shading import exposure_tone_mapping
from ..render.restir import KERNELS, FrameOps
from ..render.rmis import (
    canonical_draws, check_mis, checkpointed, differentiable_iteration,
    draw_seeds, neighbourhood,
)
from ..render.romis import romis_estimate
from .grad import SceneParams, _value_and_grad, apply_params

def band_layout(height: int, n_bands: int, radius: int) -> int:
    """The band height, refusing a split the bands cannot take."""
    if n_bands < 1 or height % n_bands:
        raise ValueError(f"render_mis_banded: the image's {height} rows must "
                         f"divide into n_bands = {n_bands} equal bands")
    h_loc = height // n_bands
    if h_loc < radius:
        raise ValueError(f"render_mis_banded: the band height {h_loc} must "
                         f"cover the halo radius {radius}")
    return h_loc


def pad_rows(a: torch.Tensor, radius: int) -> torch.Tensor:
    """[..., H, W] → [..., H + 2·radius, W], zero rows above and below."""
    z = a.new_zeros(a.shape[:-2] + (radius, a.shape[-1]))
    return torch.cat([z, a, z], dim=-2)


def render_mis_banded(generator, cam: CameraParams, geometry, lights,
                      num_lights: int, height: int, width: int,
                      features: Features, n_bands: int, inject=None,
                      noise=None, ops: FrameOps = KERNELS) -> torch.Tensor:
    """R-MIS or R-OMIS (by ``features.ray_trace_mode``: R-MIS, else R-OMIS)
    as ``n_bands`` row bands in turn → tone-mapped image [H, W, 3].
    Always the differentiable formulation: this function exists for its
    backward; a forward render takes ``render.rmis.render_rmis`` or
    ``render.romis.render_romis``. ``inject`` as in ``render_rmis``;
    ``noise`` replaces the neighbour selection's draws
    (``render.neighbours``), and the bands' RIS draws come from
    ``generator``."""
    radius = features.spatial_resample_radius
    h_loc = band_layout(height, n_bands, radius)
    features = features.replace(fused_resampling=False)
    check_mis(features, geometry, ops)
    is_rmis = features.ray_trace_mode == RayTraceMode.RMIS
    balance = features.mis_weight_rmis == MISWeight.BALANCE
    mode = ("rmis_balance" if balance else "rmis_equal") if is_rmis \
        else "romis"
    d = features.num_neighbours_to_sample
    ctx, _, offs = neighbourhood(generator, cam, geometry, height, width,
                                 features, ops, inject, noise)
    dev = offs.device
    seeds = draw_seeds(generator, n_bands) if inject is None else None
    ctx_p = {f.name: pad_rows(getattr(ctx, f.name), radius)
             for f in fields(ctx)}
    res_p = None if inject is None else [
        {f.name: pad_rows(getattr(r, f.name), radius) for f in fields(r)}
        for r in inject[2]]
    zpad = torch.zeros((2 * d, radius, width), dtype=offs.dtype, device=dev)

    def center(a):
        return a[..., radius:radius + h_loc, :]

    def band(b):
        """Band ``b``'s linear colour [3, h_loc, W]."""
        def rows(a):
            return a[..., b * h_loc:b * h_loc + h_loc + 2 * radius, :]

        ctx_b = ShadeCtx(**{f: rows(a) for f, a in ctx_p.items()})
        offs_b = torch.cat([zpad, offs[:, b * h_loc:(b + 1) * h_loc], zpad],
                           dim=1)
        nbr_ctx = None if mode == "rmis_equal" else resolve_neighbour_ctx(
            pack_center_ctx(ctx_b), offs_b, ops.halo_gather)
        if res_p is not None:
            def draw(it):
                return Reservoirs(**{f: rows(a) for f, a in
                                     res_p[it].items()}), None
        else:
            draw = canonical_draws(
                torch.Generator(device=dev).manual_seed(seeds[b]), ctx_b,
                lights, num_lights, geometry, features, ops, records=False)
        step = differentiable_iteration(ctx_b, offs_b, lights, num_lights,
                                        geometry, features, mode, ops, draw,
                                        nbr_ctx, center)
        if is_rmis:
            acc = torch.zeros((3, h_loc, width), device=dev)
            for it in range(features.max_iterations_mis):
                acc = acc + step(it)
            return acc / features.max_iterations_mis
        return romis_estimate(step, d + 1, features.num_samples_in_reservoir,
                              h_loc, width, features, dev)[0]

    color = torch.cat([checkpointed(band, b) for b in range(n_bands)], dim=1)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    return color.permute(1, 2, 0)


def mis_banded_l2_loss(params: SceneParams, target, generator, cam,
                       geometry, lights, num_lights: int, height: int,
                       width: int, features: Features, n_bands: int,
                       inject=None, noise=None,
                       ops: FrameOps = KERNELS) -> torch.Tensor:
    """Mean-squared error of a band-sequential R-MIS / R-OMIS render
    against a target image [H, W, 3], with ``params`` substituted into the
    scene: ``diff.grad.mis_l2_image_loss``'s contract, one band's backward
    held at a time."""
    geometry, lights = apply_params(geometry, lights, params)
    img = render_mis_banded(generator, cam, geometry, lights, num_lights,
                            height, width, features, n_bands, inject, noise,
                            ops)
    return torch.mean((img - target) ** 2)


def make_mis_banded_grad_fn(geometry, lights, num_lights: int, height: int,
                            width: int, features: Features, n_bands: int,
                            ops: FrameOps = KERNELS):
    """``diff.grad.make_mis_grad_fn`` on ``mis_banded_l2_loss``:
    ``fn(params, target, generator, cam, inject=None, noise=None)`` →
    (loss, SceneParams of gradients)."""

    def value_and_grad(params: SceneParams, target, generator, cam,
                       inject=None, noise=None):
        return _value_and_grad(
            lambda p: mis_banded_l2_loss(p, target, generator, cam, geometry,
                                         lights, num_lights, height, width,
                                         features, n_bands, inject, noise,
                                         ops), params)

    return value_and_grad
