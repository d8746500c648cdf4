"""Differentiable rendering: gradients of the rendered image with respect to
the scene's parameters (reference ``romis_tpu/diff/grad.py``): the ReSTIR
step (``make_grad_fn``) and the R-MIS / R-OMIS step
(``make_mis_grad_fn``; its band-sequential form is ``diff.banded``).

The parameters are light emission (the four corner colours of every light),
light placement (v0 / edge01 / edge02), the material tables (kd, ks,
shininess) and the triangles' vertices (v0 / e1 / e2). Discrete choices
(light pick, reservoir winners, closest-hit triangle, visibility) carry no
gradient; the evaluation of what they chose is differentiated.

On CUDA tensors every kernel of the frame runs forward, and the backward
goes through the kernels' re-evaluation and scatter backwards: the closest
hit (re-evaluated from its selected triangle), the row gathers (kernel 13,
the scatter-add), the halo gathers of per-pixel offsets (kernel 10), and
the final shade (its shadow rays traced again by kernel 6, or on geometry
with a BVH by the walk kernels through ``ops.trace.any_hit``). The resampling
phases run their differentiable formulation (``fused_resampling=False``):
with ``surrogate_resampling_grad`` the detached replay RIS (kernel 14) and
the winner-replay combines.

The MIS step (``render_mis_with_params``) runs the same way: the
differentiable formulation of ``render.rmis`` (``fused_resampling=False``)
in place of the MIS RIS and sweep kernels (15, 17), which have no
backward; with ``surrogate_resampling_grad`` the replay RIS (kernel 14)
and the replay-records gather, the light rows through kernels 2 and 13;
the neighbourhood's stats and contexts through the halo gather and its
scatter (kernels 9, 10); the shadow rays through kernel 6 (the BVH walks
on geometry with a BVH), their visibility detached. The neighbour
selection (kernel 16) is discrete and detached. Each iteration runs under
a checkpoint, so its kernels launch again in the backward.

Both renders take a row band (``band``); the sharded training steps of
``parallel.shard`` and ``parallel.mis`` differentiate them on each rank.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from ..core.features import Features, RayTraceMode

from ..core.camera import CameraParams
from ..render.restir import (
    KERNELS, FrameOps, TemporalState, render_restir_frame,
)
from ..render.rmis import render_rmis
from ..render.romis import render_romis
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod


@dataclass
class SceneParams:
    """The differentiable subset of the scene."""

    light_c0: torch.Tensor  # [L, 3]
    light_c1: torch.Tensor
    light_c2: torch.Tensor
    light_c3: torch.Tensor
    light_v0: torch.Tensor  # [L, 3]
    light_e01: torch.Tensor
    light_e02: torch.Tensor
    mat_kd: torch.Tensor  # [M, 3]
    mat_ks: torch.Tensor  # [M, 3]
    mat_shininess: torch.Tensor  # [M]
    tri_v0: torch.Tensor  # [T, 3]
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor

    def leaves(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]


def extract_params(geometry, lights) -> SceneParams:
    return SceneParams(
        light_c0=lights.c0, light_c1=lights.c1, light_c2=lights.c2,
        light_c3=lights.c3, light_v0=lights.v0, light_e01=lights.edge01,
        light_e02=lights.edge02,
        mat_kd=geometry.mat_kd, mat_ks=geometry.mat_ks,
        mat_shininess=geometry.mat_shininess,
        tri_v0=geometry.v0, tri_e1=geometry.e1, tri_e2=geometry.e2,
    )


def apply_params(geometry, lights, params: SceneParams):
    """The scene with ``params`` substituted and its packed tables rebuilt
    from them (differentiably: the kernels read the tables, the gradients
    reach the parameters)."""
    geometry = scene_mod.repack_rows(replace(
        geometry, mat_kd=params.mat_kd, mat_ks=params.mat_ks,
        mat_shininess=params.mat_shininess, v0=params.tri_v0,
        e1=params.tri_e1, e2=params.tri_e2))
    lights = lights_mod.repack_rows(replace(
        lights, c0=params.light_c0, c1=params.light_c1, c2=params.light_c2,
        c3=params.light_c3, v0=params.light_v0, edge01=params.light_e01,
        edge02=params.light_e02))
    return geometry, lights


def render_with_params(params: SceneParams, generator, cam: CameraParams,
                       geometry, lights, num_lights: int, height: int,
                       width: int, features: Features, prev: TemporalState,
                       noise=None, ops: FrameOps = KERNELS, band=None):
    """Forward render with ``params`` substituted into the scene → (image,
    detached TemporalState). As in the reference, the resampling phases run
    their differentiable formulation (``fused_resampling=False``) and the
    spatial offsets go coherent unless ``features.exact_gradients``. Tone
    mapping is typically disabled for optimisation (linear losses).
    ``noise`` is ``render_restir_frame``'s test hook; with ``band``
    (``parallel.mesh.Bands``) the band's image rows and state, as there."""
    geometry, lights = apply_params(geometry, lights, params)
    features = features.replace(fused_resampling=False)
    if not features.exact_gradients:
        features = features.replace(coherent_spatial_offsets=True)
    return render_restir_frame(generator, cam, geometry, lights, num_lights,
                               height, width, features, prev, noise=noise,
                               ops=ops, band=band)


def l2_image_loss(params: SceneParams, target, generator, cam, geometry,
                  lights, num_lights: int, height: int, width: int,
                  features: Features, prev: TemporalState, noise=None,
                  ops: FrameOps = KERNELS) -> torch.Tensor:
    """Mean-squared error against a target image [H, W, 3]."""
    img, _ = render_with_params(params, generator, cam, geometry, lights,
                                num_lights, height, width, features, prev,
                                noise, ops)
    return torch.mean((img - target) ** 2)


def make_grad_fn(geometry, lights, num_lights: int, height: int, width: int,
                 features: Features, ops: FrameOps = KERNELS):
    """The value and gradient of the L2 loss with respect to SceneParams:
    ``fn(params, target, generator, cam, prev, noise=None)`` → (loss,
    SceneParams of gradients, zeros where a parameter does not reach the
    image).

    Geometry with a BVH (``ops.bvh.with_bvh``) is taken as the reference
    takes it: the tree stays as it was built. The forward traces through
    it (on CUDA the walk kernels 18, 20 and 21); the backward re-evaluates
    the triangles the forward selected, and the shade's backward traces its
    shadow rays through the same tree. ``apply_params`` rebuilds the packed
    tables from the parameters but not the boxes, so parameters far from
    the ones the tree was built for miss hits the boxes no longer cover; a
    caller who moves vertices far rebuilds the tree with
    ``ops.bvh.with_bvh``."""

    def value_and_grad(params: SceneParams, target, generator, cam,
                       prev: TemporalState, noise=None):
        return _value_and_grad(
            lambda p: l2_image_loss(p, target, generator, cam, geometry,
                                    lights, num_lights, height, width,
                                    features, prev, noise, ops), params)

    return value_and_grad


def _value_and_grad(loss_fn, params: SceneParams, has_aux: bool = False):
    """(loss, SceneParams of gradients) of ``loss_fn`` at ``params``, with
    zeros where a parameter does not reach the loss; with ``has_aux``
    ``loss_fn`` gives (loss, aux) and the result is (loss, aux, grads)."""
    leaves = [p.detach().requires_grad_() for p in params.leaves()]
    out = loss_fn(SceneParams(*leaves))
    loss = out[0] if has_aux else out
    grads = SceneParams(*(
        torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))))
    if has_aux:
        return loss.detach(), out[1], grads
    return loss.detach(), grads


def render_mis_with_params(params: SceneParams, generator,
                           cam: CameraParams, geometry, lights,
                           num_lights: int, height: int, width: int,
                           features: Features, inject=None, noise=None,
                           ops: FrameOps = KERNELS, band=None) -> torch.Tensor:
    """Forward R-MIS or R-OMIS render (by ``features.ray_trace_mode``: R-MIS,
    else R-OMIS) with ``params`` substituted into the scene, on the
    differentiable formulation (``fused_resampling=False``) → image
    [H, W, 3]. ``inject`` and ``noise`` are ``render.rmis.render_rmis``'
    test hooks; with ``band`` (``parallel.mesh.Bands``) the band's image
    rows, as there."""
    geometry, lights = apply_params(geometry, lights, params)
    features = features.replace(fused_resampling=False)
    render = render_rmis if features.ray_trace_mode == RayTraceMode.RMIS \
        else render_romis
    return render(generator, cam, geometry, lights, num_lights, height,
                  width, features, inject=inject, noise=noise, ops=ops,
                  band=band)


def mis_l2_image_loss(params: SceneParams, target, generator, cam, geometry,
                      lights, num_lights: int, height: int, width: int,
                      features: Features, inject=None, noise=None,
                      ops: FrameOps = KERNELS) -> torch.Tensor:
    """Mean-squared error of an R-MIS / R-OMIS render against a target
    image [H, W, 3]."""
    img = render_mis_with_params(params, generator, cam, geometry, lights,
                                 num_lights, height, width, features, inject,
                                 noise, ops)
    return torch.mean((img - target) ** 2)


def make_mis_grad_fn(geometry, lights, num_lights: int, height: int,
                     width: int, features: Features,
                     ops: FrameOps = KERNELS):
    """The value and gradient of the MIS L2 loss with respect to
    SceneParams: ``fn(params, target, generator, cam, inject=None,
    noise=None)`` → (loss, SceneParams of gradients, zeros where a
    parameter does not reach the image). There is no temporal state.
    Geometry with a BVH is taken as ``make_grad_fn`` takes it."""

    def value_and_grad(params: SceneParams, target, generator, cam,
                       inject=None, noise=None):
        return _value_and_grad(
            lambda p: mis_l2_image_loss(p, target, generator, cam, geometry,
                                        lights, num_lights, height, width,
                                        features, inject, noise, ops),
            params)

    return value_and_grad
