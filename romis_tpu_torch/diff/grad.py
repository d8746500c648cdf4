"""Differentiable rendering: gradients of the rendered image with respect to
the scene's parameters (reference ``romis_tpu/diff/grad.py``, the ReSTIR
half; R-MIS and R-OMIS come with the MIS slice).

The parameters are light emission (the four corner colours of every light),
light placement (v0 / edge01 / edge02), the material tables (kd, ks,
shininess) and the triangles' vertices (v0 / e1 / e2). Discrete choices
(light pick, reservoir winners, closest-hit triangle, visibility) carry no
gradient; the evaluation of what they chose is differentiated.

On CUDA tensors every kernel of the frame runs forward, and the backward
goes through the kernels' re-evaluation and scatter backwards: the closest
hit (re-evaluated from its selected triangle), the row gathers (kernel 13,
the scatter-add), the halo gathers of per-pixel offsets (kernel 10), and
the final shade (its shadow rays traced again by kernel 6). The resampling
phases run their differentiable formulation (``fused_resampling=False``):
with ``surrogate_resampling_grad`` the detached replay RIS (kernel 14) and
the winner-replay combines.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from romis_tpu.core.features import Features

from ..core.camera import CameraParams
from ..render.restir import (
    KERNELS, FrameOps, TemporalState, render_restir_frame,
)
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
                       noise=None, ops: FrameOps = KERNELS):
    """Forward render with ``params`` substituted into the scene → (image,
    detached TemporalState). As in the reference, the resampling phases run
    their differentiable formulation (``fused_resampling=False``) and the
    spatial offsets go coherent unless ``features.exact_gradients``. Tone
    mapping is typically disabled for optimisation (linear losses).
    ``noise`` is ``render_restir_frame``'s test hook."""
    geometry, lights = apply_params(geometry, lights, params)
    features = features.replace(fused_resampling=False)
    if not features.exact_gradients:
        features = features.replace(coherent_spatial_offsets=True)
    return render_restir_frame(generator, cam, geometry, lights, num_lights,
                               height, width, features, prev, noise=noise,
                               ops=ops)


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
    image)."""

    def value_and_grad(params: SceneParams, target, generator, cam,
                       prev: TemporalState, noise=None):
        leaves = [p.detach().requires_grad_() for p in params.leaves()]
        loss = l2_image_loss(SceneParams(*leaves), target, generator, cam,
                             geometry, lights, num_lights, height, width,
                             features, prev, noise, ops)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), SceneParams(*(
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)))

    return value_and_grad
