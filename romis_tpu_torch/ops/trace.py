"""Closest hit and any-hit against the triangle soup (reference
``romis_tpu/ops/pallas_trace.py``, ``pallas_closest`` and ``pallas_any``).

Kernel 1 (``csrc/trace.cu``) replaces the Pallas ``_closest_kernel``:
Möller–Trumbore over the whole triangle soup, one thread per ray, triangles
staged through shared memory. Same contract as the plain block scan
``ops.intersect.intersect_closest``: t in (0, t_max), ties to the lowest
triangle index, (t = inf, tri = -1, u = v = 0) on a miss. ``closest_hit``
is differentiable in the rays and the vertex columns, with the reference's
re-evaluation backward (``ops/intersect.closest_hit_diff``): the selected
triangles are fixed and (t, u, v) re-derived from one Möller–Trumbore
evaluation each (``ops.intersect.reeval_tuv``, whose row gather and its
scatter backward are kernels 2 and 13 on CUDA).

Kernel 6 (``csrc/any.cu``) replaces the Pallas ``_any_kernel``: boolean
occlusion at t in (0, t_max) with an early exit per ray, leading sample
axes kept, the same contract as ``ops.intersect.intersect_any``.

Bound on the H100: compute, ~30 flops per ray-triangle test; the triangle
columns are a shared-memory broadcast, so device memory sees only rays in
and hits out (~40 B per pixel for the closest hit, 29 B per ray for the
any-hit).
"""

from __future__ import annotations

import math

import torch

from ..core.types import Rays
from . import _build
from .intersect import intersect_any, intersect_closest, reeval_tuv

# The soup the reference kernel holds on chip (pallas_trace.MAX_SMEM_TRIS);
# larger scenes go through the paged BVH, which is not ported yet.
MAX_SOUP_TRIS = 2048


def closest_hit_plain(rays: Rays, geometry, t_max: float = math.inf):
    """The plain version: the block scan of ``ops/intersect.py``."""
    tm = None
    if not math.isinf(t_max):
        tm = torch.full(rays.hw, t_max, device=rays.origin.device)
    return intersect_closest(rays, geometry, tm)


def _closest_hit_forward(rays: Rays, geometry, t_max: float):
    if not rays.origin.is_cuda:
        return closest_hit_plain(rays, geometry, t_max)
    h, w = rays.hw
    _build.check(rays.origin, "rays.origin", torch.float32, (3, h, w))
    _build.check(rays.direction, "rays.direction", torch.float32, (3, h, w))
    cols = geometry.tri_cols
    _build.check(cols, "tri_cols", torch.float32)
    n_tris = cols.shape[1]
    if n_tris > MAX_SOUP_TRIS:
        raise ValueError(f"closest_hit: {n_tris} triangles exceed the soup "
                         f"kernel's {MAX_SOUP_TRIS}")
    dev = rays.origin.device
    t = torch.empty((h, w), dtype=torch.float32, device=dev)
    tri = torch.empty((h, w), dtype=torch.int32, device=dev)
    u = torch.empty((h, w), dtype=torch.float32, device=dev)
    v = torch.empty((h, w), dtype=torch.float32, device=dev)
    if h * w == 0:
        return t, tri, u, v
    _build.launch("romis_closest_hit", rays.origin.data_ptr(),
                  rays.direction.data_ptr(), h * w, cols.data_ptr(), n_tris,
                  float(t_max), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                  v.data_ptr())
    closest_hit.launches += 1
    return t, tri, u, v


class _ClosestHit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, origin, direction, v0, e1, e2, geometry, t_max):
        t, tri, u, v = _closest_hit_forward(Rays(origin, direction),
                                            geometry, t_max)
        ctx.save_for_backward(origin, direction, v0, e1, e2, tri)
        ctx.mark_non_differentiable(tri)
        return t, tri, u, v

    @staticmethod
    def backward(ctx, ct_t, _ct_tri, ct_u, ct_v):
        *inputs, tri = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        inputs = [a.detach().requires_grad_(n) for a, n in zip(inputs, needs)]
        # A miss's t is inf; its cotangent is zeroed, never propagated.
        ct_t = torch.where(torch.isfinite(ct_t), ct_t, 0.0)
        with torch.enable_grad():
            t, u, v = reeval_tuv(Rays(inputs[0], inputs[1]), *inputs[2:],
                                 tri)
            grads = iter(torch.autograd.grad(
                (t, u, v), [a for a, n in zip(inputs, needs) if n],
                (ct_t, ct_u, ct_v), allow_unused=True))
        return tuple(next(grads) if n else None for n in needs) + (None, None)


def closest_hit(rays: Rays, geometry, t_max: float = math.inf):
    """Closest hit of rays [3, H, W] → (t, tri int32, u, v), each [H, W];
    differentiable in the rays and in ``geometry.v0/e1/e2``."""
    inputs = (rays.origin, rays.direction, geometry.v0, geometry.e1,
              geometry.e2)
    if torch.is_grad_enabled() and any(a.requires_grad for a in inputs):
        return _ClosestHit.apply(*inputs, geometry, t_max)
    return _closest_hit_forward(rays, geometry, t_max)


closest_hit.launches = 0


def any_hit_plain(origins, dirs, t_max, geometry) -> torch.Tensor:
    """The plain version: the block scan ``ops.intersect.intersect_any``."""
    return intersect_any(origins, dirs, t_max, geometry)


def any_hit(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion: True where a triangle lies at t in (0, t_max).
    origins [..., 3, H, W], dirs broadcastable to them, t_max [..., H, W]
    → bool [..., H, W]; the leading axes are kept."""
    if not origins.is_cuda:
        return any_hit_plain(origins, dirs, t_max, geometry)
    lead = tuple(origins.shape[:-3])
    h, w = origins.shape[-2:]
    if origins.shape[-3] != 3 or tuple(t_max.shape) != lead + (h, w):
        raise ValueError(f"any_hit: origins {tuple(origins.shape)} and t_max "
                         f"{tuple(t_max.shape)} do not match")
    o = origins.contiguous()
    d = dirs.expand(origins.shape).contiguous()
    tm = t_max.contiguous()
    _build.check(o, "origins", torch.float32)
    _build.check(d, "dirs", torch.float32)
    _build.check(tm, "t_max", torch.float32)
    cols = geometry.tri_cols
    _build.check(cols, "tri_cols", torch.float32)
    n_tris = cols.shape[1]
    if n_tris > MAX_SOUP_TRIS:
        raise ValueError(f"any_hit: {n_tris} triangles exceed the soup "
                         f"kernel's {MAX_SOUP_TRIS}")
    out = torch.empty(lead + (h, w), dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_any_hit", o.data_ptr(), d.data_ptr(),
                      tm.data_ptr(), h * w, out.numel(), cols.data_ptr(),
                      n_tris, out.data_ptr())
        any_hit.launches += 1
    return out


any_hit.launches = 0
