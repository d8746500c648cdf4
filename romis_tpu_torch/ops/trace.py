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

Geometry with a BVH (``ops.bvh.with_bvh``) goes to the BVH walk kernels
instead (``ops/walk.py``): the closest hit to kernel 18, the any-hit to
kernel 20 when 2 to 16 rays per pixel share one walk, else to kernel 19 (the
reference's rule, ``ops/intersect.py:154-162``). The soup kernels hold at
most ``MAX_SOUP_TRIS`` triangles; a larger soup without a BVH raises,
naming ``with_bvh``.
"""

from __future__ import annotations

import math

import torch

from ..core.types import Rays
from . import _build, walk
from .intersect import intersect_any, intersect_closest, reeval_tuv

# The soup the reference kernel holds on chip (pallas_trace.MAX_SMEM_TRIS);
# larger scenes go through a BVH.
MAX_SOUP_TRIS = 2048


def check_soup(geometry, name: str) -> None:
    """Raise where the soup kernels cannot take ``geometry``."""
    n_tris = geometry.tri_cols.shape[1]
    if n_tris > MAX_SOUP_TRIS:
        raise ValueError(f"{name}: {n_tris} triangles exceed the soup "
                         f"kernel's {MAX_SOUP_TRIS}; attach a BVH with "
                         "ops.bvh.with_bvh")


def closest_hit_plain(rays: Rays, geometry, t_max: float = math.inf):
    """The plain version: the block scan of ``ops/intersect.py`` (the plain
    BVH traversal for BVH geometry)."""
    tm = None
    if not math.isinf(t_max):
        tm = torch.full(rays.hw, t_max, device=rays.origin.device)
    return intersect_closest(rays, geometry, tm)


def _closest_hit_forward(rays: Rays, geometry, t_max: float):
    if not rays.origin.is_cuda:
        return closest_hit_plain(rays, geometry, t_max)
    if geometry.bvh is not None:
        return walk.closest_hit_bvh(rays, geometry, t_max)
    h, w = rays.hw
    _build.check(rays.origin, "rays.origin", torch.float32, (3, h, w))
    _build.check(rays.direction, "rays.direction", torch.float32, (3, h, w))
    cols = geometry.tri_cols
    _build.check(cols, "tri_cols", torch.float32)
    check_soup(geometry, "closest_hit")
    n_tris = cols.shape[1]
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
    differentiable in the rays and in ``geometry.v0/e1/e2`` (the backward
    re-evaluates the selected triangles, so a BVH does not enter it)."""
    inputs = (rays.origin, rays.direction, geometry.v0, geometry.e1,
              geometry.e2)
    if torch.is_grad_enabled() and any(a.requires_grad for a in inputs):
        return _ClosestHit.apply(*inputs, geometry, t_max)
    return _closest_hit_forward(rays, geometry, t_max)


closest_hit.launches = 0


def any_hit_plain(origins, dirs, t_max, geometry) -> torch.Tensor:
    """The plain version: the block scan ``ops.intersect.intersect_any``
    (the plain BVH traversal for BVH geometry)."""
    return intersect_any(origins, dirs, t_max, geometry)


def any_hit(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion: True where a triangle lies at t in (0, t_max).
    origins [..., 3, H, W], dirs broadcastable to them, t_max [..., H, W]
    → bool [..., H, W]; the leading axes are kept."""
    if not origins.is_cuda:
        return any_hit_plain(origins, dirs, t_max, geometry)
    if geometry.bvh is not None:
        rays_per_pixel = math.prod(origins.shape[:-3])
        if 2 <= rays_per_pixel <= walk.K_MAX:
            return walk.any_hit_bvh_k(origins, dirs, t_max, geometry)
        return walk.any_hit_bvh(origins, dirs, t_max, geometry)
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
    check_soup(geometry, "any_hit")
    n_tris = cols.shape[1]
    out = torch.empty(lead + (h, w), dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_any_hit", o.data_ptr(), d.data_ptr(),
                      tm.data_ptr(), h * w, out.numel(), cols.data_ptr(),
                      n_tris, out.data_ptr())
        any_hit.launches += 1
    return out


any_hit.launches = 0
