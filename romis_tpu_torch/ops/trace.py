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

Kernel 7 (``csrc/zcount.cu``, ``zcount_occ``) replaces the Pallas
``_zcount_kernel``: the Z-count occlusion of the unbiased pass's visibility
check, the rays from R+1 origins to K targets per pixel with the
reference's division-free Möller–Trumbore, whose origin terms are shared by
the K rays of an origin. Its plain version is ``zcount_occ_plain``, the same
operations in the same order as a block scan; on geometry with a BVH the Z
rays go through ``ops.wrs.visibility_from`` and the walk kernels instead
(the reference's rule). Bound: operations, (R+1)·K ray-triangle tests per
pixel up to each ray's first hit.

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
from .intersect import (
    _pick_block, intersect_any, intersect_closest, reeval_tuv,
)

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


def _zcount_rays(origins, targets, mask):
    """Per (origin, target): the unit direction's planes and the window's
    end → (dx, dy, dz, dist), each [R+1, K, H, W]; a masked-off ray's dist
    is 0 (the reference kernel's set-up, ``pallas_trace.py:641-657``)."""
    o = origins[:, None]
    tg = targets[None]
    tox, toy, toz = (tg[:, :, c] - o[:, :, c] for c in range(3))
    sq = tox * tox + toy * toy + toz * toz
    ok = sq > 1e-30
    dist = torch.where(ok, torch.sqrt(torch.where(ok, sq, 1.0)), 0.0)
    dinv = 1.0 / torch.clamp_min(dist, 1e-20)
    if mask is not None:
        dist = torch.where(mask, dist, 0.0)
    return tox * dinv, toy * dinv, toz * dinv, dist


def zcount_occ_plain(origins, targets, geometry, eps: float = 1e-3,
                     mask=None, counts=None) -> torch.Tensor:
    """The plain version of kernel 7: every ray against blocks of the soup,
    the kernel's arithmetic operation for operation. With a ``counts``
    dict it also records the triangle tests kernel 7 makes (each traced
    ray tests the active triangles in order up to its first hit):
    ``counts["tests"]`` [R+1, K, H, W] int64."""
    dx, dy, dz, dist = (a[:, :, None] for a in _zcount_rays(origins,
                                                            targets, mask))
    ox, oy, oz = (origins[:, None, c, None] for c in range(3))
    cols = geometry.tri_cols
    n = cols.shape[1]
    occluded = torch.zeros(dist.shape[:2] + dist.shape[-2:],
                           dtype=torch.bool, device=origins.device)
    block = _pick_block(dist.numel(), n)
    first = torch.zeros(occluded.shape, dtype=torch.int64,
                        device=origins.device)
    for base in range(0, n, block):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, act = \
            cols[:, base:base + block, None, None]
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        e2q = e2x * qx + e2y * qy + e2z * qz
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ua = (tx * px + ty * py + tz * pz) * det
        va = (dx * qx + dy * qy + dz * qz) * det
        ta = e2q * det
        aa = det * det
        hit = ((aa > 1e-18) & (ua >= 0.0) & (va >= 0.0) & (ua + va <= aa)
               & (ta > eps * aa) & (ta < dist * aa) & (act > 0.0))
        if counts is not None:
            first = torch.where(~occluded & hit.any(dim=2),
                                base + hit.int().argmax(dim=2), first)
        occluded = occluded | hit.any(dim=2)
    if counts is not None:
        traced = dist[:, :, 0] > eps
        n_active = int((cols[9] > 0.0).sum())
        counts["tests"] = torch.where(
            traced, torch.where(occluded, first + 1, n_active), 0)
    return occluded


def zcount_occ(origins, targets, geometry, eps: float = 1e-3,
               mask=None) -> torch.Tensor:
    """The Z-count occlusion of the unbiased pass (the reference's
    ``pallas_zcount_occ``): origins [R+1, 3, H, W] (the receiver, then the
    R neighbours), targets [K, 3, H, W] (the winners), an optional bool
    mask [R+1, K, H, W] → bool [R+1, K, H, W], True where a triangle lies at
    t in (eps, dist) from the unshifted origin toward the target
    (``ops.wrs.visibility_from``'s occlusion; dist <= eps and masked-off
    rays are never occluded). Kernel 7 for CUDA tensors on a soup, the
    plain version for CPU tensors."""
    if not origins.is_cuda:
        return zcount_occ_plain(origins, targets, geometry, eps, mask)
    if geometry.bvh is not None:
        raise ValueError("zcount_occ: kernel 7 traces a soup; geometry with "
                         "a BVH takes the Z rays through visibility_from")
    r1, k = origins.shape[0], targets.shape[0]
    h, w = origins.shape[-2:]
    o = origins.contiguous()
    tg = targets.contiguous()
    _build.check(o, "origins", torch.float32, (r1, 3, h, w))
    _build.check(tg, "targets", torch.float32, (k, 3, h, w))
    if not 1 <= k <= 4 or not 1 <= r1 <= 9:
        raise ValueError(f"zcount_occ: K={k}, R+1={r1} outside 1..4, 1..9")
    m_ptr = None
    if mask is not None:
        m = mask.contiguous()
        _build.check(m, "mask", torch.bool, (r1, k, h, w))
        m_ptr = m.data_ptr()
    cols = geometry.tri_cols
    _build.check(cols, "tri_cols", torch.float32)
    check_soup(geometry, "zcount_occ")
    out = torch.empty((r1, k, h, w), dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_zcount_occ", o.data_ptr(), tg.data_ptr(), m_ptr,
                      h * w, r1, k, cols.data_ptr(), cols.shape[1],
                      float(eps), out.data_ptr())
        zcount_occ.launches += 1
    return out


zcount_occ.launches = 0
