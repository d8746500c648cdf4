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

Kernel 8 (``csrc/plucker.cu``, ``any_hit_plucker``) replaces the Pallas
``_any_mxu_kernel``: ``any_hit``'s occlusion by another algebra, the
Plücker sign test of each segment against five rows of side constants per
triangle (``plucker_matrix``). The reference keeps it as a measured
negative result that no frame calls, and so does the port: its entry is
the op alone. Each row of the table has at most six non-zero columns
(``PLUCKER_COLS``); the kernel and its plain version ``any_hit_plucker_plain``
sum only those, in the same order, so the two give the same bool. Leaving
out a term that is exactly zero changes no finite side but the sign of a
zero, which no test reads, so the bools are those of the full 10-term
products. Against Möller–Trumbore they differ only on rays at a sign
boundary. Bound: operations, the non-zero terms of the five products per
ray-triangle test up to the first hit.

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


def _cross_rows(p, q):
    """p × q of [..., 3] rows, each product rounded before the difference."""
    return torch.stack([p[..., 1] * q[..., 2] - p[..., 2] * q[..., 1],
                        p[..., 2] * q[..., 0] - p[..., 0] * q[..., 2],
                        p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]], dim=-1)


def plucker_matrix(geometry) -> torch.Tensor:
    """[5T, 16] side constants of kernel 8 (the reference's
    ``pallas_trace.plucker_matrix``, built here with torch on the geometry's
    device): for the segment p0 → p0 + D, R = [D, M = p0 × D, p0, 1, 0...],
    rows [0, 3T) give the three Plücker edge sides [m_e, d_e]·R, rows
    [3T, 4T) the plane value s0 = n·p0 − n·a, rows [4T, 5T) ds = n·D.
    Inactive triangles get all-zero rows, which never occlude. The three
    edges are built as one batch, to keep the launches of a call few."""
    v0, e1, e2 = geometry.v0, geometry.e1, geometry.e2
    t = v0.shape[0]
    a, b, c = v0, v0 + e1, v0 + e2
    p, q = torch.stack([a, b, c]), torch.stack([b, c, a])  # [3, T, 3]
    n = _cross_rows(e1, e2)
    na = n * a
    zeros = v0.new_zeros((t, 16))
    rows = torch.cat([
        torch.cat([_cross_rows(p, q), q - p,
                   zeros[None, :, :10].expand(3, t, 10)], dim=2).reshape(3 * t, 16),
        torch.cat([zeros[:, :6], n, -((na[:, 0:1] + na[:, 1:2]) + na[:, 2:3]),
                   zeros[:, :6]], dim=1),
        torch.cat([n, zeros[:, :13]], dim=1)])
    return rows * geometry.active.to(v0.dtype).repeat(5)[:, None]


# R's components in the order of C's columns: D, M, p0, 1.
_R_TERMS = 10
# The columns [lo, hi) that can be non-zero in each of a triangle's five
# rows of ``plucker_matrix``: the edge rows [m_e, d_e] pair with D and M,
# the plane row [n, −n·a] with p0 and 1, the n·D row with D.
PLUCKER_COLS = ((0, 6), (0, 6), (0, 6), (6, 10), (0, 3))


def _plucker_rays(origins, dirs, t_max):
    """The [10, ...] ray vectors R = [D, M, p0, 1] with D = t_max·d and
    M = p0 × D, each component as the kernel computes it."""
    d = dirs.expand(origins.shape)
    ox, oy, oz = (origins[..., c, :, :] for c in range(3))
    bx, by, bz = (t_max * d[..., c, :, :] for c in range(3))
    return torch.stack([bx, by, bz, oy * bz - oz * by, oz * bx - ox * bz,
                        ox * by - oy * bx, ox, oy, oz,
                        torch.ones_like(ox)])


def any_hit_plucker_plain(origins, dirs, t_max, geometry,
                          counts=None) -> torch.Tensor:
    """The plain version of kernel 8: the five products of every ray with
    every triangle's rows of ``plucker_matrix``, each over the row's
    ``PLUCKER_COLS`` summed left to right as the kernel sums them (no
    matmul: its order of summation is not fixed), then the sign test, a
    block of triangles at a time. With a ``counts`` dict it also records
    the triangles kernel 8 tests (each ray tests them in order up to its
    first occluding one): ``counts["tests"]`` [..., H, W] int64."""
    c = plucker_matrix(geometry)
    n = c.shape[0] // 5
    c = c.reshape(5, n, 16)
    r = _plucker_rays(origins, dirs, t_max).reshape(_R_TERMS, 1, -1)
    occluded = torch.zeros(r.shape[-1], dtype=torch.bool,
                           device=origins.device)
    first = torch.full(occluded.shape, n, dtype=torch.int64,
                       device=origins.device)
    block = _pick_block(r.shape[-1], n)
    for base in range(0, n, block):
        cb = c[:, base:base + block, :, None]  # [5, B, 16, 1]
        sides = []
        for row, (lo, hi) in enumerate(PLUCKER_COLS):
            acc = cb[row, :, lo] * r[lo]
            for j in range(lo + 1, hi):
                acc = acc + cb[row, :, j] * r[j]
            sides.append(acc)  # [B, rays]
        e0, e1, e2, s0, ds = sides
        same = (((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0))
                | ((e0 <= 0.0) & (e1 <= 0.0) & (e2 <= 0.0)))
        hit = same & (s0 * (s0 + ds) < 0.0)
        if counts is not None:
            first = torch.where(~occluded & hit.any(dim=0),
                                base + hit.int().argmax(dim=0), first)
        occluded = occluded | hit.any(dim=0)
    if counts is not None:
        counts["tests"] = torch.where(occluded, first + 1, n).reshape(
            t_max.shape)
    return occluded.reshape(t_max.shape)


def any_hit_plucker(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion by the Plücker sign test (the reference's
    ``pallas_any_mxu``), ``any_hit``'s contract: origins [..., 3, H, W],
    dirs broadcastable to them, t_max [..., H, W] → bool [..., H, W], True
    where the segment p0 → p0 + t_max·d crosses an active triangle; the
    leading axes are kept. The side constants (``plucker_matrix``) are
    built from the geometry on every call, as the reference builds them.
    Soup only, at most ``MAX_SOUP_TRIS`` triangles on the card. Kernel 8
    for CUDA tensors, the plain version for CPU tensors."""
    if geometry.bvh is not None:
        raise ValueError("any_hit_plucker: kernel 8 tests a soup; geometry "
                         "with a BVH takes any_hit")
    lead = tuple(origins.shape[:-3])
    h, w = origins.shape[-2:]
    if origins.shape[-3] != 3 or tuple(t_max.shape) != lead + (h, w):
        raise ValueError(f"any_hit_plucker: origins {tuple(origins.shape)} "
                         f"and t_max {tuple(t_max.shape)} do not match")
    if not origins.is_cuda:
        return any_hit_plucker_plain(origins, dirs, t_max, geometry)
    check_soup(geometry, "any_hit_plucker")
    c = plucker_matrix(geometry)
    o = origins.contiguous()
    d = dirs.expand(origins.shape).contiguous()
    tm = t_max.contiguous()
    _build.check(o, "origins", torch.float32)
    _build.check(d, "dirs", torch.float32)
    _build.check(tm, "t_max", torch.float32)
    out = torch.empty(lead + (h, w), dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_any_hit_plucker", o.data_ptr(), d.data_ptr(),
                      tm.data_ptr(), h * w, out.numel(), c.data_ptr(),
                      c.shape[0] // 5, out.data_ptr())
        any_hit_plucker.launches += 1
    return out


any_hit_plucker.launches = 0
