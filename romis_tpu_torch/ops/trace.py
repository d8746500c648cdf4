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
(the reference's rule). Bound: operations, the ray-triangle tests. The
kernel culls as the TPU kernel did: ``zcount_blocks`` orders the
soup (by the Morton code of its triangles' boxes where that gives smaller
boxes than the input order) and gives each block of ``ZCOUNT_BLOCK``
triangles a grown box, once per soup; a pending ray tests a block's box
over its window before the block's triangles and stops at its first hit,
and a near-parallel guard keeps the blocks whose triangles the plain
test's rounding could accept though the box misses them. The soup and the
blocks are staged into shared memory once a thread block for all R+1
origins. ``zcount_occ_culled`` is a plain model of that walk: the same
bool as ``zcount_occ_plain`` on every ray, and the box, guard, triangle
and origin tests the kernel makes (the bound after the cull).

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


def any_hit_plain(origins, dirs, t_max, geometry,
                  counts=None) -> torch.Tensor:
    """The plain version: the block scan ``ops.intersect.intersect_any``
    (the plain BVH traversal for BVH geometry); ``counts`` as there."""
    return intersect_any(origins, dirs, t_max, geometry, counts)


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


ZCOUNT_BLOCK = 16  # triangles a box of kernel 7 (csrc/zcount.cu kZBlock)
# A block's box grows by this share of its largest side (zcount_blocks).
ZCOUNT_GROW = 0.05
# A pair of triangles whose unit normals lie farther apart than this chord
# gets no cone: its two normals are tried at once (zcount_blocks).
ZCOUNT_CONE = 0.1
_U = 2.0 ** -24  # float32's unit roundoff


def _spread_bits(q: torch.Tensor) -> torch.Tensor:
    """10-bit integers → their bits 3 apart (a Morton code's axis)."""
    q = (q | (q << 16)) & 0x030000FF
    q = (q | (q << 8)) & 0x0300F00F
    q = (q | (q << 4)) & 0x030C30C3
    return (q | (q << 2)) & 0x09249249


@torch.no_grad()
def _blocks(cols: torch.Tensor, order: bool):
    """zcount_blocks in the Morton (``order``) or the input order."""
    cols = cols.detach()
    t = cols.shape[1]
    if t == 0:
        return cols, cols.new_zeros((13, 0)), cols.new_zeros((5, 0))
    act = cols[9] > 0.0
    v0 = cols[0:3]
    v1, v2 = v0 + cols[3:6], v0 + cols[6:9]
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    inf = float("inf")
    if order:
        s_lo = torch.where(act, lo, inf).amin(dim=1, keepdim=True)
        s_hi = torch.where(act, hi, -inf).amax(dim=1, keepdim=True)
        span = torch.nan_to_num(s_hi - s_lo, nan=1.0, posinf=1.0,
                                neginf=1.0).clamp_min(1e-30)
        rel = torch.nan_to_num(((lo + hi) * 0.5 - s_lo) / span)
        q = (rel * 1023.0).clamp(0.0, 1023.0).to(torch.int64)
        key = ((_spread_bits(q[0]) << 2) | (_spread_bits(q[1]) << 1)
               | _spread_bits(q[2]))
        perm = torch.argsort(torch.where(act, key, 1 << 31), stable=True)
        cols, lo, hi, act = cols[:, perm], lo[:, perm], hi[:, perm], act[perm]
    pad = (-t) % ZCOUNT_BLOCK
    if pad:
        cols, lo, hi = (torch.nn.functional.pad(a, (0, pad))
                        for a in (cols, lo, hi))
        act = torch.cat([act, act.new_zeros(pad)])
    nb = (t + pad) // ZCOUNT_BLOCK
    b_lo = torch.where(act, lo, inf).reshape(3, nb, ZCOUNT_BLOCK).amin(-1)
    b_hi = torch.where(act, hi, -inf).reshape(3, nb, ZCOUNT_BLOCK).amax(-1)
    full = act.reshape(nb, ZCOUNT_BLOCK).any(-1)
    big = torch.where(act, torch.maximum(lo.abs(), hi.abs()), 0.0).amax()
    side = torch.where(full, (b_hi - b_lo).amax(0), 0.0)
    grow = 1e-4 + 1e-5 * big + ZCOUNT_GROW * side
    b_lo = torch.where(full, b_lo - grow, 1e30)
    b_hi = torch.where(full, b_hi + grow, 1e30)
    # The near-parallel guard (zcount_blocks): per block the centre, three
    # L1 half-diagonals and the growth over 8u; per triangle its unit
    # normal times sin(theta) times the block's growth over 64u; per pair
    # of triangles the cone of their unit normals.
    centre = (b_lo + b_hi) * 0.5
    s3 = 1.5 * (b_hi - b_lo).sum(0)
    g_over = torch.where(full, grow / (8.0 * _U), inf)
    e1, e2 = cols[3:6], cols[6:9]
    cross = torch.linalg.cross(e1, e2, dim=0)
    den = torch.linalg.vector_norm(e1, dim=0) * torch.linalg.vector_norm(
        e2, dim=0)
    area = torch.linalg.vector_norm(cross, dim=0)
    scale = (grow / (64.0 * _U)).repeat_interleave(ZCOUNT_BLOCK)
    live = act & (den > 0.0)  # a zero edge makes det 0: never a hit
    nrm = torch.where(live, cross / torch.where(live, den, 1.0) * scale, inf)
    # The pairs' cones: axis a, radius rho (the chord to the farther of
    # the two sign-aligned unit normals) and iota, the larger 1/|m| → the
    # float4 (a / iota, rho / iota): a ray with |d·a| / iota - rho / iota
    # above its reach is near-parallel to neither triangle.
    ok = live & (area > 0.0)
    unit = cross / torch.where(ok, area, 1.0)
    inv_m = torch.where(ok, den / torch.where(ok, area, 1.0) / scale, 0.0)
    u0, u1 = unit[:, 0::2], unit[:, 1::2]
    ok0, ok1 = ok[0::2], ok[1::2]
    flip = torch.where((u0 * u1).sum(0) < 0.0, -1.0, 1.0)
    u1 = u1 * flip
    axis = torch.where(ok0 & ok1, u0 + u1, torch.where(ok0, u0, u1))
    axis = axis / torch.linalg.vector_norm(axis, dim=0).clamp_min(1e-30)
    rho = torch.maximum(
        torch.where(ok0, torch.linalg.vector_norm(u0 - axis, dim=0), 0.0),
        torch.where(ok1, torch.linalg.vector_norm(u1 - axis, dim=0), 0.0))
    iota = torch.maximum(inv_m[0::2], inv_m[1::2])
    any_ok = ok0 | ok1
    # No cone (radius inf: each normal is tried) for a pair with a live
    # triangle of no area, or whose two planes are far apart (a soup's).
    bad = (live & ~ok).reshape(-1, 2).any(1) | (rho > ZCOUNT_CONE)
    cone = torch.cat([torch.where(any_ok, axis / torch.where(
        any_ok, iota, 1.0), 0.0), torch.where(
        any_ok, (rho + 1e-5) / torch.where(any_ok, iota, 1.0),
        -inf)[None]]).T
    cone[bad, 3] = inf
    guard = torch.cat([nrm, cone.reshape(2, -1)])
    slot = torch.arange(1, ZCOUNT_BLOCK + 1, device=cols.device)
    end = torch.where(act.reshape(nb, ZCOUNT_BLOCK), slot, 0).amax(-1)
    # A block whose pairs mostly lack a cone defers its guard (kernel 7
    # runs it only for the rays its walk leaves unoccluded).
    pairs_live = (act[0::2] | act[1::2]).reshape(nb, -1)
    no_cone = (bad & any_ok).reshape(nb, -1)
    defer = no_cone.sum(-1) * 2 > pairs_live.sum(-1)
    boxes = torch.cat([b_lo, b_hi, centre, s3[None], g_over[None],
                       end.to(cols.dtype)[None], defer.to(cols.dtype)[None]])
    return cols.contiguous(), boxes.contiguous(), guard.contiguous()


def _box_area(boxes: torch.Tensor) -> torch.Tensor:
    """The summed surface area of the boxes (0 for a block no window
    reaches): a ray spread uniformly meets a box in proportion to it."""
    x, y, z = boxes[3:6] - boxes[:3]
    return (2.0 * (x * y + y * z + z * x)).sum()


def zcount_blocks(geometry, order: bool | None = None):
    """Kernel 7's cull: the soup's columns [10, T] in the Morton order of
    the triangles' box centres (``order=True``), in the input order
    (``False``) or, by default, in whichever of the two gives the blocks'
    boxes the smaller summed surface area (the order a mesh is written in
    keeps a strip of neighbours together; a shuffled soup needs the sort),
    padded with inactive triangles to a multiple of ``ZCOUNT_BLOCK`` →
    (cols [10, T'], boxes [13, T'/ZCOUNT_BLOCK], guard [5, T']).

    A block's box (rows 0-5: min xyz, max xyz) holds its active triangles'
    corners (v0, v0 + e1, v0 + e2), grown by g = 1e-4 + 1e-5 of the soup's
    largest coordinate + ``ZCOUNT_GROW`` of the block's largest side; a
    block with no active triangle gets a degenerate box at 1e30 that no
    window reaches. A ray that misses the box by g misses every triangle
    of the block, but the plain test's rounding may still accept a
    triangle the ray is nearly parallel to (its errors grow as
    1/|cos|): in float32 the exact crossing of the plane lies within
    ~23u·L / (sin θ·|cos|) of what the test accepts, u = 2^-24, L the
    origin's distance to the triangle + its edge + the window, θ the
    triangle's corner angle. So a block may only be skipped when, for
    each of its triangles, |d·m| > L, m = its unit normal·sin θ·g / 64u
    (``normals``; inactive: inf), L bounded from the block's centre (rows
    6-8) and three L1 half-diagonals (row 9) as |o - c|₁ + row 9 + dist,
    and when L < g / 8u (row 10), which keeps the slab test's own rounding
    below g / 2. Tensor operations on the columns' device, no host sync,
    and outside autograd (the blocks only cull). The default is kept on
    the geometry (``Geometry.zcount``) with the columns tensor it was
    built from, and rebuilt if the geometry's columns are another tensor
    or were written to; ``build_zcount_blocks`` builds it afresh."""
    cols = geometry.tri_cols
    if order is not None:
        return _blocks(cols, order)
    kept = geometry.zcount
    if kept is not None and kept[0] is cols and kept[1] == cols._version:
        return kept[2]
    out = build_zcount_blocks(cols)
    geometry.zcount = (cols, cols._version, out)
    return out


def build_zcount_blocks(cols: torch.Tensor):
    """``zcount_blocks``' default of the columns [10, T], not kept."""
    m, i = _blocks(cols, True), _blocks(cols, False)
    morton = _box_area(m[1]) < _box_area(i[1])
    return tuple(torch.where(morton, a, b) for a, b in zip(m, i))


def _inv_dir(c: torch.Tensor) -> torch.Tensor:
    """A slab test's reciprocal: zero components become a huge slope."""
    return torch.where(c < 0.0, -1.0, 1.0) / torch.clamp_min(c.abs(), 1e-20)


def zcount_occ_culled(origins, targets, geometry, eps: float = 1e-3,
                      mask=None, counts=None, order: bool | None = None,
                      lazy: bool | None = None,
                      guard: bool = True) -> torch.Tensor:
    """A plain model of kernel 7's culled walk: the blocks of
    ``zcount_blocks`` in order, a pending ray's slab test of each block's
    box over its window [0, dist], then the block's triangles in order
    with ``zcount_occ_plain``'s arithmetic, each ray stopping at its first
    hit. Where a box test fails, the near-parallel guard over the block's
    triangles may still keep the block: at once, or in a second pass over
    the blocks for the rays the walk left unoccluded (every block with
    ``lazy``, none without; by default the blocks ``zcount_blocks`` flags,
    as the kernel does). Its bool is
    ``zcount_occ_plain``'s on every ray (a block is only dropped where no
    triangle of it can accept the ray). With a ``counts`` dict it records
    the tests the kernel makes (one lane's own rays, the per-lane mode):
    ``box``, ``guard`` (blocks whose box failed and were guarded),
    ``guard_cone`` and ``guard_tri`` (the cone and normal products of
    their guard) and ``tri`` [R+1, K, H, W] per ray, ``origin`` [R+1, H, W]
    the origin set-ups (a triangle of a block that some ray of the origin
    tests). With ``guard=False`` the box alone decides (the walk the cull
    itself needs; its bool may then miss a hit on a near-parallel ray)."""
    cols, boxes, guard_data = zcount_blocks(geometry, order)
    defer = ([bool(lazy)] * boxes.shape[1] if lazy is not None
             else (boxes[12] > 0.5).tolist())
    nrm, cones = guard_data[:3], guard_data[3:].reshape(-1, 4)
    dx, dy, dz, dist = _zcount_rays(origins, targets, mask)
    r1, k, h, w = dist.shape
    dev = origins.device
    o = [origins[:, None, c].expand(r1, k, h, w).reshape(-1) for c in range(3)]
    d = [a.reshape(-1) for a in (dx, dy, dz)]
    inv = [_inv_dir(a) for a in d]
    dist = dist.reshape(-1)
    pending = dist > eps
    occluded = torch.zeros_like(pending)
    n = {name: torch.zeros(dist.shape, dtype=torch.int64, device=dev)
         for name in ("box", "tri", "guard", "guard_tri", "guard_cone")}
    n_origin = torch.zeros(r1 * h * w, dtype=torch.int64, device=dev)
    ray_origin = (torch.arange(dist.numel(), device=dev) // (k * h * w)
                  * (h * w) + torch.arange(dist.numel(), device=dev) % (h * w))

    def box_ok(b, idx):
        n["box"][idx] += 1
        ox, oy, oz = (a[idx] for a in o)
        t = [(boxes[c, b] - oc) * ic[idx] for c, oc, ic in
             ((0, ox, inv[0]), (1, oy, inv[1]), (2, oz, inv[2]))]
        t1 = [(boxes[3 + c, b] - oc) * ic[idx] for c, oc, ic in
              ((0, ox, inv[0]), (1, oy, inv[1]), (2, oz, inv[2]))]
        tn = torch.maximum(torch.maximum(torch.minimum(t[0], t1[0]),
                                         torch.minimum(t[1], t1[1])),
                           torch.minimum(t[2], t1[2]))
        tf = torch.minimum(torch.minimum(torch.maximum(t[0], t1[0]),
                                         torch.maximum(t[1], t1[1])),
                           torch.maximum(t[2], t1[2]))
        return (tf >= tn) & (tf >= 0.0) & (tn <= dist[idx])

    def guard_keeps(b, idx):
        """The near-parallel guard of block b for the rays idx (their box
        test failed): kept where some triangle's rounding could reach the
        ray; a pair's cone first, then the pair's two normals."""
        n["guard"][idx] += 1
        ox, oy, oz = (a[idx] for a in o)
        reach = ((ox - boxes[6, b]).abs() + (oy - boxes[7, b]).abs()
                 + (oz - boxes[8, b]).abs() + boxes[9, b] + dist[idx])
        near = reach >= boxes[10, b]
        di = [a[idx] for a in d]
        for q in range(ZCOUNT_BLOCK // 2):
            c = cones[b * ZCOUNT_BLOCK // 2 + q]
            pair = ~near
            if c[3] < 1e30:
                n["guard_cone"][idx[pair]] += 1
                pair &= ~((di[0] * c[0] + di[1] * c[1] + di[2] * c[2]).abs()
                          - c[3] > reach)
            n["guard_tri"][idx[pair]] += 2
            for j in range(b * ZCOUNT_BLOCK + 2 * q,
                           b * ZCOUNT_BLOCK + 2 * q + 2):
                near |= pair & ((di[0] * nrm[0, j] + di[1] * nrm[1, j]
                                 + di[2] * nrm[2, j]).abs() <= reach)
        return near

    def test(b, live):
        """The triangles of block b against the rays ``live``."""
        if live.numel() == 0:
            return
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, act = \
            cols[:, b * ZCOUNT_BLOCK:(b + 1) * ZCOUNT_BLOCK, None]
        ox, oy, oz = (a[live] for a in o)
        rdx, rdy, rdz = (a[live] for a in d)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        e2q = e2x * qx + e2y * qy + e2z * qz
        px = rdy * e2z - rdz * e2y
        py = rdz * e2x - rdx * e2z
        pz = rdx * e2y - rdy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ua = (tx * px + ty * py + tz * pz) * det
        va = (rdx * qx + rdy * qy + rdz * qz) * det
        ta = e2q * det
        aa = det * det
        hit = ((aa > 1e-18) & (ua >= 0.0) & (va >= 0.0) & (ua + va <= aa)
               & (ta > eps * aa) & (ta < dist[live] * aa) & (act > 0.0))
        any_hit_ = hit.any(dim=0)
        tested = torch.cumsum((act[:, 0] > 0.0).to(torch.int64), 0)
        tests = torch.where(any_hit_, tested[hit.int().argmax(dim=0)],
                            tested[-1])
        n["tri"][live] += tests
        n_origin.add_(torch.zeros_like(n_origin).scatter_reduce_(
            0, ray_origin[live], tests, "amax"))
        done = live[any_hit_]
        occluded[done] = True
        pending[done] = False

    for b in range(boxes.shape[1]):
        idx = pending.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        ok = box_ok(b, idx)
        if guard and not defer[b]:
            ok[~ok] = guard_keeps(b, idx[~ok])
        test(b, idx[ok])
    for b in (b for b in range(boxes.shape[1]) if guard and defer[b]):
        idx = pending.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        cand = idx[~box_ok(b, idx)]
        test(b, cand[guard_keeps(b, cand)])
    if counts is not None:
        counts.update({name: v.reshape(r1, k, h, w) for name, v in n.items()})
        counts["origin"] = n_origin.reshape(r1, h, w)
    return occluded.reshape(r1, k, h, w)


def zcount_occ(origins, targets, geometry, eps: float = 1e-3,
               mask=None) -> torch.Tensor:
    """The Z-count occlusion of the unbiased pass (the reference's
    ``pallas_zcount_occ``): origins [R+1, 3, H, W] (the receiver, then the
    R neighbours), targets [K, 3, H, W] (the winners), an optional bool
    mask [R+1, K, H, W] → bool [R+1, K, H, W], True where a triangle lies at
    t in (eps, dist) from the unshifted origin toward the target
    (``ops.wrs.visibility_from``'s occlusion; dist <= eps and masked-off
    rays are never occluded). Kernel 7 for CUDA tensors on a soup (its
    blocks from ``zcount_blocks``, built at the soup's first call), the
    plain version for CPU tensors."""
    if not origins.is_cuda:
        return zcount_occ_plain(origins, targets, geometry, eps, mask)
    if geometry.bvh is not None:
        raise ValueError("zcount_occ: kernel 7 traces a soup; geometry with "
                         "a BVH takes the Z rays through visibility_from")
    r1, k = origins.shape[0], targets.shape[0]
    h, w = origins.shape[-2:]
    if not 1 <= k <= 4 or not 1 <= r1 <= 9:
        raise ValueError(f"zcount_occ: K={k}, R+1={r1} outside 1..4, 1..9")
    if h * w >= 2 ** 31:
        raise ValueError(f"zcount_occ: {h}x{w} pixels exceed 32-bit "
                         "indexing")
    o = origins.contiguous()
    tg = targets.contiguous()
    _build.check(o, "origins", torch.float32, (r1, 3, h, w))
    _build.check(tg, "targets", torch.float32, (k, 3, h, w))
    m_ptr = None
    if mask is not None:
        m = mask.contiguous()
        _build.check(m, "mask", torch.bool, (r1, k, h, w))
        m_ptr = m.data_ptr()
    _build.check(geometry.tri_cols, "tri_cols", torch.float32)
    check_soup(geometry, "zcount_occ")
    cols, boxes, guard = zcount_blocks(geometry)
    out = torch.empty((r1, k, h, w), dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_zcount_occ", o.data_ptr(), tg.data_ptr(), m_ptr,
                      h, w, r1, k, cols.data_ptr(), boxes.data_ptr(),
                      guard.data_ptr(), cols.shape[1], float(eps),
                      out.data_ptr())
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
