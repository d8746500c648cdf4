"""Closest hit and any-hit against the triangle soup (reference
``romis_tpu/ops/pallas_trace.py``, ``pallas_closest`` and ``pallas_any``).

Kernel 1 (``csrc/trace.cu``) replaces the Pallas ``_closest_kernel``:
Möller–Trumbore over the triangle soup, one thread per ray, the soup
staged into shared memory once a persistent thread block; a soup of more
than ``ZCOUNT_BLOCK`` triangles culled by the blocks of ``soup_blocks``
(``closest_hit_culled`` is the plain model of that walk and derives why
its answer is the plain scan's). Same contract as the plain block scan
``ops.intersect.intersect_closest``: t in (0, t_max), ties to the lowest
triangle index, (t = inf, tri = -1, u = v = 0) on a miss. ``closest_hit``
is differentiable in the rays and the vertex columns, with the reference's
re-evaluation backward (``ops/intersect.closest_hit_diff``): the selected
triangles are fixed and (t, u, v) re-derived from one Möller–Trumbore
evaluation each (``ops.intersect.reeval_tuv``, whose row gather and its
scatter backward are kernels 2 and 13 on CUDA).

Kernel 6 (``csrc/any.cu``) replaces the Pallas ``_any_kernel``: boolean
occlusion at t in (0, t_max) with an early exit per ray, leading sample
axes kept, the same contract as ``ops.intersect.intersect_any``. A soup of
more than ``ZCOUNT_BLOCK`` triangles is culled as the TPU kernel culls it,
by the blocks of ``zcount_blocks`` and the walk kernel 4 shares
(``any_hit_culled`` is its plain model); a smaller soup is tested
directly.

Bound on the H100: the triangle columns are a shared-memory broadcast, so
device memory sees only rays in and hits out (~40 B per pixel for the
closest hit, 29 B per ray for the any-hit); operations, the ray-triangle
tests (and the box tests of a culled soup; the guards' printed apart).

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
boundary. The constants are kept with the soup (``plucker_blocks``); a
soup of more than ``ZCOUNT_BLOCK`` triangles is culled by the same blocks
with kernel 8's own near-parallel guard, which
``any_hit_plucker_culled`` (the walk's plain model) derives from the
Plücker test's rounding. Bound: operations, the box tests and the
non-zero terms of the five products per ray-triangle test of the culled
walk.

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
    _mt, _pick_block, intersect_any, intersect_closest, reeval_tuv,
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
    _build.check(geometry.tri_cols, "tri_cols", torch.float32)
    check_soup(geometry, "closest_hit")
    if geometry.tri_cols.shape[1] <= ZCOUNT_BLOCK:  # nothing to cull
        cols, boxes, guard, index = geometry.tri_cols, None, None, None
    else:
        cols, boxes, guard, index = soup_blocks(geometry)
    dev = rays.origin.device
    t = torch.empty((h, w), dtype=torch.float32, device=dev)
    tri = torch.empty((h, w), dtype=torch.int32, device=dev)
    u = torch.empty((h, w), dtype=torch.float32, device=dev)
    v = torch.empty((h, w), dtype=torch.float32, device=dev)
    if h * w == 0:
        return t, tri, u, v

    def ptr(a):
        return None if a is None else a.data_ptr()

    _build.launch("romis_closest_hit", rays.origin.data_ptr(),
                  rays.direction.data_ptr(), h, w, cols.data_ptr(),
                  ptr(boxes), ptr(guard), ptr(index), cols.shape[1],
                  float(t_max), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                  v.data_ptr())
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


def any_hit_plain(origins, dirs, t_max, geometry,
                  counts=None) -> torch.Tensor:
    """The plain version: the block scan ``ops.intersect.intersect_any``
    (the plain BVH traversal for BVH geometry); ``counts`` as there."""
    return intersect_any(origins, dirs, t_max, geometry, counts)


def any_hit(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion: True where a triangle lies at t in (0, t_max).
    origins [..., 3, H, W], dirs broadcastable to them, t_max [..., H, W]
    → bool [..., H, W]; the leading axes are kept. Kernel 6 for CUDA
    tensors on a soup (more than ``ZCOUNT_BLOCK`` triangles culled by the
    blocks of ``zcount_blocks``, built at the soup's first call;
    ``any_hit_culled(..., lazy=False)`` is the plain model of its walk),
    the BVH walks on geometry with a BVH, the plain version for CPU
    tensors."""
    if not origins.is_cuda:
        return any_hit_plain(origins, dirs, t_max, geometry)
    if geometry.bvh is not None:
        rays_per_pixel = math.prod(origins.shape[:-3])
        if 2 <= rays_per_pixel <= walk.K_MAX:
            return walk.any_hit_bvh_k(origins, dirs, t_max, geometry)
        return walk.any_hit_bvh(origins, dirs, t_max, geometry)
    o, d, tm, h, w, planes = _ray_args(origins, dirs, t_max, "any_hit")
    _build.check(geometry.tri_cols, "tri_cols", torch.float32)
    check_soup(geometry, "any_hit")
    if geometry.tri_cols.shape[1] <= ZCOUNT_BLOCK:  # nothing to cull
        cols, boxes, guard = geometry.tri_cols, None, None
    else:
        cols, boxes, guard = zcount_blocks(geometry)
    out = torch.empty(tuple(t_max.shape), dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_any_hit", o.data_ptr(), d.data_ptr(),
                      tm.data_ptr(), h, w, planes, cols.data_ptr(),
                      _ptr(boxes), _ptr(guard), cols.shape[1],
                      out.data_ptr())
    return out


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
    """soup_blocks in the Morton (``order``) or the input order."""
    cols = cols.detach()
    t = cols.shape[1]
    index = torch.arange(t, dtype=torch.int32, device=cols.device)
    if t == 0:
        return (cols, cols.new_zeros((13, 0)), cols.new_zeros((5, 0)),
                index)
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
        index = index[perm]
    pad = (-t) % ZCOUNT_BLOCK
    if pad:
        cols, lo, hi = (torch.nn.functional.pad(a, (0, pad))
                        for a in (cols, lo, hi))
        act = torch.cat([act, act.new_zeros(pad)])
        index = torch.nn.functional.pad(index, (0, pad), value=-1)
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
    return cols.contiguous(), boxes.contiguous(), guard.contiguous(), index


def _box_area(boxes: torch.Tensor) -> torch.Tensor:
    """The summed surface area of the boxes (0 for a block no window
    reaches): a ray spread uniformly meets a box in proportion to it."""
    x, y, z = boxes[3:6] - boxes[:3]
    return (2.0 * (x * y + y * z + z * x)).sum()


def zcount_blocks(geometry, order: bool | None = None):
    """``soup_blocks`` without the index: (cols, boxes, guard), the kept
    tuple itself by default."""
    if order is not None:
        return _blocks(geometry.tri_cols, order)[:3]
    soup_blocks(geometry)
    return geometry.zcount[2]


def soup_blocks(geometry, order: bool | None = None):
    """The cull of kernels 7, 4 and 1: the soup's columns [10, T] in the
    Morton order of the triangles' box centres (``order=True``), in the
    input order
    (``False``) or, by default, in whichever of the two gives the blocks'
    boxes the smaller summed surface area (the order a mesh is written in
    keeps a strip of neighbours together; a shuffled soup needs the sort),
    padded with inactive triangles to a multiple of ``ZCOUNT_BLOCK`` →
    (cols [10, T'], boxes [13, T'/ZCOUNT_BLOCK], guard [5, T'], index
    [T'] int32: each slot's triangle in the input order, -1 on padding).

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
    if kept is None or kept[0] is not cols or kept[1] != cols._version:
        out = build_zcount_blocks(cols)
        kept = geometry.zcount = (cols, cols._version, out[:3], out[3])
    return kept[2] + (kept[3],)


def build_zcount_blocks(cols: torch.Tensor):
    """``soup_blocks``' default of the columns [10, T], not kept."""
    m, i = _blocks(cols, True), _blocks(cols, False)
    morton = _box_area(m[1]) < _box_area(i[1])
    return tuple(torch.where(morton, a, b) for a, b in zip(m, i))


def _inv_dir(c: torch.Tensor) -> torch.Tensor:
    """A slab test's reciprocal: zero components become a huge slope."""
    return torch.where(c < 0.0, -1.0, 1.0) / torch.clamp_min(c.abs(), 1e-20)


def _box_ok(n, boxes, b, o, inv, dist, idx):
    """The slab test of block b's box for the rays idx over [0, dist]."""
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
    return (tf >= tn) & (tf >= 0.0) & (tn <= dist)


def _guard_keeps(n, boxes, guard_data, b, o, d, dist, idx, capped=False):
    """The near-parallel guard of block b for the rays idx (their box test
    failed) over the window [0, dist]: kept where some triangle's rounding
    could reach the ray; a pair's cone first, then the pair's two normals.
    ``capped`` (a closest-hit ray, dist its best t): the reach of the
    smaller of ``closest_hit_culled``'s two rules that holds."""
    n["guard"][idx] += 1
    nrm, cones = guard_data[:3], guard_data[3:].reshape(-1, 4)
    ox, oy, oz = (a[idx] for a in o)
    di = [a[idx] for a in d]
    l0 = ((ox - boxes[6, b]).abs() + (oy - boxes[7, b]).abs()
          + (oz - boxes[8, b]).abs() + boxes[9, b])
    if not capped:
        reach = l0 + dist
        near = reach >= boxes[10, b]
    else:  # closest_hit_culled's two rules
        reach = l0 + torch.minimum(dist, CLOSEST_REACH * l0)
        box_rule = reach < boxes[10, b]
        cx, cy, cz = boxes[6, b] - ox, boxes[7, b] - oy, boxes[8, b] - oz
        qx = cy * di[2] - cz * di[1]
        qy = cz * di[0] - cx * di[2]
        qz = cx * di[1] - cy * di[0]
        delta = ((qx * qx + qy * qy + qz * qz).sqrt() * (1.0 - 2.0 ** -16)
                 - boxes[9, b] * (1.0 / 3.0)
                 - 2.0 ** -16 * (cx.abs() + cy.abs() + cz.abs()))
        g = boxes[10, b] * 2.0 ** -21  # row 10 = g / 8u
        gp = torch.minimum(2.5 * delta, 0.2 * l0)
        r_delta = torch.where(gp > g, (2.0 * l0) * (g / gp), torch.inf)
        near = ~box_rule & ~(gp > g)
        reach = torch.where(box_rule, torch.minimum(reach, r_delta), r_delta)
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


def _walk_counts(shape, device):
    return {name: torch.zeros(shape, dtype=torch.int64, device=device)
            for name in ("box", "tri", "guard", "guard_tri", "guard_cone")}


def _culled_walk(o, d, dist, boxes, defer, test, keeps=None,
                 direct=False):
    """The culled walk of kernels 7, 4, 6 and 8 over the blocks of
    ``soup_blocks``, on flat rays: origins ``o`` and directions ``d``
    (three [N] tensors each), the window [0, dist] [N], every ray with
    ``dist`` > 0 traced. Per block, in order, a pending ray's slab test of
    the block's box, then (where the box rejects it and the block is not
    deferred) the near-parallel guard ``keeps(n, b, idx)`` → bool [idx]
    (None: no guard, the box alone decides), then ``test(b, rays)`` → (hit
    [n] bool, triangles tested up to the first hit [n]); a hit ends the
    ray. The deferred blocks' guard runs in a second pass for the rays
    left pending. ``direct`` (a soup of one block): no box test, the
    block's triangles tested at once. → (occluded [N], counts: box, guard
    (blocks guarded), guard_cone and guard_tri (its products), tri, each
    [N] int64)."""
    inv = [_inv_dir(a) for a in d]
    pending = dist > 0.0
    occluded = torch.zeros_like(pending)
    n = _walk_counts(dist.shape, dist.device)

    def run(b, live):
        if live.numel() == 0:
            return
        hit, tests = test(b, live)
        n["tri"][live] += tests
        done = live[hit]
        occluded[done] = True
        pending[done] = False

    if direct:
        run(0, pending.nonzero().squeeze(1))
        return occluded, n
    for b in range(boxes.shape[1]):
        idx = pending.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        ok = _box_ok(n, boxes, b, o, inv, dist[idx], idx)
        if keeps is not None and not defer[b]:
            ok[~ok] = keeps(n, b, idx[~ok])
        run(b, idx[ok])
    for b in (b for b in range(boxes.shape[1])
              if keeps is not None and defer[b]):
        idx = pending.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        cand = idx[~_box_ok(n, boxes, b, o, inv, dist[idx], idx)]
        run(b, cand[keeps(n, b, cand)])
    return occluded, n


def _guard_rays(d, dist):
    """The guards' view of rays of any length: the unit directions (0 for
    a zero direction) and the window's length dist·|d|, as kernels 6 and
    8 form them."""
    norm = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).sqrt()
    ok = norm > 0.0
    unit = [torch.where(ok, a / torch.where(ok, norm, 1.0), 0.0) for a in d]
    return unit, dist * norm


def _first_tests(hit, act):
    """Triangles a ray tests in a block, its active ones in order up to
    its first hit: hit [B, n] bool, act [B] → [n] int64."""
    tested = torch.cumsum(act.to(torch.int64), 0)
    return torch.where(hit.any(dim=0), tested[hit.int().argmax(dim=0)],
                       tested[-1])


def zcount_occ_culled(origins, targets, geometry, eps: float = 1e-3,
                      mask=None, counts=None, order: bool | None = None,
                      lazy: bool | None = None,
                      guard: bool = True) -> torch.Tensor:
    """A plain model of kernel 7's culled walk (``_culled_walk``): the
    blocks of ``zcount_blocks`` in order, a pending ray's slab test of
    each block's box over its window [0, dist], then the block's triangles
    in order with ``zcount_occ_plain``'s arithmetic, each ray stopping at
    its first hit. Where a box test fails, the near-parallel guard over
    the block's triangles may still keep the block: at once, or in a
    second pass over the blocks for the rays the walk left unoccluded
    (every block with ``lazy``, none without; by default the blocks
    ``zcount_blocks`` flags, as the kernel does). Its bool is
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
    dx, dy, dz, dist = _zcount_rays(origins, targets, mask)
    r1, k, h, w = dist.shape
    dev = origins.device
    o = [origins[:, None, c].expand(r1, k, h, w).reshape(-1) for c in range(3)]
    d = [a.reshape(-1) for a in (dx, dy, dz)]
    dist = dist.reshape(-1)
    n_origin = torch.zeros(r1 * h * w, dtype=torch.int64, device=dev)
    ray_origin = (torch.arange(dist.numel(), device=dev) // (k * h * w)
                  * (h * w) + torch.arange(dist.numel(), device=dev) % (h * w))

    def test(b, live):
        """The triangles of block b against the rays ``live``."""
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
        tests = _first_tests(hit, act[:, 0] > 0.0)
        n_origin.add_(torch.zeros_like(n_origin).scatter_reduce_(
            0, ray_origin[live], tests, "amax"))
        return hit.any(dim=0), tests

    # A ray is traced where its window reaches past eps (kernel 7's test).
    dist = torch.where(dist > eps, dist, 0.0)

    def keeps(n, b, idx):
        return _guard_keeps(n, boxes, guard_data, b, o, d, dist[idx], idx)

    occluded, n = _culled_walk(o, d, dist, boxes, defer, test,
                               keeps if guard else None)
    if counts is not None:
        counts.update({name: v.reshape(r1, k, h, w) for name, v in n.items()})
        counts["origin"] = n_origin.reshape(r1, h, w)
    return occluded.reshape(r1, k, h, w)


def any_hit_culled(origins, dirs, t_max, geometry, counts=None,
                   guard: bool = True,
                   lazy: bool | None = None) -> torch.Tensor:
    """A plain model of the culled walk of kernels 4 (its shadow rays) and
    6 (``any_hit``), ``csrc/cull.cuh``'s ``soup_any`` over the blocks of
    ``zcount_blocks`` (the soup's default order; the guard deferred to a
    second pass over the rays left pending for every block with
    ``lazy``, for none without (kernel 6), by default for the blocks
    ``zcount_blocks`` flags (kernel 4)): each ray's box test over [0,
    t_max], the guard where the box rejects it, then the block's
    triangles in order with the plain any-hit's Möller–Trumbore
    (``ops.intersect._mt``, the division form ``mt_tri`` of the kernels),
    t in (0, t_max); a soup of at most one block (or none) tests its
    triangles as given, directly.
    origins [..., 3, H, W], dirs broadcastable to them, t_max [..., H, W]
    → bool [..., H, W], ``any_hit_plain``'s on every ray traced (t_max >
    0; the others are False). With a ``counts`` dict it records the tests
    the kernels make per ray (``box``, ``guard``, ``guard_cone``,
    ``guard_tri``, ``tri``, each [..., H, W]); ``guard=False`` lets the
    box alone decide (the tests the cull itself needs). The box test is
    parametric in the direction as given; the guard takes the unit
    direction and the window's length t_max·|d| (``_guard_rays``), so the
    bound below, stated for unit directions, holds for any (kernel 4,
    whose directions are unit vectors by construction, takes them as they
    are).

    The guard's bound (``zcount_blocks``) holds for this test too. With
    s = sin θ·|cos| (θ the triangle's corner angle, cos = d·n̂) and L as
    there, det = e1·(d × e2) and the numerators t·p, d·q, e2·q carry
    absolute errors of at most 5.83u|e1||e2|, 5.83u|t||e2|,
    5.83u|t||e1| and 5.83u|t||e1||e2| (two roundings a cross-product
    term, three a dot product), and the division and the product by the
    reciprocal add 2u relative to each of u, v and t. So the exact crossing
    of the plane lies within 5.83u(3|t| + |e1| + |e2| + |t*|)/s + 2u(|e1|
    + |e2| + |t*|) ≤ 20.4u·L/s of a point the test accepts (|t| ≤ |o -
    c|₁ + h, |e1|, |e2| ≤ 2h, |t*| ≤ dist, L = |o - c|₁ + 3h + dist, h the
    box's L1 half-diagonal), under the division-free form's 23u·L/s that
    the guard's 64u covers; a ray the guard lets go has s > 64u·L/g ≥
    576u, so det's relative error stays under 1 %."""
    direct = geometry.tri_cols.shape[1] <= ZCOUNT_BLOCK
    if direct:  # the soup as given, no blocks (kernel 4's wrapper builds none)
        cols = geometry.tri_cols.detach()
        boxes = guard_data = cols.new_zeros((13, 1))
    else:
        cols, boxes, guard_data = zcount_blocks(geometry)
    lead = tuple(t_max.shape)
    o = [origins.select(-3, c).expand(lead).reshape(-1) for c in range(3)]
    d = [dirs.expand(origins.shape).select(-3, c).expand(lead).reshape(-1)
         for c in range(3)]
    dist = t_max.reshape(-1)

    def test(b, live):
        tri = cols[:, b * ZCOUNT_BLOCK:(b + 1) * ZCOUNT_BLOCK, None, None]
        if tri.shape[1] == 0:  # an empty soup: nothing to hit
            none = torch.zeros(live.shape, dtype=torch.int64,
                               device=live.device)
            return none.bool(), none
        ray = tuple(a[live][None, None] for a in o + d)
        t, _, _ = _mt(ray, tri)  # [B, 1, n]
        hit = t[:, 0] < dist[live]
        return hit.any(dim=0), _first_tests(hit, tri[9, :, 0, 0] > 0.0)

    unit, length = _guard_rays(d, dist)

    def keeps(n, b, idx):
        return _guard_keeps(n, boxes, guard_data, b, o, unit, length[idx],
                            idx)

    defer = ([bool(lazy)] * boxes.shape[1] if lazy is not None
             else (boxes[12] > 0.5).tolist())
    occluded, n = _culled_walk(o, d, dist, boxes, defer, test,
                               keeps if guard else None, direct=direct)
    if counts is not None:
        counts.update({name: v.reshape(lead) for name, v in n.items()})
    return occluded.reshape(lead)


# The guard's window of a closest-hit ray, min(best t, CLOSEST_REACH · l0)
# (closest_hit_culled; csrc/trace.cu kReach).
CLOSEST_REACH = 1.0


def closest_hit_culled(rays: Rays, geometry, t_max: float = math.inf,
                       counts=None, order: bool | None = None,
                       guard: bool = True):
    """A plain model of kernel 1's walk, ``closest_hit_plain``'s contract:
    rays [3, H, W] → (t, tri int32, u, v), each [H, W]; t = inf, tri = -1,
    u = v = 0 on a miss. A soup of more than ``ZCOUNT_BLOCK`` triangles is
    walked over the blocks of ``soup_blocks`` in order, each ray with its
    running best t (t_max before its first hit): the block's box over [0,
    best t], then, where the box rejects the ray (and the block is not
    deferred), the near-parallel guard, then the block's triangles with
    the plain scan's Möller–Trumbore (``ops.intersect._mt``, the division
    form ``mt_tri`` of the kernels); a hit replaces the best where it comes
    first in (t, input index) order (``index``), so the answer does not
    depend on the blocks' order and ties go to the lowest input index, as
    the plain scan's do. The deferred blocks' guard runs in a second pass
    over the rays' final windows. A soup of at most ``ZCOUNT_BLOCK``
    triangles is tested as given, up to its last active triangle. With a
    ``counts`` dict it records the tests kernel 1 makes per ray (``box``,
    ``guard``, ``guard_cone``, ``guard_tri``, ``tri``, each [H, W]);
    ``order`` picks the blocks' order as ``soup_blocks`` does (by default
    the kernel's); ``guard=False`` lets the box alone decide (the tests the
    cull itself needs; its answer may then miss a hit on a near-parallel
    ray).

    The box rule's window. ``any_hit_culled``'s bound takes |t*| <= dist for
    the exact plane crossing t* of an accepted hit, and a closest-hit
    window [0, best t] is infinite until the ray's first hit. So the guard
    takes the window min(best t, D), D = ``CLOSEST_REACH`` · l0 = l0, l0 =
    |o - c|₁ + row 9 (three L1 half-diagonals h of the grown box, h >= 3g
    since every side is at least 2g): reach = l0 + min(best t, D). Where
    best t <= D the bound is the any-hit one. Else a triangle whose
    crossing has |t*| <= D is covered by the bound with dist = D, and one
    with |t*| > D cannot accept the ray: every point of the triangle lies
    within h of c, so the crossing is at least |t*||d| - |o - c|₂ - h >=
    (|t*| - D) + 2h - 2^-21 |t*| from it (|d| = 1 within ``vnormalize``'s
    rounding), while the test accepts only points within 20.4u (l0 +
    |t*|) / s of it (s as there), and a ray the guard lets go has s >
    64u · 2 l0 / g; so the accepted point would lie within 0.16 g (1 +
    |t*| / l0) of the crossing, less than that distance since h >= 3g and
    l0 >= 9g. This is the box rule: it rests on the box
    test's failure, and holds where reach < row 10.

    The distance rule. Far from a block the box rule keeps more than it
    must: the ray misses the grown box by g at least, but its line may
    pass far from the block. With delta a lower bound of the distance from
    the ray's line to every point of the block (|(c - o) × d| less row 9
    / 3, the grown box's L1 half-diagonal, each rounded down), take the
    growth g' = min(2.5 delta, 0.2 l0) in g's place: where g' > g, a ray
    with s > 64u · 2 l0 / g' for each triangle, i.e. |d·m| > 2 l0 g / g',
    cannot be accepted. For |t*| <= l0 the test accepts only points within
    20.4u (l0 + |t*|) / s < 0.32 g' <= 0.8 delta of the crossing, nearer
    than the line comes to the triangle; for |t*| = k l0 > l0 within 0.16
    g' (1 + k), under delta for k <= 1.1 (0.84 delta) and under (k - 1) l0
    <= the crossing's distance from the block beyond (g' <= 0.2 l0), and
    s > 640u keeps det's error small, as there. The guard keeps a block
    where some triangle has |d·m| at most the smaller reach of the rules
    that hold, and wholly where neither holds. A block is thus only
    dropped where no triangle of it can be accepted at t <= best t (the
    margins leave the boundary strict), and the answer is the plain scan's
    on every ray."""
    h, w = rays.hw
    n = h * w
    dev = rays.origin.device
    o = [rays.origin[c].reshape(n) for c in range(3)]
    d = [rays.direction[c].reshape(n) for c in range(3)]
    cols = geometry.tri_cols.detach()
    direct = cols.shape[1] <= ZCOUNT_BLOCK
    if direct:
        index = torch.arange(cols.shape[1], device=dev)
    else:
        cols, boxes, guard_data, index = soup_blocks(geometry, order)
    index = index.long()
    best_t = torch.full((n,), float(t_max), device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    cnt = _walk_counts((n,), dev)

    def test(j0, j1, live):
        """Triangles [j0, j1) against the rays ``live``."""
        if live.numel() == 0 or j1 <= j0:
            return
        cnt["tri"][live] += j1 - j0
        ray = tuple(a[live][None] for a in o + d)
        t, u, v = _mt(ray, cols[:, j0:j1, None])  # [B, n], t inf off a hit
        t_min = t.amin(0)
        first = torch.where(t == t_min, index[j0:j1, None],
                            torch.iinfo(torch.int64).max)
        loc = first.argmin(0, keepdim=True)
        i_min = torch.gather(first, 0, loc)[0]
        bt, bi = best_t[live], best_i[live]
        better = torch.isfinite(t_min) & ((t_min < bt)
                                          | ((t_min == bt) & (i_min < bi)))
        best_t[live] = torch.where(better, t_min, bt)
        best_i[live] = torch.where(better, i_min, bi)
        best_u[live] = torch.where(better, torch.gather(u, 0, loc)[0],
                                   best_u[live])
        best_v[live] = torch.where(better, torch.gather(v, 0, loc)[0],
                                   best_v[live])

    every = torch.arange(n, device=dev)
    if direct:
        act = (cols[9] > 0.0).nonzero()
        test(0, int(act[-1]) + 1 if act.numel() else 0, every)
    else:
        inv = [_inv_dir(a) for a in d]
        defer = (boxes[12] > 0.5).tolist()
        ends = boxes[11].long().tolist()
        for b in range(boxes.shape[1]):
            ok = _box_ok(cnt, boxes, b, o, inv, best_t, every)
            if guard and not defer[b]:
                fail = every[~ok]
                ok[~ok] = _guard_keeps(cnt, boxes, guard_data, b, o, d,
                                       best_t[fail], fail, capped=True)
            test(b * ZCOUNT_BLOCK, b * ZCOUNT_BLOCK + ends[b], every[ok])
        for b in (b for b in range(boxes.shape[1]) if guard and defer[b]):
            cand = every[~_box_ok(cnt, boxes, b, o, inv, best_t, every)]
            keep = _guard_keeps(cnt, boxes, guard_data, b, o, d,
                                best_t[cand], cand, capped=True)
            test(b * ZCOUNT_BLOCK, b * ZCOUNT_BLOCK + ends[b], cand[keep])
    if counts is not None:
        counts.update({name: v.reshape(h, w) for name, v in cnt.items()})
    hit = best_i >= 0
    return (torch.where(hit, best_t, torch.inf).reshape(h, w),
            best_i.int().reshape(h, w), best_u.reshape(h, w),
            best_v.reshape(h, w))


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
    return out


def _cross_rows(p, q):
    """p × q of [..., 3] rows, each product rounded before the difference."""
    return torch.stack([p[..., 1] * q[..., 2] - p[..., 2] * q[..., 1],
                        p[..., 2] * q[..., 0] - p[..., 0] * q[..., 2],
                        p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]], dim=-1)


def plucker_rows(v0, e1, e2, active) -> torch.Tensor:
    """``plucker_matrix`` of the triangles v0, e1, e2 [T, 3] and the bool
    active [T] → [5T, 16]."""
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
    return rows * active.to(v0.dtype).repeat(5)[:, None]


def plucker_matrix(geometry) -> torch.Tensor:
    """[5T, 16] side constants of kernel 8 (the reference's
    ``pallas_trace.plucker_matrix``, built here with torch on the geometry's
    device): for the segment p0 → p0 + D, R = [D, M = p0 × D, p0, 1, 0...],
    rows [0, 3T) give the three Plücker edge sides [m_e, d_e]·R, rows
    [3T, 4T) the plane value s0 = n·p0 − n·a, rows [4T, 5T) ds = n·D.
    Inactive triangles get all-zero rows, which never occlude. The three
    edges are built as one batch, to keep the launches of a call few."""
    return plucker_rows(geometry.v0, geometry.e1, geometry.e2,
                        geometry.active)


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


# The compact slots of a triangle's kernel-8 constants (csrc/plucker.cu):
# the edge rows' columns 0-5 at 0, 8 and 16, the plane row's 6-9 at 24, the
# n·D row's 0-2 at 28 (a triangle is 32 floats, eight float4).
PLUCKER_SLOTS = 32
_SLOT_OF = [(k, j, (8 * k + j) if k < 3 else (18 + j) if k == 3 else 28 + j)
            for k, (lo, hi) in enumerate(PLUCKER_COLS) for j in range(lo, hi)]


def plucker_slots(table: torch.Tensor) -> torch.Tensor:
    """The [5T, 16] constants → [T, PLUCKER_SLOTS]: each triangle's
    ``PLUCKER_COLS`` of its five rows in kernel 8's slots (the same
    floats, zero elsewhere)."""
    t = table.shape[0] // 5
    c = table.reshape(5, t, 16)
    out = table.new_zeros((t, PLUCKER_SLOTS))
    for k, j, slot in _SLOT_OF:
        out[:, slot] = c[k, :, j]
    return out


# Kernel 8's guard (any_hit_plucker_culled): the reach's terms in the
# origin's norm and the window's length, and the share of the growth g
# added for the roundings of the guard's own products.
PLUCKER_REACH_O = 1.17
PLUCKER_REACH_LEN = 0.17
PLUCKER_REACH_G = 0.02
# Where the guard's bound is kept (else every block the box rejects is
# kept): the soup's vertices and the rays' origins within 1e12 of the
# origin (no product overflows), a triangle's within 1e-4 of it or beyond
# and of area above 1e-30 (no product underflows), windows in (1e-12,
# 1e12).
PLUCKER_FAR = 1e12
PLUCKER_NEAR = 1e-4
PLUCKER_LEN_MIN = 1e-12


@torch.no_grad()
def _plucker_guard(cols: torch.Tensor, boxes: torch.Tensor):
    """Kernel 8's guard data of the block-ordered columns [10, T'] and
    their boxes [13, nb] (``soup_blocks``) → (guard [5, T'], blocks [2,
    nb]), float32, computed in float64 from the float32 vertices a = v0,
    b = v0 + e1, c = v0 + e2 the constants are built from
    (``any_hit_plucker_culled`` derives each term), in the layout of
    ``zcount_blocks``' guard: rows 0-2 per triangle m = n·g /
    (320u·diam²) (n = (b − a) × (c − a), diam its longest edge, g its
    block's growth), 0 for an active triangle the bound does not cover,
    which the guard then always keeps, inf for an inactive one, which
    never occludes; rows 3-4 per pair of triangles the float4 (axis·μ,
    ρ·μ) of the cone of its unit normals (radius ρ about the axis; μ the
    smaller |m|; radius inf, no cone, where ρ > ``ZCOUNT_CONE``; −inf for
    a pair with no active triangle). Per block: row 0 Q, the largest of
    P²/diam + 0.26 P + 0.15 diam + (0.04 + 0.026 P/diam) g over its
    triangles (P the largest vertex norm), row 1 Q', the largest
    P²/diam, both grown by 1 %."""
    f64 = torch.float64
    u = 2.0 ** -24
    nb = boxes.shape[1]
    act = cols[9] > 0.0
    a32 = cols[0:3]
    a, b, c = (x.to(f64) for x in (a32, a32 + cols[3:6], a32 + cols[6:9]))
    n = torch.linalg.cross(b - a, c - a, dim=0)
    nn = torch.linalg.vector_norm(n, dim=0)
    diam = torch.stack([torch.linalg.vector_norm(x, dim=0)
                        for x in (b - a, c - b, a - c)]).amax(0)
    big = torch.stack([torch.linalg.vector_norm(x, dim=0)
                       for x in (a, b, c)]).amax(0)
    g = (boxes[10].to(f64) * 2.0 ** -21).repeat_interleave(ZCOUNT_BLOCK)
    live = (act & (nn > 1e-30) & (diam > 0.0) & (big >= PLUCKER_NEAR)
            & (big < PLUCKER_FAR))
    dsafe = torch.where(live, diam, 1.0)
    inf = float("inf")
    m = torch.where(live, n * g / (320.0 * u * dsafe * dsafe),
                    torch.where(act, 0.0, inf))
    p2d = big * big / dsafe
    q = p2d + 0.26 * big + 0.15 * diam + (0.04 + 0.026 * big / dsafe) * g
    q_b = torch.where(live, q, 0.0).reshape(nb, -1).amax(-1) * 1.01
    q2_b = torch.where(live, p2d, 0.0).reshape(nb, -1).amax(-1) * 1.01
    # The pairs' cones: the second unit normal turned toward the first.
    unit = torch.where(live, n / torch.where(live, nn, 1.0), 0.0)
    u0, u1 = unit[:, 0::2], unit[:, 1::2]
    ok0, ok1 = live[0::2], live[1::2]
    u1 = u1 * torch.where((u0 * u1).sum(0) < 0.0, -1.0, 1.0)
    axis = torch.where(ok0 & ok1, u0 + u1, torch.where(ok0, u0, u1))
    axis = axis / torch.linalg.vector_norm(axis, dim=0).clamp_min(1e-300)
    rho = torch.maximum(
        torch.where(ok0, torch.linalg.vector_norm(u0 - axis, dim=0), 0.0),
        torch.where(ok1, torch.linalg.vector_norm(u1 - axis, dim=0), 0.0))
    mag = torch.where(live, torch.linalg.vector_norm(m, dim=0),
                      torch.where(act, 0.0, inf))
    mu = torch.minimum(mag[0::2], mag[1::2])
    some = act[0::2] | act[1::2]
    mu = torch.where(some, mu, 0.0)
    radius = torch.where(rho > ZCOUNT_CONE, inf,
                         rho * mu * (1.0 + 2.0 ** -10) + 1e-30)
    cone = torch.cat([axis * mu, torch.where(some, radius, -inf)[None]]).T
    guard = torch.cat([m, cone.reshape(2, -1)])
    return (guard.to(cols.dtype).contiguous(),
            torch.stack([q_b, q2_b]).to(cols.dtype).contiguous())


def plucker_blocks(geometry):
    """Kernel 8's kept data of the soup → (table [5T', 16], slots [T',
    PLUCKER_SLOTS], boxes, guard, blocks). Of a soup of more than
    ``ZCOUNT_BLOCK`` triangles: the rows of ``plucker_matrix`` for the
    columns in ``soup_blocks``' order (a row permutation of the geometry's
    own, bit for bit, the padding zero rows), its slots, the blocks' boxes
    (``soup_blocks``' own) and kernel 8's guard (``_plucker_guard``); of a
    smaller soup the table and slots of the columns as given, the rest
    None. Kept on the geometry (``Geometry.plucker``) with the columns
    tensor it was built from, and rebuilt if the geometry's columns are
    another tensor or were written to, as ``soup_blocks`` keeps its
    blocks."""
    cols = geometry.tri_cols
    kept = geometry.plucker
    if kept is None or kept[0] is not cols or kept[1] != cols._version:
        with torch.no_grad():
            if cols.shape[1] <= ZCOUNT_BLOCK:
                c, boxes, guard, blocks = cols.detach(), None, None, None
            else:
                c, boxes, _ = zcount_blocks(geometry)
                guard, blocks = _plucker_guard(c, boxes)
            table = plucker_rows(c[0:3].T, c[3:6].T, c[6:9].T, c[9] > 0.0)
            out = (table, plucker_slots(table).contiguous(), boxes, guard,
                   blocks)
        kept = geometry.plucker = (cols, cols._version, out)
    return kept[2]


def _plucker_sides(c, r):
    """The five products of rays ``r`` [10, N] with triangles' constants
    ``c`` [5, B, 16] over ``PLUCKER_COLS``, left to right → the sign test
    and straddle's hit [B, N]."""
    sides = []
    for row, (lo, hi) in enumerate(PLUCKER_COLS):
        acc = c[row, :, lo, None] * r[lo]
        for j in range(lo + 1, hi):
            acc = acc + c[row, :, j, None] * r[j]
        sides.append(acc)
    e0, e1, e2, s0, ds = sides
    same = (((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0))
            | ((e0 <= 0.0) & (e1 <= 0.0) & (e2 <= 0.0)))
    return same & (s0 * (s0 + ds) < 0.0)


def _pairs_keep(n, guard_data, b, unit, idx, reach):
    """The pairs' cones of block b, then the normals of the pairs a cone
    does not rule out, against ``reach`` [idx] → kept [idx]."""
    ux, uy, uz = (a[idx] for a in unit)
    nrm, cones = guard_data[:3], guard_data[3:].reshape(-1, 4)
    near = torch.zeros_like(reach, dtype=torch.bool)
    for q in range(ZCOUNT_BLOCK // 2):
        c = cones[b * ZCOUNT_BLOCK // 2 + q]
        pair = ~near
        n["guard_cone"][idx[pair]] += 1
        pair &= ~((ux * c[0] + uy * c[1] + uz * c[2]).abs() - c[3] > reach)
        n["guard_tri"][idx[pair]] += 2
        for j in range(b * ZCOUNT_BLOCK + 2 * q,
                       b * ZCOUNT_BLOCK + 2 * q + 2):
            near |= pair & ((ux * nrm[0, j] + uy * nrm[1, j]
                             + uz * nrm[2, j]).abs() <= reach)
    return near


def _plucker_keeps(n, boxes, guard_data, blocks, b, o, unit, length,
                   norm_o, idx):
    """Kernel 8's guard of block b for the rays idx (their box test
    failed), in the kernel's order: where the box rule holds, the pairs
    against its reach (a block dropped there is dropped by the smaller
    reach too); then, for the rays it keeps or that it does not cover,
    the line rule's reach where it holds and is the smaller; the block is
    kept wholly where neither rule holds or the segment lies outside the
    bound's range (``any_hit_plucker_culled`` derives both)."""
    n["guard"][idx] += 1
    ox, oy, oz = (a[idx] for a in o)
    ux, uy, uz = (a[idx] for a in unit)
    ln, no = length[idx], norm_o[idx]
    l0 = ((ox - boxes[6, b]).abs() + (oy - boxes[7, b]).abs()
          + (oz - boxes[8, b]).abs() + boxes[9, b])
    g = boxes[10, b] * 2.0 ** -21  # row 10 = g / 8u
    ok = (ln > PLUCKER_LEN_MIN) & (ln < PLUCKER_FAR) & (no < PLUCKER_FAR)
    box_rule = ok & (l0 + ln < boxes[10, b])
    reach = torch.where(
        box_rule, (blocks[0, b] + PLUCKER_REACH_O * no + PLUCKER_REACH_LEN * ln)
        * 1.001 + PLUCKER_REACH_G * g, torch.inf)
    keep = ~ok
    first = box_rule.nonzero().squeeze(1)
    held = torch.zeros_like(keep)
    held[first] = _pairs_keep(n, guard_data, b, unit, idx[first],
                              reach[first])
    rest = ok & (~box_rule | held)  # the line rule may still drop these
    cx, cy, cz = boxes[6, b] - ox, boxes[7, b] - oy, boxes[8, b] - oz
    qx = cy * uz - cz * uy
    qy = cz * ux - cx * uz
    qz = cx * uy - cy * ux
    delta = ((qx * qx + qy * qy + qz * qz).sqrt() * (1.0 - 2.0 ** -16)
             - boxes[9, b] * (1.0 / 3.0)
             - 2.0 ** -16 * (cx.abs() + cy.abs() + cz.abs()))
    line = (g * 0.125 / delta) * (blocks[1, b] + no) * 1.001 + PLUCKER_REACH_G * g
    try_line = rest & (delta > 0.0) & (line < reach)
    keep |= rest & ~try_line
    second = try_line.nonzero().squeeze(1)
    keep[second] = _pairs_keep(n, guard_data, b, unit, idx[second],
                               line[second])
    return keep


def any_hit_plucker_culled(origins, dirs, t_max, geometry, counts=None,
                           guard: bool = True) -> torch.Tensor:
    """A plain model of kernel 8's culled walk (``csrc/cull.cuh``'s
    ``soup_any`` with the Plücker test): ``any_hit_plucker``'s contract,
    origins [..., 3, H, W], dirs broadcastable to them, t_max [..., H, W]
    → bool [..., H, W], ``any_hit_plucker_plain``'s on every ray (a
    negative t_max is the segment (−d, −t_max), the same D and M bit for
    bit; t_max = 0 never occludes). A soup of more than
    ``ZCOUNT_BLOCK`` triangles is walked over the blocks of
    ``soup_blocks`` (``plucker_blocks``: the constants are
    ``plucker_matrix``'s rows in the blocks' order): each ray's slab test
    of a block's box over [0, t_max], where it fails kernel 8's own
    near-parallel guard (derived below; deferred to a second pass over
    the rays left pending for the blocks ``zcount_blocks`` does not flag,
    those whose pairs have cones), then the block's triangles
    with ``any_hit_plucker_plain``'s products and sign test, up to the
    first hit. A smaller soup tests its triangles as given. With a
    ``counts`` dict it records the tests kernel 8 makes per ray (``box``,
    ``guard``, ``guard_cone``, ``guard_tri``, ``tri``, each [..., H, W]);
    ``guard=False`` lets the box alone decide (the tests the cull needs;
    its bool may then miss a hit).

    Why the cull leaves the bool unchanged. Kernels 1, 4, 6 and 7 bound
    Möller–Trumbore's rounding by the origin's distance to the block
    (``any_hit_culled``); the Plücker sides cancel world-frame terms, so
    their guard does not serve here, and kernel 8 has its own, on the same
    boxes. Write u = 2^-24; a, b, c the float32 vertices the constants are
    built from (the box holds them: ``soup_blocks`` forms v0 + e1 and v0 +
    e2 as ``plucker_rows`` does), n = (b − a) × (c − a) exactly, N its unit,
    diam the longest edge, P the largest vertex norm; D̃ = fl(t_max·d);
    d̂ = d/|d|, cos = d̂·N.

    The sign test. An edge p → q's side fl(m·D̃ + d_e·M) (six products
    left to right, m = fl(p × q), d_e = fl(q − p), M = fl(p0 × D̃)) is
    within E = 10u|D|(P² + diam|p0|) of the exact D̃·((p − p0) × (q −
    p0)) (a cross product's rounding is at most 2.83u|x||y|, the sum's
    6u of its terms' magnitudes, the difference u|q − p|). With X the
    point where the line crosses the plane of abc, that exact side is
    (D̃·N)|q − p|σ, σ the signed distance of X from the edge's line in
    the plane. So a wrong sign needs |σ| <= E/(|D̃·N||q − p|) = h_e κ_e,
    κ_e = E/(|D̃·N|·|n|), h_e the edge's altitude; with κ the largest,
    every barycentric coordinate of an accepted X is at least −2κ (all
    signs ≥ 0: each ≥ −κ; all ≤ 0: each ≤ κ and they sum to 1), so X lies
    within 4κ·diam of the triangle: r1 = K/|cos|, K = 40u·diam(P² +
    diam|p0|)/|n|.
    The straddle. fl(s0) and fl(s0 + ds) lie within ε = 7u|ñ|(|p0| + P
    + |D|) of the exact values of ñ·(x − a) at the segment's ends, ñ =
    fl(e1 × e2); so it accepts only a segment that crosses the plane of
    ñ through a, or ends within ε/|ñ| of it. That plane leans on the
    true one by τ <= u(6 diam² + 4.1 P diam)/|n| (ñ's rounding and b −
    a = e1 within u|b|). So, where |cos| >= 2τ, a point Z of the segment
    lies within (2K + 2ε/|ñ| + 2τ·diam)/|cos| of the triangle.
    The box rule. A ray the slab test rejects over [0, t_max] stays g/2
    from the block (while L = l0 + len < g/8u, row 10, ``zcount_blocks``;
    len = t_max|d|), and the segment p0 → p0 + D̃ within uL < g/8 of it,
    so the triangle accepts it only if |cos| <= max(2τ, 8(K + ε/|ñ| +
    τ·diam)/g). With Y = 320u·diam²/|n| and m = N·g/Y (the guard's):
    |d̂·m| <= P²/diam + |p0| + 0.152(|p0| + len) + 0.255P + 0.15 diam +
    (0.0375 + 0.0257 P/diam)g (|n| <= 0.866 diam², so 56u/Y <= 0.152)
    <= Q + 1.17|p0| + 0.17 len (row 0: Q).
    The line rule. The sign test alone needs r1 >= the line's distance
    δ from the triangle, i.e. |cos| <= K/δ, |d̂·m| <= (g/8δ)(P²/diam +
    |p0|) <= (g/8δ)(Q' + |p0|) (row 1); δ is bounded below as kernel 1
    bounds it (the line's distance from the block's centre less its L1
    half-diagonal). It needs no box test: far from a block's line it is
    the tighter.
    A hit the cull would drop thus needs |d̂·m| at most the smaller reach
    of the rules that hold; the guard keeps the block where a triangle
    has it (a pair's cone first: |d̂·m| >= μ(|d̂·a| − ρ)), wholly
    where neither rule holds, and 0.02g and 0.1 % cover the roundings of
    cos, D̃ and the guard's own products. Overflow and underflow would
    void the relative bounds: the guard keeps every block for a window
    outside (1e-12, 1e12) or an origin beyond 1e12, and treats a
    triangle beyond 1e12, within 1e-4 of the origin or of area under
    1e-30 as always kept (m = 0). A block is thus dropped only where no
    triangle of it can accept the segment, and the bool is the plain
    version's on every ray. The error grows with P²/diam: for a soup far
    from the origin the reach covers most directions and the guard keeps
    most blocks; the bool stays exact."""
    n_t = geometry.tri_cols.shape[1]
    table, _, boxes, guard_data, blocks = plucker_blocks(geometry)
    direct = n_t <= ZCOUNT_BLOCK
    cols = geometry.tri_cols.detach() if direct else zcount_blocks(geometry)[0]
    if direct:
        boxes = cols.new_zeros((13, 1))
    c = table.reshape(5, -1, 16)
    lead = tuple(t_max.shape)
    o = [origins.select(-3, k).expand(lead).reshape(-1) for k in range(3)]
    dist = t_max.reshape(-1)
    # A negative t_max: the segment (−d, −t_max), whose D and M are the
    # same floats.
    flip = torch.where(dist < 0.0, -1.0, 1.0)
    d = [dirs.expand(origins.shape).select(-3, k).expand(lead).reshape(-1)
         * flip for k in range(3)]
    dist = dist.abs()
    big = [dist * a for a in d]
    r = torch.stack(big + [o[1] * big[2] - o[2] * big[1],
                           o[2] * big[0] - o[0] * big[2],
                           o[0] * big[1] - o[1] * big[0]]
                    + o + [torch.ones_like(dist)])

    def test(b, live):
        cb = c[:, b * ZCOUNT_BLOCK:(b + 1) * ZCOUNT_BLOCK]
        if cb.shape[1] == 0:  # an empty soup: nothing to hit
            none = torch.zeros(live.shape, dtype=torch.int64,
                               device=live.device)
            return none.bool(), none
        hit = _plucker_sides(cb, r[:, live])
        act = cols[9, b * ZCOUNT_BLOCK:(b + 1) * ZCOUNT_BLOCK] > 0.0
        return hit.any(dim=0), _first_tests(hit, act)

    unit, length = _guard_rays(d, dist)
    norm_o = (o[0] * o[0] + o[1] * o[1] + o[2] * o[2]).sqrt()

    def keeps(n, b, idx):
        return _plucker_keeps(n, boxes, guard_data, blocks, b, o, unit,
                              length, norm_o, idx)

    occluded, n = _culled_walk(o, d, dist, boxes, (boxes[12] <= 0.5).tolist(),
                               test, keeps if guard else None, direct=direct)
    if counts is not None:
        counts.update({name: v.reshape(lead) for name, v in n.items()})
    return occluded.reshape(lead)


def _ray_args(origins, dirs, t_max, name):
    """The kernels' flat ray planes: (o, d, t_max, h, w, planes) with
    origins [..., 3, H, W] and dirs expanded to them, contiguous."""
    lead = tuple(origins.shape[:-3])
    h, w = origins.shape[-2:]
    if origins.shape[-3] != 3 or tuple(t_max.shape) != lead + (h, w):
        raise ValueError(f"{name}: origins {tuple(origins.shape)} and t_max "
                         f"{tuple(t_max.shape)} do not match")
    if h * w >= 2 ** 31:
        raise ValueError(f"{name}: {h}x{w} pixels exceed 32-bit indexing")
    o = origins.contiguous()
    d = dirs.expand(origins.shape).contiguous()
    tm = t_max.contiguous()
    _build.check(o, "origins", torch.float32)
    _build.check(d, "dirs", torch.float32)
    _build.check(tm, "t_max", torch.float32)
    return o, d, tm, h, w, math.prod(lead)


def any_hit_plucker(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion by the Plücker sign test (the reference's
    ``pallas_any_mxu``), ``any_hit``'s contract: origins [..., 3, H, W],
    dirs broadcastable to them, t_max [..., H, W] → bool [..., H, W], True
    where the segment p0 → p0 + t_max·d crosses an active triangle; the
    leading axes are kept. The side constants are ``plucker_matrix``'s
    rows, kept with the soup (``plucker_blocks``: built at the soup's
    first call, in the blocks' order for a culled soup, and rebuilt when
    its columns are written to); the result is the plain version's
    whichever call builds them. Soup only, at most ``MAX_SOUP_TRIS``
    triangles on the card. Kernel 8 for CUDA tensors (a soup of more than
    ``ZCOUNT_BLOCK`` triangles culled, ``any_hit_plucker_culled``), the
    plain version for CPU tensors."""
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
    _build.check(geometry.tri_cols, "tri_cols", torch.float32)
    o, d, tm, h, w, planes = _ray_args(origins, dirs, t_max,
                                       "any_hit_plucker")
    _, slots, boxes, guard, blocks = plucker_blocks(geometry)
    cols = None if boxes is None else zcount_blocks(geometry)[0]
    out = torch.empty(lead + (h, w), dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_any_hit_plucker", o.data_ptr(), d.data_ptr(),
                      tm.data_ptr(), h, w, planes, slots.data_ptr(),
                      _ptr(cols), _ptr(boxes), _ptr(guard), _ptr(blocks),
                      slots.shape[0], out.data_ptr())
    return out


def _ptr(a):
    return None if a is None else a.data_ptr()
