"""Ray-triangle intersection by brute force over the soup, and the hit
attributes (reference ``romis_tpu/ops/intersect.py``).

``intersect_closest`` and ``intersect_any`` are the plain block scans:
Möller–Trumbore of every ray against a block of triangles at a time, a
running best across blocks. They are the plain versions of kernels 1 and 6.
On geometry that carries a BVH (``ops.bvh.with_bvh``) both dispatch to the
plain threaded traversal (``ops/traverse.py``), as the reference's do off
the TPU.
``reeval_tuv`` re-evaluates (t, u, v) of already selected triangles
differentiably: the backward of the closest hit (``ops.trace.closest_hit``).

Semantics: closest hit accepts t in (0, t_max) and returns barycentrics
(u toward v1, v toward v2); any-hit accepts t in (0, t_max); ties in t go to
the lowest triangle index.
"""

from __future__ import annotations

import torch

from ..core.features import Features

from ..core.types import HitRecord, Rays, ShadeCtx
from ..core.vec import comp, e, vcross, vdot, vnorm
from .rows import gather_rows
from .shading import acquire_texel

MT_EPSILON = 1e-9


def _pick_block(rays_size: int, num_tris: int, budget: int = 1 << 24) -> int:
    """Triangles per block so a [block, rays] temporary holds ~budget
    elements."""
    return max(1, min(num_tris, budget // max(rays_size, 1)))


def _mt(ray, tri):
    """Möller–Trumbore on component planes. ray = (ox, oy, oz, dx, dy, dz),
    each [..., 1, H, W]; tri = the [10, B] triangle columns as [10, B, 1, 1].
    → (t, u, v) [..., B, H, W], t = inf on a miss."""
    ox, oy, oz, dx, dy, dz = ray
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, act = tri
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) > MT_EPSILON
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0) & (act > 0.0))
    return torch.where(ok, t, torch.inf), u, v


def mt_one(o, d, v0, e1, e2):
    """Möller–Trumbore against one gathered triangle per ray (reference
    ``ops/traverse._mt_one``). All vectors [..., 3, H, W] → (t, u, v, ok),
    each [..., H, W]."""
    pvec = vcross(d, e2)
    det = vdot(e1, pvec)
    det_ok = torch.abs(det) > MT_EPSILON
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = o - v0
    u = vdot(tvec, pvec) * inv_det
    qvec = vcross(tvec, e1)
    v = vdot(d, qvec) * inv_det
    t = vdot(e2, qvec) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0))
    return t, u, v, ok


def reeval_tuv(rays: Rays, v0, e1, e2, tri, gather=gather_rows):
    """(t, u, v) of the already selected triangles ``tri`` [H, W] (-1 on a
    miss), differentiable in the rays and the vertex columns v0/e1/e2
    [T, 3] (reference ``ops/intersect._reeval_tuv``): ONE row gather of the
    packed [T, 9] v0|e1|e2 table, rebuilt here so that gradients reach the
    live columns, then Möller–Trumbore. Misses give (inf, 0, 0)."""
    rows = gather(torch.cat([v0, e1, e2], dim=1), torch.clamp_min(tri, 0))
    t, u, v, _ = mt_one(rays.origin, rays.direction, rows[0:3], rows[3:6],
                        rows[6:9])
    valid = tri >= 0
    return (torch.where(valid, t, torch.inf), torch.where(valid, u, 0.0),
            torch.where(valid, v, 0.0))


def _ray_planes(origins, dirs):
    """[..., 3, H, W] origins/directions → six [..., 1, H, W] planes."""
    d = dirs.expand(origins.shape)
    return tuple(comp(a, i).unsqueeze(-3) for a in (origins, d)
                 for i in range(3))


def intersect_closest(rays: Rays, geometry, t_max=None):
    """Closest hit of rays [3, H, W] against the whole soup → (t, tri int32,
    u, v), each [H, W]; t = inf, tri = -1 on a miss. BVH geometry: the
    plain traversal ``ops.traverse.bvh_closest``."""
    if geometry.bvh is not None:
        from .traverse import bvh_closest

        return bvh_closest(rays, geometry, geometry.bvh, t_max)
    h, w = rays.hw
    dev = rays.origin.device
    ray = _ray_planes(rays.origin, rays.direction)
    tmax0 = torch.full((h, w), torch.inf, device=dev) if t_max is None \
        else t_max
    cols = geometry.tri_cols  # [10, T]
    n = cols.shape[1]
    block = _pick_block(h * w, n)
    best_t = torch.full((h, w), torch.inf, device=dev)
    best_i = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((h, w), device=dev)
    best_v = torch.zeros((h, w), device=dev)
    for base in range(0, n, block):
        tri = cols[:, base:base + block, None, None]
        t, u, v = _mt(ray, tri)  # [B, H, W]
        t = torch.where(t < tmax0, t, torch.inf)
        loc = torch.argmin(t, dim=0, keepdim=True)  # first minimum wins ties
        t_b = torch.gather(t, 0, loc)[0]
        better = t_b < best_t
        best_t = torch.where(better, t_b, best_t)
        best_i = torch.where(better, loc[0].int() + base, best_i)
        best_u = torch.where(better, torch.gather(u, 0, loc)[0], best_u)
        best_v = torch.where(better, torch.gather(v, 0, loc)[0], best_v)
    return best_t, best_i, best_u, best_v


def intersect_any(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion: True where a triangle lies at t in (0, t_max).
    origins/dirs [..., 3, H, W], t_max [..., H, W] → bool [..., H, W]. BVH
    geometry: the plain traversal ``ops.traverse.bvh_any``."""
    if geometry.bvh is not None:
        from .traverse import bvh_any

        return bvh_any(origins, dirs, t_max, geometry, geometry.bvh)
    ray = _ray_planes(origins, dirs)
    cols = geometry.tri_cols
    n = cols.shape[1]
    block = _pick_block(t_max.numel(), n)
    occluded = torch.zeros(t_max.shape, dtype=torch.bool,
                           device=origins.device)
    tm = t_max.unsqueeze(-3)
    for base in range(0, n, block):
        t, _, _ = _mt(ray, cols[:, base:base + block, None, None])
        occluded = occluded | (t < tm).any(dim=-3)
    return occluded


def make_hit_record(rays: Rays, geometry, t, tri, u, v,
                    gather=gather_rows) -> HitRecord:
    """Interpolated hit attributes from ONE packed attr-row gather per pixel
    (``Geometry.attr_rows``); shading normals are normalized."""
    valid = torch.isfinite(t)
    rows = gather(geometry.attr_rows, torch.clamp_min(tri, 0))  # [24, H, W]
    bw = e(1.0 - u - v)
    bu = e(u)
    bv = e(v)
    normal = bw * rows[0:3] + bu * rows[3:6] + bv * rows[6:9]
    normal = normal / torch.clamp_min(e(vnorm(normal)), 1e-20)
    uv = bw * rows[9:11] + bu * rows[11:13] + bv * rows[13:15]
    ev = e(valid)
    return HitRecord(
        valid=valid,
        t=t,
        normal=torch.where(ev, normal, 0.0),
        uv=torch.where(ev, uv, 0.0),
        mat_id=torch.where(valid, rows[15].int(), 0),
        geom_id=torch.where(valid, rows[16].int(), -1),
        prim_id=torch.where(valid, tri, -1),
    )


def make_shade_ctx(rays: Rays, hits: HitRecord, geometry, features: Features,
                   gather=gather_rows) -> ShadeCtx:
    """The receiver context: hit position, normal, view origin, material
    from ONE packed mat-row gather (``Geometry.mat_rows``), texture
    overlay."""
    safe_t = torch.where(hits.valid, hits.t, 0.0)
    position = rays.origin + e(safe_t) * rays.direction
    rows = gather(geometry.mat_rows, hits.mat_id)  # [8, H, W]
    kd = rows[0:3]
    tex_id = rows[7].int()
    if features.enable_texture_mapping and geometry.tex_data.shape[1] > 1:
        texel = acquire_texel(geometry.tex_data, geometry.tex_size, tex_id,
                              hits.uv)
        kd = torch.where(e(tex_id >= 0), texel, kd)
    return ShadeCtx(
        valid=hits.valid,
        position=position,
        normal=hits.normal,
        view_origin=rays.origin,
        kd=kd,
        ks=rows[3:6],
        shininess=rows[6],
        geom_id=hits.geom_id,
        depth_t=safe_t,
    )
