"""Threaded BVH traversal, the plain version (reference
``romis_tpu/ops/traverse.py``).

Every ray holds one cursor into the DFS-preorder skip-link tree
(``ops/bvh.py``); per step it tests the cursor node's box (slab test against
its running t_max), then either tests the node's leaf triangles and
follows ``miss_link``, descends to cursor + 1 on an inner box hit, or follows
``miss_link`` on a miss. The closest hit prunes with its running best t and
keeps the first hit found in traversal order on ties (``t < best_t``); the
any-hit stops a ray at its first accepted hit. The arithmetic is the
reference's: the 1e-12 guard of the inverse direction, the slab test
``tnear <= tfar & tfar >= 0 & tnear <= t_max``, Möller–Trumbore with
``MT_EPSILON = 1e-9`` (``ops.intersect.mt_one``).

One deliberate departure: a leaf's triangles are all tested. The reference
unrolls its leaf loop to ``MAX_LEAF = 4`` slots, but the SAH builder emits
leaves of up to 16 triangles (when SAH stops at <= 2·max_leaf, or when all
centroids fall in one bin), whose triangles 5-16 the reference's XLA
traversal would miss; here the loop runs to the tree's largest leaf
(``BVH.max_leaf_count``). On trees whose leaves hold at most 4 triangles the
two agree exactly.

These are the plain versions of kernels 18, 19 and 20 (``ops/walk.py``,
``csrc/walk.cu``). The whole ray set advances in lockstep, and finished rays
are dropped from the working set after every step, so the work follows the
rays still walking. ``counts`` (a dict) receives the box tests and the
triangle tests each ray made (int64, shaped like the rays' pixels), the
work the kernels' bound counts.
"""

from __future__ import annotations

import torch

from ..core.types import Rays
from .intersect import mt_one


def inv_direction(d: torch.Tensor) -> torch.Tensor:
    """1/d with the reference's guard: 1e12 where |d| <= 1e-12."""
    big = torch.abs(d) > 1e-12
    return torch.where(big, 1.0 / torch.where(big, d, 1.0), 1e12)


def slab_test(bvh, node, o, inv_d, t_max) -> torch.Tensor:
    """Ray-box slab test of node [N] (long) for rays o, inv_d [3, N] and
    t_max [N] → bool [N]."""
    t0x = (bvh.bmin_x[node] - o[0]) * inv_d[0]
    t1x = (bvh.bmax_x[node] - o[0]) * inv_d[0]
    t0y = (bvh.bmin_y[node] - o[1]) * inv_d[1]
    t1y = (bvh.bmax_y[node] - o[1]) * inv_d[1]
    t0z = (bvh.bmin_z[node] - o[2]) * inv_d[2]
    t1z = (bvh.bmax_z[node] - o[2]) * inv_d[2]
    tnear = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                        torch.minimum(t0y, t1y)),
                          torch.minimum(t0z, t1z))
    tfar = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_max)


def _mt(o, d, cols, idx):
    """``mt_one`` of rays o, d [3, N] against triangles idx [N] of the
    [10, T] columns → (t, u, v, ok) [N]."""
    g = cols[:9, idx, None]  # [9, N, 1]: vectors on the -3 axis
    t, u, v, ok = mt_one(o[:, :, None], d[:, :, None], g[0:3], g[3:6],
                         g[6:9])
    return t[:, 0], u[:, 0], v[:, 0], ok[:, 0]


class _Counts:
    """Per-ray box and triangle tests, accumulated into ``out`` (a dict)
    when given."""

    def __init__(self, out, n, device):
        self.out = out
        if out is not None:
            self.box = torch.zeros(n, dtype=torch.int64, device=device)
            self.tri = torch.zeros(n, dtype=torch.int64, device=device)

    def add(self, ray, box_hit, leaf_n):
        if self.out is not None:
            self.box.index_add_(0, ray, torch.ones_like(ray))
            self.tri.index_add_(0, ray, torch.where(box_hit, leaf_n, 0).long())

    def done(self, shape):
        if self.out is not None:
            self.out["box"] = self.box.reshape(shape)
            self.out["tri"] = self.tri.reshape(shape)


def bvh_closest(rays: Rays, geometry, bvh, t_max=None, counts=None):
    """Closest hit by the threaded walk: rays [3, H, W] → (t, tri int32, u,
    v), each [H, W]; tri = -1 and u = v = 0 on a miss, where t is t_max (inf
    without a cap), as in the reference. ``tri`` indexes the BVH-permuted
    geometry."""
    h, w = rays.hw
    dev = rays.origin.device
    n = h * w
    o_all = rays.origin.reshape(3, n)
    d_all = rays.direction.reshape(3, n)
    inv_all = inv_direction(d_all)
    best_t = (torch.full((n,), torch.inf, device=dev) if t_max is None
              else t_max.reshape(n).to(torch.float32).clone())
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    n_tris = geometry.tri_cols.shape[1]
    cnt = _Counts(counts, n, dev)

    ray = torch.arange(n, device=dev)
    cursor = torch.zeros(n, dtype=torch.long, device=dev)
    while ray.numel():
        o, d, inv = o_all[:, ray], d_all[:, ray], inv_all[:, ray]
        count = bvh.leaf_count[cursor]
        first = bvh.leaf_first[cursor]
        is_leaf = count > 0
        box_hit = slab_test(bvh, cursor, o, inv, best_t[ray])
        at_leaf = box_hit & is_leaf
        cnt.add(ray, at_leaf, count)
        # The leaf tests of the rays at a leaf they hit (for the others
        # the reference's ok is False).
        sel = at_leaf.nonzero().squeeze(1)
        if sel.numel():
            r = ray[sel]
            os_, ds_, cs, fs = o[:, sel], d[:, sel], count[sel], first[sel]
            bt, bi, bu, bv = best_t[r], best_i[r], best_u[r], best_v[r]
            for j in range(bvh.max_leaf_count):
                tri_idx = torch.clamp_max(fs + j, n_tris - 1)
                t, u, v, ok = _mt(os_, ds_, geometry.tri_cols, tri_idx)
                ok = ok & (j < cs) & (t < bt)
                bt = torch.where(ok, t, bt)
                bi = torch.where(ok, tri_idx, bi)
                bu = torch.where(ok, u, bu)
                bv = torch.where(ok, v, bv)
            best_t[r], best_i[r], best_u[r], best_v[r] = bt, bi, bu, bv
        nxt = torch.where(box_hit & ~is_leaf, cursor + 1,
                          bvh.miss_link[cursor].long())
        keep = (nxt >= 0).nonzero().squeeze(1)
        ray, cursor = ray[keep], nxt[keep]
    cnt.done((h, w))
    return (best_t.reshape(h, w), best_i.reshape(h, w),
            best_u.reshape(h, w), best_v.reshape(h, w))


def bvh_any(origins, dirs, t_max, geometry, bvh, counts=None) -> torch.Tensor:
    """Occlusion by the threaded walk, each ray stopping at its first
    accepted hit: origins [..., 3, H, W], dirs broadcastable to them, t_max
    [..., H, W] → bool [..., H, W], True where a triangle lies at t in
    (0, t_max)."""
    lead = tuple(origins.shape[:-3])
    h, w = origins.shape[-2:]
    dev = origins.device
    shape = lead + (h, w)
    n = 1
    for s in shape:
        n *= s

    def flat(a):  # [..., 3, H, W] → [3, N], rays in (lead, pixel) order
        return a.expand(lead + (3, h, w)).reshape(-1, 3, h * w) \
            .transpose(0, 1).reshape(3, n)

    o_all, d_all = flat(origins), flat(dirs)
    inv_all = inv_direction(d_all)
    tm_all = t_max.expand(shape).reshape(n)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    n_tris = geometry.tri_cols.shape[1]
    cnt = _Counts(counts, n, dev)

    ray = torch.arange(n, device=dev)
    cursor = torch.zeros(n, dtype=torch.long, device=dev)
    while ray.numel():
        o, d, inv, tm = o_all[:, ray], d_all[:, ray], inv_all[:, ray], \
            tm_all[ray]
        count = bvh.leaf_count[cursor]
        first = bvh.leaf_first[cursor]
        is_leaf = count > 0
        box_hit = slab_test(bvh, cursor, o, inv, tm)
        at_leaf = box_hit & is_leaf
        cnt.add(ray, at_leaf, count)
        hit_any = torch.zeros(ray.shape, dtype=torch.bool, device=dev)
        sel = at_leaf.nonzero().squeeze(1)
        if sel.numel():
            os_, ds_, cs, fs, ts = (o[:, sel], d[:, sel], count[sel],
                                    first[sel], tm[sel])
            hit = torch.zeros(sel.shape, dtype=torch.bool, device=dev)
            for j in range(bvh.max_leaf_count):
                tri_idx = torch.clamp_max(fs + j, n_tris - 1)
                t, _, _, ok = _mt(os_, ds_, geometry.tri_cols, tri_idx)
                hit = hit | (ok & (j < cs) & (t < ts))
            hit_any[sel] = hit
        occluded[ray] = hit_any
        nxt = torch.where(box_hit & ~is_leaf, cursor + 1,
                          bvh.miss_link[cursor].long())
        keep = ((nxt >= 0) & ~hit_any).nonzero().squeeze(1)
        ray, cursor = ray[keep], nxt[keep]
    cnt.done(shape)
    return occluded.reshape(shape)
