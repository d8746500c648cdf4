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

``bvh_closest_ordered`` is a plain model of kernel 18's own walk, which
visits the nearer child first, and ``bvh_any_wide`` of kernel 19's, on the
same two-box records (the tests each kernel makes, for the CPU tests and
the bounds); their plain versions stay ``bvh_closest`` and ``bvh_any``.
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


WALK_STACK = 32  # entries of kernel 18's stack (csrc/walk.cuh kWalkStack)
LOOSE = 1.0 + 2.0 ** -14  # its box test's slack over the best t (kLoose)


def _slabs(lo, hi, o, inv):
    """``slab_test``'s (tnear, tfar) of boxes lo, hi [3, N] for rays o,
    inv [3, N], in its order of operations."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                     torch.minimum(t0[1], t1[1])),
                       torch.minimum(t0[2], t1[2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                     torch.maximum(t0[1], t1[1])),
                       torch.maximum(t0[2], t1[2]))
    return tn, tf


def bvh_closest_ordered(rays: Rays, geometry, bvh, t_max=None, counts=None):
    """A plain model of kernel 18's walk: ``bvh_closest``'s contract and,
    on the rays its certainty test passes, its bits (the rest it walks
    again with ``bvh_closest``, as the kernel does).

    Each ray tests the root's box, then at an inner node both children's
    boxes from ``bvh.wide`` (``slab_test``'s arithmetic) and goes to the
    nearer (the smaller tnear; the left on a tie), pushing the farther on a
    stack of ``WALK_STACK`` entries; a leaf's triangles are tested in
    order. A hit replaces the best where it comes first in (t, index)
    order, so ties go to the lowest index. A box is entered where the plain
    test passes it with the ray's t_max (tnear <= tfar, tfar >= 0, tnear <=
    t_max) and where ``pm``, the largest tnear on its path from the root,
    is at most the best t times ``LOOSE``; a popped entry is dropped when
    its ``pm`` is not.

    Why the answer is the plain walk's. The plain walk enters a box where
    tnear <= its best t when it gets there; its leaves come in preorder in
    ascending ``leaf_first``, so its strict ``t < best_t`` keeps the lowest
    index on ties. Let m be the first in (t, index) order of the hits in
    the leaves whose boxes pass with t_max alone. A walk tests m where
    every box on m's path has tnear <= its best t then, which holds
    whatever the order if ``pm(m)`` <= t_m: then both walks find m. The
    rounding of the slab test and of Möller–Trumbore can put a box's tnear
    a few ulps above the t of a triangle inside it (``pm(m)`` > t_m); the
    plain walk then misses m only if it found before, in preorder, a hit y
    with t_m < t_y < ``pm(m)``. So the walk keeps ``t2``, the least t of
    its other hits (replaced bests included), and its answer stands unless
    ``pm(best)`` > best t and ``t2`` < ``pm(best)``; such a ray (or one
    whose stack overflows) is walked again by the plain walk. The slack
    ``LOOSE`` makes the walk see every hit y that could do so, on the
    assumption that no hit's t lies more than 2**-16 of it below the
    tnear of a box on its path (tens of ulps is what the rounding gives a
    ray that is not within a fraction of a degree of parallel to the
    triangle): then ``pm(m)`` <= t_m (1 + 2**-16) and ``pm(y)`` <= t_m (1 +
    2**-16)**2 < t_m ``LOOSE``. ``counts`` as ``bvh_closest``'s, both walks'
    tests of a ray walked again summed, and ``counts["again"]``, the rays
    walked again (bool)."""
    h, w = rays.hw
    dev = rays.origin.device
    n = h * w
    o_all = rays.origin.reshape(3, n)
    d_all = rays.direction.reshape(3, n)
    inv_all = inv_direction(d_all)
    tmax = (torch.full((n,), torch.inf, device=dev) if t_max is None
            else t_max.reshape(n).to(torch.float32))
    best_t = tmax.clone()
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    t2 = torch.full((n,), torch.inf, device=dev)
    tau = torch.full((n,), -torch.inf, device=dev)
    again = torch.zeros(n, dtype=torch.bool, device=dev)
    n_box = torch.ones(n, dtype=torch.int64, device=dev)
    n_tri = torch.zeros(n, dtype=torch.int64, device=dev)
    n_tris = geometry.tri_cols.shape[1]
    wide = bvh.wide
    refs = wide.view(torch.int32)[:, 12:14].long()
    root_lo = torch.stack([bvh.bmin_x[0], bvh.bmin_y[0], bvh.bmin_z[0]])
    root_hi = torch.stack([bvh.bmax_x[0], bvh.bmax_y[0], bvh.bmax_z[0]])
    root_tn, root_tf = _slabs(root_lo[:, None], root_hi[:, None], o_all,
                              inv_all)
    cap = min(WALK_STACK, bvh.depth)
    stack_ref = torch.zeros((n, cap), dtype=torch.long, device=dev)
    stack_pm = torch.zeros((n, cap), device=dev)
    sp = torch.zeros(n, dtype=torch.long, device=dev)
    root_leaf = int(bvh.leaf_count[0]) > 0
    root_ref = -((int(bvh.leaf_first[0]) << 5) | int(bvh.leaf_count[0])) \
        if root_leaf else 0
    # The walking rays, each with its cursor (an inner node's index or a
    # leaf's negated word) and its path's largest tnear.
    ray = ((root_tn <= root_tf) & (root_tf >= 0.0)
           & (root_tn <= tmax)).nonzero().squeeze(1)
    cur = torch.full(ray.shape, root_ref, dtype=torch.long, device=dev)
    pm = root_tn[ray]
    pop = torch.zeros(ray.shape, dtype=torch.bool, device=dev)
    while ray.numel():
        # A ray at a leaf tests its triangles and then pops.
        at_leaf = ~pop & (cur < 0)
        sel = at_leaf.nonzero().squeeze(1)
        if sel.numel():
            r = ray[sel]
            word = -cur[sel]
            first, count = word >> 5, word & 31
            n_tri.index_add_(0, r, count)
            os_, ds_ = o_all[:, r], d_all[:, r]
            bt, bi, bu, bv = best_t[r], best_i[r], best_u[r], best_v[r]
            s2, ta, lpm = t2[r], tau[r], pm[sel]
            for j in range(bvh.max_leaf_count):
                idx = torch.clamp_max(first + j, n_tris - 1)
                t, u, v, ok = _mt(os_, ds_, geometry.tri_cols, idx)
                ok = ok & (j < count)
                better = ok & ((t < bt) | ((t == bt) & (idx < bi)))
                s2 = torch.where(better & (bi >= 0), torch.minimum(s2, bt),
                                 s2)
                s2 = torch.where(ok & ~better & (t < tmax[r]),
                                 torch.minimum(s2, t), s2)
                bt = torch.where(better, t, bt)
                bi = torch.where(better, idx, bi)
                bu = torch.where(better, u, bu)
                bv = torch.where(better, v, bv)
                ta = torch.where(better, lpm, ta)
            best_t[r], best_i[r], best_u[r], best_v[r] = bt, bi, bu, bv
            t2[r], tau[r] = s2, ta
            pop[sel] = True
        # A ray at an inner node tests both children's boxes.
        sel = (~pop & ~at_leaf).nonzero().squeeze(1)
        if sel.numel():
            r = ray[sel]
            n_box.index_add_(0, r, torch.full_like(r, 2))
            rec = wide[cur[sel]]  # [n, 16]
            o, inv, lim = o_all[:, r], inv_all[:, r], best_t[r] * LOOSE
            went = []
            for side in (0, 2):
                lo = torch.stack([rec[:, 4 * a + side] for a in range(3)])
                hi = torch.stack([rec[:, 4 * a + side + 1] for a in range(3)])
                tn, tf = _slabs(lo, hi, o, inv)
                cpm = torch.maximum(pm[sel], tn)
                went.append(((tn <= tf) & (tf >= 0.0) & (tn <= tmax[r])
                             & (cpm <= lim), tn, cpm))
            (gl, tnl, pml), (gr, tnr, pmr) = went
            ref_l, ref_r = refs[cur[sel], 0], refs[cur[sel], 1]
            left_first = tnl <= tnr
            both = gl & gr
            full = both & (sp[r] >= cap)
            again[r[full]] = True
            push = (both & ~full).nonzero().squeeze(1)
            if push.numel():
                far = torch.where(left_first[push], ref_r[push], ref_l[push])
                far_pm = torch.where(left_first[push], pmr[push], pml[push])
                stack_ref[r[push], sp[r[push]]] = far
                stack_pm[r[push], sp[r[push]]] = far_pm
                sp[r[push]] += 1
            go_l = gl & (~gr | left_first)
            cur[sel] = torch.where(go_l, ref_l, ref_r)
            pm[sel] = torch.where(go_l, pml, pmr)
            pop[sel] = ~(gl | gr) | full
        # A popping ray takes its stack's top entry while the entry's path
        # can still hold a hit first in (t, index) order; an empty stack
        # (or an overflow) ends its walk.
        sel = (pop & ~again[ray]).nonzero().squeeze(1)
        done = pop & again[ray]
        if sel.numel():
            r = ray[sel]
            has = sp[r] > 0
            top = torch.clamp_min(sp[r] - 1, 0)
            e_ref, e_pm = stack_ref[r, top], stack_pm[r, top]
            sp[r] = top
            take = has & (e_pm <= best_t[r] * LOOSE)
            cur[sel] = torch.where(take, e_ref, cur[sel])
            pm[sel] = torch.where(take, e_pm, pm[sel])
            pop[sel] = ~take
            done[sel] = ~has
        keep = (~done).nonzero().squeeze(1)
        ray, cur, pm, pop = ray[keep], cur[keep], pm[keep], pop[keep]
    again |= (best_i >= 0) & (tau > best_t) & (t2 < tau)
    sel = again.nonzero().squeeze(1)
    best_i = best_i.int()
    if sel.numel():  # the plain walk, on these rays alone
        cnt = None if counts is None else {}
        sub = Rays(o_all[:, sel, None], d_all[:, sel, None])
        res = bvh_closest(sub, geometry, bvh, tmax[sel, None], cnt)
        best_t[sel], best_i[sel], best_u[sel], best_v[sel] = (
            a[:, 0] for a in res)
        if cnt is not None:
            n_box.index_add_(0, sel, cnt["box"][:, 0])
            n_tri.index_add_(0, sel, cnt["tri"][:, 0])
    if counts is not None:
        counts["box"] = n_box.reshape(h, w)
        counts["tri"] = n_tri.reshape(h, w)
        counts["again"] = again.reshape(h, w)
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


def bvh_any_wide(origins, dirs, t_max, geometry, bvh, counts=None,
                 stack: int = WALK_STACK) -> torch.Tensor:
    """A plain model of kernel 19's walk: ``bvh_any``'s contract and bool.

    Each ray tests the root's box (``slab_test``), then at an inner node
    both children's boxes from ``bvh.wide`` with its t_max (``slab_test``'s
    arithmetic) and goes to the left child where its box passes, pushing
    the right where both pass on a stack of ``stack`` entries; a leaf's
    triangles are tested in order up to the first accepted hit (t in (0,
    t_max)), which ends the walk. A ray that would push onto a full stack
    is walked again by ``bvh_any``, as the kernel walks it again in
    preorder. The kernel's loop puts a leaf aside until every lane of its
    warp holds one (csrc/walk.cuh walk_any_wide), so on an occluded ray it
    may test a few boxes more than this model counts, never fewer.

    Why the bool is ``bvh_any``'s: both walks enter exactly the leaves
    whose box and ancestors' boxes pass the slab test with the ray's t_max
    (a child's box in ``bvh.wide`` is the child node's), and for a fixed
    t_max the any-hit bool is the OR over those leaves' triangles, so it
    depends neither on the order of the visits nor on where a walk stops.
    ``counts`` (a dict) receives the box and triangle tests each ray made
    (both walks' of a ray walked again, summed) and ``"again"``, the rays
    walked again (bool), each shaped like the rays' pixels."""
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
    tm_all = t_max.expand(shape).reshape(n).to(torch.float32)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    again = torch.zeros(n, dtype=torch.bool, device=dev)
    n_box = torch.ones(n, dtype=torch.int64, device=dev)
    n_tri = torch.zeros(n, dtype=torch.int64, device=dev)
    n_tris = geometry.tri_cols.shape[1]
    wide = bvh.wide
    refs = wide.view(torch.int32)[:, 12:14].long()
    root = torch.zeros(n, dtype=torch.long, device=dev)
    alive = slab_test(bvh, root, o_all, inv_all, tm_all)
    # An entry of the stack is never deeper than the tree.
    room = max(1, min(stack, bvh.depth + 1))
    stack_ref = torch.zeros((n, room), dtype=torch.long, device=dev)
    sp = torch.zeros(n, dtype=torch.long, device=dev)
    root_ref = -((int(bvh.leaf_first[0]) << 5) | int(bvh.leaf_count[0])) \
        if int(bvh.leaf_count[0]) > 0 else 0
    ray = alive.nonzero().squeeze(1)
    cur = torch.full(ray.shape, root_ref, dtype=torch.long, device=dev)
    pop = torch.zeros(ray.shape, dtype=torch.bool, device=dev)
    while ray.numel():
        done = torch.zeros(ray.shape, dtype=torch.bool, device=dev)
        # A ray at a leaf tests its triangles up to the first hit.
        at_leaf = ~pop & (cur < 0)
        sel = at_leaf.nonzero().squeeze(1)
        if sel.numel():
            r = ray[sel]
            word = -cur[sel]
            first, count = word >> 5, word & 31
            os_, ds_, tm = o_all[:, r], d_all[:, r], tm_all[r]
            hit = torch.zeros(sel.shape, dtype=torch.bool, device=dev)
            tested = torch.zeros(sel.shape, dtype=torch.int64, device=dev)
            for j in range(bvh.max_leaf_count):
                live = ~hit & (j < count)
                idx = torch.clamp_max(first + j, n_tris - 1)
                t, _, _, ok = _mt(os_, ds_, geometry.tri_cols, idx)
                tested += live.long()
                hit = hit | (live & ok & (t < tm))
            n_tri.index_add_(0, r, tested)
            occluded[r] = hit
            done[sel] = hit
            pop[sel] = ~hit
        # A ray at an inner node tests both children's boxes.
        sel = (~pop & ~at_leaf).nonzero().squeeze(1)
        if sel.numel():
            r = ray[sel]
            n_box.index_add_(0, r, torch.full_like(r, 2))
            rec = wide[cur[sel]]  # [n, 16]
            o, inv, tm = o_all[:, r], inv_all[:, r], tm_all[r]
            went = []
            for side in (0, 2):
                lo = torch.stack([rec[:, 4 * a + side] for a in range(3)])
                hi = torch.stack([rec[:, 4 * a + side + 1] for a in range(3)])
                tn, tf = _slabs(lo, hi, o, inv)
                went.append((tn <= tf) & (tf >= 0.0) & (tn <= tm))
            gl, gr = went
            ref_l, ref_r = refs[cur[sel], 0], refs[cur[sel], 1]
            both = gl & gr
            full = both & (sp[r] >= stack)
            again[r[full]] = True
            done[sel] = full
            push = (both & ~full).nonzero().squeeze(1)
            if push.numel():
                stack_ref[r[push], sp[r[push]]] = ref_r[push]
                sp[r[push]] += 1
            cur[sel] = torch.where(gl, ref_l, ref_r)
            pop[sel] = ~(gl | gr)
        # A popping ray takes its stack's top entry; an empty stack ends
        # its walk (visible).
        sel = (pop & ~done).nonzero().squeeze(1)
        if sel.numel():
            r = ray[sel]
            has = sp[r] > 0
            top = torch.clamp_min(sp[r] - 1, 0)
            cur[sel] = torch.where(has, stack_ref[r, top], cur[sel])
            sp[r] = top
            pop[sel] = ~has
            done[sel] = ~has
        keep = (~done).nonzero().squeeze(1)
        ray, cur, pop = ray[keep], cur[keep], pop[keep]
    sel = again.nonzero().squeeze(1)
    if sel.numel():  # the plain walk, on these rays alone
        cnt = None if counts is None else {}
        o_, d_ = (a[:, sel].T[:, :, None, None] for a in (o_all, d_all))
        occluded[sel] = bvh_any(o_, d_, tm_all[sel, None, None], geometry,
                                bvh, cnt)[:, 0, 0]
        if cnt is not None:
            n_box.index_add_(0, sel, cnt["box"][:, 0, 0])
            n_tri.index_add_(0, sel, cnt["tri"][:, 0, 0])
    if counts is not None:
        counts["box"] = n_box.reshape(shape)
        counts["tri"] = n_tri.reshape(shape)
        counts["again"] = again.reshape(shape)
    return occluded.reshape(shape)
