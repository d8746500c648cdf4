"""Closest hit and any-hit by walking a BVH (reference
``romis_tpu/ops/pallas_bvh.py``, ``paged_closest``, ``paged_any`` and
``paged_any_k``).

Kernels 18, 19 and 20 (``csrc/walk.cu``, the walk in ``csrc/walk.cuh``)
replace the Pallas ``_closest_kernel``, ``_any_kernel`` and
``_any_k_kernel``. The TPU kernels walk a shared-memory top tree with one
cursor per ray tile and bring 512-triangle pages in by DMA, because Mosaic
has no per-lane control flow; on the H100 every thread walks the whole
threaded tree (``ops/bvh.py``) with its own cursor, reading node records
and leaf triangles through the read-only cache:
- kernel 18 (``closest_hit_bvh``): one thread per primary ray, pruning with
  its running best t;
- kernel 19 (``any_hit_bvh``): one thread per ray, stopping at the first
  hit;
- kernel 20 (``any_hit_bvh_k``): the S <= 16 rays of each pixel, a thread
  per ray with the pixel's S rays in adjacent lanes, each stopping at its
  first hit; its leaf triangles come as 48-byte records
  (``tri_records``, built from the columns in each call).
Their plain versions are ``ops.traverse.bvh_closest`` and ``bvh_any``,
whose walk the kernels repeat step for step, so they agree hit for hit.

``ops.trace.closest_hit`` and ``any_hit`` send BVH geometry here, with the
reference's rule for the any-hit (``ops/intersect.py:154-162``): 2 <= S <=
16 rays per pixel (the product of the leading axes) go to kernel 20,
anything else to kernel 19.

Bound on the H100: operations, the walk's box tests (about 22 operations
each) and triangle tests (one Möller–Trumbore each); device memory sees
the rays in and the hits out (40 B a closest-hit ray, 29 B an any-hit ray).
What holds a walk back is latency: each step is a dependent node load, so
occupancy decides how many walks hide it. The TPU's kernel 20 shares one
walk between a pixel's S rays to amortise its page DMAs; on this card that
union walk visits every node any of the S rays needs, runs the S slab
tests of a node one after another and holds 10·S floats of ray state a
thread, and it lost to the per-ray walk. Kernel 20 walks each ray alone
(40 registers at any S) and reads a leaf's triangles as three float4 each
instead of ten scattered floats. A ray's walk is the plain one operation
for operation, and for a fixed t_max the any-hit bool is the OR over the
triangles of every leaf whose box (and its ancestors') the ray passes, so
it depends neither on the order of visits nor on where the ray stops: the
kernel gives the plain traversal's bool on every ray.
"""

from __future__ import annotations

import math

import torch

from ..core.types import Rays
from . import _build
from .traverse import bvh_any, bvh_closest

K_MAX = 16  # rays per pixel kernel 20 takes (the reference's PAGED_ANY_K_MAX)


def checked_tree(geometry):
    """The BVH record and the triangle columns, checked for the walk."""
    bvh = geometry.bvh
    if bvh is None:
        raise ValueError("the BVH walk needs geometry with a BVH "
                         "(ops.bvh.with_bvh)")
    _build.check(bvh.nodes, "bvh.nodes", torch.float32, (bvh.n_nodes, 8))
    if bvh.nodes.data_ptr() % 16:
        raise ValueError("bvh.nodes: expected 16-byte aligned records")
    cols = geometry.tri_cols
    _build.check(cols, "tri_cols", torch.float32)
    return bvh.nodes, cols


def closest_hit_bvh(rays: Rays, geometry, t_max: float = math.inf):
    """Closest hit of rays [3, H, W] by the BVH walk → (t, tri int32, u,
    v), each [H, W]; tri = -1, u = v = 0 and t = t_max on a miss. Kernel
    18 for CUDA tensors, the plain traversal for CPU tensors."""
    if not rays.origin.is_cuda:
        tm = None
        if not math.isinf(t_max):
            tm = torch.full(rays.hw, t_max, device=rays.origin.device)
        return bvh_closest(rays, geometry, geometry.bvh, tm)
    h, w = rays.hw
    _build.check(rays.origin, "rays.origin", torch.float32, (3, h, w))
    _build.check(rays.direction, "rays.direction", torch.float32, (3, h, w))
    nodes, cols = checked_tree(geometry)
    dev = rays.origin.device
    t = torch.empty((h, w), dtype=torch.float32, device=dev)
    tri = torch.empty((h, w), dtype=torch.int32, device=dev)
    u = torch.empty((h, w), dtype=torch.float32, device=dev)
    v = torch.empty((h, w), dtype=torch.float32, device=dev)
    if h * w:
        _build.launch("romis_bvh_closest", rays.origin.data_ptr(),
                      rays.direction.data_ptr(), h * w, nodes.data_ptr(),
                      cols.data_ptr(), cols.shape[1], float(t_max),
                      t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr())
        closest_hit_bvh.launches += 1
    return t, tri, u, v


closest_hit_bvh.launches = 0


def tri_records(cols: torch.Tensor) -> torch.Tensor:
    """The [10, T] triangle columns as kernel 20 reads them: [T, 12], a
    48-byte record a triangle (v0 xyz | e1 xyz | e2 xyz | active | 0 0)."""
    return torch.nn.functional.pad(cols.t(), (0, 2)).contiguous()


def _any_args(origins, dirs, t_max, name):
    lead = tuple(origins.shape[:-3])
    h, w = origins.shape[-2:]
    if origins.shape[-3] != 3 or tuple(t_max.shape) != lead + (h, w):
        raise ValueError(f"{name}: origins {tuple(origins.shape)} and t_max "
                         f"{tuple(t_max.shape)} do not match")
    o = origins.contiguous()
    d = dirs.expand(origins.shape).contiguous()
    tm = t_max.contiguous()
    _build.check(o, "origins", torch.float32)
    _build.check(d, "dirs", torch.float32)
    _build.check(tm, "t_max", torch.float32)
    return o, d, tm, lead + (h, w), h * w


def any_hit_bvh(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion by the BVH walk, one walk per ray: origins [..., 3, H, W],
    dirs broadcastable to them, t_max [..., H, W] → bool [..., H, W].
    Kernel 19 for CUDA tensors, the plain traversal for CPU tensors."""
    if not origins.is_cuda:
        return bvh_any(origins, dirs, t_max, geometry, geometry.bvh)
    o, d, tm, shape, n_pix = _any_args(origins, dirs, t_max, "any_hit_bvh")
    nodes, cols = checked_tree(geometry)
    out = torch.empty(shape, dtype=torch.bool, device=o.device)
    if out.numel():
        _build.launch("romis_bvh_any", o.data_ptr(), d.data_ptr(),
                      tm.data_ptr(), n_pix, out.numel(), nodes.data_ptr(),
                      cols.data_ptr(), cols.shape[1], out.data_ptr())
        any_hit_bvh.launches += 1
    return out


any_hit_bvh.launches = 0


def any_hit_bvh_k(origins, dirs, t_max, geometry) -> torch.Tensor:
    """Occlusion of S = prod(leading axes) <= 16 rays per pixel, a walk per
    ray with a pixel's rays side by side: origins [..., 3, H, W], dirs
    broadcastable to them, t_max [..., H, W] → bool [..., H, W]. Kernel 20
    for CUDA tensors, the plain traversal for CPU tensors."""
    if not origins.is_cuda:
        return bvh_any(origins, dirs, t_max, geometry, geometry.bvh)
    o, d, tm, shape, n_pix = _any_args(origins, dirs, t_max, "any_hit_bvh_k")
    s = math.prod(shape[:-2])
    if not 1 <= s <= K_MAX:
        raise ValueError(f"any_hit_bvh_k: {s} rays per pixel outside "
                         f"1..{K_MAX}")
    nodes, cols = checked_tree(geometry)
    out = torch.empty(shape, dtype=torch.bool, device=o.device)
    if n_pix:
        recs = tri_records(cols)
        _build.launch("romis_bvh_any_k", o.data_ptr(), d.data_ptr(),
                      tm.data_ptr(), n_pix, s, nodes.data_ptr(),
                      recs.data_ptr(), out.data_ptr())
        any_hit_bvh_k.launches += 1
    return out


any_hit_bvh_k.launches = 0
