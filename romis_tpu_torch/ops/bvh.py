"""BVH build on the host and its threaded layout (reference
``romis_tpu/ops/bvh.py``).

The build runs once per scene on the host, over the active triangles:
- ``builder="sah"`` (the default): the binned-SAH builder, the port's own
  copy of the JAX package's native builder (``csrc/host/bvh_builder.cpp``),
  compiled at first use with the host C++ compiler (``_build.host_library``;
  a missing compiler raises);
- ``builder="median"``: the reference's numpy median-split builder, with
  the same output contract. Neither falls back to the other.

The layout is threaded (stackless skip links) in DFS preorder: an inner
node's first child is the next node, its ``miss_link`` the node after its
subtree (-1 ends the walk), and a leaf owns the triangles
[leaf_first, leaf_first + leaf_count) of the permuted geometry: the build
reorders EVERY triangle column (and repacks the row tables) so that leaves
are contiguous and a hit index addresses the hit triangle's own
attributes. A ray walks with one cursor: a box hit descends to cursor + 1,
a miss or a finished leaf follows ``miss_link``.

Besides the reference's node columns, a BVH carries ``nodes``, the record
the CUDA walk reads (``csrc/walk.cuh``): per node 8 words, bmin xyz | bmax
xyz | miss_link | leaf, where leaf = leaf_first * 32 + leaf_count for a leaf
and 0 for an inner node (the miss link and the leaf word are int32 bit
patterns), ``wide``, the record of kernel 18's nearer-first walk (per inner
node both children's boxes and references, derived from the same tree; see
``wide_record``), ``depth``, the tree's depth, and ``max_leaf_count``, the
largest leaf, which bounds the plain traversal's leaf loop
(``ops/traverse.py``). The SAH builder may emit
leaves of up to 4 * max_leaf triangles. The reference's TPU page cut
(``PagedBVH``) is a Mosaic shared-memory and DMA layout and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from . import _build

MAX_LEAF = 4
BUILDERS = ("sah", "median")
LEAF_COUNT_BITS = 5  # the leaf word: leaf_first << 5 | leaf_count


@dataclass
class BVH:
    # Node columns [N] (DFS preorder; first child = parent + 1).
    bmin_x: torch.Tensor
    bmin_y: torch.Tensor
    bmin_z: torch.Tensor
    bmax_x: torch.Tensor
    bmax_y: torch.Tensor
    bmax_z: torch.Tensor
    miss_link: torch.Tensor  # int32, -1 ends the walk
    leaf_first: torch.Tensor  # int32, -1 for inner nodes
    leaf_count: torch.Tensor  # int32, 0 for inner nodes
    nodes: torch.Tensor  # [N, 8] f32, the CUDA walk's record
    max_leaf_count: int
    wide: torch.Tensor  # [N, 16] f32, the nearer-first walk's (wide_record)
    depth: int  # nodes on the longest root-to-leaf path

    @property
    def n_nodes(self) -> int:
        return self.bmin_x.shape[0]


def bvh_from_arrays(bmin, bmax, miss, lfirst, lcount, device) -> BVH:
    """A BVH on ``device`` from its numpy arrays: bmin, bmax [N, 3],
    miss_link, leaf_first, leaf_count [N]."""
    bmin = np.asarray(bmin, np.float32).reshape(-1, 3)
    bmax = np.asarray(bmax, np.float32).reshape(-1, 3)
    miss = np.asarray(miss, np.int32)
    lfirst = np.asarray(lfirst, np.int32)
    lcount = np.asarray(lcount, np.int32)
    n = len(miss)
    if not (len(bmin) == len(bmax) == len(lfirst) == len(lcount) == n > 0):
        raise ValueError("bvh_from_arrays: node columns of unequal length")
    leaf = lcount > 0
    if lcount.max() >= 1 << LEAF_COUNT_BITS or (
            leaf.any() and int(lfirst[leaf].max()) >= 1 << (
                31 - LEAF_COUNT_BITS)):
        raise ValueError("bvh_from_arrays: a leaf does not fit the walk's "
                         "record (count < 32, first < 2**26)")
    rec = np.zeros((n, 8), np.float32)
    rec[:, 0:3] = bmin
    rec[:, 3:6] = bmax
    words = rec.view(np.int32)
    words[:, 6] = miss
    words[:, 7] = np.where(leaf, (lfirst << LEAF_COUNT_BITS) | lcount, 0)

    wide, depth = wide_record(bmin, bmax, miss, words[:, 7])

    def t(a):
        return torch.as_tensor(np.array(a, order="C"), device=device)

    return BVH(bmin_x=t(bmin[:, 0]), bmin_y=t(bmin[:, 1]),
               bmin_z=t(bmin[:, 2]), bmax_x=t(bmax[:, 0]),
               bmax_y=t(bmax[:, 1]), bmax_z=t(bmax[:, 2]), miss_link=t(miss),
               leaf_first=t(lfirst), leaf_count=t(lcount), nodes=t(rec),
               max_leaf_count=int(lcount.max()), wide=t(wide), depth=depth)


def wide_record(bmin, bmax, miss, leaf_word):
    """Kernel 18's node record, derived from the threaded tree → (wide
    [N, 16] f32, depth). Inner node i's children are i + 1 and the miss
    link of i + 1 (its sibling); row i holds x | y | z, each as (lo, hi)
    of the left child then of the right, then the two children's
    references: an inner child's node index (>= 1), a leaf child's leaf
    word negated (< 0); the last two words are 0, as is a leaf's row. The
    references are int32 bit patterns. A ray tests both children's boxes
    from one 64-byte record and goes to the nearer first."""
    n = len(miss)
    wide = np.zeros((n, 16), np.float32)
    inner = np.nonzero(leaf_word == 0)[0]
    inner = inner[inner + 1 < n]
    left = inner + 1
    right = miss[left]
    for row, c in ((0, left), (2, right)):
        for axis in range(3):
            wide[inner, 4 * axis + row] = bmin[c, axis]
            wide[inner, 4 * axis + row + 1] = bmax[c, axis]
    refs = wide.view(np.int32)
    refs[inner, 12] = np.where(leaf_word[left] != 0, -leaf_word[left], left)
    refs[inner, 13] = np.where(leaf_word[right] != 0, -leaf_word[right],
                               right)
    # Preorder: a parent comes before its children.
    depth = np.ones(n, np.int64)
    for i, lft, rgt in zip(inner.tolist(), left.tolist(), right.tolist()):
        depth[lft] = depth[rgt] = depth[i] + 1
    return wide, int(depth.max())


def _build_arrays_sah(v0, e1, e2, max_leaf):
    """The binned-SAH builder (``csrc/host/bvh_builder.cpp``) → (bmin,
    bmax, left, right, leaf_first, leaf_count, order)."""
    n = len(v0)
    cap = 2 * n
    bmin = np.zeros((cap, 3), np.float32)
    bmax = np.zeros((cap, 3), np.float32)
    left, right, lfirst, lcount = (np.zeros(cap, np.int32) for _ in range(4))
    order = np.zeros(n, np.int32)
    v0, e1, e2 = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    n_nodes = _build.host_library().bvh_build_sah(
        v0.ctypes.data, e1.ctypes.data, e2.ctypes.data, n, max_leaf,
        bmin.ctypes.data, bmax.ctypes.data, left.ctypes.data,
        right.ctypes.data, lfirst.ctypes.data, lcount.ctypes.data,
        order.ctypes.data)
    if n_nodes < 0:
        raise RuntimeError("the SAH BVH build failed")
    return (bmin[:n_nodes], bmax[:n_nodes], left[:n_nodes], right[:n_nodes],
            lfirst[:n_nodes], lcount[:n_nodes], order)


def _build_arrays_median(v0, e1, e2, max_leaf):
    """The reference's median-split builder (``_build_arrays_numpy``), with
    the SAH builder's output contract."""
    n = len(v0)
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    cent = 0.5 * (lo + hi)

    bmin, bmax, left, right, lfirst, lcount = [], [], [], [], [], []
    leaves = []

    def build(idxs):
        node = len(bmin)
        bmin.append(lo[idxs].min(axis=0))
        bmax.append(hi[idxs].max(axis=0))
        left.append(-1)
        right.append(-1)
        if len(idxs) <= max_leaf:
            lfirst.append(-2)  # patched below: position in the final order
            lcount.append(len(idxs))
            leaves.append((node, idxs))
            return node
        lfirst.append(-1)
        lcount.append(0)
        ext = cent[idxs].max(axis=0) - cent[idxs].min(axis=0)
        axis = int(np.argmax(ext))
        med = np.argsort(cent[idxs, axis], kind="stable")
        half = len(idxs) // 2
        left[node] = build(idxs[med[:half]])
        right[node] = build(idxs[med[half:]])
        return node

    build(np.arange(n, dtype=np.int32))
    order = []
    for node, idxs in leaves:
        lfirst[node] = len(order)
        order.extend(idxs.tolist())
    return (np.asarray(bmin, np.float32), np.asarray(bmax, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(lfirst, np.int32), np.asarray(lcount, np.int32),
            np.asarray(order, np.int32))


def _thread_links(left, right):
    """miss_link per node for the DFS-preorder skip walk: the root's is -1,
    a left child's is its sibling, a right child's its parent's."""
    miss = np.full(len(left), -1, np.int32)
    stack = [(0, -1)]
    while stack:
        node, link = stack.pop()
        miss[node] = link
        if left[node] >= 0:
            stack.append((right[node], link))
            stack.append((left[node], right[node]))
    return miss


def _check_contracts(left, lfirst, lcount, n_active):
    """DFS preorder (an inner node's left child directly follows it) and
    leaf ranges partitioning [0, n_active) in node order: what the threaded
    walk and the contiguous leaves rely on."""
    inner = left >= 0
    if not np.array_equal(left[inner], np.nonzero(inner)[0] + 1):
        raise RuntimeError("BVH builder violated DFS preorder (left child "
                           "!= parent + 1)")
    starts = lfirst[~inner]
    ends = starts + lcount[~inner]
    if not (len(starts) > 0 and starts[0] == 0
            and np.array_equal(starts[1:], ends[:-1])
            and int(ends[-1]) == n_active):
        raise RuntimeError("BVH leaf ranges do not partition [0, n) in "
                           "preorder")


PERMUTED = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
            "mat_id", "geom_id", "active")


def build_bvh(geometry, max_leaf: int = MAX_LEAF, builder: str = "sah"):
    """Build a BVH over the active triangles of ``geometry`` → (BVH on the
    geometry's device, geometry with every triangle column permuted so that
    leaves are contiguous, padding at the tail, and the row tables
    repacked)."""
    from ..scene.scene import repack_rows

    if builder not in BUILDERS:
        raise ValueError(f"build_bvh: builder {builder!r} not in {BUILDERS}")
    active = geometry.active.detach().cpu().numpy()
    act_idx = np.nonzero(active)[0]
    pad_idx = np.nonzero(~active)[0]
    if len(act_idx) == 0:
        raise ValueError("build_bvh: the geometry has no active triangle")
    v0, e1, e2 = (getattr(geometry, f).detach().cpu().numpy()[act_idx]
                  for f in ("v0", "e1", "e2"))
    build = _build_arrays_sah if builder == "sah" else _build_arrays_median
    bmin, bmax, left, right, lfirst, lcount, order = build(v0, e1, e2,
                                                           max_leaf)
    _check_contracts(left, lfirst, lcount, len(v0))
    miss = _thread_links(left, right)
    perm = torch.as_tensor(np.concatenate([act_idx[order], pad_idx]),
                           device=geometry.device)
    geometry = repack_rows(replace(geometry, **{
        f: getattr(geometry, f)[perm] for f in PERMUTED}))
    return bvh_from_arrays(bmin, bmax, miss, lfirst, lcount,
                           geometry.device), geometry


def with_bvh(geometry, max_leaf: int = MAX_LEAF, builder: str = "sah"):
    """``geometry`` with its triangles permuted and a BVH attached
    (``geometry.bvh``): every trace entry point (``ops.intersect``,
    ``ops.trace``, ``ops.shade``, the MIS sweep's ``ext_vis``) then walks
    the tree."""
    bvh, geometry = build_bvh(geometry, max_leaf, builder)
    return replace(geometry, bvh=bvh)


def sah_cost(bvh: BVH) -> float:
    """Total SAH cost relative to the root's area (build quality)."""
    bmin = torch.stack([bvh.bmin_x, bvh.bmin_y, bvh.bmin_z], -1).cpu().numpy()
    bmax = torch.stack([bvh.bmax_x, bvh.bmax_y, bvh.bmax_z], -1).cpu().numpy()
    d = np.maximum(bmax - bmin, 0)
    area = 2 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    counts = bvh.leaf_count.cpu().numpy()
    root = max(area[0], 1e-12)
    return float((area * np.maximum(counts, 1)).sum() / root)
