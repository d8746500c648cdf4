"""Scatter-add into a small row table, the transpose of the planes-first
row gather (reference ``romis_tpu/ops/pallas_scatter.py``):

    d_table[r, c] = sum over p with idx[p] == r of ct[c, p].

Kernel 13 (``csrc/scatter.cu``) replaces the Pallas ``_scatter_kernel``
(a one-hot MXU contraction capped at 2048 rows). Each warp-group of 32
indices is classed by its distinct rows (at most ``HELD``, or more), and a
warp sums up to ``HELD`` rows in registers while its groups stay on them.
A table that fits in shared memory (``scatter_tile``) is summed by
persistent blocks, as many an SM as fit: each warp owns ``warp_cols``
whole columns of its block's table, reads their values from device memory
a batch ahead, adds with plain read-modify-writes where tags show that no
other lane adds to the same address, and each block flushes its table
once with device atomics. A larger table (a scene's BVH triangles) is
summed in device memory, a many-row group's runs of equal rows by a
segmented scan. ``scatter_rows_add`` launches it for CUDA tensors and runs
``scatter_rows_add_plain`` (``index_add_``) for CPU tensors. It is the
backward of ``ops.rows.gather_rows``.

Bound on the H100: device memory, (C + 1) x 4 B per index, once the
contention on the few rows most pixels share (one material row and a few
triangle rows on the flagship scene, 3 light rows on the torus field)
stays in registers and shared memory; what holds the 512 random light
rows back is each warp's chain of votes, shuffles and read-modify-writes
(``PERF.md``). Float atomics add in no fixed order, so the last bits vary
from run to run.
"""

from __future__ import annotations

import torch

from . import _build


SMEM_BYTES = 232448  # shared memory a block may hold on sm_90 (227 KB)
TILE = 2048  # indices a tile of kernel 13's shared-memory path
HELD = 4     # rows a warp of kernel 13 sums in registers (kHeld)
TAGS = 256   # row tags a warp of kernel 13's tiled path keeps (kTags)


def warp_cols(n_cols: int, n_rows: int) -> int:
    """Columns a warp of kernel 13's tiled path takes. A narrow table
    (C < 16): 1 (its C warps, several blocks an SM, keep enough loads in
    flight). A wide one: its groups' classes and held rows serve the
    warp's columns, whose chains of adds run side by side; 3 where most
    groups sit on a few rows held in registers (at most 64 rows), 2 where
    most add to random rows (fewer registers, more warps)."""
    if n_cols < 16:
        return 1
    return 3 if n_rows <= 64 else 2


def scatter_smem(n_cols: int, n_rows: int, tile: int = TILE) -> int:
    """Bytes of shared memory kernel 13's tiled path takes: the table (its
    row stride n_cols rounded up to odd), two buffers of a tile's indices
    (rewritten as codes), a record of HELD + 1 ints a group of 32, and
    TAGS ints for each of its warps (one a ``warp_cols`` columns, at least
    4 and at most 32)."""
    tab = (n_rows * (n_cols | 1) + 3) // 4 * 4
    warps = min(max(-(-n_cols // warp_cols(n_cols, n_rows)), 4), 32)
    return 4 * (tab + 2 * tile + (HELD + 1) * (tile // 32) + TAGS * warps)


def scatter_tile(n_cols: int, n_rows: int) -> int:
    """Kernel 13's tile for a [n_rows, n_cols] table: ``TILE`` where its
    shared memory (``scatter_smem``) fits in ``SMEM_BYTES``, else 0 (the
    device-memory path)."""
    return TILE if scatter_smem(n_cols, n_rows) <= SMEM_BYTES else 0


def _flat(ct: torch.Tensor, idx: torch.Tensor):
    """(ct as [C, N], idx as [N]), after checking that they match."""
    if tuple(ct.shape[1:]) != tuple(idx.shape):
        raise ValueError(f"scatter_rows_add: ct {tuple(ct.shape)} does not "
                         f"match idx {tuple(idx.shape)}")
    return ct.reshape(ct.shape[0], -1), idx.reshape(-1)


def scatter_rows_add_plain(ct: torch.Tensor, idx: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The plain version: ``index_add_`` of the [N, C] cotangent rows."""
    flat_ct, flat_idx = _flat(ct, idx)
    out = torch.zeros((n_rows, ct.shape[0]), dtype=torch.float32,
                      device=ct.device)
    return out.index_add_(0, flat_idx.long().clamp(0, n_rows - 1),
                          flat_ct.t().float())


def scatter_rows_add(ct: torch.Tensor, idx: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """ct [C, ..., H, W] f32, idx [..., H, W] int32 → d_table [T, C] f32
    with T = ``n_rows``; out-of-range indices land on the clamped row."""
    if not ct.is_cuda:
        return scatter_rows_add_plain(ct, idx, n_rows)
    flat_ct, flat_idx = _flat(ct, idx)
    flat_ct = flat_ct.contiguous()
    flat_idx = flat_idx.to(torch.int32).contiguous()
    _build.check(flat_ct, "ct", torch.float32)
    _build.check(flat_idx, "idx", torch.int32)
    c, n = flat_ct.shape
    out = torch.zeros((n_rows, c), dtype=torch.float32, device=ct.device)
    if n and c:
        _build.launch("romis_scatter_rows_add", flat_ct.data_ptr(), c,
                      flat_idx.data_ptr(), n, n_rows, scatter_tile(c, n_rows),
                      warp_cols(c, n_rows), out.data_ptr())
        scatter_rows_add.launches += 1
    return out


scatter_rows_add.launches = 0
