"""Scatter-add into a small row table, the transpose of the planes-first
row gather (reference ``romis_tpu/ops/pallas_scatter.py``):

    d_table[r, c] = sum over p with idx[p] == r of ct[c, p].

Kernel 13 (``csrc/scatter.cu``) replaces the Pallas ``_scatter_kernel``: a
warp-aggregated, block-private shared-memory accumulator flushed with one
global atomic per (row, component) per block, instead of the TPU's one-hot
MXU contraction and its 2048-row cap. ``scatter_rows_add`` launches it for
CUDA tensors and runs ``scatter_rows_add_plain`` (``index_add_``) for CPU
tensors. It is the backward of ``ops.rows.gather_rows``.

Bound on the H100: contention on the few rows most pixels share (one
material row and two triangle rows on the flagship scene), which the
in-warp and in-block reductions absorb; device memory sees (C + 1) x 4 B
per index. Float atomics add in no fixed order, so the last bits vary from
run to run.
"""

from __future__ import annotations

import torch

from . import _build


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
                      flat_idx.data_ptr(), n, n_rows, out.data_ptr())
        scatter_rows_add.launches += 1
    return out


scatter_rows_add.launches = 0
