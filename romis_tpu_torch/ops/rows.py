"""Planes-first packed row gather: table [T, C] + idx [..., H, W] →
[C, ..., H, W] (reference ``romis_tpu/ops/pallas_rows.py``).

Kernel 2 (``csrc/rows.cu``) replaces the Pallas ``_rows_kernel``: one
thread per index, C coalesced plane stores, the table read through the
read-only cache. The copy is exact. ``gather_rows`` is differentiable in
the table, as the reference's custom VJP is: its forward launches kernel 2
for CUDA tensors and runs ``gather_rows_plain`` for CPU tensors, and its
backward is ``ops.scatter.scatter_rows_add`` (kernel 13 on CUDA), run only
when the table needs a gradient.

Bound on the H100: device-memory bandwidth, (C + 1) x 4 B per index; the
table itself stays in cache.
"""

from __future__ import annotations

import torch

from . import _build
from .scatter import scatter_rows_add


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``table[idx]`` moved planes-first, with indices
    clamped into [0, T) as the kernel clamps them (differentiable by
    PyTorch's own indexing backward)."""
    i = idx.long().clamp(0, table.shape[0] - 1)
    return table[i].movedim(-1, 0)


def _gather_rows_forward(table: torch.Tensor, idx: torch.Tensor):
    if not idx.is_cuda:
        return gather_rows_plain(table, idx)
    table, idx = table.contiguous(), idx.contiguous()
    _build.check(table, "table", torch.float32)
    _build.check(idx, "idx", torch.int32)
    if table.dim() != 2:
        raise ValueError(f"table: expected [T, C], got {tuple(table.shape)}")
    t, c = table.shape
    out = torch.empty((c,) + tuple(idx.shape), dtype=torch.float32,
                      device=idx.device)
    if idx.numel() == 0:
        return out
    _build.launch("romis_gather_rows", table.data_ptr(), t, c, idx.data_ptr(),
                  idx.numel(), out.data_ptr())
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return _gather_rows_forward(table, idx)

    @staticmethod
    def backward(ctx, ct):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return scatter_rows_add(ct, idx, ctx.n_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, C] f32, idx [..., H, W] int32 → [C, ..., H, W] f32."""
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(table, idx)
    return _gather_rows_forward(table, idx)
