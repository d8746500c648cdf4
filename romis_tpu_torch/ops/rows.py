"""Planes-first packed row gather: table [T, C] + idx [..., H, W] →
[C, ..., H, W] (reference ``romis_tpu/ops/pallas_rows.py``).

Kernel 2 (``csrc/rows.cu``) replaces the Pallas ``_rows_kernel``: one
thread per index, C coalesced plane stores, the table read through the
read-only cache. The copy is exact. ``gather_rows`` launches it for CUDA
tensors and runs ``gather_rows_plain`` for CPU tensors.

Bound on the H100: device-memory bandwidth, (C + 1) x 4 B per index; the
table itself stays in cache.
"""

from __future__ import annotations

import torch

from . import _build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``table[idx]`` moved planes-first, with indices
    clamped into [0, T) as the kernel clamps them."""
    i = idx.long().clamp(0, table.shape[0] - 1)
    return table[i].movedim(-1, 0)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, C] f32, idx [..., H, W] int32 → [C, ..., H, W] f32."""
    if not idx.is_cuda:
        return gather_rows_plain(table, idx)
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
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
