"""Row bands of a frame: the arguments of the kernels' band entries
(``parallel/``, the counterpart of the reference's ``halo_src`` /
``row_base`` / ``h_global``).

A launch covers either the whole frame or a row band of it: rows
``row_base`` to ``row_base + h`` of a frame of ``h_global`` rows. A kernel
that reads neighbours (the spatial passes, the neighbour selection, the
MIS sweep) then reads planes that hold the band inside a halo of rows above
and below it (``parallel.halo.halo_extend``), clamps a neighbour's row to
the frame in frame rows, and draws its Philox numbers at the frame's pixel
index, so the band computes, bit for bit, the rows the whole frame's
launch computes. ``h_global=None`` means the whole frame.
"""

from __future__ import annotations

import torch


def check_band(name: str, h: int, row_base: int, h_global) -> int:
    """The frame's rows for a launch of ``h`` rows from ``row_base`` on
    (``h`` when ``h_global`` is None), refusing a band outside the
    frame."""
    if h_global is None:
        if row_base:
            raise ValueError(f"{name}: row_base {row_base} without h_global")
        return h
    if row_base < 0 or row_base + h > h_global:
        raise ValueError(f"{name}: rows {row_base}..{row_base + h} outside "
                         f"the frame's {h_global}")
    return h_global


def inner_rows(name: str, h_in: int, halo: int, row_base: int,
               h_global) -> int:
    """The band's rows when its planes of ``h_in`` rows hold it inside a
    halo of ``halo`` rows (``h_in`` when ``h_global`` is None: the whole
    frame, no halo)."""
    if h_global is None:
        check_band(name, h_in, row_base, None)
        return h_in
    h = h_in - 2 * halo
    if halo < 0 or h < 1:
        raise ValueError(f"{name}: {h_in} rows cannot hold a band inside a "
                         f"halo of {halo} rows")
    check_band(name, h, row_base, h_global)
    return h


def band_of(t: torch.Tensor, row_base: int, h: int) -> torch.Tensor:
    """Rows ``row_base`` to ``row_base + h`` of a frame's [..., H, W]."""
    return t[..., row_base:row_base + h, :]


def frame_rows(h: int, row_base: int, device) -> torch.Tensor:
    """The frame rows of a launch's ``h`` rows → int32 [h, 1]."""
    return (row_base + torch.arange(h, dtype=torch.int32, device=device)
            )[:, None]
