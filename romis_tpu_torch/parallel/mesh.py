"""Row bands of the frame over the ranks of a process group (reference
``romis_tpu/parallel/mesh.py``).

The reference shards the pixel axis over a 1-D ``tiles`` device mesh and
lets GSPMD partition every per-pixel op and lower the neighbour reads to
collectives (``make_mesh``, ``row_sharding``, ``replicated``,
``shard_pixels``, ``TILE_AXIS``). PyTorch has no such partitioner, so these
have no counterpart here and are not imitated. Instead each rank renders
its own row band explicitly, with the kernels' band entries
(``ops.band``), and exchanges halo rows with the ranks above and below it
(``parallel.halo.halo_extend``). ``Bands`` is what a rank knows of the
split: the image's rows, the world size, its rank and the process group.
The scene is replicated: every rank builds or loads it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Bands:
    """The row band of rank ``rank`` of ``world`` in an image of ``height``
    rows: rows ``row_base`` to ``row_base + h_loc``. ``group`` is the
    ``torch.distributed`` process group (None: the default group).
    ``exchange`` replaces the group's halo exchange (``parallel.halo.
    halo_extend``) by a function (x, radius, bands) → the extended band,
    for running the bands of one frame in one process; for a gradient
    step its result must keep ``x``'s autograd graph in the band's rows."""

    height: int
    world: int = 1
    rank: int = 0
    group: object = None
    exchange: Callable | None = None

    def __post_init__(self):
        if self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} of a world of {self.world}")
        if self.height % self.world:
            raise ValueError(f"the image's {self.height} rows must divide "
                             f"into {self.world} equal bands, one a rank")

    @property
    def h_loc(self) -> int:
        return self.height // self.world

    @property
    def row_base(self) -> int:
        return self.rank * self.h_loc

    def check_halo(self, radius: int) -> None:
        """Refuse a halo the neighbouring bands cannot fill: each band's
        rows must cover the halo's ``radius``."""
        if self.world > 1 and self.h_loc < radius:
            raise ValueError(f"the band height {self.h_loc} must cover the "
                             f"halo radius {radius}")

    def band_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A whole frame's [..., H, W] → this band's rows [..., h_loc, W]."""
        if t.shape[-2] != self.height:
            raise ValueError(f"band_rows: {t.shape[-2]} rows, not the "
                             f"image's {self.height}")
        return t[..., self.row_base:self.row_base + self.h_loc, :]

    def extend(self, t: torch.Tensor, radius: int) -> torch.Tensor:
        """This band's [..., h_loc, W] → [..., h_loc + 2·radius, W] with the
        neighbouring bands' rows (``parallel.halo.halo_extend``)."""
        from .halo import halo_extend

        return halo_extend(t, radius, self)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group's ranks, on every rank (one
        ``all_reduce``; ``t`` itself for a world of 1)."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every band's [..., h_loc, W] → the frame's [..., H, W] on every
        rank (one ``all_gather``)."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=-2)


def make_bands(height: int, group=None) -> Bands:
    """The calling rank's band of an image of ``height`` rows over
    ``group`` (the default group), or the whole image when no process
    group is initialised."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return Bands(height)
    return Bands(height, dist.get_world_size(group), dist.get_rank(group),
                 group)
