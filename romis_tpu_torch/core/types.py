"""Per-pixel state as dataclasses of tensors (reference
``romis_tpu/core/types.py``), image-minor: the last two axes of every field
are (H, W), 3-vectors sit on axis -3 and sample axes (K lanes, R inputs)
lead."""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from .device import resolve_device


@dataclass
class Rays:
    origin: torch.Tensor  # [3, H, W]
    direction: torch.Tensor  # [3, H, W] (normalized)

    @property
    def hw(self):
        return tuple(self.origin.shape[-2:])


@dataclass
class HitRecord:
    valid: torch.Tensor  # [H, W] bool
    t: torch.Tensor  # [H, W] hit distance (inf on miss)
    normal: torch.Tensor  # [3, H, W] interpolated shading normal
    uv: torch.Tensor  # [2, H, W]
    mat_id: torch.Tensor  # [H, W] int32
    geom_id: torch.Tensor  # [H, W] int32 (-1 on miss)
    prim_id: torch.Tensor  # [H, W] int32 (-1 on miss)


@dataclass
class ShadeCtx:
    valid: torch.Tensor  # [H, W] bool
    position: torch.Tensor  # [3, H, W]
    normal: torch.Tensor  # [3, H, W]
    view_origin: torch.Tensor  # [3, H, W]
    kd: torch.Tensor  # [3, H, W]
    ks: torch.Tensor  # [3, H, W]
    shininess: torch.Tensor  # [H, W]
    geom_id: torch.Tensor  # [H, W] int32
    depth_t: torch.Tensor  # [H, W]


@dataclass
class Reservoirs:
    pos: torch.Tensor  # [K, 3, H, W]
    color: torch.Tensor  # [K, 3, H, W]
    w_sum: torch.Tensor  # [K, H, W]
    m: torch.Tensor  # [K, H, W]
    big_w: torch.Tensor  # [K, H, W]
    chosen_w: torch.Tensor  # [K, H, W]

    @property
    def k(self) -> int:
        return self.pos.shape[0]

    @property
    def hw(self):
        return tuple(self.pos.shape[-2:])

    def total_m(self) -> torch.Tensor:
        """Sum of the lane counts → [H, W]."""
        return self.m.sum(dim=0)


def empty_reservoirs(height: int, width: int, k: int,
                     device=None) -> Reservoirs:
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return Reservoirs(pos=z(k, 3, height, width), color=z(k, 3, height, width),
                      w_sum=z(k, height, width), m=z(k, height, width),
                      big_w=z(k, height, width), chosen_w=z(k, height, width))


def pack_reservoir_planes(res: Reservoirs) -> torch.Tensor:
    """Reservoirs → [10K, H, W]: pos 3K | color 3K | w_sum K | m K | big_w K
    | chosen_w K (reference ``render/restir.pack_reservoir_planes``)."""
    hw = res.hw
    return torch.cat([
        res.pos.reshape((-1,) + hw), res.color.reshape((-1,) + hw),
        res.w_sum, res.m, res.big_w, res.chosen_w,
    ], dim=0)


def unpack_reservoir_planes(g: torch.Tensor, k: int) -> Reservoirs:
    """[..., 10K, H, W] → Reservoirs with the leading axes first (views
    into ``g``)."""
    lead, hw = tuple(g.shape[:-3]), tuple(g.shape[-2:])

    def planes(i, j, shape):
        return g[..., i:j, :, :].reshape(lead + shape + hw)

    return Reservoirs(
        pos=planes(0, 3 * k, (k, 3)), color=planes(3 * k, 6 * k, (k, 3)),
        w_sum=planes(6 * k, 7 * k, (k,)), m=planes(7 * k, 8 * k, (k,)),
        big_w=planes(8 * k, 9 * k, (k,)),
        chosen_w=planes(9 * k, 10 * k, (k,)),
    )


def detached(state):
    """A dataclass of tensors (ShadeCtx, Reservoirs, LightTable, ...) with
    every field detached from the autograd graph."""
    return replace(state, **{f.name: getattr(state, f.name).detach()
                             for f in fields(state)})
