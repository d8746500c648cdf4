"""Unified light table (reference ``romis_tpu/scene/lights.py``).

Every light is canonicalised into the parallelogram form, so sampling one
light with two uniforms (u, v) is branch-free:

    position = v0 + u*edge01 + v*edge02
    color    = mix(mix(c0, c1, u), mix(c2, c3, u), v)

The builder is numpy-only; ``build(device)`` places the tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.device import resolve_device

POINT, SEGMENT, PARALLELOGRAM = 0, 1, 2


@dataclass
class LightTable:
    v0: torch.Tensor  # [L, 3]
    edge01: torch.Tensor  # [L, 3]
    edge02: torch.Tensor  # [L, 3]
    c0: torch.Tensor  # [L, 3]
    c1: torch.Tensor  # [L, 3]
    c2: torch.Tensor  # [L, 3]
    c3: torch.Tensor  # [L, 3]
    kind: torch.Tensor  # [L] int32
    # Packed rows [L, 24]: v0 | e01 | e02 | c0 | c1 | c2 | c3 | pad(3).
    rows: torch.Tensor

    @property
    def n(self) -> int:
        return self.v0.shape[0]


COLUMNS = ("v0", "edge01", "edge02", "c0", "c1", "c2", "c3")


def pack_rows(v0, e01, e02, c0, c1, c2, c3) -> torch.Tensor:
    """The packed [L, 24] rows from the [L, 3] columns; differentiable in
    them (reference ``scene/lights._pack_rows_jnp``)."""
    cols = torch.cat([v0, e01, e02, c0, c1, c2, c3], dim=1)
    return torch.cat([cols, torch.zeros((cols.shape[0], 24 - cols.shape[1]),
                                        device=cols.device)], dim=1)


def repack_rows(lights: LightTable) -> LightTable:
    """Rebuild the packed rows after replacing any column."""
    return replace(lights, rows=pack_rows(
        *(getattr(lights, c) for c in COLUMNS)))


def light_table_from_arrays(arrays: dict, device=None) -> LightTable:
    """LightTable from numpy columns (``COLUMNS`` [L, 3] each, ``kind``
    [L]) on ``device`` (default: the CUDA device); the packed rows are
    built from the columns."""
    device = resolve_device(device)
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a, order="C"), dtype=dtype,
                               device=device)

    cols = {c: t(np.asarray(arrays[c], np.float32).reshape(-1, 3))
            for c in COLUMNS}
    return repack_rows(LightTable(
        **cols, kind=t(np.asarray(arrays["kind"], np.int32), torch.int32),
        rows=None))


class LightListBuilder:
    """Host-side builder mirroring the reference light variants."""

    def __init__(self):
        self.rows = []

    def add_point(self, position, color):
        z = (0.0, 0.0, 0.0)
        self.rows.append((position, z, z, color, color, color, color, POINT))
        return self

    def add_segment(self, endpoint0, endpoint1, color0, color1):
        e0 = np.asarray(endpoint0, np.float32)
        e1 = np.asarray(endpoint1, np.float32)
        z = (0.0, 0.0, 0.0)
        self.rows.append((e0, e1 - e0, z, color0, color1, color0, color1,
                          SEGMENT))
        return self

    def add_parallelogram(self, v0, edge01, edge02, color0, color1, color2,
                          color3):
        self.rows.append((v0, edge01, edge02, color0, color1, color2, color3,
                          PARALLELOGRAM))
        return self

    def arrays(self) -> dict:
        """The table as numpy columns; a 1-row all-zero table (weight-0
        light) when empty, as in the reference."""
        if not self.rows:
            z = np.zeros((1, 3), np.float32)
            out = {c: z for c in COLUMNS}
            out["kind"] = np.zeros((1,), np.int32)
            return out
        cols = list(zip(*self.rows))
        out = {c: np.asarray(a, np.float32).reshape(-1, 3)
               for c, a in zip(COLUMNS, cols[:7])}
        out["kind"] = np.asarray(cols[7], np.int32)
        return out

    def build(self, device=None) -> LightTable:
        return light_table_from_arrays(self.arrays(), device)

    def __len__(self):
        return len(self.rows)


def sample_lights_planes(lights: LightTable, light_idx: torch.Tensor,
                         u: torch.Tensor, v: torch.Tensor, gather=None):
    """Sample lights ``light_idx`` [..., H, W] at (u, v) → (px, py, pz, cr,
    cg, cb) planes, each [..., H, W]. ``gather`` is the row gather to use
    (default: ``ops.rows.gather_rows``)."""
    if gather is None:
        from ..ops.rows import gather_rows as gather

    rows = gather(lights.rows, light_idx)  # [24, ..., H, W]
    px = rows[0] + u * rows[3] + v * rows[6]
    py = rows[1] + u * rows[4] + v * rows[7]
    pz = rows[2] + u * rows[5] + v * rows[8]
    cols = []
    for c in range(3):
        lerp01 = rows[9 + c] * (1.0 - u) + rows[12 + c] * u
        lerp23 = rows[15 + c] * (1.0 - u) + rows[18 + c] * u
        cols.append(lerp01 * (1.0 - v) + lerp23 * v)
    return px, py, pz, cols[0], cols[1], cols[2]


def regular_light_grid(builder: LightListBuilder, start_pos, counts, edge01,
                       edge02, color, empty_space_percentage: float = 0.1):
    """Grid of parallelogram lights (reference regularLightGrid)."""
    start_pos = np.asarray(start_pos, np.float32)
    edge01 = np.asarray(edge01, np.float32)
    edge02 = np.asarray(edge02, np.float32)
    cx, cy = counts
    space01 = edge01 / cx
    space02 = edge02 / cy
    light01 = edge01 * (1.0 - empty_space_percentage) / cx
    light02 = edge02 * (1.0 - empty_space_percentage) / cy
    for xl in range(cx):
        for yl in range(cy):
            origin = start_pos + space01 * xl + space02 * yl
            builder.add_parallelogram(origin, light01, light02,
                                      color, color, color, color)
    return builder
