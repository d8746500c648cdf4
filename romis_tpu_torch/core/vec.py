"""Vector math on the image-minor layout (reference ``romis_tpu/core/vec.py``).

- scalar pixel field:  [..., H, W]
- 3-vector field:      [..., 3, H, W]   (vector axis = -3)
- reservoir lanes:     [K, ..., H, W]   (sample axes lead)

Sums over the vector axis are written out as ``x0 + x1 + x2`` so the
rounding order is the same on every device.
"""

from __future__ import annotations

import torch

VEC_AXIS = -3


def e(s: torch.Tensor) -> torch.Tensor:
    """[..., H, W] → [..., 1, H, W], to broadcast against 3-vectors."""
    return s.unsqueeze(VEC_AXIS)


def comp(a: torch.Tensor, i: int) -> torch.Tensor:
    """Component i of a [..., 3, H, W] vector → [..., H, W]."""
    return a.select(VEC_AXIS, i)


def vec(x, y, z) -> torch.Tensor:
    """Stack three scalar fields into a [..., 3, H, W] vector."""
    return torch.stack([x, y, z], dim=VEC_AXIS)


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] x [..., 3, H, W] → [..., H, W]."""
    return (comp(a, 0) * comp(b, 0) + comp(a, 1) * comp(b, 1)
            + comp(a, 2) * comp(b, 2))


def vcross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = (comp(a, i) for i in range(3))
    bx, by, bz = (comp(b, i) for i in range(3))
    return vec(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def vnorm(a: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """L2 norm over the vector axis, exactly 0 for the zero vector."""
    sq = vdot(a, a)
    ok = sq > eps
    return torch.where(ok, torch.sqrt(torch.where(ok, sq, 1.0)), 0.0)


def vnormalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return a * e(torch.reciprocal(torch.clamp_min(vnorm(a), eps)))
