"""Final shade: shadow visibility x Phong x W, averaged over the K lanes
(reference ``romis_tpu/ops/pallas_shade.py``).

Kernel 4 (``csrc/shade.cu``) replaces the Pallas ``_shade_kernel``: per
pixel, K shadow rays any-hit traced against the triangle soup in shared
memory with an early exit, and the Phong arithmetic in the same thread.
Its plain version, ``final_shade_plain``, is the unfused formulation:
``ops.wrs.visibility`` and ``ops.shading.phong_shade``.

Bound on the H100: compute, ~30 flops per live shadow-ray/triangle test up
to the first hit; dead rays skip the trace. Device memory sees 18 + 10K
planes in and 3 out.
"""

from __future__ import annotations

import torch

from romis_tpu.core.features import Features

from ..core.types import Reservoirs, ShadeCtx, pack_reservoir_planes
from ..core.vec import e
from . import _build
from .shading import phong_shade
from .trace import MAX_SOUP_TRIS
from .wrs import visibility

CTX_PLANES = 18
MAX_LANES = 4  # the kernel is instantiated for K = 1..4


def pack_center_ctx(ctx: ShadeCtx) -> torch.Tensor:
    """ShadeCtx → [18, H, W]: position3 | normal3 | view3 | kd3 | ks3 |
    shininess | depth | valid."""
    return torch.cat([
        ctx.position, ctx.normal, ctx.view_origin, ctx.kd, ctx.ks,
        ctx.shininess[None], ctx.depth_t[None], ctx.valid.float()[None],
    ], dim=0)


def final_shade_plain(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                      features: Features) -> torch.Tensor:
    """The plain version → pre-tone-map color [3, H, W]."""
    vis = visibility(ctx.position, reservoirs.pos, geometry)  # [K, H, W]
    shade = phong_shade(ctx, reservoirs.pos, reservoirs.color, features)
    contrib = torch.where(e(vis), shade, 0.0) * e(reservoirs.big_w)
    return contrib.sum(dim=0) / reservoirs.k


def final_shade_fused(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                      features: Features) -> torch.Tensor:
    """Visibility x Phong x W lane average → color [3, H, W], pre-tone-map.
    Kernel 4 for CUDA tensors, the plain version for CPU tensors."""
    if not ctx.position.is_cuda:
        return final_shade_plain(ctx, reservoirs, geometry, features)
    if not features.enable_shading:
        raise NotImplementedError(
            "the final-shade kernel computes Phong shading; the unshaded "
            "(enable_shading=False) final shade has no kernel yet")
    h, w = ctx.depth_t.shape[-2:]
    k = reservoirs.k
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"final shade kernel: K={k} outside 1..{MAX_LANES}")
    cp = pack_center_ctx(ctx)
    rp = pack_reservoir_planes(reservoirs)
    cols = geometry.tri_cols
    _build.check(cp, "ctx", torch.float32, (CTX_PLANES, h, w))
    _build.check(rp, "reservoirs", torch.float32, (10 * k, h, w))
    _build.check(cols, "tri_cols", torch.float32)
    if cols.shape[1] > MAX_SOUP_TRIS:
        raise ValueError(f"final shade: {cols.shape[1]} triangles exceed the "
                         f"soup kernel's {MAX_SOUP_TRIS}")
    out = torch.empty((3, h, w), dtype=torch.float32, device=cp.device)
    if h * w:
        _build.launch("romis_final_shade", cp.data_ptr(), rp.data_ptr(),
                      h * w, k, cols.data_ptr(), cols.shape[1],
                      out.data_ptr())
        final_shade_fused.launches += 1
    return out


final_shade_fused.launches = 0
