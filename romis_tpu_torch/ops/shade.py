"""Final shade: shadow visibility x Phong x W, averaged over the K lanes
(reference ``romis_tpu/ops/pallas_shade.py``).

Kernel 4 (``csrc/shade.cu``) replaces the Pallas ``_shade_kernel``: per
pixel, K shadow rays any-hit traced against the triangle soup in shared
memory with an early exit, and the Phong arithmetic in the same thread.
Its plain version, ``final_shade_plain``, is the unfused formulation:
``ops.wrs.visibility`` and ``ops.shading.phong_shade``. ``final_shade_fused``
is differentiable in the context and the reservoirs, with the reference's
re-evaluation backward (``render/restir._final_shade_fused_bwd``): the
shadow rays are traced again without gradient by ``ops.trace.any_hit``
(kernel 6 on CUDA), and Phong x W is differentiated with that visibility
held fixed.

Bound on the H100: compute, ~30 flops per live shadow-ray/triangle test up
to the first hit; dead rays skip the trace. Device memory sees 18 + 10K
planes in and 3 out.

Kernel 21 (``final_shade_bvh``, the BVH mode of ``csrc/shade.cu``) replaces
the Pallas ``_shade_paged_kernel`` for geometry with a BVH: the same pixel,
its K live shadow rays traced by one shared walk of the tree (kernel 20's
walk, ``csrc/walk.cuh``). Its plain version is the same
``final_shade_plain``, whose visibility then walks the tree
(``ops.traverse.bvh_any``). ``final_shade_fused`` dispatches on
``geometry.bvh`` (the reference's ``restir.py:571-579``).

Both kernels have the unshaded mode of ``Features(enable_shading=False)``:
each lane's shade is kd, as ``phong_shade`` returns it then, so every lane
with W != 0 traces its shadow ray. (The reference's own final shade falls
back to XLA for that flag; here the kernels run it.)
"""

from __future__ import annotations

import torch

from ..core.features import Features

from ..core.types import Reservoirs, ShadeCtx, pack_reservoir_planes
from ..core.vec import e
from . import _build
from .shading import phong_shade
from .trace import any_hit, check_soup
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


_CTX_FIELDS = ("valid", "position", "normal", "view_origin", "kd", "ks",
               "shininess", "geom_id", "depth_t")
_RES_FIELDS = ("pos", "color", "w_sum", "m", "big_w", "chosen_w")


def _shade(ctx: ShadeCtx, reservoirs: Reservoirs, vis,
           features: Features) -> torch.Tensor:
    """Phong x W where ``vis`` [K, H, W], averaged over the K lanes."""
    shade = phong_shade(ctx, reservoirs.pos, reservoirs.color, features)
    contrib = torch.where(e(vis), shade, 0.0) * e(reservoirs.big_w)
    return contrib.sum(dim=0) / reservoirs.k


def final_shade_plain(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                      features: Features) -> torch.Tensor:
    """The plain version → pre-tone-map color [3, H, W]."""
    vis = visibility(ctx.position, reservoirs.pos, geometry)  # [K, H, W]
    return _shade(ctx, reservoirs, vis, features)


def _packed(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
            features: Features):
    """The kernels' inputs, checked → (ctx [18, H, W], reservoirs
    [10K, H, W], tri_cols, K, output [3, H, W])."""
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
    out = torch.empty((3, h, w), dtype=torch.float32, device=cp.device)
    return cp, rp, cols, k, out


def final_shade_bvh(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                    features: Features) -> torch.Tensor:
    """Kernel 21: the final shade of geometry with a BVH, its shadow rays
    traced by the shared K-ray walk → color [3, H, W]. The plain version
    for CPU tensors."""
    if not ctx.position.is_cuda:
        return final_shade_plain(ctx, reservoirs, geometry, features)
    from .walk import checked_tree

    cp, rp, cols, k, out = _packed(ctx, reservoirs, geometry, features)
    nodes, _ = checked_tree(geometry)
    if out.numel():
        _build.launch("romis_final_shade_bvh", cp.data_ptr(), rp.data_ptr(),
                      out[0].numel(), k, nodes.data_ptr(), cols.data_ptr(),
                      cols.shape[1], int(not features.enable_shading),
                      out.data_ptr())
        final_shade_bvh.launches += 1
    return out


final_shade_bvh.launches = 0


def _final_shade_forward(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                         features: Features) -> torch.Tensor:
    if not ctx.position.is_cuda:
        return final_shade_plain(ctx, reservoirs, geometry, features)
    if geometry.bvh is not None:
        return final_shade_bvh(ctx, reservoirs, geometry, features)
    cp, rp, cols, k, out = _packed(ctx, reservoirs, geometry, features)
    check_soup(geometry, "final shade")
    if out.numel():
        _build.launch("romis_final_shade", cp.data_ptr(), rp.data_ptr(),
                      out[0].numel(), k, cols.data_ptr(), cols.shape[1],
                      int(not features.enable_shading), out.data_ptr())
        final_shade_fused.launches += 1
    return out


def _split(tensors):
    n = len(_CTX_FIELDS)
    return (ShadeCtx(*tensors[:n]), Reservoirs(*tensors[n:]))


class _FinalShade(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geometry, features, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.geometry, ctx.features = geometry, features
        return _final_shade_forward(*_split(tensors), geometry, features)

    @staticmethod
    def backward(ctx, ct):
        needs = ctx.needs_input_grad[2:]
        tensors = [a.detach().requires_grad_(n)
                   for a, n in zip(ctx.saved_tensors, needs)]
        c, r = _split(tensors)
        with torch.no_grad():
            vis = visibility(c.position, r.pos, ctx.geometry, any_hit)
        with torch.enable_grad():
            out = _shade(c, r, vis, ctx.features)
            grads = iter(torch.autograd.grad(
                out, [a for a, n in zip(tensors, needs) if n], ct,
                allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None
                                    for n in needs)


def final_shade_fused(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                      features: Features) -> torch.Tensor:
    """Visibility x Phong x W lane average → color [3, H, W], pre-tone-map.
    Kernel 4 for CUDA tensors (kernel 21 for geometry with a BVH), the
    plain version for CPU tensors; differentiable in ``ctx`` and
    ``reservoirs``."""
    tensors = ([getattr(ctx, f) for f in _CTX_FIELDS]
               + [getattr(reservoirs, f) for f in _RES_FIELDS])
    if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
        return _FinalShade.apply(geometry, features, *tensors)
    return _final_shade_forward(ctx, reservoirs, geometry, features)


final_shade_fused.launches = 0
