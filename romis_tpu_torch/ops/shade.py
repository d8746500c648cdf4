"""Final shade: shadow visibility x Phong x W, averaged over the K lanes
(reference ``romis_tpu/ops/pallas_shade.py``).

Kernel 4 (``csrc/shade.cu``, ``final_shade_soup``) replaces the Pallas
``_shade_kernel`` on a triangle soup: a thread per (pixel, lane), a pixel's
K lanes side by side in one warp, each tracing its live shadow ray through
the soup culled as kernel 7 culls it (the blocks of
``ops.trace.zcount_blocks``, staged with their grown boxes and guard data
in shared memory; ``ops.trace.any_hit_culled`` is the plain model of the
walk, with the plain any-hit's bool on every ray) and computing its lane's
Phong term only where the lane is lit; the pixel's first thread sums the K
terms in lane order. Its plain version, ``final_shade_plain``, is the
unfused formulation: ``ops.wrs.visibility`` and ``ops.shading.phong_shade``.

Kernel 21 (``final_shade_bvh``, the BVH mode of ``csrc/shade.cu``) replaces
the Pallas ``_shade_paged_kernel`` for geometry with a BVH, with the same
mapping and arithmetic: each live shadow ray walks the tree alone (kernel
20's walk, ``csrc/walk.cuh``, on the triangle records
``ops.walk.tri_records``). The TPU kernel's one shared walk of a pixel's K
rays lost to walks per ray on this card (kernel 20). Its plain version is
the same ``final_shade_plain``, whose visibility then walks the tree
(``ops.traverse.bvh_any``).

Both kernels read the context's and the reservoirs' own planes
(``_fields``), no packed copies. ``final_shade_fused`` dispatches on
``geometry.bvh`` (the reference's ``restir.py:571-579``) and is
differentiable in the context and the reservoirs, with the reference's
re-evaluation backward (``render/restir._final_shade_fused_bwd``): the
shadow rays are traced again without gradient by ``ops.trace.any_hit``
(kernel 6 on CUDA), and Phong x W is differentiated with that visibility
held fixed.

Bound on the H100: the bytes the frame's data needs, counted in 32-byte
sectors (valid, W and the colour out at every pixel; position, normal and
sample position where a lane may be live; colour and material where one
is lit), or the tests of the walk: kernel 4's box, guard and triangle
tests on a culled soup, kernel 21's box and triangle tests of the tree.

Both kernels have the unshaded mode of ``Features(enable_shading=False)``:
each lane's shade is kd, as ``phong_shade`` returns it then, so every lane
with W != 0 traces its shadow ray. (The reference's own final shade falls
back to XLA for that flag; here the kernels run it.)
"""

from __future__ import annotations

import torch

from ..core.features import Features

from ..core.types import Reservoirs, ShadeCtx
from ..core.vec import e, vdot
from . import _build
from .shading import phong_shade
from .trace import ZCOUNT_BLOCK, any_hit, check_soup, zcount_blocks
from .wrs import visibility

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


def _fields(ctx: ShadeCtx, reservoirs: Reservoirs):
    """The kernels' inputs, each field's own planes (no packed copies),
    checked and contiguous → ([position, normal, view origin, kd, ks,
    shininess, valid, sample positions, colours, W], K)."""
    h, w = ctx.depth_t.shape[-2:]
    k = reservoirs.k
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"final shade kernel: K={k} outside 1..{MAX_LANES}")

    def plane(name, a, shape, dtype=torch.float32):
        a = a.detach().expand(shape).contiguous()
        _build.check(a, name, dtype, shape)
        return a

    return [plane("position", ctx.position, (3, h, w)),
            plane("normal", ctx.normal, (3, h, w)),
            plane("view_origin", ctx.view_origin, (3, h, w)),
            plane("kd", ctx.kd, (3, h, w)), plane("ks", ctx.ks, (3, h, w)),
            plane("shininess", ctx.shininess, (h, w)),
            plane("valid", ctx.valid, (h, w), torch.bool),
            plane("pos", reservoirs.pos, (k, 3, h, w)),
            plane("color", reservoirs.color, (k, 3, h, w)),
            plane("big_w", reservoirs.big_w, (k, h, w))], k


def final_shade_bvh(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                    features: Features) -> torch.Tensor:
    """Kernel 21: the final shade of geometry with a BVH, each live shadow
    ray walking the tree alone → color [3, H, W]. The plain version for
    CPU tensors."""
    if not ctx.position.is_cuda:
        return final_shade_plain(ctx, reservoirs, geometry, features)
    from .walk import checked_tree, kept_records

    planes, k = _fields(ctx, reservoirs)
    nodes = checked_tree(geometry)
    h, w = ctx.depth_t.shape[-2:]
    out = torch.empty((3, h, w), dtype=torch.float32, device=nodes.device)
    if out.numel():
        recs = kept_records(geometry)
        _build.launch("romis_final_shade_bvh",
                      *(a.data_ptr() for a in planes), h * w, k,
                      nodes.data_ptr(), recs.data_ptr(),
                      int(not features.enable_shading), out.data_ptr())
    return out


def final_shade_soup(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                     features: Features, occlusion: bool = False):
    """Kernel 4: the final shade of a triangle soup, its shadow rays walking
    the culled soup (``zcount_blocks``, built at the soup's first call; a
    soup of at most ``ZCOUNT_BLOCK`` triangles, or none, tested directly) →
    color [3, H, W]; with ``occlusion`` also each lane's bool [K, H, W]
    (False where the lane's ray is not traced: a dead lane). The plain
    version for CPU tensors (its occlusion: the plain any-hit of the lanes
    kernel 4 traces)."""
    if not ctx.position.is_cuda:
        color = final_shade_plain(ctx, reservoirs, geometry, features)
        if not occlusion:
            return color
        return color, shadow_occlusion_plain(ctx, reservoirs, geometry,
                                             features)
    planes, k = _fields(ctx, reservoirs)
    _build.check(geometry.tri_cols, "tri_cols", torch.float32)
    check_soup(geometry, "final shade")
    if geometry.tri_cols.shape[1] <= ZCOUNT_BLOCK:
        # Nothing to cull: the kernel tests the soup as given (none: every
        # lane visible), so no blocks are built (gradient steps repack the
        # columns every step).
        cols, boxes, guard = geometry.tri_cols.detach().contiguous(), None, None
    else:
        cols, boxes, guard = zcount_blocks(geometry)
    h, w = ctx.depth_t.shape[-2:]
    dev = ctx.position.device
    out = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    occ = torch.zeros((k, h, w), dtype=torch.bool, device=dev) \
        if occlusion else None
    if out.numel():
        _build.launch("romis_final_shade",
                      *(a.data_ptr() for a in planes), h * w, k,
                      cols.data_ptr(),
                      None if boxes is None else boxes.data_ptr(),
                      None if guard is None else guard.data_ptr(),
                      cols.shape[1], int(not features.enable_shading),
                      out.data_ptr(), None if occ is None else occ.data_ptr())
    return out if occ is None else (out, occ)


def shadow_occlusion_plain(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                           features: Features, any_hit_fn=None):
    """Each lane's shadow-ray occlusion as kernel 4 reports it → bool
    [K, H, W]: ``any_hit_fn`` (the plain any-hit by default) on the rays of
    ``ops.wrs.visibility``, False where the lane is not traced (when
    shaded, a light behind the surface or an invalid receiver, by
    ``phong_shade``'s dot product; W = 0; a coincident light)."""
    from .trace import any_hit_plain

    pos, smp = ctx.position.detach(), reservoirs.pos.detach()
    occluded = ~visibility(pos, smp, geometry, any_hit_fn or any_hit_plain)
    to = smp - pos
    dist = torch.sqrt(torch.clamp_min(vdot(to, to), 1e-24))
    dot_nl = vdot(ctx.normal.detach(), to / e(torch.clamp_min(dist, 1e-20)))
    gate = (not features.enable_shading) | (ctx.valid & (dot_nl >= 0.0))
    return occluded & gate & (reservoirs.big_w.detach() != 0.0)


def _final_shade_forward(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                         features: Features) -> torch.Tensor:
    if not ctx.position.is_cuda:
        return final_shade_plain(ctx, reservoirs, geometry, features)
    if geometry.bvh is not None:
        return final_shade_bvh(ctx, reservoirs, geometry, features)
    return final_shade_soup(ctx, reservoirs, geometry, features)


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
