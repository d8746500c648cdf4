"""R-MIS: reservoir-based multiple importance sampling (reference
``romis_tpu/render/rmis.py``, renderRMIS of render.cpp:64-119).

Iterated RIS over a fixed per-pixel neighbourhood: each iteration draws
fresh canonical reservoirs, then every pixel shades every sample of its
D+1 neighbourhood pixels with a per-sample MIS weight — equal, 1/(D+1), or
the generalised balance heuristic (render_utils.cpp:179-187) — times the
sample's W, divided by the K samples per reservoir. Iterations are averaged
and tone mapped.

A frame runs the primary rays (closest hit, kernel 1; hit attributes and
materials, kernel 2), the neighbour selection (``render.neighbours``,
kernel 16), the neighbours' contexts for the balance heuristic (halo gather,
kernel 9), every iteration's canonical reservoirs in one launch (kernel 15)
and one sweep per iteration (kernel 17). With
``initial_samples_visibility_check`` each iteration runs its own RIS
(kernel 3) and the visibility kill (any-hit, kernel 6), as the reference
does. ``ops`` picks the kernels or the plain versions (``restir.KERNELS``,
``restir.PLAIN``).

The sweep's plain version is the reference's XLA formulation of one
iteration, whose pieces are here (``shade_neighbourhood``,
``balance_heuristic_weights``, ``rmis_sample_contrib``) and in
``render.romis``; ``ops.mis.mis_iteration_plain`` gathers the
neighbourhood and calls them. On geometry with a BVH (``ops.bvh.with_bvh``,
any scene size) the sweep runs in its ``ext_vis`` mode, as the reference's
does above its soup kernels' triangles: per iteration ``mis_ext_vis``
gathers the neighbours' sample positions (``ops.halo_gather``) and traces
the D1·K shadow rays of every pixel in one batch (``ops.any_hit``: kernel
20, the shared BVH walk), and the sweep reads those visibility planes. A
soup above the soup kernels' 2048 triangles without a BVH is refused,
naming ``with_bvh``; so is the MIS gradient formulation
(``surrogate_resampling_grad``), not ported yet.
"""

from __future__ import annotations

import torch

from ..core.camera import CameraParams, generate_rays
from ..core.features import Features, MISWeight
from ..core.types import ShadeCtx
from ..ops.mis import (
    MAX_NEIGHBOURS, mis_pack_planes, pack_mis_reservoirs,
    resolve_neighbour_ctx,
)
from ..ops.shade import pack_center_ctx
from ..ops.shading import (
    exposure_tone_mapping, phong_shade_planes, target_pdf_planes,
)
from ..ops.trace import MAX_SOUP_TRIS
from ..ops.wrs import (
    gen_canonical_samples, gen_canonical_samples_plain, visibility,
)
from .neighbours import select_neighbour_indices
from .restir import KERNELS, PLAIN, FrameOps, trace_primary

FLT_MIN = 1.17549435e-38  # the reference's FLT_MIN denominators


def mis_offsets(ny: torch.Tensor, nx: torch.Tensor) -> torch.Tensor:
    """Neighbour coordinates [D1, H, W] (self first) → the sweep's offsets
    [2D, H, W] int32 (dy block, then dx block)."""
    h, w = ny.shape[-2:]
    rows = torch.arange(h, dtype=torch.int32, device=ny.device)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=ny.device)[None, :]
    return torch.cat([ny[1:].int() - rows, nx[1:].int() - cols])


def ctx_j_getter(ctx: ShadeCtx, nbr_ctx):
    """j → the context of neighbourhood member j: the receiver for j = 0,
    else neighbour j from the 14-plane pack (``ops.mis.
    resolve_neighbour_ctx``) with the receiver's view origin."""
    def get(j):
        if j == 0:
            return ctx
        c = nbr_ctx[14 * (j - 1):14 * j]
        return ShadeCtx(position=c[0:3], normal=c[3:6],
                        view_origin=ctx.view_origin, kd=c[6:9], ks=c[9:12],
                        shininess=c[12], valid=c[13] > 0.5,
                        geom_id=ctx.geom_id, depth_t=ctx.depth_t)
    return get


def _comps(nb):
    p, c = nb.pos, nb.color
    return (p[:, :, 0], p[:, :, 1], p[:, :, 2],
            c[:, :, 0], c[:, :, 1], c[:, :, 2])  # [D1, K, H, W] each


def shade_neighbourhood(ctx: ShadeCtx, nb, geometry, features: Features,
                        vis=None):
    """Every neighbourhood sample (fields [D1, K, ..., H, W]) at the
    receiver → (f: the visible shade, 3 planes [D1, K, H, W], shadow rays by
    the plain block scan or traversal unless their visibility ``vis``
    [D1, K, H, W] is given; the receiver's p̂, the norm of the unshadowed
    shade)."""
    from ..ops.intersect import intersect_any

    rgb = phong_shade_planes(ctx, *_comps(nb), features)
    sq = rgb[0] * rgb[0] + rgb[1] * rgb[1] + rgb[2] * rgb[2]
    ok = sq > 1e-30
    p_recv = torch.where(ok, torch.sqrt(torch.where(ok, sq, 1.0)), 0.0)
    if vis is None:
        vis = visibility(ctx.position, nb.pos, geometry, intersect_any)
    return [torch.where(vis, c, 0.0) for c in rgb], p_recv


def neighbour_phat(get_j, nb, j: int, p_recv, features: Features):
    """p̂ of every sample under member j's context (j = 0: ``p_recv``)."""
    if j == 0:
        return p_recv
    return target_pdf_planes(get_j(j), *_comps(nb), features)


def balance_heuristic_weights(get_j, nb, p_recv, features: Features):
    """generalisedBalanceHeuristic: p̂_receiver / (FLT_MIN + Σ_j p̂_j),
    the denominator over every neighbourhood member's own context."""
    denom = FLT_MIN + p_recv
    for j in range(1, nb.pos.shape[0]):
        denom = denom + neighbour_phat(get_j, nb, j, p_recv, features)
    return p_recv / denom


def samples(nb):
    """The (d, lane) sample order of the sweep's sums."""
    d1, k = nb.pos.shape[:2]
    return [(d, lane) for d in range(d1) for lane in range(k)]


def rmis_sample_contrib(ctx: ShadeCtx, get_j, nb, geometry,
                        features: Features, balance: bool, vis=None):
    """One R-MIS iteration's contribution Σ_{d,k} w·W·f / K → [3, H, W]
    (render.cpp:92-112), summed in the sweep's order."""
    d1, k = nb.pos.shape[:2]
    f, p_recv = shade_neighbourhood(ctx, nb, geometry, features, vis)
    if balance:
        mis_w = balance_heuristic_weights(get_j, nb, p_recv, features)
    else:
        mis_w = torch.full(p_recv.shape, 1.0 / d1, device=p_recv.device)
    weight = mis_w * nb.big_w
    contrib = torch.zeros((3,) + tuple(p_recv.shape[-2:]),
                          device=p_recv.device)
    for d, lane in samples(nb):
        contrib = contrib + torch.stack(
            [weight[d, lane] * fc[d, lane] for fc in f]) / k
    return contrib


def check_mis(features: Features, geometry, ops: FrameOps) -> None:
    """Refuse what belongs to a later slice, and the XLA-formulation flags
    on the card: there ``ops`` alone picks the kernels or the plain
    versions (``restir.PLAIN``)."""
    if (geometry.tri_cols.is_cuda and ops is not PLAIN
            and not (features.fused_resampling
                     and features.fused_spatial_gather)):
        raise ValueError(
            "R-MIS / R-OMIS on CUDA tensors runs the kernels; for the plain "
            "versions pass ops=restir.PLAIN instead of fused_resampling="
            "False or fused_spatial_gather=False")
    if features.surrogate_resampling_grad:
        raise NotImplementedError(
            "R-MIS / R-OMIS with surrogate_resampling_grad is the MIS "
            "gradient formulation (gather_nb_records, slim_ctx_stream), "
            "not ported yet")
    if geometry.bvh is None and geometry.tri_cols.shape[1] > MAX_SOUP_TRIS:
        raise ValueError(
            f"R-MIS / R-OMIS above {MAX_SOUP_TRIS} triangles traces its "
            "shadow rays through a BVH: attach one with ops.bvh.with_bvh")
    if not 1 <= features.num_neighbours_to_sample <= MAX_NEIGHBOURS:
        raise ValueError(f"R-MIS / R-OMIS: D = "
                         f"{features.num_neighbours_to_sample} outside "
                         f"1..{MAX_NEIGHBOURS}")


def iteration_packs(generator, ctx: ShadeCtx, lights, num_lights: int,
                    geometry, features: Features, romis: bool,
                    ops: FrameOps, inject=None, uniforms=None):
    """Per iteration, (reservoir pack, block index): every block of one
    batched RIS (``ops.mis_ris``) on CUDA tensors without the initial
    visibility check, else one canonical RIS per iteration (with the
    check's any-hit; the plain RIS on CPU tensors, as the reference runs
    its XLA path off the TPU), or the injected reservoirs."""
    fused = ctx.position.is_cuda
    it_n = features.max_iterations_mis
    if inject is not None:
        for res in inject[2]:
            yield pack_mis_reservoirs(res, romis), 0
        return
    if fused and not features.initial_samples_visibility_check:
        pack = ops.mis_ris(ctx, lights, num_lights, features, it_n, romis,
                           generator=generator, uniforms=uniforms)
        for i in range(it_n):
            yield pack, i
        return
    ris = ops.ris if fused else gen_canonical_samples_plain
    for i in range(it_n):
        res = gen_canonical_samples(
            ctx, lights, num_lights, geometry, features, generator=generator,
            uniforms=None if uniforms is None else uniforms[i], ris=ris,
            any_hit=ops.any_hit)
        yield pack_mis_reservoirs(res, romis), 0


def mis_ext_vis(ctx: ShadeCtx, pos_planes: torch.Tensor, offs: torch.Tensor,
                geometry, k: int, ops: FrameOps = KERNELS) -> torch.Tensor:
    """Visibility planes [D1·K, H, W] (1.0 = visible) for the sweep's
    ``ext_vis`` mode (reference ``rmis.mis_ext_vis``): the neighbours'
    sample positions through the per-pixel offsets (``ops.halo_gather``),
    then every pixel's D1·K shadow rays from the receiver in one batch
    (``ops.any_hit``; ``ops.wrs.visibility``, with the coincident-pair
    escape). ``pos_planes`` = an iteration block's pos planes [3K, H, W]
    (the ``pack_mis_reservoirs`` order)."""
    d = offs.shape[0] // 2
    h, w = pos_planes.shape[-2:]
    nbr_pos = ops.halo_gather(pos_planes, offs[:d], offs[d:])  # [D, 3K, ..]
    targets = torch.cat([pos_planes[None], nbr_pos]).reshape(d + 1, k, 3, h,
                                                             w)
    vis = visibility(ctx.position, targets, geometry, ops.any_hit)
    return vis.reshape((d + 1) * k, h, w).float()


def sweep(ops: FrameOps, ctx: ShadeCtx, cen, pack, block: int, offs,
          geometry, mode: str, num_lights: int, features: Features, **kw):
    """One ``ops.mis_iteration`` on iteration block ``block`` of ``pack``,
    in the ``ext_vis`` mode (``mis_ext_vis`` first) for geometry with a
    BVH."""
    k = features.num_samples_in_reservoir
    if geometry.bvh is not None:
        c_res = mis_pack_planes(mode, k)
        kw["ext_vis"] = mis_ext_vis(
            ctx, pack[block * c_res:block * c_res + 3 * k], offs, geometry, k,
            ops)
    return ops.mis_iteration(cen, pack, offs, geometry, k, mode, num_lights,
                             features, it_block=block, **kw)


def neighbourhood(generator, cam: CameraParams, geometry, height: int,
                  width: int, features: Features, ops: FrameOps, inject,
                  noise):
    """The frame's receivers and fixed neighbourhoods → (ctx, packed
    receiver [18, H, W], offsets [2D, H, W])."""
    rays = generate_rays(cam, height, width)
    _, ctx = trace_primary(rays, geometry, features, ops)
    if inject is not None:
        ny, nx = inject[0], inject[1]
    else:
        ny, nx = select_neighbour_indices(generator, ctx, height, width,
                                          features, noise=noise,
                                          select=ops.neighbour_select)
    return ctx, pack_center_ctx(ctx), mis_offsets(ny, nx)


def render_rmis(generator, cam: CameraParams, geometry, lights,
                num_lights: int, height: int, width: int, features: Features,
                inject=None, noise=None, ops: FrameOps = KERNELS):
    """Full R-MIS render → tone-mapped image [H, W, 3].

    ``inject`` = (rows [D1, H, W], cols [D1, H, W], [Reservoirs per
    iteration]) replaces the neighbour selection and the canonical
    reservoirs (the reference's golden-test hook); ``noise`` = (the
    selection's noise, see ``render.neighbours``; RIS uniforms
    [iterations, S/K, 4, K, H, W]) replaces the draws."""
    check_mis(features, geometry, ops)
    nbr_noise, ris_u = (None, None) if noise is None else noise
    ctx, cen, offs = neighbourhood(generator, cam, geometry, height, width,
                                   features, ops, inject, nbr_noise)
    balance = features.mis_weight_rmis == MISWeight.BALANCE
    mode = "rmis_balance" if balance else "rmis_equal"
    nbr_ctx = resolve_neighbour_ctx(cen, offs, ops.halo_gather) \
        if balance else None
    acc = torch.zeros((3, height, width), device=cen.device)
    for pack, block in iteration_packs(generator, ctx, lights, num_lights,
                                       geometry, features, False, ops,
                                       inject, ris_u):
        acc = acc + sweep(ops, ctx, cen, pack, block, offs, geometry, mode,
                          num_lights, features, nbr_ctx=nbr_ctx)
    color = acc / features.max_iterations_mis
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    return color.permute(1, 2, 0)
