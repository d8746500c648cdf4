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
naming ``with_bvh``.

A frame may render one row band of itself (``band``, ``parallel.mesh.
Bands``, for the sharded frames and step of ``parallel.mis``): the band's
rows of the rays, the selection on the band's gates with a halo of radius
rows (kernel 16's band entry), the neighbours' contexts through kernel 9
on the band's planes extended by that halo, every iteration's pack
(kernel 15's band entry) extended by that halo once a frame, and each
sweep on the band (kernel 17's band entry); draws are made for the whole
frame and cut to the band's rows. Without injected noise a band's rows
are the whole frame's, bit for bit.

With ``fused_resampling=False`` (``diff.grad.make_mis_grad_fn`` sets it,
as the reference does) the iterations run the reference's differentiable
formulation instead of kernels 15 and 17, which have no backward: per
iteration the canonical RIS (with ``surrogate_resampling_grad`` the
detached replay RIS, kernel 14, and the winner-replay tail; else the plain
candidate loop), the neighbourhood gather (``ops.halo_gather``: kernel 9,
kernel 10 as its backward; with the surrogate in replay-records mode,
``gather_nb_records``, whose light rows take kernel 2 and kernel 13), the
D1·K shadow rays of every pixel (``ops.any_hit``: kernel 6, or the BVH
walks) and the sweep's arithmetic as tensor code (``rmis_sample_contrib``,
``render.romis.romis_iteration_terms``). The neighbours' contexts are
gathered once a frame (``ops.mis.resolve_neighbour_ctx``, 14 planes a
neighbour). Each iteration runs under ``torch.utils.checkpoint``
(``checkpointed``), so the backward holds one iteration's intermediates
at a time; its random numbers come from a seed drawn before the body
(``canonical_draws``), so that the recompute draws what the forward drew.
On a row band the differentiable iteration draws the band's rows of the
frame's reservoirs (the replay RIS through kernel 14's band entry),
extends their planes by the halo between two checkpoints
(``differentiable_iteration``) and gathers the neighbourhoods with kernel
9 on the extended planes.
"""

from __future__ import annotations

from dataclasses import fields
from functools import partial
from types import SimpleNamespace

import torch
from torch.utils.checkpoint import checkpoint

from ..core.camera import CameraParams, generate_rays
from ..core.features import Features, MISWeight
from ..core.types import Rays, Reservoirs, ShadeCtx
from ..ops.band import frame_rows
from ..ops.mis import (
    MAX_NEIGHBOURS, gather_neighbourhood, mis_pack_planes,
    pack_mis_reservoirs, resolve_neighbour_ctx,
)
from ..ops.spatial import halo_band_gather
from ..ops.shade import pack_center_ctx
from ..ops.shading import (
    exposure_tone_mapping, phong_shade_planes, target_pdf_planes,
)
from ..ops.trace import MAX_SOUP_TRIS
from ..ops.wrs import (
    _lane_layout, gen_canonical_samples, gen_canonical_samples_plain,
    gen_canonical_surrogate, visibility,
)
from ..scene.lights import sample_lights_planes
from ..utils import stats
from .neighbours import select_neighbour_indices
from .restir import (
    KERNELS, PLAIN, FrameOps, _fused, band_gather, trace_primary,
)

FLT_MIN = 1.17549435e-38  # the reference's FLT_MIN denominators


def mis_offsets(ny: torch.Tensor, nx: torch.Tensor,
                row_base: int = 0) -> torch.Tensor:
    """Neighbour coordinates [D1, H, W] (self first) → the sweep's offsets
    [2D, H, W] int32 (dy block, then dx block); for a row band its rows
    from frame row ``row_base`` on."""
    h, w = ny.shape[-2:]
    rows = frame_rows(h, row_base, ny.device)
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
    """Refuse what the port does not run: on CUDA tensors the reference's
    XLA gathers (``fused_spatial_gather=False``; there ``ops`` alone picks
    the kernels or the plain versions, ``restir.PLAIN``), a large soup
    without a BVH, and D outside the sweep kernel's range."""
    if (geometry.tri_cols.is_cuda and ops is not PLAIN
            and not features.fused_spatial_gather):
        raise ValueError(
            "R-MIS / R-OMIS on CUDA tensors gathers through the kernels; for "
            "the plain versions pass ops=restir.PLAIN instead of "
            "fused_spatial_gather=False")
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
                    ops: FrameOps, inject=None, uniforms=None, band=None,
                    height=None):
    """Per iteration, (reservoir pack, block index): every block of one
    batched RIS (``ops.mis_ris``) on CUDA tensors without the initial
    visibility check, else one canonical RIS per iteration (with the
    check's any-hit; the plain RIS on CPU tensors, as the reference runs
    its XLA path off the TPU), or the injected reservoirs. On a row
    ``band`` (of a frame of ``height`` rows; ``inject`` and ``uniforms``
    the whole frame's) each pack is the band's, extended by a halo of
    radius rows: the batched pack once for every iteration."""
    fused = _fused(features, ctx.position)
    it_n = features.max_iterations_mis
    cut, ext, on_band = (lambda t: t), (lambda t: t), {}
    if band is not None:
        radius = features.spatial_resample_radius
        cut = band.band_rows
        on_band = dict(row_base=band.row_base, h_global=height)

        def ext(t):
            return band.extend(t, radius)
    if inject is not None:
        for res in inject[2]:
            yield ext(cut(pack_mis_reservoirs(res, romis))), 0
        return
    uniforms = None if uniforms is None else cut(uniforms)
    if fused and not features.initial_samples_visibility_check:
        pack = ext(ops.mis_ris(ctx, lights, num_lights, features, it_n, romis,
                               generator=generator, uniforms=uniforms,
                               **on_band))
        for i in range(it_n):
            yield pack, i
        return
    ris = partial(ops.ris if fused else gen_canonical_samples_plain,
                  **on_band)
    for i in range(it_n):
        res = gen_canonical_samples(
            ctx, lights, num_lights, geometry, features, generator=generator,
            uniforms=None if uniforms is None else uniforms[i], ris=ris,
            any_hit=ops.any_hit)
        yield ext(pack_mis_reservoirs(res, romis)), 0


def mis_ext_vis(ctx: ShadeCtx, pos_planes: torch.Tensor, offs: torch.Tensor,
                geometry, k: int, ops: FrameOps = KERNELS,
                halo: int = 0) -> torch.Tensor:
    """Visibility planes [D1·K, H, W] (1.0 = visible) for the sweep's
    ``ext_vis`` mode (reference ``rmis.mis_ext_vis``): the neighbours'
    sample positions through the per-pixel offsets (``ops.halo_gather``),
    then every pixel's D1·K shadow rays from the receiver in one batch
    (``ops.any_hit``; ``ops.wrs.visibility``, with the coincident-pair
    escape). ``pos_planes`` = an iteration block's pos planes [3K, H, W]
    (the ``pack_mis_reservoirs`` order); for a row band they hold it inside
    a halo of ``halo`` rows (``ops.spatial.halo_band_gather``)."""
    d = offs.shape[0] // 2
    h, w = offs.shape[-2:]
    nbr_pos = halo_band_gather(pos_planes, offs[:d], offs[d:], halo,
                               ops.halo_gather)  # [D, 3K, ..]
    targets = torch.cat([pos_planes[None, :, halo:halo + h],
                         nbr_pos]).reshape(d + 1, k, 3, h, w)
    vis = visibility(ctx.position, targets, geometry, ops.any_hit)
    return vis.reshape((d + 1) * k, h, w).float()


def sweep(ops: FrameOps, ctx: ShadeCtx, cen, pack, block: int, offs,
          geometry, mode: str, num_lights: int, features: Features,
          band=None, height=None, **kw):
    """One ``ops.mis_iteration`` on iteration block ``block`` of ``pack``,
    in the ``ext_vis`` mode (``mis_ext_vis`` first) for geometry with a
    BVH; on a row ``band`` of a frame of ``height`` rows, the pack
    extended by a halo (``iteration_packs``)."""
    k = features.num_samples_in_reservoir
    halo = (pack.shape[-2] - offs.shape[-2]) // 2
    if band is not None:
        kw.update(row_base=band.row_base, h_global=height)
    if geometry.bvh is not None:
        c_res = mis_pack_planes(mode, k)
        kw["ext_vis"] = mis_ext_vis(
            ctx, pack[block * c_res:block * c_res + 3 * k], offs, geometry, k,
            ops, halo)
    return ops.mis_iteration(cen, pack, offs, geometry, k, mode, num_lights,
                             features, it_block=block, **kw)


def neighbourhood(generator, cam: CameraParams, geometry, height: int,
                  width: int, features: Features, ops: FrameOps, inject,
                  noise, band=None):
    """The frame's receivers and fixed neighbourhoods → (ctx, packed
    receiver [18, H, W], offsets [2D, H, W]); a row ``band``'s (``inject``
    the whole frame's)."""
    rays = generate_rays(cam, height, width)
    if band is not None:
        rays = Rays(band.band_rows(rays.origin).contiguous(),
                    band.band_rows(rays.direction).contiguous())
    _, ctx = trace_primary(rays, geometry, features, ops)
    if inject is not None:
        ny, nx = inject[0], inject[1]
        if band is not None:
            ny, nx = band.band_rows(ny), band.band_rows(nx)
    else:
        ny, nx = select_neighbour_indices(generator, ctx, height, width,
                                          features, noise=noise,
                                          select=ops.neighbour_select,
                                          band=band)
    return ctx, pack_center_ctx(ctx), mis_offsets(
        ny, nx, 0 if band is None else band.row_base)


def checkpointed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward recomputes the body instead of holding its intermediates, so
    its kernels launch again there. The body draws from no caller's
    generator (``canonical_draws``); the global RNG states are not kept."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def canonical(ctx: ShadeCtx, lights, num_lights: int, geometry,
              features: Features, ops: FrameOps, generator=None,
              uniforms=None, records: bool = False, row_base: int = 0,
              h_global=None):
    """One iteration's canonical reservoirs on the differentiable path →
    (Reservoirs, replay records [K, 3, H, W] or None): with
    ``surrogate_resampling_grad`` the winner-replay surrogate (the
    detached replay RIS ``ops.ris_replay``, uniforms [S/K, 5, K, H, W]),
    its records kept with ``records``; else the plain candidate loop
    (uniforms [S/K, 4, K, H, W]), as the reference's
    ``gen_canonical_samples`` chooses. ``row_base`` and ``h_global``: a
    row band's (``ops.band``), whose draws are the frame's."""
    on_band = {} if h_global is None else dict(row_base=row_base,
                                               h_global=h_global)
    if features.surrogate_resampling_grad:
        res, rec = gen_canonical_surrogate(
            ctx, lights, num_lights, geometry, features, generator=generator,
            uniforms=uniforms, replay=ops.ris_replay, gather=ops.gather_rows,
            any_hit=ops.any_hit, **on_band)
        return res, rec if records else None
    return gen_canonical_samples(
        ctx, lights, num_lights, geometry, features, generator=generator,
        uniforms=uniforms, ris=partial(gen_canonical_samples_plain, **on_band),
        any_hit=ops.any_hit), None


def draw_seeds(generator, n: int) -> list[int]:
    """``n`` seeds from ``generator``, drawn before the checkpointed bodies
    that seed their own generators from them. The read back to the host
    is the span ``romis.sync.mis_seeds``."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device)
    with stats.span(stats.SYNC + "mis_seeds"):
        return seeds.tolist()


def canonical_draws(generator, ctx: ShadeCtx, lights, num_lights: int,
                    geometry, features: Features, ops: FrameOps, inject=None,
                    uniforms=None, records: bool = True, band=None,
                    height=None):
    """it → iteration ``it``'s (Reservoirs, replay records or None) on
    ``ctx``'s pixels (the whole frame, or a band's rows): the injected
    reservoirs (no records, as in the reference), or ``canonical`` on the
    iteration's uniforms [iterations, S/K, 4 or 5, K, H, W], or on a
    generator seeded inside the call from a seed drawn here; the records
    kept with ``records``. The per-iteration checkpoint's recompute then
    draws what the forward drew, and the caller's generator is not drawn
    from by the backward. On a row ``band`` of a frame of ``height`` rows
    (``inject`` and ``uniforms`` the whole frame's) the draws are the
    frame's, cut to the band's rows."""
    cut = (lambda t: t) if band is None else band.band_rows
    if inject is not None:
        return lambda it: (Reservoirs(**{
            f.name: cut(getattr(inject[2][it], f.name))
            for f in fields(Reservoirs)}), None)
    seeds = None if uniforms is not None else draw_seeds(
        generator, features.max_iterations_mis)
    dev = ctx.position.device
    on_band = {} if band is None else dict(row_base=band.row_base,
                                           h_global=height)

    def draw(it):
        gen = None if seeds is None else \
            torch.Generator(device=dev).manual_seed(seeds[it])
        return canonical(ctx, lights, num_lights, geometry, features, ops,
                         gen, None if uniforms is None else cut(uniforms[it]),
                         records, **on_band)
    return draw


def nb_planes(res, rec, romis: bool) -> tuple:
    """An iteration's reservoirs → the planes its neighbourhood gathers:
    (the slim pack,), or with replay ``records`` (the records as planes
    [3K, H, W], detached; the differentiable planes: big_w (R-MIS) or
    w_sum | chosen_w (R-OMIS))."""
    if rec is None:
        return (pack_mis_reservoirs(res, romis),)
    diff = torch.cat([res.w_sum, res.chosen_w]) if romis else res.big_w
    return rec.detach().reshape((-1,) + tuple(rec.shape[-2:])), diff


def gather_nb_records(rec: torch.Tensor, diff: torch.Tensor,
                      offs: torch.Tensor, lights, ops: FrameOps):
    """The neighbourhood gather in replay-records mode (reference
    ``rmis.gather_nb_records``): the winners' records [3K, H, W] (per lane
    light index | u | v, index -1 for none) gathered as data, only
    ``diff`` [C, H, W] (big_w, or w_sum | chosen_w) differentiably, and
    every sample's position and colour re-derived at the receiver from the
    light table through ``ops.gather_rows`` (kernel 2; kernel 13 its
    backward), zero where the record has none. Under the surrogate the
    canonical planes are derived so (``ops.wrs.surrogate_tail``), so these
    are bit for bit the stored planes and the gradient's composition is
    theirs, while the halo gather's backward shrinks to C planes → (pos
    [D1, K, 3, H, W], color, diff [D1, C, H, W]), self first. For a row
    band (offsets [2D, h, W]) the planes hold it inside a halo of rows
    (``ops.spatial.halo_band_gather``)."""
    d = offs.shape[0] // 2
    h, w = offs.shape[-2:]
    k = rec.shape[0] // 3
    halo = (rec.shape[-2] - h) // 2

    def nbhd(planes):
        return torch.cat([planes[None, :, halo:halo + h], halo_band_gather(
            planes, offs[:d], offs[d:], halo, ops.halo_gather)])
    g_rec = nbhd(rec).reshape(d + 1, k, 3, h, w)
    g_dif = nbhd(diff)
    idxf = g_rec[:, :, 0]
    has = idxf >= 0.0
    comps = sample_lights_planes(lights, torch.clamp_min(idxf, 0.0).int(),
                                 g_rec[:, :, 1], g_rec[:, :, 2],
                                 gather=ops.gather_rows)
    pos = torch.stack([torch.where(has, c, 0.0) for c in comps[0:3]], dim=2)
    color = torch.stack([torch.where(has, c, 0.0) for c in comps[3:6]],
                        dim=2)
    return pos, color, g_dif


def gather_nb(planes: tuple, offs: torch.Tensor, lights, romis: bool, k: int,
              ops: FrameOps, band=None, height=None):
    """The neighbourhood reservoirs of the differentiable path from an
    iteration's ``nb_planes``, fields [D1, K, (3,) H, W], self first: pos,
    color and big_w (R-MIS) or w_sum and chosen_w (R-OMIS), the slim pack
    through ``ops.halo_gather``, or with replay records
    ``gather_nb_records``. On a row ``band`` of a frame of ``height`` rows
    the planes are its rows inside a halo of radius rows."""
    if len(planes) == 1:
        on_band = {} if band is None else dict(row_base=band.row_base,
                                               h_global=height)
        return gather_neighbourhood(planes[0], offs,
                                    "romis" if romis else "rmis_equal", k,
                                    gather=ops.halo_gather, **on_band)
    pos, color, g = gather_nb_records(*planes, offs, lights, ops)
    if romis:
        return SimpleNamespace(pos=pos, color=color, w_sum=g[:, :k],
                               chosen_w=g[:, k:])
    return SimpleNamespace(pos=pos, color=color, big_w=g)


def differentiable_iteration(ctx: ShadeCtx, offs: torch.Tensor, lights,
                             num_lights: int, geometry, features: Features,
                             mode: str, ops: FrameOps, draw, nbr_ctx=None,
                             center=None, band=None, height=None):
    """The reference's differentiable formulation of one iteration →
    step(it, alphas=None), giving what ``ops.mis_iteration`` gives for
    iteration ``it`` (the R-MIS contribution, or A's upper triangle, b and
    with ``alphas`` the progressive sum), each iteration ``checkpointed``.
    ``draw(it)`` gives the iteration's reservoirs and records on ``ctx``'s
    pixels, which the neighbourhood is gathered over; ``nbr_ctx`` is
    ``resolve_neighbour_ctx`` on them. ``center`` slices the receiving
    pixels from those (a band's rows in ``diff.banded``; all of them by
    default).

    The whole iteration runs under one checkpoint. On a row ``band`` of a
    frame of ``height`` rows (``parallel/``) it runs under two: the draw
    and the neighbourhood's planes (``nb_planes``) in the first, the
    gathers over those planes extended by the halo and the rest in the
    second, with the halo exchange (``band.extend``) between them, outside
    both. So no checkpoint's recompute runs an exchange: every rank issues
    the forward's exchanges in order, then their transposes in the
    backward, in the autograd engine's order, which is the same on every
    rank since the ranks build the same graph. The D1·K shadow rays stay
    on the band's pixels."""
    from ..render.romis import romis_iteration_terms

    romis = mode == "romis"
    k = features.num_samples_in_reservoir
    _, lane_counts, _ = _lane_layout(features.initial_light_samples, k)
    rctx = ctx
    if center is not None:
        rctx = ShadeCtx(**{f.name: center(getattr(ctx, f.name))
                           for f in fields(ctx)})
        nbr_ctx = None if nbr_ctx is None else center(nbr_ctx)
    get_j = ctx_j_getter(rctx, nbr_ctx)

    def planes(it):
        return nb_planes(*draw(it), romis)

    def terms(pl, alphas=None):
        nb = gather_nb(pl, offs, lights, romis, k, ops, band, height)
        if center is not None:
            nb = SimpleNamespace(**{f: center(v) for f, v in vars(nb).items()})
        vis = visibility(rctx.position, nb.pos, geometry, ops.any_hit)
        if romis:
            return romis_iteration_terms(rctx, get_j, nb, alphas, lane_counts,
                                         num_lights, geometry, features, vis)
        return rmis_sample_contrib(rctx, get_j, nb, geometry, features,
                                   mode == "rmis_balance", vis)

    if band is None:
        def body(it, alphas=None):
            return terms(planes(it), alphas)
        return lambda it, alphas=None: checkpointed(body, it, alphas)
    radius = features.spatial_resample_radius

    def step(it, alphas=None):
        pl = checkpointed(planes, it)
        return checkpointed(terms, tuple(band.extend(t, radius) for t in pl),
                            alphas)
    return step


def iteration_step(generator, ctx: ShadeCtx, cen: torch.Tensor,
                   offs: torch.Tensor, lights, num_lights: int, geometry,
                   features: Features, mode: str, ops: FrameOps, inject,
                   uniforms, nbr_ctx, band=None, height=None):
    """step(it, alphas=None) → iteration ``it``'s sweep outputs: with
    ``fused_resampling`` the sweep on the iteration packs (``ops.mis_ris``
    and ``ops.mis_iteration``, in order), else the differentiable
    formulation (``differentiable_iteration``). Either takes a row
    ``band`` (of a frame of ``height`` rows)."""
    if features.fused_resampling:
        packs = iteration_packs(generator, ctx, lights, num_lights, geometry,
                                features, mode == "romis", ops, inject,
                                uniforms, band, height)

        def step(it, alphas=None):
            pack, block = next(packs)
            return sweep(ops, ctx, cen, pack, block, offs, geometry, mode,
                         num_lights, features, band, height, nbr_ctx=nbr_ctx,
                         alphas=alphas)
        return step
    draw = canonical_draws(generator, ctx, lights, num_lights, geometry,
                           features, ops, inject, uniforms, band=band,
                           height=height)
    return differentiable_iteration(ctx, offs, lights, num_lights, geometry,
                                    features, mode, ops, draw, nbr_ctx,
                                    band=band, height=height)


def render_rmis(generator, cam: CameraParams, geometry, lights,
                num_lights: int, height: int, width: int, features: Features,
                inject=None, noise=None, ops: FrameOps = KERNELS, band=None):
    """Full R-MIS render → tone-mapped image [H, W, 3].

    ``inject`` = (rows [D1, H, W], cols [D1, H, W], [Reservoirs per
    iteration]) replaces the neighbour selection and the canonical
    reservoirs (the reference's golden-test hook); ``noise`` = (the
    selection's noise, see ``render.neighbours``; RIS uniforms
    [iterations, S/K, 4, K, H, W], on the differentiable path with
    ``surrogate_resampling_grad`` the replay's [iterations, S/K, 5, K, H,
    W]) replaces the draws. With ``band`` (``parallel.mesh.Bands``) it
    renders that row band → its image rows [h, W, 3]; ``inject`` and
    ``noise`` are the whole frame's."""
    check_mis(features, geometry, ops)
    nbr_noise, ris_u = (None, None) if noise is None else noise
    balance = features.mis_weight_rmis == MISWeight.BALANCE
    mode = "rmis_balance" if balance else "rmis_equal"
    with stats.span("romis.select"):
        ctx, cen, offs = neighbourhood(generator, cam, geometry, height,
                                       width, features, ops, inject,
                                       nbr_noise, band)
        nbr_ctx = resolve_neighbour_ctx(cen, offs, band_gather(
            band, features.spatial_resample_radius, ops)) if balance \
            else None
    step = iteration_step(generator, ctx, cen, offs, lights, num_lights,
                          geometry, features, mode, ops, inject, ris_u,
                          nbr_ctx, band, height)
    acc = torch.zeros((3,) + tuple(cen.shape[-2:]), device=cen.device)
    for it in range(features.max_iterations_mis):
        with stats.span("romis.mis_iter"):
            acc = acc + step(it)
    color = acc / features.max_iterations_mis
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    return color.permute(1, 2, 0)
