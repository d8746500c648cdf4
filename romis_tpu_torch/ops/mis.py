"""One R-MIS / R-OMIS iteration over the fixed neighbourhoods (reference
``romis_tpu/ops/pallas_mis.py``).

Per pixel, every sample of its D+1 neighbourhood reservoirs (self first) is
shaded at the receiver behind a shadow ray, then:
- R-MIS (``rmis_equal``, ``rmis_balance``): the contribution
  Σ_{d,k} w·W·f / K, w = 1/(D+1) or the balance heuristic
  p̂_receiver / (FLT_MIN + Σ_j p̂_j) under every neighbourhood pixel j's own
  context (render_utils.cpp:179-187);
- R-OMIS (``romis``): colvec_j = 1/W'_j for the J = D+1 techniques,
  scale = 1/(FLT_MIN + K·Σ_j colvec_j), ŵ = scale·colvec, and the updates
  A += ŵŵᵀ (upper triangle, D1(D1+1)/2 planes) and b_c += scale·ŵ·f_c
  (render.cpp:168-219); progressive mode adds Σ (f - Σ_j α_j·colvec_j) /
  (FLT_MIN + K/(D+1)·Σ_j colvec_j) over the samples (render.cpp:191-204;
  the caller divides by D1·K).

The reservoirs come as the slim pack (``pack_mis_reservoirs``: pos 3K |
color 3K | big_w K for R-MIS, pos 3K | color 3K | w_sum K | chosen_w K for
R-OMIS), possibly several iterations' blocks stacked (``it_block`` picks
one); the neighbours at per-pixel offsets [2D, H, W] (dy block, then dx
block); their contexts pre-gathered once per frame
(``resolve_neighbour_ctx``, 14 planes each).

Kernel 17 (``csrc/mis.cu``, ``mis_iteration``) replaces the Pallas
``_mis_kernel``: one thread per pixel reads the neighbour reservoirs at its
offsets straight from the pack (each member pixel found once, as a 32-bit
in-plane index: the wrapper refuses H·W ≥ 2^31) and traces the D1·K
shadow rays against the soup staged in shared memory. It
evaluates technique-major over chunks of the neighbourhood (3 members for
R-OMIS, 2 for balance): a chunk's samples go into a per-thread stage in
shared memory, each neighbour j's context, unit view and weights are read
once a chunk, p̂_j of the chunk's samples is staged (the R-OMIS colvec, or
the balance p̂), and a pass per sample forms scale, ŵ and the A / b (or
contribution) updates in the plain version's order. Its ``ext_vis`` mode (the reference's, for
geometry with a BVH) reads the visibility of the D1·K rays from planes
[D1·K, H, W] traced beforehand (``render.rmis.mis_ext_vis``, one batch
through the BVH walk) instead of tracing the soup; the planes already hold
the coincident-pair escape. Its plain version, ``mis_iteration_plain``
(which takes the same planes), is the reference's XLA formulation of one
iteration on the gathered neighbourhood (``render.rmis.
rmis_sample_contrib``, ``render.romis.romis_iteration_terms``), with the
sample sums written out in the kernel's order (d-major, then lane), so the
two round alike; the receiver's p̂ is the norm of its shade planes, as in
the reference kernel.

A row band (``row_base``, ``h_global``: ``ops.band``): the pack then holds
the band inside a halo of rows (``parallel.halo.halo_extend``, once a frame
for every iteration's block), every other input and the outputs its rows;
the offsets are the frame's, and a member's row is clamped to the frame in
frame rows, so the band's sums are the frame's, bit for bit. The plain
version takes the same arguments.

The kernel has the unshaded mode of ``Features(enable_shading=False)``:
every shade is the receiver's kd and every p̂ the norm of a kd, as the plain
formulation computes them, so every shadow ray is traced.

Bound on the H100: operations, in every mode (narrowly for equal
weights), with a ``powf``, a division or a square root counted at its
instruction cost: D1·K Phong evaluations per pixel at the receiver and,
for the balance heuristic and R-OMIS, D·D1·K more under the neighbours'
contexts, plus the shadow rays' triangle tests; device memory sees 18 +
C_res + 2D (+ 14D, + 3D1) planes in and 3 (or 21 + 18 + 3 at D = 5) out.
Every multiply-add is two instructions (``--fmad=false``, for bit-equality
with the plain version). The earlier, sample-major design reloaded each
neighbour's 14 context planes and recomputed its view for every sample
(840 floats a pixel where 70 are distinct) and held the R-OMIS
accumulators across all of it (229 registers at D1 = 6). The chunk size
trades the stage's shared memory, which bounds the warps an SM holds,
against reloads of the contexts; the registers and times of both designs
and of each chunk size are in ``PERF.md``.
"""

from __future__ import annotations

import torch

from ..core.features import Features
from ..core.types import Reservoirs
from . import _build
from .band import check_band
from .spatial import (
    clamped_offsets, halo_band_gather, halo_offset_gather,
    halo_offset_gather_plain, unpack_center_ctx,
)
from .trace import check_soup
from .wrs import _lane_layout

MODES = ("rmis_equal", "rmis_balance", "romis")
MAX_NEIGHBOURS = 8  # the R-OMIS kernel is instantiated for D = 1..8
MAX_LANES = 4
NBR_CTX_PLANES = 14


def pack_mis_reservoirs(res: Reservoirs, romis: bool) -> torch.Tensor:
    """The slim pack: pos 3K | color 3K | then big_w K (R-MIS) or w_sum K |
    chosen_w K (R-OMIS). Canonical M is the static lane layout."""
    hw = res.hw
    parts = [res.pos.reshape((-1,) + hw), res.color.reshape((-1,) + hw)]
    parts += [res.w_sum, res.chosen_w] if romis else [res.big_w]
    return torch.cat(parts, dim=0)


def mis_pack_planes(mode: str, k: int) -> int:
    """Planes per iteration block of the pack: 7K (R-MIS) or 8K (R-OMIS)."""
    return (8 if mode == "romis" else 7) * k


def resolve_neighbour_ctx(cen_ctx: torch.Tensor, offs: torch.Tensor,
                          gather=halo_offset_gather) -> torch.Tensor:
    """The neighbours' shading contexts, gathered once per frame:
    [18, H, W] (``ops.shade.pack_center_ctx``) and offsets [2D, H, W] →
    [14D, H, W], per neighbour pos3 | normal3 | kd3 | ks3 | shin | valid.
    The view origin (one per frame for the pinhole camera) and the depth
    (unread by the sweep) are not gathered."""
    d = offs.shape[0] // 2
    sub = torch.cat([cen_ctx[0:6], cen_ctx[9:16], cen_ctx[17:18]])
    g = gather(sub, offs[:d], offs[d:])
    return g.reshape((d * NBR_CTX_PLANES,) + tuple(g.shape[-2:]))


def expand_a_upper(a_up: torch.Tensor, d1: int) -> torch.Tensor:
    """Upper-triangular A planes [D1(D1+1)/2, H, W] → symmetric
    [D1, D1, H, W]."""
    rows = [[None] * d1 for _ in range(d1)]
    u = 0
    for i in range(d1):
        for j in range(i, d1):
            rows[i][j] = rows[j][i] = a_up[u]
            u += 1
    return torch.stack([torch.stack(r) for r in rows])


def _check_mode(mode, nbr_ctx, alphas):
    if mode not in MODES:
        raise ValueError(f"mis_iteration: unknown mode {mode!r}")
    if mode != "rmis_equal" and nbr_ctx is None:
        raise ValueError(f"{mode} needs the neighbour contexts (nbr_ctx)")
    if alphas is not None and mode != "romis":
        raise ValueError("alphas are read by the progressive R-OMIS only")


def pack_halo(res_planes: torch.Tensor, h: int) -> int:
    """The halo rows of a pack that holds a band of h rows inside it."""
    halo, odd = divmod(res_planes.shape[-2] - h, 2)
    if halo < 0 or odd:
        raise ValueError(f"mis_iteration: a pack of {res_planes.shape[-2]} "
                         f"rows cannot hold {h} rows inside a halo")
    return halo


def gather_neighbourhood(res_planes: torch.Tensor, offs: torch.Tensor,
                         mode: str, k: int, it_block: int = 0,
                         gather=halo_offset_gather_plain, row_base: int = 0,
                         h_global=None):
    """Block ``it_block`` of the pack at the neighbourhood, self first →
    SimpleNamespace of fields [D1, K, (3,) H, W]: pos, color and big_w
    (R-MIS) or w_sum and chosen_w (R-OMIS). ``gather`` fetches the
    neighbours (the plain halo gather; the differentiable formulation
    passes ``ops.halo_gather``, kernel 9 with kernel 10 as its backward).
    With ``h_global`` the pack holds the row band from frame row
    ``row_base`` on inside a halo, and ``offs`` are its rows' (the
    gather runs over the extended pack, ``ops.spatial.halo_band_gather``)."""
    from types import SimpleNamespace

    c_res = mis_pack_planes(mode, k)
    block = res_planes[it_block * c_res:(it_block + 1) * c_res]
    d = offs.shape[0] // 2
    h, w = offs.shape[-2:]
    h_frame = check_band("mis_iteration", h, row_base, h_global)
    halo = pack_halo(block, h)
    if h_global is None:
        g = torch.cat([block[None], gather(block, offs[:d], offs[d:])])
    else:
        dy, dx = clamped_offsets(offs.reshape(2, d, h, w), h_frame, w,
                                 row_base)
        g = torch.cat([block[None, :, halo:halo + h],
                       halo_band_gather(block, dy, dx, halo, gather)])
    nb = SimpleNamespace(pos=g[:, :3 * k].reshape(d + 1, k, 3, h, w),
                         color=g[:, 3 * k:6 * k].reshape(d + 1, k, 3, h, w))
    if mode == "romis":
        nb.w_sum, nb.chosen_w = g[:, 6 * k:7 * k], g[:, 7 * k:8 * k]
    else:
        nb.big_w = g[:, 6 * k:7 * k]
    return nb


def mis_iteration_plain(cen_ctx: torch.Tensor, res_planes: torch.Tensor,
                        offs: torch.Tensor, geometry, k: int, mode: str,
                        num_lights: int, features: Features, nbr_ctx=None,
                        alphas=None, it_block: int = 0, ext_vis=None,
                        row_base: int = 0, h_global=None):
    """The plain version: the neighbourhood gather, then
    ``render.rmis.rmis_sample_contrib`` or
    ``render.romis.romis_iteration_terms`` (shadow rays by the plain block
    scan or traversal, or read from ``ext_vis``), with the lane layout of
    ``features.initial_light_samples``; a row band's as in
    ``mis_iteration``."""
    from ..render.rmis import ctx_j_getter, rmis_sample_contrib
    from ..render.romis import romis_iteration_terms

    _check_mode(mode, nbr_ctx, alphas)
    nb = gather_neighbourhood(res_planes, offs, mode, k, it_block,
                              row_base=row_base, h_global=h_global)
    ctx = unpack_center_ctx(cen_ctx)
    get_j = ctx_j_getter(ctx, nbr_ctx)
    vis = None
    if ext_vis is not None:
        vis = ext_vis.reshape(nb.pos.shape[:2] + nb.pos.shape[-2:]) > 0.5
    if mode != "romis":
        return rmis_sample_contrib(ctx, get_j, nb, geometry, features,
                                   mode == "rmis_balance", vis)
    _, lane_counts, _ = _lane_layout(features.initial_light_samples, k)
    return romis_iteration_terms(ctx, get_j, nb, alphas, lane_counts,
                                 num_lights, geometry, features, vis)


def mis_iteration(cen_ctx: torch.Tensor, res_planes: torch.Tensor,
                  offs: torch.Tensor, geometry, k: int, mode: str,
                  num_lights: int, features: Features, nbr_ctx=None,
                  alphas=None, it_block: int = 0, ext_vis=None,
                  row_base: int = 0, h_global=None):
    """One fused iteration: cen_ctx [18, H, W], res_planes [n·C_res, H, W]
    (``pack_mis_reservoirs`` blocks; ``it_block`` picks one), offs
    [2D, H, W] int32, nbr_ctx [14D, H, W] (balance and R-OMIS), alphas
    [3·D1, H, W] (progressive R-OMIS), ext_vis [D1·K, H, W] (the samples'
    visibility, 1 = visible, d-major; required for geometry with a BVH)
    → the R-MIS contribution [3, H, W], or (A upper [D1(D1+1)/2, H, W], b
    [3·D1, H, W][, progressive sum [3, H, W]]); the samples' M is the lane
    layout of ``features.initial_light_samples`` over K. With ``h_global``
    (a frame of that many rows) ``res_planes`` holds the row band from
    frame row ``row_base`` on inside a halo of rows ([n·C_res, h + 2·halo,
    W]; the neighbours are within ±halo rows), every other input and the
    outputs its h rows; ``offs`` are the frame's, pre-clipped to it. Kernel
    17 for CUDA tensors, the plain version for CPU tensors."""
    if not cen_ctx.is_cuda:
        return mis_iteration_plain(cen_ctx, res_planes, offs, geometry, k,
                                   mode, num_lights, features, nbr_ctx,
                                   alphas, it_block, ext_vis, row_base,
                                   h_global)
    _check_mode(mode, nbr_ctx, alphas)
    d = offs.shape[0] // 2
    d1 = d + 1
    h, w = cen_ctx.shape[-2:]
    check_band("mis_iteration", h, row_base, h_global)
    halo = pack_halo(res_planes, h)
    if h_global is None and halo:
        raise ValueError("mis_iteration: a pack with halo rows is a band's; "
                         "pass row_base and h_global")
    if not 1 <= k <= MAX_LANES or not 1 <= d <= MAX_NEIGHBOURS:
        raise ValueError(f"mis_iteration: K={k}, D={d} outside "
                         f"1..{MAX_LANES}, 1..{MAX_NEIGHBOURS}")
    if (h + 2 * halo) * w >= 2 ** 31:
        raise ValueError(f"mis_iteration: {h + 2 * halo}x{w} pixels exceed "
                         "32-bit indexing")
    s = features.initial_light_samples
    c_res = mis_pack_planes(mode, k)
    if res_planes.dim() != 3 or res_planes.shape[-1] != w:
        raise ValueError(f"mis_iteration: pack {tuple(res_planes.shape)} "
                         f"does not match {h}x{w} pixels")
    if res_planes.shape[0] % c_res or not \
            0 <= it_block < res_planes.shape[0] // c_res:
        raise ValueError(f"mis_iteration: block {it_block} of a "
                         f"{res_planes.shape[0]}-plane pack of {c_res}")
    cols, n_tris = geometry.tri_cols, geometry.tri_cols.shape[1]
    vis_ptr = None
    if ext_vis is not None:
        ext_vis = ext_vis.contiguous()
        _build.check(ext_vis, "ext_vis", torch.float32, (d1 * k, h, w))
        vis_ptr = ext_vis.data_ptr()
        cols, n_tris = None, 0
    elif geometry.bvh is not None:
        raise ValueError("mis_iteration: geometry with a BVH takes its "
                         "visibility as ext_vis (render.rmis.mis_ext_vis)")
    else:
        check_soup(geometry, "mis_iteration")
        _build.check(cols, "tri_cols", torch.float32)
    _build.check(cen_ctx, "cen_ctx", torch.float32, (18, h, w))
    _build.check(res_planes, "res_planes", torch.float32)
    offs = offs.to(torch.int32).contiguous()
    _build.check(offs, "offs", torch.int32, (2 * d, h, w))
    nbr_ptr = al_ptr = None
    if nbr_ctx is not None:
        _build.check(nbr_ctx, "nbr_ctx", torch.float32,
                     (NBR_CTX_PLANES * d, h, w))
        nbr_ptr = nbr_ctx.data_ptr()
    if alphas is not None:
        alphas = alphas.contiguous()
        _build.check(alphas, "alphas", torch.float32, (3 * d1, h, w))
        al_ptr = alphas.data_ptr()
    dev = cen_ctx.device
    romis = mode == "romis"
    if romis:
        outs = [torch.empty((d1 * (d1 + 1) // 2, h, w), device=dev),
                torch.empty((3 * d1, h, w), device=dev)]
        if alphas is not None:
            outs.append(torch.empty((3, h, w), device=dev))
    else:
        outs = [torch.empty((3, h, w), device=dev)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    if h * w:
        block = res_planes[it_block * c_res:(it_block + 1) * c_res]
        args = (cen_ctx.data_ptr(), block.data_ptr(), offs.data_ptr(),
                nbr_ptr, al_ptr, vis_ptr,
                None if cols is None else cols.data_ptr(), n_tris, h, w, d1,
                k, s, num_lights, MODES.index(mode),
                int(not features.enable_shading), *ptrs)
        if h_global is None:
            _build.launch("romis_mis_iteration", *args)
        else:
            _build.launch("romis_mis_iteration_band", *args, halo, row_base,
                          h_global)
    return outs[0] if not romis else tuple(outs)
