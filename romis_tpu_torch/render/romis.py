"""R-OMIS: reservoir-based optimal multiple importance sampling (reference
``romis_tpu/render/romis.py``, renderROMIS of render.cpp:121-265).

Per pixel, a (D+1)×(D+1) technique matrix A and a contribution vector b per
colour channel accumulate over the iterations; the optimal per-technique
weights α solve A α = b (``solve_alpha``: a Tikhonov-regularised Cholesky
unrolled on the image planes, converging to the min-norm least-squares α
of the reference's Eigen completeOrthogonalDecomposition). The pixel is
the sum of the α (direct estimator, render.cpp:234-264) or a running
progressive estimate whose α are re-solved on the reference's schedule
(render.cpp:159-204).

Per sample (render.cpp:168-219): colvec_j = 1/W'_j with the mock weight
W'_j = (1/p̂_j)(1/M_j)(wSum_j − chosenW_j + p̂_j·|lights|)
(render_utils.cpp:245-257); scale = 1/(FLT_MIN + K·Σ_j colvec_j);
ŵ = scale·colvec; A += ŵŵᵀ; b_c += scale·ŵ·f_c (scale enters b twice, as
in the reference). The progressive estimator uses the float ratio
K/(D+1), the reference's fix of its integer division (render.cpp:139).

The frame runs as ``render.rmis`` does, with the R-OMIS sweep: kernel 17
accumulates A's upper triangle and b (and the progressive sum) per
iteration (on geometry with a BVH in its ``ext_vis`` mode,
``render.rmis.sweep``); ``solve_alpha`` stays plain tensor code between
iterations, as in the reference. The sweep's plain version is
``romis_iteration_terms`` on the gathered neighbourhood
(``ops.mis.mis_iteration_plain``). With ``fused_resampling=False`` the
iterations run the differentiable formulation of ``render.rmis``
(``iteration_step``), each under a checkpoint; the α solve stays outside
them and runs only on the refresh iterations, so no iteration solves the
all-zero system of iteration 0 (the reference's scan solves every
iteration and bumps that system to keep its backward finite).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import CameraParams
from ..core.features import Features
from ..ops.mis import expand_a_upper, resolve_neighbour_ctx
from ..ops.shading import exposure_tone_mapping
from ..utils import stats
from .restir import KERNELS, FrameOps, band_gather
from .rmis import (
    FLT_MIN, check_mis, iteration_step, neighbour_phat, neighbourhood,
    samples, shade_neighbourhood,
)


def _colvec_for_samples(get_j, nb, p_recv, lane_counts, num_lights: int,
                        features: Features):
    """colVecW of every sample (d, lane) under every technique j → a list
    over j of [D1, K, H, W], with the stats of member j's reservoir in the
    same lane and the reference's grad-safe gates (p̂ above 1e-18, |W'|
    above 1e-37)."""
    d1 = nb.pos.shape[0]
    inv_m = 1.0 / torch.clamp_min(torch.as_tensor(
        np.asarray(lane_counts, np.float32), device=p_recv.device), 1e-37)
    colvec = []
    for j in range(d1):
        p_j = neighbour_phat(get_j, nb, j, p_recv, features)
        ok_p = p_j > 1e-18
        inv_p = torch.where(ok_p, 1.0 / torch.where(ok_p, p_j, 1.0), 0.0)
        w_prime = (inv_p * inv_m[:, None, None]) * (
            (nb.w_sum[j] - nb.chosen_w[j]) + p_j * float(num_lights))
        ok_w = ok_p & (torch.abs(w_prime) > 1e-37)
        colvec.append(torch.where(
            ok_w, 1.0 / torch.where(ok_w, w_prime, 1.0), 0.0))
    return colvec


def solve_alpha(a_mat: torch.Tensor, b_vec: torch.Tensor) -> torch.Tensor:
    """α = (A + λI)⁻¹ b per pixel and channel, λ = 1e-6·tr(A)/D1 + 1e-20,
    by a Cholesky factorisation unrolled on the [H, W] planes: a_mat
    [D1, D1, H, W], b_vec [3, D1, H, W] → [3, D1, H, W]. Pivots are floored
    at λ; non-finite α (numerically rank-0 neighbourhoods) become 0."""
    n = a_mat.shape[0]
    tr = a_mat[0, 0]
    for i in range(1, n):
        tr = tr + a_mat[i, i]
    lam = 1e-6 * tr / n + 1e-20
    a = [[a_mat[i, j] + lam if i == j else a_mat[i, j] for j in range(n)]
         for i in range(n)]
    zero = torch.zeros_like(lam)

    def dot(pairs):
        out = zero
        for x, y in pairs:
            out = out + x * y
        return out

    low = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for j in range(n):
        diag = torch.sqrt(torch.maximum(
            a[j][j] - dot((low[j][q], low[j][q]) for q in range(j)), lam))
        low[j][j] = diag
        inv_diag[j] = 1.0 / diag
        for i in range(j + 1, n):
            low[i][j] = (a[i][j] - dot((low[i][q], low[j][q])
                                       for q in range(j))) * inv_diag[j]

    def solve_one(rhs):
        y = [None] * n
        for i in range(n):
            y[i] = (rhs[i] - dot((low[i][q], y[q]) for q in range(i))) \
                * inv_diag[i]
        x = [None] * n
        for i in reversed(range(n)):
            x[i] = (y[i] - dot((low[q][i], x[q]) for q in range(i + 1, n))) \
                * inv_diag[i]
        return x

    alpha = torch.stack([torch.stack(solve_one([b_vec[c, i]
                                                for i in range(n)]))
                         for c in range(3)])
    return torch.where(torch.isfinite(alpha), alpha, 0.0)


def romis_ab_from_colvec(nb, colvec, f, alphas):
    """The post-colvec half of an iteration: scale, ŵ and the updates → (A
    upper [D1(D1+1)/2, H, W], b [3·D1, H, W], and with ``alphas``
    [3·D1, H, W] the progressive sum Σ_{d,k} (f − Σ_j α_j·colvec_j) /
    (FLT_MIN + K/D1·Σ_j colvec_j) [3, H, W]), summed in the sweep's
    order."""
    d1, k = nb.pos.shape[:2]
    h, w = nb.pos.shape[-2:]
    dev = nb.pos.device
    s_cv = colvec[0]
    for j in range(1, d1):
        s_cv = s_cv + colvec[j]
    ok_s = s_cv >= 1e-30
    scale = torch.where(ok_s, 1.0 / torch.where(
        ok_s, FLT_MIN + float(k) * s_cv, 1.0), 1.0 / FLT_MIN)
    w_hat = torch.stack([cv * scale for cv in colvec])  # [J, D1, K, H, W]
    ws = w_hat * scale
    iu, ju = np.triu_indices(d1)
    a_up = torch.zeros((len(iu), h, w), device=dev)
    b = torch.zeros((3, d1, h, w), device=dev)
    for d, lane in samples(nb):
        wh = w_hat[:, d, lane]
        a_up = a_up + wh[iu] * wh[ju]
        b = b + ws[:, d, lane][None] * torch.stack(
            [fc[d, lane] for fc in f])[:, None]
    if alphas is None:
        return a_up, b.reshape(3 * d1, h, w)
    al = alphas.reshape(3, d1, h, w)
    sum_frac = FLT_MIN + (float(k) / float(d1)) * s_cv
    ok_f = sum_frac >= 1e-30
    inv_sf = torch.where(ok_f, 1.0 / torch.where(ok_f, sum_frac, 1.0),
                         1.0 / FLT_MIN)
    prog = torch.zeros((3, h, w), device=dev)
    for d, lane in samples(nb):
        terms = []
        for c in range(3):
            sap = al[c, 0] * colvec[0][d, lane]
            for j in range(1, d1):
                sap = sap + al[c, j] * colvec[j][d, lane]
            terms.append((f[c][d, lane] - sap) * inv_sf[d, lane])
        prog = prog + torch.stack(terms)
    return a_up, b.reshape(3 * d1, h, w), prog


def romis_iteration_terms(ctx, get_j, nb, alphas, lane_counts,
                          num_lights: int, geometry, features: Features,
                          vis=None):
    """One R-OMIS iteration from the gathered neighbourhood (fields
    [D1, K, ..., H, W]: pos, color, w_sum, chosen_w) → the sweep's
    outputs (see ``romis_ab_from_colvec``); ``vis`` [D1, K, H, W] as in
    ``render.rmis.shade_neighbourhood``."""
    f, p_recv = shade_neighbourhood(ctx, nb, geometry, features, vis)
    colvec = _colvec_for_samples(get_j, nb, p_recv, lane_counts, num_lights,
                                 features)
    return romis_ab_from_colvec(nb, colvec, f, alphas)


def romis_estimate(step, d1: int, k: int, height: int, width: int,
                   features: Features, device):
    """The R-OMIS accumulation over ``step(it, alphas)`` (the sweep's
    outputs for iteration ``it``) → (colour [3, H, W], α [3, D1, H, W]):
    A and b summed over the iterations and solved once (direct), or the
    progressive estimate with α re-solved on the reference's schedule.
    Each iteration is a span ``romis.mis_iter``; each α solve a span
    ``romis.alpha_solve``, also timed on ``device``'s clock."""
    progressive = features.use_progressive_romis
    a_up = torch.zeros((d1 * (d1 + 1) // 2, height, width), device=device)
    b_vec = torch.zeros((3 * d1, height, width), device=device)
    final = torch.zeros((3, height, width), device=device)
    alphas = torch.zeros((3, d1, height, width), device=device)
    total = float(d1 * k)
    for it in range(features.max_iterations_mis):
        if (progressive and it >= 1
                and it % features.progressive_update_mod == 0):
            with stats.span("romis.alpha_solve", device):
                alphas = solve_alpha(expand_a_upper(a_up, d1),
                                     b_vec.reshape(3, d1, height, width))
        if progressive:
            final = final + alphas.sum(dim=1)
        with stats.span("romis.mis_iter"):
            outs = step(it, alphas.reshape(3 * d1, height, width)
                        if progressive else None)
        a_up = a_up + outs[0]
        b_vec = b_vec + outs[1]
        if progressive:
            final = final + outs[2] / total
    if progressive:
        return final / features.max_iterations_mis, alphas
    with stats.span("romis.alpha_solve", device):
        alpha_out = solve_alpha(expand_a_upper(a_up, d1),
                                b_vec.reshape(3, d1, height, width))
    return alpha_out.sum(dim=1), alpha_out


def render_romis(generator, cam: CameraParams, geometry, lights,
                 num_lights: int, height: int, width: int,
                 features: Features, return_alphas: bool = False,
                 inject=None, noise=None, ops: FrameOps = KERNELS,
                 band=None):
    """Full R-OMIS render → tone-mapped image [H, W, 3] (and with
    ``return_alphas`` the per-technique α images [D1, H, W, 3]).
    ``inject``, ``noise`` and ``band`` (the band's rows out) as in
    ``render.rmis.render_rmis``."""
    check_mis(features, geometry, ops)
    nbr_noise, ris_u = (None, None) if noise is None else noise
    with stats.span("romis.select"):
        ctx, cen, offs = neighbourhood(generator, cam, geometry, height,
                                       width, features, ops, inject,
                                       nbr_noise, band)
        nbr_ctx = resolve_neighbour_ctx(cen, offs, band_gather(
            band, features.spatial_resample_radius, ops))
    d1 = features.num_neighbours_to_sample + 1
    step = iteration_step(generator, ctx, cen, offs, lights, num_lights,
                          geometry, features, "romis", ops, inject, ris_u,
                          nbr_ctx, band, height)
    color, alpha_out = romis_estimate(
        step, d1, features.num_samples_in_reservoir, cen.shape[-2], width,
        features, cen.device)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    image = color.permute(1, 2, 0)
    if return_alphas:
        return image, alpha_out.permute(1, 2, 3, 0)
    return image
