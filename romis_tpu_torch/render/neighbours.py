"""Fixed per-pixel resampling neighbourhoods for R-MIS / R-OMIS (reference
``romis_tpu/render/neighbours.py``).

Every pixel gets D+1 coordinates, itself first, chosen once per frame from
the ±radius box around it: uniformly at random in the box clamped to the
image (RANDOM), or by similarity class, sampling without replacement
within a class (SIMILAR and DISSIMILAR prefer their class and fill a
deficit from the other; EQUAL_SIMILAR_DISSIMILAR takes min(D//2 + 1,
#similar) similar cells, deficit-corrected, and dissimilar ones for the
rest). The similarity gates compare the normal dot product against the
cosine of the angle (the reference's fix of neighbour_selection.cpp:16-18).

The similarity strategies run ``ops.nbrsel``: kernel 16 for CUDA tensors,
the plain streamed top-D for CPU tensors (or with ``select`` set to it);
the deficit tail below is torch code for both, as in the reference.

On a row band (``band``, ``parallel.mesh.Bands``) the selection runs on
the band's rows with the gates extended by a halo of ``radius`` rows
(kernel 16's band entry), the draws made for the whole frame and cut to
the band's rows, and the coordinates are the frame's.

Random numbers: ``noise`` replaces the draws — for RANDOM the uniforms
[2, D, H, W] (rows, then columns), for the similarity strategies one score
plane per box offset [(2r+1)²-1, H, W] in the XLA path's order (dy-major,
dx-minor, (0, 0) skipped). Otherwise they come from ``generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.features import Features, NeighbourSelectionStrategy
from ..core.types import ShadeCtx
from ..ops import nbrsel
from ..ops.band import frame_rows


def _to_coords(packs, rows, cols, radius: int):
    """Box indices [D, H, W] → (rows, cols) of the cells."""
    side = 2 * radius + 1
    p = torch.clamp_min(packs, 0)
    return (rows + torch.div(p, side, rounding_mode="floor") - radius,
            cols + p % side - radius)


def select_neighbour_indices(generator, ctx: ShadeCtx, height: int,
                             width: int, features: Features, noise=None,
                             select=nbrsel.neighbour_select, band=None):
    """Per-pixel neighbour coordinates (rows [D+1, H, W], cols [D+1, H, W],
    int32), self first. ``select`` is the box scan of the similarity
    strategies (``ops.nbrsel.neighbour_select`` by default, or its plain
    version). The context is read without gradient: neighbour choice is
    discrete. On a row ``band`` the context and the outputs are the band's
    rows (``height`` the frame's, ``noise`` the whole frame's), the
    coordinates the frame's."""
    d = features.num_neighbours_to_sample
    radius = features.spatial_resample_radius
    dev = ctx.depth_t.device
    h = ctx.depth_t.shape[-2]
    cut = (lambda t: t) if band is None else band.band_rows
    rows = frame_rows(h, 0 if band is None else band.row_base, dev)
    cols = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    self_r = rows.expand(h, width)[None]
    self_c = cols.expand(h, width)[None]
    strategy = features.neighbour_selection_strategy

    if strategy == NeighbourSelectionStrategy.RANDOM:
        # D uniform picks in the window clamped to the image.
        lo_y = torch.clamp_min(rows - radius, 0)
        hi_y = torch.clamp_max(rows + radius, height - 1)
        lo_x = torch.clamp_min(cols - radius, 0)
        hi_x = torch.clamp_max(cols + radius, width - 1)
        if noise is None:
            noise = torch.rand((2, d, height, width), generator=generator,
                               device=generator.device)
        noise = cut(noise)
        ny = lo_y + torch.floor(noise[0] * (hi_y - lo_y + 1)).int()
        nx = lo_x + torch.floor(noise[1] * (hi_x - lo_x + 1)).int()
        return torch.cat([self_r, ny]), torch.cat([self_c, nx])

    two = strategy == NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR
    prefer = strategy in (NeighbourSelectionStrategy.SIMILAR,
                          NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR)
    key = None
    if noise is None and ctx.depth_t.is_cuda:
        from ..ops.spatial import philox_key

        key = philox_key(generator)
    normal_cos = float(np.cos(
        features.neighbour_max_normal_angle_difference_radians))
    gates = nbrsel.selection_gates(ctx)
    on_band = {}
    if band is not None:
        gates = band.extend(gates, radius)
        noise = None if noise is None else cut(noise)
        on_band = dict(row_base=band.row_base, h_global=height)
    with torch.no_grad():
        outs = select(
            gates, d, radius, two, prefer,
            features.neighbour_same_geometry,
            features.neighbour_max_depth_difference_fraction, normal_cos,
            generator=generator, key=key, scores=noise, **on_band)

    if not two:
        s, p = outs
        ny, nx = _to_coords(p, rows, cols, radius)
        real = torch.isfinite(s)
        return (torch.cat([self_r, torch.where(real, ny, rows)]),
                torch.cat([self_c, torch.where(real, nx, cols)]))

    # EqualSimilarDissimilar: n_sim = min(D//2 + 1, #similar), raised so the
    # dissimilar class can fill the rest, capped at D; slots in rank order.
    s_s, p_s, s_d, p_d, cnt = outs
    c_s, c_d = cnt[0], cnt[1]
    ny_s, nx_s = _to_coords(p_s, rows, cols, radius)
    ny_d, nx_d = _to_coords(p_d, rows, cols, radius)
    i_s = ny_s * width + nx_s
    i_d = ny_d * width + nx_d
    n_sim = torch.clamp_max(c_s, d // 2 + 1)
    n_sim = torch.maximum(n_sim, d - torch.clamp_max(c_d, d))
    n_sim = torch.clamp_max(n_sim, d)
    ranks = torch.arange(d, dtype=torch.int32, device=dev)[:, None, None]
    take_sim = ranks < n_sim[None]
    sim_pick = torch.where(take_sim & torch.isfinite(s_s), i_s, -1)
    # The ranks from n_sim on take the dissimilar slots from the top.
    dis_rank = (ranks - n_sim[None]).clamp(0, d - 1).long()
    dis_idx_at = torch.gather(i_d, 0, dis_rank)
    dis_fin = torch.gather(torch.isfinite(s_d), 0, dis_rank)
    picks = torch.where(take_sim, sim_pick,
                        torch.where(dis_fin, dis_idx_at, -1))
    self_pack = rows * width + cols
    picks = torch.where(picks < 0, self_pack[None], picks)
    return (torch.cat([self_r, torch.div(picks, width,
                                          rounding_mode="floor")]),
            torch.cat([self_c, picks % width]))
