"""The halo exchange and the ReSTIR frame on row bands (reference
``romis_tpu/parallel/halo.py``).

Each rank renders its row band of the frame. A neighbour read stays within
a fixed number of rows of its pixel: ±``spatial_resample_radius`` for the
spatial passes (render_utils.cpp:108-111), ±``reprojection_radius`` for
temporal reprojection. So before each such read a rank extends the planes
it reads by that many rows from the ranks above and below it
(``halo_extend``: one ``batch_isend_irecv`` with each neighbour), and the
kernels' band entries read the extended planes (``ops.band``): the context
and gates once a frame, the reservoirs before every pass (the combine
rewrites them), the previous frame's planes for reprojection.

The reference's halo path folds a per-device key into its draws, an
estimator-equivalent pattern but not the same draws. The port's bands keep
the whole frame's draws instead: every rank draws from its
``torch.Generator`` exactly as the single-device frame does (the frame's
shapes, cut to its rows), and every kernel puts the frame's pixel index in
its Philox counter. So without injected noise the sharded frame equals
``render.restir.render_restir_frame`` bit for bit, at any world size.
"""

from __future__ import annotations

import torch

from ..core.features import Features
from ..core.types import Reservoirs, ShadeCtx
from ..render.restir import (
    KERNELS, FrameOps, initial_temporal_state, render_restir_frame,
    spatial_reuse,
)
from .mesh import Bands


def _peer(bands: Bands, rank: int) -> int:
    """The global rank of rank ``rank`` of the bands' group."""
    import torch.distributed as dist

    return rank if bands.group is None else \
        dist.get_global_rank(bands.group, rank)


def _swap_rows(bands: Bands, up: torch.Tensor, down: torch.Tensor):
    """Send ``up`` [..., r, W] to the rank above and ``down`` to the rank
    below, in one ``dist.batch_isend_irecv`` → (the rows received from
    above, from below), each zeros where there is no neighbour. Both
    neighbours take part, so every rank's sends meet their receives."""
    import torch.distributed as dist

    up, down = up.contiguous(), down.contiguous()
    from_above, from_below = torch.zeros_like(up), torch.zeros_like(down)
    ops = []
    if bands.rank > 0:
        peer = _peer(bands, bands.rank - 1)
        ops += [dist.P2POp(dist.isend, up, peer, bands.group),
                dist.P2POp(dist.irecv, from_above, peer, bands.group)]
    if bands.rank < bands.world - 1:
        peer = _peer(bands, bands.rank + 1)
        ops += [dist.P2POp(dist.isend, down, peer, bands.group),
                dist.P2POp(dist.irecv, from_below, peer, bands.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_above, from_below


class _HaloExchange(torch.autograd.Function):
    """The exchange of a world of two or more, and its transpose.

    Forward: a band's top rows go up (the rank above's bottom halo), its
    bottom rows go down. Backward: the cotangent g [..., h + 2r, W] of the
    extended band sends its halo rows' cotangents back to the ranks whose
    rows they were (g[..., :r, :] up, g[..., -r:, :] down) and adds what
    comes back to its own edge rows; with r ≤ h < 2r the top and bottom
    edge rows overlap and both additions apply."""

    @staticmethod
    def forward(ctx, x, radius: int, bands: Bands):
        ctx.radius, ctx.bands = radius, bands
        above, below = _swap_rows(bands, x[..., :radius, :],
                                  x[..., -radius:, :])
        return torch.cat([above, x, below], dim=-2)

    @staticmethod
    def backward(ctx, g):
        r, bands = ctx.radius, ctx.bands
        from_above, from_below = _swap_rows(bands, g[..., :r, :],
                                            g[..., -r:, :])
        grad = g[..., r:-r, :].clone()
        if bands.rank < bands.world - 1:
            grad[..., -r:, :] += from_below
        if bands.rank > 0:
            grad[..., :r, :] += from_above
        return grad, None, None


def halo_extend(x: torch.Tensor, radius: int, bands: Bands) -> torch.Tensor:
    """Extend this rank's band [..., h_loc, W] with ``radius`` rows from
    the bands above and below → [..., h_loc + 2·radius, W]: one
    ``dist.batch_isend_irecv`` of the edge rows with each neighbouring rank.
    The edge ranks' outer rows are zeros, which the band entries never read
    (they clamp to the frame). A world of 1 pads with zeros.

    Differentiable in ``x``: the backward is the exchange's transpose
    (``_HaloExchange``), one ``batch_isend_irecv`` with each neighbour, so
    gradients cross the band edges where the forward read across them.
    Every rank runs the same sequence of exchanges, forward and backward,
    which keeps the point-to-point sends of neighbouring ranks matched."""
    bands.check_halo(radius)
    if bands.exchange is not None:
        return bands.exchange(x, radius, bands)
    if radius == 0:
        return x
    if bands.world == 1:
        return torch.nn.functional.pad(x, (0, 0, radius, radius))
    return _HaloExchange.apply(x, radius, bands)


def spatial_reuse_halo(generator, ctx: ShadeCtx, reservoirs: Reservoirs,
                       height: int, width: int, geometry, features: Features,
                       bands: Bands, inject=None,
                       ops: FrameOps = KERNELS) -> Reservoirs:
    """Spatial reuse on this rank's row band (``ctx`` and ``reservoirs``
    its rows; ``height`` the image's) → the band's reservoirs: the passes
    of ``render.restir.spatial_reuse`` with the band's planes extended by a
    halo before each (kernels 5 and 11 in their band entries on CUDA
    tensors with ``fused_resampling`` and ``fused_spatial_gather``, else
    the gather at the frame-clamped offsets through kernel 9 on the
    extended planes). ``inject`` (per pass: the whole frame's offsets
    [2, R, H, W] and Gumbel noise [R+1, K, H, W]) replaces the draws, as
    the reference's does; each rank takes its rows."""
    return spatial_reuse(generator, ctx, reservoirs, height, width, features,
                         ops, inject, None, None, geometry, band=bands)


def render_frame_band(generator, cam, geometry, lights, num_lights: int,
                      height: int, width: int, features: Features, prev,
                      bands: Bands, noise=None, ops: FrameOps = KERNELS):
    """One ReSTIR frame on this rank's row band → (its image rows
    [h_loc, W, 3], its TemporalState). ``prev`` is the band's state (None:
    the first frame); ``noise`` the whole frame's, as in
    ``render_restir_frame``."""
    if prev is None:
        prev = initial_temporal_state(bands.h_loc, width,
                                      features.num_samples_in_reservoir, cam)
    return render_restir_frame(generator, cam, geometry, lights, num_lights,
                               height, width, features, prev, noise=noise,
                               ops=ops, band=bands)


def gather_image(image: torch.Tensor, bands: Bands) -> torch.Tensor:
    """Every rank's image rows [..., h_loc, W, 3] → the frame's
    [..., H, W, 3] on every rank."""
    return bands.gather_rows(image.movedim(-1, -3)).movedim(-3, -1)


def render_frame_halo(generator, cam, geometry, lights, num_lights: int,
                      height: int, width: int, features: Features, prev,
                      bands: Bands, noise=None, ops: FrameOps = KERNELS):
    """The ReSTIR frame over the ranks' row bands → (image [H, W, 3] on
    every rank, this rank's TemporalState, which stays its band's, as the
    reference's stays row-sharded). The same frame as
    ``render.restir.render_restir_frame``, bit for bit without injected
    noise: every phase runs on the band, temporal reprojection and the
    spatial passes read halos (``halo_extend``)."""
    image, state = render_frame_band(generator, cam, geometry, lights,
                                     num_lights, height, width, features,
                                     prev, bands, noise, ops)
    return gather_image(image, bands), state
