"""Sharded R-MIS / R-OMIS over row bands (reference
``romis_tpu/parallel/mis.py``).

The MIS neighbourhood of a pixel lies within ±``spatial_resample_radius``
rows of it (neighbour_selection.cpp:55-58), so each rank renders its row
band of the frame (``render.rmis.render_rmis`` / ``render.romis.
render_romis`` with ``band``) with a halo of that many rows from the ranks
above and below (``parallel.halo.halo_extend``):

- the neighbour selection (kernel 16's band entry) reads the band's gates
  with the halo; its coordinates are the frame's, and the offsets those
  coordinates give stay within the frame;
- the neighbours' contexts come from kernel 9 on the band's context
  planes extended by the halo;
- every iteration's canonical reservoirs are drawn in one launch (kernel
  15's band entry) and the pack is exchanged once a frame for all the
  iterations (the reference exchanges every iteration, since its pack
  holds one);
- each iteration's sweep (kernel 17's band entry) reads the extended pack;
  on a scene with a BVH the ext_vis rays take the neighbours' sample
  positions from the same extended pack;
- the α solve and the progressive terms are pixel-local.

The sweep runs the same kernels as the single-device frame (the
reference's sharded bodies use its XLA formulation). Every rank draws the
whole frame's numbers and every kernel counts the frame's pixel, so
without injected noise the sharded frame equals the single-device frame
bit for bit, at any world size. ``inject`` (the frame's neighbour
coordinates and per-iteration reservoirs, the reference's hook) replaces
the draws; each rank takes its rows.

``make_sharded_mis_train_step`` is the reference's SGD step of the L2 loss
over the sharded R-MIS / R-OMIS frame, on the differentiable formulation
(``fused_resampling=False``, ``render.rmis.differentiable_iteration`` on
the band): each iteration's canonical reservoirs on the band's rows, their
planes extended by the halo between the iteration's two checkpoints, the
neighbourhoods gathered by kernel 9 on the extended planes (kernel 10 its
backward, whose halo rows' gradients the exchange's transpose returns to
the bands they came from), the shadow rays on the band's pixels. The loss
and the gradients are summed over the ranks as in
``parallel.shard.make_sharded_train_step``; under ``torchrun`` (see
there)::

    step = make_sharded_mis_train_step(geometry, lights, num_lights, height,
                                       width, features, global_bands(height))
    params, loss, grads = step(params, target, generator, cam)

Without injected noise its image rows are the single-device step's
(``diff.grad.make_mis_grad_fn``) bit for bit, its loss and gradients the
same up to float32 summation order.
"""

from __future__ import annotations

from ..core.features import Features
from ..diff.grad import SceneParams, _value_and_grad, render_mis_with_params
from ..render.restir import KERNELS, FrameOps
from ..render.rmis import render_rmis
from ..render.romis import render_romis
from .halo import gather_image
from .mesh import Bands
from .shard import band_l2_term, reduce_value_and_grad, sgd


def render_rmis_sharded(generator, cam, geometry, lights, num_lights: int,
                        height: int, width: int, features: Features,
                        bands: Bands, inject=None, noise=None,
                        ops: FrameOps = KERNELS):
    """R-MIS over the ranks' row bands → the tone-mapped image [H, W, 3]
    on every rank; ``inject`` and ``noise`` as in ``render_rmis`` (the
    whole frame's)."""
    bands.check_halo(features.spatial_resample_radius)
    image = render_rmis(generator, cam, geometry, lights, num_lights, height,
                        width, features, inject=inject, noise=noise, ops=ops,
                        band=bands)
    return gather_image(image, bands)


def render_romis_sharded(generator, cam, geometry, lights, num_lights: int,
                         height: int, width: int, features: Features,
                         bands: Bands, return_alphas: bool = False,
                         inject=None, noise=None, ops: FrameOps = KERNELS):
    """R-OMIS over the ranks' row bands → the tone-mapped image [H, W, 3]
    (and with ``return_alphas`` the per-technique α images
    [D1, H, W, 3]) on every rank; ``inject`` and ``noise`` as in
    ``render_romis``."""
    bands.check_halo(features.spatial_resample_radius)
    out = render_romis(generator, cam, geometry, lights, num_lights, height,
                       width, features, return_alphas=return_alphas,
                       inject=inject, noise=noise, ops=ops, band=bands)
    if not return_alphas:
        return gather_image(out, bands)
    image, alphas = out
    return gather_image(image, bands), gather_image(alphas, bands)


def mis_band_loss(params: SceneParams, target, generator, cam, geometry,
                  lights, num_lights: int, height: int, width: int,
                  features: Features, bands: Bands, inject=None, noise=None,
                  ops: FrameOps = KERNELS):
    """This rank's term of the L2 loss of the R-MIS or R-OMIS frame (by
    ``features.ray_trace_mode``) rendered on its band with ``params``
    (``parallel.shard.band_l2_term``); ``inject`` and ``noise`` the whole
    frame's, as in ``render.rmis.render_rmis``."""
    bands.check_halo(features.spatial_resample_radius)
    image = render_mis_with_params(params, generator, cam, geometry, lights,
                                   num_lights, height, width, features,
                                   inject, noise, ops, band=bands)
    return band_l2_term(image, target, bands)


def make_sharded_mis_train_step(geometry, lights, num_lights: int,
                                height: int, width: int, features: Features,
                                bands: Bands, lr: float = 1e-2,
                                ops: FrameOps = KERNELS):
    """SGD on the scene parameters over the sharded R-MIS / R-OMIS frame:
    ``step(params, target, generator, cam, inject=None, noise=None)`` →
    (new_params, loss, gradients), the loss and gradients summed over the
    ranks and the same new parameters on every rank."""

    def step(params: SceneParams, target, generator, cam, inject=None,
             noise=None):
        loss, grads = _value_and_grad(
            lambda p: mis_band_loss(p, target, generator, cam, geometry,
                                    lights, num_lights, height, width,
                                    features, bands, inject, noise, ops),
            params)
        loss, grads = reduce_value_and_grad(loss, grads, bands)
        return sgd(params, grads, lr), loss, grads

    return step
