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

The reference's ``make_sharded_mis_train_step`` is not ported yet: it
needs a differentiable halo exchange.
"""

from __future__ import annotations

from ..core.features import Features
from ..render.restir import KERNELS, FrameOps
from ..render.rmis import render_rmis
from ..render.romis import render_romis
from .halo import gather_image
from .mesh import Bands


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
