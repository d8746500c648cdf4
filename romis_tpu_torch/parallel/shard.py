"""The sharded ReSTIR frame and training step (reference
``romis_tpu/parallel/shard.py``).

The reference has two lowerings of the sharded frame: this module's, which
constrains the pixel axis to the mesh and lets GSPMD turn the neighbour
reads into collectives, and ``parallel/halo.py``'s hand-scheduled halo
exchange. Without GSPMD there is no second lowering in PyTorch: both names
are the one band frame of ``parallel.halo.render_frame_halo``.

``make_sharded_train_step`` is the reference's SGD step of the L2 loss over
that frame. Each rank renders its row band through the band entries
(``diff.grad.render_with_params`` with the band) and differentiates its
band's term of the loss; gradients cross the band edges through the halo
exchange's transpose (``parallel.halo.halo_extend``), and the loss and the
scene parameters' gradients are summed over the ranks in one
``all_reduce`` (``Bands.all_reduce``), after which every rank takes the
same step. The reference's GSPMD does the same sum (the replicated
parameters' psum). Run it under ``torchrun``, one process a GPU::

    # step.py
    from romis_tpu_torch.parallel.launch import global_bands, \\
        maybe_init_distributed
    from romis_tpu_torch.parallel.shard import make_sharded_train_step

    maybe_init_distributed()            # NCCL; "cpu" joins with gloo
    bands = global_bands(height)        # this rank's rows
    step = make_sharded_train_step(geometry, lights, num_lights, height,
                                   width, features, bands, lr=1e-2)
    state = None
    for _ in range(steps):
        params, loss, state = step(params, target, generator, cam, state)

    torchrun --nproc_per_node=4 step.py

Every rank draws the whole frame's numbers (the same generator on every
rank), so without injected noise a sharded step's image rows are the
single-device step's (``diff.grad.make_grad_fn``) bit for bit at any world
size, and its loss and gradients agree up to float32 summation order.
"""

from __future__ import annotations

import torch

from ..core.features import Features
from ..diff.grad import SceneParams, _value_and_grad, render_with_params
from ..render.restir import KERNELS, FrameOps, initial_temporal_state
from .halo import render_frame_halo
from .mesh import Bands

render_frame_sharded = render_frame_halo


def band_l2_term(image: torch.Tensor, target: torch.Tensor,
                 bands: Bands) -> torch.Tensor:
    """This band's term of the frame's ``mean((image − target)²)``: the sum
    of squares over its rows (``image`` [h_loc, W, 3]; ``target`` the
    frame's [H, W, 3]) over the frame's H·W·3 values. The terms of the
    bands sum to the loss."""
    rows = target[bands.row_base:bands.row_base + bands.h_loc]
    return ((image - rows) ** 2).sum() / target.numel()


def reduce_value_and_grad(loss: torch.Tensor, grads: SceneParams,
                          bands: Bands):
    """(the loss, its gradients) summed over the ranks in one
    ``all_reduce`` of a flat buffer → (loss, SceneParams)."""
    leaves = grads.leaves()
    flat = bands.all_reduce(torch.cat([loss.reshape(1)] + [
        g.reshape(-1) for g in leaves]))
    out, at = [], 1
    for g in leaves:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[0], SceneParams(*out)


def sgd(params: SceneParams, grads: SceneParams, lr: float) -> SceneParams:
    """``p − lr·g`` for every leaf."""
    return SceneParams(*(p.detach() - lr * g for p, g in zip(
        params.leaves(), grads.leaves())))


def band_loss(params: SceneParams, target, generator, cam, geometry, lights,
              num_lights: int, height: int, width: int, features: Features,
              prev, bands: Bands, noise=None, ops: FrameOps = KERNELS):
    """This rank's term of the L2 loss of the frame rendered on its band
    with ``params`` (``band_l2_term``) → (term, the band's detached
    TemporalState). ``prev`` is the band's state (None: the first frame),
    ``noise`` the whole frame's, as in ``render_restir_frame``."""
    if prev is None:
        prev = initial_temporal_state(bands.h_loc, width,
                                      features.num_samples_in_reservoir, cam)
    image, state = render_with_params(params, generator, cam, geometry,
                                      lights, num_lights, height, width,
                                      features, prev, noise, ops, band=bands)
    return band_l2_term(image, target, bands), state


def make_sharded_grad_fn(geometry, lights, num_lights: int, height: int,
                         width: int, features: Features, bands: Bands,
                         ops: FrameOps = KERNELS):
    """The value and gradient of the L2 loss over the ranks' row bands:
    ``fn(params, target, generator, cam, prev, noise=None)`` → (loss,
    SceneParams of gradients, both summed over the ranks; this rank's
    TemporalState). The sharded counterpart of ``diff.grad.make_grad_fn``;
    ``target`` is the frame's [H, W, 3] on every rank."""

    def value_and_grad(params: SceneParams, target, generator, cam, prev,
                       noise=None):
        loss, state, grads = _value_and_grad(
            lambda p: band_loss(p, target, generator, cam, geometry, lights,
                                num_lights, height, width, features, prev,
                                bands, noise, ops), params, has_aux=True)
        loss, grads = reduce_value_and_grad(loss, grads, bands)
        return loss, grads, state

    return value_and_grad


def make_sharded_train_step(geometry, lights, num_lights: int, height: int,
                            width: int, features: Features, bands: Bands,
                            lr: float = 1e-2, ops: FrameOps = KERNELS):
    """SGD on the scene parameters over the sharded frame:
    ``step(params, target, generator, cam, prev, noise=None)`` →
    (new_params, loss, this rank's TemporalState), the same new parameters
    on every rank. ``prev`` is the band's state (None: the first frame)."""
    value_and_grad = make_sharded_grad_fn(geometry, lights, num_lights,
                                          height, width, features, bands, ops)

    def step(params: SceneParams, target, generator, cam, prev, noise=None):
        loss, grads, state = value_and_grad(params, target, generator, cam,
                                            prev, noise)
        return sgd(params, grads, lr), loss, state

    return step


__all__ = ["render_frame_sharded", "make_sharded_grad_fn",
           "make_sharded_train_step"]
