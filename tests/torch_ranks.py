"""Rank bodies of the port's sharded-frame and sharded-step tests
(``test_torch_parallel.py``, ``test_torch_parallel_mis.py``,
``test_torch_parallel_grad.py``), run in processes spawned with
``torch.multiprocessing``: they import torch and the port only, never JAX
or the JAX package.

The test writes the inputs (scenes, cameras, features, the JAX package's
draws) into a directory with ``torch.save``; ``run`` joins a gloo group of
four ranks through a ``file://`` store there (with a timeout, so that a
hang fails instead of waiting) and runs the named body at world sizes 1, 2
and 4: alone, on the subgroups {0, 1} and {2, 3}, and on the whole group.
Each rank saves what it returned, which the test reads back and compares.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch

TIMEOUT_S = 60
RANKS = 4
WORLDS = (1, 2, 4)
# A sharded step's loss and gradients against the single-device step's:
# the same float32 terms summed in another order.
STEP_RTOL = 1e-5


def _init(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def run(rank: int, directory: str, body: str) -> None:
    """Spawn target: join the group of RANKS, run ``BODIES[body]`` on the
    inputs at every world size of WORLDS, and save this rank's results
    ({world: the body's output}, with rank 0's single-device frames) as
    ``{body}_{rank}.pt``."""
    import torch.distributed as dist

    from romis_tpu_torch.parallel.mesh import Bands, make_bands

    _init(rank, RANKS, os.path.join(directory, f"store_{body}"))
    inputs = torch.load(os.path.join(directory, f"{body}_inputs.pt"),
                        weights_only=False)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {1: None, 2: pairs[rank // 2], 4: None}
    out = {}
    for world in WORLDS:
        def bands(h, world=world):
            return Bands(h) if world == 1 else make_bands(h, groups[world])
        out[world] = BODIES[body](inputs, bands)
    if rank == 0:
        out["single"] = SINGLE[body](inputs)
    torch.save(out, os.path.join(directory, f"{body}_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def band_fields(dc, bands):
    """A dataclass of whole-frame [..., H, W] tensors → the band's rows."""
    return dataclasses.replace(dc, **{f.name: bands.band_rows(
        getattr(dc, f.name)) for f in dataclasses.fields(dc)})


def frames(case, bands=None):
    """The frames of ``case`` = (scene, cameras, features, seed, (H, W)):
    through ``render_frame`` without ``bands``, else through the sharded
    frame of the features' mode on ``bands`` → (images [H, W, 3], the last
    state's reservoir planes or None)."""
    from romis_tpu_torch import RayTraceMode
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.parallel.mis import (
        render_rmis_sharded, render_romis_sharded,
    )
    from romis_tpu_torch.parallel.shard import render_frame_sharded
    from romis_tpu_torch.render.pipeline import render_frame

    scene, cams, feats, seed, (h, w) = case
    gen = torch.Generator().manual_seed(seed)
    g, li, nl = scene.geometry, scene.lights, scene.num_lights
    images, state = [], None
    for cam in cams:
        if bands is None:
            image, state = render_frame(gen, cam, scene, h, w, feats, state)
        elif feats.ray_trace_mode == RayTraceMode.RMIS:
            image = render_rmis_sharded(gen, cam, g, li, nl, h, w, feats,
                                        bands)
        elif feats.ray_trace_mode == RayTraceMode.ROMIS:
            image = render_romis_sharded(gen, cam, g, li, nl, h, w, feats,
                                         bands)
        else:
            image, state = render_frame_sharded(gen, cam, g, li, nl, h, w,
                                                feats, state, bands)
        images.append(image)
    planes = None if state is None else pack_reservoir_planes(
        state.reservoirs)
    return images, planes


def _equal_cases(inputs, bands_of):
    """Each bit-for-bit case's sharded frames."""
    return {name: frames(case, bands_of(case[4][0]))
            for name, case in inputs["equal"].items()}


def restir_body(inputs, bands_of):
    """The halo exchange, spatial reuse on injected noise, the sharded
    frame on the JAX package's draws, and the equal-to-single cases, on
    the bands of ``bands_of(height)``."""
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.parallel.halo import halo_extend, spatial_reuse_halo
    from romis_tpu_torch.parallel.shard import render_frame_sharded

    x, radius = inputs["halo"]
    bands = bands_of(x.shape[-2])
    out = {"halo": halo_extend(bands.band_rows(x), radius, bands)}
    for name, (scene, ctx, res, feats, inject, (h, w)) in \
            inputs["spatial"].items():
        bands = bands_of(h)
        got = spatial_reuse_halo(None, band_fields(ctx, bands),
                                 band_fields(res, bands), h, w,
                                 scene.geometry, feats, bands, inject=inject)
        out[name] = pack_reservoir_planes(got)
    scene, cam, feats, noises, (h, w) = inputs["frame"]
    bands = bands_of(h)
    state, images = None, []
    for noise in noises:
        image, state = render_frame_sharded(
            None, cam, scene.geometry, scene.lights, scene.num_lights, h, w,
            feats, state, bands, noise=noise)
        images.append(image)
    out["frame"] = (images, state.reservoirs.m)
    out["equal"] = _equal_cases(inputs, bands_of)
    return out


def mis_body(inputs, bands_of):
    """The sharded R-MIS / R-OMIS frames on the JAX package's injected
    neighbourhoods and reservoirs, and the equal-to-single cases; without
    ``bands_of`` the injected frames on the single device."""
    from romis_tpu_torch import RayTraceMode
    from romis_tpu_torch.parallel.mis import (
        render_rmis_sharded, render_romis_sharded,
    )

    from romis_tpu_torch.render.rmis import render_rmis
    from romis_tpu_torch.render.romis import render_romis

    out = {}
    for name, (scene, cam, feats, inject, (h, w)) in inputs["jax"].items():
        bands = None if bands_of is None else bands_of(h)
        args = (None, cam, scene.geometry, scene.lights, scene.num_lights, h,
                w, feats)
        rmis = feats.ray_trace_mode == RayTraceMode.RMIS
        if bands is None:
            out[name] = render_rmis(*args, inject=inject) if rmis else \
                render_romis(*args, return_alphas=True, inject=inject)
        elif rmis:
            out[name] = render_rmis_sharded(*args, bands, inject=inject)
        else:
            out[name] = render_romis_sharded(*args, bands, return_alphas=True,
                                             inject=inject)
    if bands_of is not None:
        out["equal"] = _equal_cases(inputs, bands_of)
    return out


def _single_frames(inputs):
    return {name: frames(case) for name, case in inputs["equal"].items()}


def halo_transpose(x, c, radius, bands):
    """The halo exchange's backward on this band: x the frame's [..., H, W],
    c the cotangent of every band's extended rows, stacked in rank order
    → (⟨halo_extend(x_band), c_band⟩, ⟨x_band, its gradient⟩, the
    gradient)."""
    h_ext = bands.h_loc + 2 * radius
    xb = bands.band_rows(x).clone().requires_grad_()
    cb = c[..., bands.rank * h_ext:(bands.rank + 1) * h_ext, :]
    lhs = (bands.extend(xb, radius) * cb).sum()
    (grad,) = torch.autograd.grad(lhs, xb)
    return lhs.detach(), (xb.detach() * grad).sum(), grad


def step_outputs(case, bands=None):
    """A ReSTIR case = (scene, camera, Features, params, target, the two
    steps' noise or None, seed) on ``bands``. With noise: two steps of
    ``make_sharded_train_step``, the state carried → {"params": [after
    each step], "loss": [...]}. Without (the generator's draws): the value
    and gradient of two frames at the same parameters, the state carried,
    through ``make_sharded_grad_fn`` (without ``bands``, ``make_grad_fn``)
    → {"loss", "grads", "images": the frames' image rows}."""
    from romis_tpu_torch.diff.grad import make_grad_fn, render_with_params
    from romis_tpu_torch.parallel.shard import (
        make_sharded_grad_fn, make_sharded_train_step,
    )
    from romis_tpu_torch.render.restir import initial_temporal_state

    scene, cam, feats, params, target, noises, seed = case
    h, w = target.shape[:2]
    args = (scene.geometry, scene.lights, scene.num_lights, h, w, feats)
    if noises is not None:
        step, state = make_sharded_train_step(*args, bands), None
        out, p = {"params": [], "loss": []}, params
        for noise in noises:
            p, loss, state = step(p, target, None, cam, state, noise)
            out["params"].append(p)
            out["loss"].append(loss)
        return out
    fn = make_grad_fn(*args) if bands is None else \
        make_sharded_grad_fn(*args, bands)
    gen = torch.Generator().manual_seed(seed)
    prev = initial_temporal_state(h if bands is None else bands.h_loc, w,
                                  feats.num_samples_in_reservoir, cam)
    out = {"loss": [], "grads": [], "images": []}
    for _ in range(2):
        drawn = gen.get_state()
        loss, grads, *state = fn(params, target, gen, cam, prev)
        # The frame the step rendered, drawn again (its backward draws
        # nothing), and its state.
        with torch.no_grad():
            image, prev = render_with_params(
                params, torch.Generator().set_state(drawn), cam, *args, prev,
                band=bands)
        if state:
            assert all(torch.equal(a, b) for a, b in zip(
                state[0].reservoirs.__dict__.values(),
                prev.reservoirs.__dict__.values()))
        out["loss"].append(loss)
        out["grads"].append(grads)
        out["images"].append(image)
    return out


def mis_step_outputs(case, bands=None):
    """An MIS case = (scene, camera, Features, params, target, inject or
    None, seed) → one step through ``make_sharded_mis_train_step`` on
    ``bands`` (else ``make_mis_grad_fn`` and SGD): {"params", "loss",
    "grads", "image": the step's image rows (drawn again from the seed)}."""
    from romis_tpu_torch.diff.grad import (
        make_mis_grad_fn, render_mis_with_params,
    )
    from romis_tpu_torch.parallel.mis import make_sharded_mis_train_step
    from romis_tpu_torch.parallel.shard import sgd

    scene, cam, feats, params, target, inject, seed = case
    h, w = target.shape[:2]
    args = (scene.geometry, scene.lights, scene.num_lights, h, w, feats)
    if bands is None:
        loss, grads = make_mis_grad_fn(*args)(
            params, target, torch.Generator().manual_seed(seed), cam, inject)
        new = sgd(params, grads, 1e-2)
    else:
        new, loss, grads = make_sharded_mis_train_step(*args, bands)(
            params, target, torch.Generator().manual_seed(seed), cam, inject)
    with torch.no_grad():
        image = render_mis_with_params(
            params, torch.Generator().manual_seed(seed), cam, *args, inject,
            band=bands)
    return dict(params=new, loss=loss, grads=grads, image=image)


def grad_body(inputs, bands_of):
    """The halo exchange's transpose, the ReSTIR and MIS training steps on
    the bands of ``bands_of(height)`` (the steps of every case in
    ``inputs["restir"]`` and ``inputs["mis"]``)."""
    out = {"halo": {}}
    for name, (x, cs, radius) in inputs.get("halo", {}).items():
        bands = bands_of(x.shape[-2])
        out["halo"][name] = halo_transpose(x, cs[bands.world], radius, bands)
    for kind, run in (("restir", step_outputs), ("mis", mis_step_outputs)):
        out[kind] = {name: run(case, bands_of(case[4].shape[0]))
                     for name, case in inputs.get(kind, {}).items()}
    return out


def _single_steps(inputs):
    """The single-device steps of the cases on the generator's draws."""
    return {kind: {name: run(case) for name, case in inputs.get(
        kind, {}).items() if case[5] is None}
            for kind, run in (("restir", step_outputs),
                              ("mis", mis_step_outputs))}


BODIES = {"restir": restir_body, "mis": mis_body, "grad": grad_body}
# Rank 0's single-device frames: the equal cases' ("equal") and for the
# MIS body its injected frames' ("inject", ``mis_body`` without bands);
# the single-device steps of the gradient body's cases.
SINGLE = {"restir": lambda inputs: dict(equal=_single_frames(inputs)),
          "mis": lambda inputs: dict(equal=_single_frames(inputs),
                                     inject=mis_body(inputs, None)),
          "grad": _single_steps}


def start(directory: str, body: str, inputs):
    """Save ``inputs`` and start ``body`` on RANKS gloo ranks → the ranks'
    context for ``finish``; the caller may work meanwhile."""
    import torch.multiprocessing as mp

    torch.save(inputs, os.path.join(directory, f"{body}_inputs.pt"))
    return directory, body, mp.spawn(run, args=(directory, body),
                                     nprocs=RANKS, join=False)


def finish(started):
    """Wait for the ranks of ``start`` → ({world: the outputs of the ranks
    of rank 0's group, in rank order}, rank 0's single-device results)."""
    directory, body, context = started
    while not context.join():
        pass
    outs = [torch.load(os.path.join(directory, f"{body}_{r}.pt"),
                       weights_only=False) for r in range(RANKS)]
    return {w: [outs[r][w] for r in range(w)] for w in WORLDS}, \
        outs[0]["single"]


def image_rows(parts):
    """The bands' image rows [h_loc, W, 3], in rank order → the frame's."""
    return torch.cat(list(parts), dim=0)


def close_grads(got, want):
    """Every leaf of the SceneParams ``got`` finite and within STEP_RTOL
    (and STEP_RTOL of the leaf's largest |g|) of ``want``'s."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert bool(torch.isfinite(a).all()), f.name
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=STEP_RTOL,
                                   atol=STEP_RTOL * scale, msg=f.name)


def spawn(directory: str, body: str, inputs):
    """``start`` then ``finish``: run ``body`` on RANKS gloo ranks."""
    return finish(start(directory, body, inputs))
