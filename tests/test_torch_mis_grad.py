"""The port's R-MIS / R-OMIS gradient step (``diff.grad.make_mis_grad_fn``)
against the JAX package's, at 12x16 with D=2, r=2, S=4, K=2 and 2
iterations (3 for progressive R-OMIS), on the procedural scenes: equal and
balance R-MIS and direct R-OMIS on the flagship, progressive R-OMIS on the
occluder scene (on the flat quad its α is ill-conditioned, see
``test_torch_mis._frame_case``).

The loss and all 13 leaves against JAX's, with the neighbourhoods and the
canonical reservoirs injected into both, and on the surrogate's
replay-records path with JAX's draws rebuilt; the records arm against the
stored-planes arm on the same draws; finite differences of the port's own
exact gradient; and the per-iteration checkpoints, which must change no
bit and draw nothing from the caller's generator in the backward.

Gradients agree to 2e-3 of each leaf's largest |g|, as in
``test_torch_grad.py``: both packages sum the same float32 terms in other
orders."""

from dataclasses import fields, replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.camera import generate_rays, make_camera
from romis_tpu.core.features import (
    Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
)
from romis_tpu.diff.grad import (
    apply_params as jax_apply_params, extract_params as jax_extract_params,
    make_mis_grad_fn as jax_make_mis_grad_fn,
)
from romis_tpu.ops.wrs import gen_canonical_samples
from romis_tpu.render.neighbours import select_neighbour_indices
from romis_tpu.render.restir import trace_primary
from romis_tpu.render.rmis import (
    PH_ITER, PH_NEIGHBOURS, render_rmis as jax_render_rmis,
)
from romis_tpu.render.romis import render_romis as jax_render_romis
from romis_tpu_torch.core.camera import generate_rays as port_rays
from romis_tpu_torch.diff import grad as port_grad
from romis_tpu_torch.diff.grad import (
    extract_params, make_mis_grad_fn, mis_l2_image_loss,
    render_mis_with_params,
)
from romis_tpu_torch.ops.wrs import gen_canonical_surrogate
from romis_tpu_torch.render import rmis, restir
from romis_tpu_torch.render.neighbours import (
    select_neighbour_indices as port_select,
)

from torch_parity import (
    jax_ris_uniforms, occluder_scene, port_camera, port_features,
    port_params, port_reservoirs, port_scene, t,
)
from test_torch_nbrsel import jax_selection_noise

H, W, S, K, D, R = 12, 16, 4, 2, 2, 2
GRAD_REL = 2e-3
MODES = ["rmis_equal", "rmis_balance", "romis_direct", "romis_progressive"]
OCCLUDER_CAM = dict(look_at=(0.0, -0.5, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                    distance=6.0, fov_deg=50.0)


def _case(mode, **kw):
    """(JAX scene, JAX camera, JAX Features) of a mode: the flagship for
    R-MIS and direct R-OMIS, the occluder scene with random neighbourhoods
    for progressive R-OMIS, whose α are refreshed on its third iteration
    from two iterations' A (as ``test_torch_mis._frame_case``)."""
    progressive = mode == "romis_progressive"
    feats = Features(
        enable_tone_mapping=False, initial_light_samples=S,
        num_samples_in_reservoir=K, num_neighbours_to_sample=D,
        spatial_resample_radius=R, max_iterations_mis=3 if progressive else 2,
        progressive_update_mod=2,
        ray_trace_mode=(RayTraceMode.RMIS if mode.startswith("rmis")
                        else RayTraceMode.ROMIS),
        mis_weight_rmis=(MISWeight.BALANCE if mode == "rmis_balance"
                         else MISWeight.EQUAL),
        use_progressive_romis=progressive, **kw)
    if not progressive:
        return ge._flagship_scene(), ge._flagship_camera(H, W), feats
    feats = feats.replace(
        neighbour_selection_strategy=NeighbourSelectionStrategy.RANDOM)
    return (occluder_scene(ge._flagship_scene().lights),
            make_camera(resolution=(H, W), **OCCLUDER_CAM), feats)


def _target():
    return np.random.default_rng(4).uniform(0.0, 0.3, (H, W, 3)).astype(
        np.float32)


def _close(got, expect, name):
    expect = np.asarray(expect)
    scale = max(float(np.abs(expect).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=GRAD_REL,
                               atol=GRAD_REL * scale, err_msg=name)


def _check_step(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for f in fields(grads):
        g = getattr(grads, f.name)
        assert bool(torch.isfinite(g).all()), f.name
        _close(g.numpy(), getattr(jgrads, f.name), f.name)


def _port_fn(jscene, feats, ops=restir.KERNELS):
    scene = port_scene(jscene)
    return scene, make_mis_grad_fn(scene.geometry, scene.lights,
                                   scene.num_lights, H, W,
                                   port_features(feats), ops=ops)


def _rebuilt_noise(key, feats):
    """JAX's draws for ``key`` as the port's noise hook: the selection's
    noise from fold_in(key, PH_NEIGHBOURS), the replay RIS's uniforms from
    split(fold_in(key, PH_ITER), iterations)."""
    it_keys = jax.random.split(jax.random.fold_in(key, PH_ITER),
                               feats.max_iterations_mis)
    return (jax_selection_noise(jax.random.fold_in(key, PH_NEIGHBOURS),
                                feats.neighbour_selection_strategy, D, R),
            torch.from_numpy(np.stack([
                jax_ris_uniforms(k, S, K, H, W, replay=True)
                for k in it_keys])))


@pytest.mark.parametrize("mode", MODES)
def test_injected_step_matches_jax(mode):
    """The loss and the 13 leaves with the neighbourhoods and each
    iteration's canonical reservoirs injected into both (JAX unjitted, its
    apply_params and render on the injected path: the reference's
    mis_l2_image_loss with ``inject``). The injected reservoirs are
    constants, so the light leaves get no gradient in either."""
    jscene, jcam, feats = _case(mode)
    key = jax.random.PRNGKey(3)
    _, jctx = trace_primary(generate_rays(jcam, H, W), jscene.geometry,
                            feats)
    ny, nx = select_neighbour_indices(jax.random.fold_in(key, PH_NEIGHBOURS),
                                      jctx, H, W, feats, jscene.geometry)
    it_keys = jax.random.split(jax.random.fold_in(key, PH_ITER),
                               feats.max_iterations_mis)
    res = [gen_canonical_samples(k, jctx, jscene.lights, jscene.num_lights,
                                 jscene.geometry, feats) for k in it_keys]
    target = _target()
    render = jax_render_rmis if mode.startswith("rmis") else jax_render_romis

    def jax_loss(params):
        geometry, lights = jax_apply_params(jscene.geometry, jscene.lights,
                                            params)
        img = render(key, jcam, geometry, lights, jscene.num_lights, H, W,
                     feats.replace(fused_resampling=False),
                     inject=(ny, nx, res))
        return jnp.mean((img - target) ** 2)

    jparams = jax_extract_params(jscene.geometry, jscene.lights)
    jloss, jgrads = jax.value_and_grad(jax_loss)(jparams)
    _, fn = _port_fn(jscene, feats)
    loss, grads = fn(port_params(jparams), t(target), None,
                     port_camera(jcam),
                     inject=(t(ny), t(nx), [port_reservoirs(r) for r in res]))
    _check_step(loss, grads, jloss, jgrads)
    for name in ("mat_kd", "tri_v0"):
        assert float(getattr(grads, name).abs().max()) > 0, name


@pytest.mark.parametrize("mode", MODES)
def test_surrogate_records_step_matches_jax(mode):
    """The surrogate step on the replay-records path (the reference's
    ``gather_nb_records``) against JAX's make_mis_grad_fn on the same key,
    its draws rebuilt as the port's noise."""
    jscene, jcam, feats = _case(mode, surrogate_resampling_grad=True)
    key = jax.random.PRNGKey(5)
    target = _target()
    jparams = jax_extract_params(jscene.geometry, jscene.lights)
    jfn = jax_make_mis_grad_fn(jscene.geometry, jscene.lights,
                               jscene.num_lights, H, W, feats)
    jloss, jgrads = jfn(jparams, target, key, jcam)
    _, fn = _port_fn(jscene, feats)
    loss, grads = fn(port_params(jparams), t(target), None,
                     port_camera(jcam), noise=_rebuilt_noise(key, feats))
    _check_step(loss, grads, jloss, jgrads)
    for name in ("light_c0", "light_v0", "mat_kd", "tri_v0"):
        assert float(getattr(grads, name).abs().max()) > 0, name


@pytest.mark.parametrize("mode", MODES)
def test_records_arm_equals_stored_planes(mode):
    """On the same draws the records arm (positions and colours re-derived
    from the gathered records) renders the stored-planes arm's image bit
    for bit, and their gradients agree: the stored arm here takes the same
    surrogate reservoirs, drawn inside the loss from the same parameters,
    through ``inject``."""
    jscene, jcam, feats = _case(mode, surrogate_resampling_grad=True)
    pfeats = port_features(feats)
    scene, cam = port_scene(jscene), port_camera(jcam)
    sel, uniforms = _rebuilt_noise(jax.random.PRNGKey(6), feats)
    params = extract_params(scene.geometry, scene.lights)
    target = t(_target())
    args = (cam, scene.geometry, scene.lights, scene.num_lights, H, W,
            pfeats)

    def stored(p):
        geometry, lights = port_grad.apply_params(scene.geometry,
                                                  scene.lights, p)
        _, ctx = restir.trace_primary(port_rays(cam, H, W), geometry, pfeats)
        ny, nx = port_select(None, ctx, H, W, pfeats, noise=sel)
        res = [gen_canonical_surrogate(ctx, lights, scene.num_lights,
                                       geometry, pfeats, uniforms=u)[0]
               for u in uniforms]
        return (ny, nx, res)

    def loss(p, records):
        if records:
            return mis_l2_image_loss(p, target, None, *args,
                                     noise=(sel, uniforms))
        return mis_l2_image_loss(p, target, None, *args, inject=stored(p))

    with torch.no_grad():
        img_r = render_mis_with_params(params, None, *args,
                                       noise=(sel, uniforms))
        img_s = render_mis_with_params(params, None, *args,
                                       inject=stored(params))
    assert torch.equal(img_r, img_s)
    (loss_r, g_r), (loss_s, g_s) = (
        port_grad._value_and_grad(lambda p: loss(p, rec), params)
        for rec in (True, False))
    assert float(loss_r) == float(loss_s)
    for f in fields(g_r):
        a, b = getattr(g_r, f.name), getattr(g_s, f.name)
        scale = max(float(b.abs().max()), 1e-12)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale,
                                   msg=f.name)
    assert float(g_r.light_c0.abs().max()) > 0


def _energy(img):
    """log1p energy (the reference's probe: it keeps a progressive
    firefly's gradient small and the differences smooth)."""
    return torch.sum(torch.log1p(torch.clamp_min(img, 0.0)))


# leaf → (probe, step, relative tolerance), after the reference's
# tests/test_grad_mis.py: a light colour and kd on the L2 loss, a light
# position and the vertices on the image's energy. The steps are where
# central differences settle in float32 in every mode: the RIS races flip
# at colour steps of 1e-3 (progressive) and R-OMIS's α solve turns the
# rounding of steps below 1e-3 into percent-level noise for the lights'
# positions.
FD_CASES = {
    "light_c0": ("l2", 3e-4, 3e-2),
    "mat_kd": ("l2", 1e-3, 8e-2),
    "light_v0": ("energy", 3e-3, 6e-2),
    "tri_v0": ("energy", 1e-3, 6e-2),
}


@pytest.mark.parametrize("leaf", FD_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_gradient_matches_finite_differences(mode, leaf):
    """The port's exact gradient (no JAX in it) along a direction of one
    leaf against central differences, every evaluation on a generator
    seeded alike: a random direction over every light's colour, kd and
    every light's corner; the ground's two triangles moved along y. Every
    leaf is finite. On the occluder scene, whose ground's edges are out of
    view, with random neighbourhoods (the similarity classes would move
    with the depths), and with the shadow rays' visibility held at the
    base parameters' values, as the gradient holds it (detached): a shadow
    edge crossing a sample is a step in the loss that no gradient
    carries."""
    jscene, jcam, _ = _case("romis_progressive")
    feats = _case(mode)[2].replace(
        neighbour_selection_strategy=NeighbourSelectionStrategy.RANDOM)
    scene, cam = port_scene(jscene), port_camera(jcam)
    probe, eps, rtol = FD_CASES[leaf]
    params = extract_params(scene.geometry, scene.lights)
    target = torch.zeros((H, W, 3))
    args = (cam, scene.geometry, scene.lights, scene.num_lights, H, W,
            port_features(feats))

    def value(p, ops=restir.KERNELS):
        gen = torch.Generator().manual_seed(9)
        if probe == "l2":
            return mis_l2_image_loss(p, target, gen, *args, ops=ops)
        return _energy(render_mis_with_params(p, gen, *args, ops=ops))

    _, grads = port_grad._value_and_grad(value, params)
    for f in fields(grads):
        assert bool(torch.isfinite(getattr(grads, f.name)).all()), f.name
    occluded = []

    def record(*a):
        occluded.append(restir.KERNELS.any_hit(*a))
        return occluded[-1]

    with torch.no_grad():
        value(params, replace(restir.KERNELS, any_hit=record))
    base = getattr(params, leaf)
    if leaf == "tri_v0":
        direction = torch.zeros_like(base)
        direction[:2, 1] = 1.0
    else:
        direction = torch.randn(base.shape,
                                generator=torch.Generator().manual_seed(1))
    analytic = float((getattr(grads, leaf) * direction).sum())

    def at(sign):
        replay = iter(occluded)
        with torch.no_grad():
            return float(value(
                replace(params, **{leaf: base + sign * eps * direction}),
                replace(restir.KERNELS, any_hit=lambda *a: next(replay))))

    fd = (at(1.0) - at(-1.0)) / (2 * eps)
    assert abs(analytic) > 0
    assert abs(fd - analytic) <= rtol * max(abs(fd), abs(analytic)), \
        (fd, analytic)


@pytest.mark.parametrize("mode, bands", [
    pytest.param("rmis_balance", 0, id="rmis_balance"),
    pytest.param("romis_progressive", 0, id="romis_progressive"),
    pytest.param("rmis_balance", 3, id="banded-rmis_balance"),
    pytest.param("romis_progressive", 3, id="banded-romis_progressive")])
def test_checkpoints_change_nothing(mode, bands, monkeypatch):
    """The per-iteration checkpoints: the step's loss and gradient are bit
    for bit those of the same step without checkpoints, with the draws
    from a generator (the records arm, the surrogate's replay RIS inside
    every body); and the backward draws nothing from the caller's
    generator: its state after a step is its state after the forward
    alone. With ``bands`` the banded step (``diff.banded``), whose
    iterations' checkpoints nest in their band's, on the plain candidate
    loop's draws inside every body."""
    from romis_tpu_torch.diff.banded import (
        make_mis_banded_grad_fn, mis_banded_l2_loss,
    )

    jscene, jcam, feats = _case(mode, surrogate_resampling_grad=not bands)
    scene = port_scene(jscene)
    args = (scene.geometry, scene.lights, scene.num_lights, H, W,
            port_features(feats))
    fn = make_mis_banded_grad_fn(*args, bands) if bands else \
        make_mis_grad_fn(*args)
    cam = port_camera(jcam)
    params = extract_params(scene.geometry, scene.lights)
    target = t(_target())

    def step():
        gen = torch.Generator().manual_seed(21)
        loss, grads = fn(params, target, gen, cam)
        return loss, grads, gen.get_state()

    loss, grads, state = step()
    forward = torch.Generator().manual_seed(21)
    with torch.no_grad():
        if bands:
            mis_banded_l2_loss(params, target, forward, cam, *args, bands)
        else:
            mis_l2_image_loss(params, target, forward, cam, *args)
    assert torch.equal(state, forward.get_state())
    monkeypatch.setattr(rmis, "checkpoint",
                        lambda fn_, *a, **kw: fn_(*a))
    loss0, grads0, state0 = step()
    assert torch.equal(state0, state) and torch.equal(loss0, loss)
    for f in fields(grads):
        assert torch.equal(getattr(grads, f.name), getattr(grads0, f.name)), \
            f.name
    assert float(grads.light_c0.abs().max()) > 0
