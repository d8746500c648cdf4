"""The port's ReSTIR gradient step (``romis_tpu_torch.diff.grad``) against
the JAX package's, on the procedural flagship scene at 12x16 with JAX's
draws replayed: the replay RIS and the surrogate tail, the records-mode
surrogate combine, the whole step (loss and all 13 parameter gradients) for
the exact, surrogate and per-pixel feature sets, and a finite-difference
check of the port's exact gradient that does not depend on JAX.

Gradients agree to 2e-3 of each leaf's largest |g|: both packages sum the
same float32 terms in different orders (segment sums, reductions over the
image), so each element may move by a few ulps of the largest."""

from dataclasses import fields, replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as ge
from romis_tpu.core.features import Features
from romis_tpu.diff.grad import (
    extract_params as jax_extract_params, make_grad_fn as jax_make_grad_fn,
    render_with_params as jax_render_with_params,
)
from romis_tpu.ops.pallas_ris import gen_canonical_replay_pallas
from romis_tpu.ops.wrs import (
    _gen_canonical_surrogate, combine_biased_surrogate as jax_surrogate,
)
from romis_tpu.render.restir import (
    initial_temporal_state as jax_initial_state, trace_primary,
)
from romis_tpu.core.camera import generate_rays
from romis_tpu_torch.diff.grad import extract_params, make_grad_fn
from romis_tpu_torch.ops.ris import gen_canonical_replay
from romis_tpu_torch.ops.wrs import (
    combine_biased_surrogate, gen_canonical_surrogate,
)
from romis_tpu_torch.render import restir
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    jax_frame_noise, jax_ris_uniforms, port_camera, port_ctx, port_params,
    port_reservoirs, port_scene, port_state, t,
)

H, W = 12, 16
GRAD_REL = 2e-3


def _lights(jax_scene):
    return jax_scene.lights.replace(const_cols=None, affine_segments=None)


def _jax_ctx(jax_scene, h=H, w=W):
    rays = generate_rays(ge._flagship_camera(h, w), h, w)
    return trace_primary(rays, jax_scene.geometry, Features())[1]


def _close(got, expect, name):
    expect = np.asarray(expect)
    scale = max(float(np.abs(expect).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=GRAD_REL,
                               atol=GRAD_REL * scale, err_msg=name)


def test_replay_and_surrogate_tail_match_jax():
    """The replay plain version and the differentiable tail against JAX's
    surrogate scan (values, the winner records, and the gradient into the
    light table, which the second race's records drive), with the draws
    rebuilt: u4 from split(key, S/K), the second race from
    fold_in(slot_key, 77)."""
    feats = Features(initial_light_samples=8)
    jax_scene = ge._flagship_scene()
    jctx, jlights = _jax_ctx(jax_scene), _lights(jax_scene)
    scene = port_scene(jax_scene)
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(0)
    proj = [rng.normal(size=s).astype(np.float32)
            for s in ((2, H, W), (2, 3, H, W), (2, H, W))]

    def jax_loss(rows):
        res, rec = _gen_canonical_surrogate(
            key, jctx, jlights.replace(rows=rows), scene.num_lights, None,
            feats, return_records=True)
        loss = (jnp.sum(res.big_w * proj[0]) + jnp.sum(res.pos * proj[1])
                + jnp.sum(res.w_sum * proj[2]))
        return loss, (res, rec)

    (_, (jres, jrec)), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(
        jlights.rows)

    rows_t = scene.lights.rows.clone().requires_grad_()
    uniforms = torch.from_numpy(jax_ris_uniforms(key, 8, 2, H, W,
                                                 replay=True))
    res, rec = gen_canonical_surrogate(
        port_ctx(jctx), replace(scene.lights, rows=rows_t), scene.num_lights,
        None, feats, uniforms=uniforms)
    loss = ((res.big_w * t(proj[0])).sum() + (res.pos * t(proj[1])).sum()
            + (res.w_sum * t(proj[2])).sum())
    (grad,) = torch.autograd.grad(loss, rows_t)

    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    for f in ("pos", "color", "w_sum", "m", "big_w", "chosen_w"):
        np.testing.assert_allclose(getattr(res, f).detach().numpy(),
                                   np.asarray(getattr(jres, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    assert float(np.abs(np.asarray(jgrad)).max()) > 0
    _close(grad.numpy(), jgrad, "d light rows")


def test_replay_zero_prng_matches_jax_kernel():
    """Zero uniforms (the Pallas kernel's PRNG in interpret mode): every
    candidate is light 0 at its (0, 0) corner, the first one wins both
    races; the plain version's w_sum and records against the kernel's."""
    from romis_tpu.scene.lights import LightListBuilder

    h, w, k = 40, 150, 2
    feats = Features()
    _, jctx = random_reservoirs_and_ctx(np.random.default_rng(4), h, w, k)
    b = LightListBuilder()
    b.add_parallelogram((0.3, 2.0, 0.1), (0.4, 0, 0), (0, 0, 0.4),
                        (1.0, 0.9, 0.8), (0.5, 0.5, 0.5),
                        (0.2, 0.4, 0.6), (0.1, 0.1, 0.1))
    b.add_point((1.0, 1.5, -0.5), (2.0, 2.0, 2.0))
    jlights = b.build()
    w_sum, r1, r2 = gen_canonical_replay_pallas(
        9, jctx, jlights, len(b), feats, interpret=pltpu.InterpretParams())

    from romis_tpu_torch.scene.lights import light_table_from_arrays

    lights = light_table_from_arrays(
        {c: np.asarray(getattr(jlights, c)) for c in (
            "v0", "edge01", "edge02", "c0", "c1", "c2", "c3", "kind")})
    sk = -(-feats.initial_light_samples // k)
    got = gen_canonical_replay(port_ctx(jctx), lights, len(b), feats,
                               uniforms=torch.zeros((sk, 5, k, h, w)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(w_sum), rtol=2e-4,
                               atol=1e-5)
    assert float(np.asarray(w_sum).max()) > 0
    for race, expect in zip(got[1:], (r1, r2)):
        for a, b_ in zip(race, expect):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_surrogate_combine_with_records_matches_jax():
    """combine_biased_surrogate in records mode, with gumbel and gumbel2
    injected: values, output records and gradients into the receiver, the
    inputs' big_w and the light table."""
    r, k = 4, 2
    feats = Features()
    jax_scene = ge._flagship_scene()
    jlights = _lights(jax_scene)
    scene = port_scene(jax_scene)
    rng = np.random.default_rng(9)
    jres, jctx = random_reservoirs_and_ctx(rng, H, W, k)
    jin = jax.tree.map(lambda a: jnp.stack([a] * r) * jnp.asarray(
        rng.uniform(0.5, 1.5, (r,) + (1,) * a.ndim).astype(np.float32)),
        jres)
    jin = jin.replace(m=jnp.round(jin.m))
    in_mask = rng.uniform(size=(r, H, W)) > 0.2
    idx = rng.integers(-1, scene.num_lights, (r, k, 1, H, W))
    records = np.concatenate([idx, rng.uniform(size=(r, k, 2, H, W))],
                             axis=2).astype(np.float32)
    gumbel = rng.gumbel(size=(r, k, H, W)).astype(np.float32)
    gumbel2 = rng.gumbel(size=(r, k, H, W)).astype(np.float32)
    proj = rng.normal(size=(4, k, H, W)).astype(np.float32)

    def jax_loss(kd, big_w, rows):
        res, rec = jax_surrogate(
            None, jctx.replace(kd=kd), jin.replace(big_w=big_w),
            jnp.asarray(in_mask), feats, jnp.asarray(gumbel),
            jnp.asarray(gumbel2), records=jnp.asarray(records),
            lights=jlights.replace(rows=rows))
        loss = sum(jnp.sum(getattr(res, f) * proj[i]) for i, f in enumerate(
            ("big_w", "w_sum", "chosen_w", "m")))
        return loss, (res, rec)

    (_, (jout, jrec)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(jctx.kd, jin.big_w,
                                                   jlights.rows)

    ctx, inputs = port_ctx(jctx), port_reservoirs(jin)
    kd = ctx.kd.clone().requires_grad_()
    big_w = inputs.big_w.clone().requires_grad_()
    rows_t = scene.lights.rows.clone().requires_grad_()
    out, rec = combine_biased_surrogate(
        replace(ctx, kd=kd), replace(inputs, big_w=big_w),
        torch.from_numpy(in_mask), feats, t(gumbel), t(gumbel2),
        records=t(records), lights=replace(scene.lights, rows=rows_t))
    loss = sum((getattr(out, f) * t(proj[i])).sum() for i, f in enumerate(
        ("big_w", "w_sum", "chosen_w", "m")))
    grads = torch.autograd.grad(loss, (kd, big_w, rows_t))

    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    for f in ("pos", "color", "w_sum", "m", "big_w", "chosen_w"):
        np.testing.assert_allclose(getattr(out, f).detach().numpy(),
                                   np.asarray(getattr(jout, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    for name, g, e in zip(("kd", "big_w", "light rows"), grads, jgrads):
        assert float(np.abs(np.asarray(e)).max()) > 0, name
        _close(g.numpy(), e, name)


STEP_FEATURES = {
    "exact": dict(),
    "grad_surrogate": dict(surrogate_resampling_grad=True),
    "grad_per_pixel": dict(surrogate_resampling_grad=True,
                           exact_gradients=True),
}


def _step_setup(flags):
    feats = Features(enable_tone_mapping=False, initial_light_samples=8,
                     num_neighbours_to_sample=3, spatial_resample_radius=2,
                     **flags)
    effective = feats.replace(
        fused_resampling=False,
        coherent_spatial_offsets=not feats.exact_gradients)
    jax_scene = ge._flagship_scene()
    jcam = ge._flagship_camera(H, W)
    jparams = jax_extract_params(jax_scene.geometry, jax_scene.lights)
    args = (jcam, jax_scene.geometry, jax_scene.lights, jax_scene.num_lights,
            H, W, feats)
    render = jax.jit(jax_render_with_params, static_argnums=(5, 6, 7, 8))
    _, jprev = render(jparams, jax.random.PRNGKey(1), *args,
                      jax_initial_state(H, W, 2, jcam))
    dim = jparams.replace(**{f: getattr(jparams, f) * 0.8 for f in (
        "light_c0", "light_c1", "light_c2", "light_c3")})
    target, _ = render(dim, jax.random.PRNGKey(2), *args, jprev)
    return feats, effective, jax_scene, jcam, jparams, jprev, target


@pytest.mark.parametrize("flags", STEP_FEATURES.values(),
                         ids=STEP_FEATURES.keys())
def test_grad_step_matches_jax(flags):
    feats, effective, jax_scene, jcam, jparams, jprev, target = \
        _step_setup(flags)
    key = jax.random.PRNGKey(3)
    jfn = jax.jit(jax_make_grad_fn(jax_scene.geometry, jax_scene.lights,
                                   jax_scene.num_lights, H, W, feats))
    jloss, jgrads = jfn(jparams, target, key, jcam, jprev)

    scene, cam = port_scene(jax_scene), port_camera(jcam)
    fn = make_grad_fn(scene.geometry, scene.lights, scene.num_lights, H, W,
                      feats)
    loss, grads = fn(port_params(jparams), t(target), None, cam,
                     port_state(jprev, cam),
                     noise=jax_frame_noise(key, effective, H, W))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for f in fields(grads):
        g = getattr(grads, f.name)
        assert bool(torch.isfinite(g).all()), f.name
        _close(g.numpy(), getattr(jgrads, f.name), f.name)
    for name in ("light_c0", "light_v0", "mat_kd", "tri_v0"):
        assert float(getattr(grads, name).abs().max()) > 0, name


@pytest.mark.parametrize("leaf", ["light_c0", "mat_kd"])
def test_exact_gradient_matches_finite_differences(leaf):
    """The port's exact gradient (no JAX) along a random direction of one
    leaf against central differences of the loss, every draw fixed."""
    h, w, s, k = 12, 16, 8, 2
    feats = Features(enable_tone_mapping=False, initial_light_samples=s,
                     num_neighbours_to_sample=3, spatial_resample_radius=2)
    scene, cam = flagship_scene(), flagship_camera(h, w)
    gen = torch.Generator().manual_seed(0)
    noise = (torch.rand((s // k, 4, k, h, w), generator=gen),
             -torch.log(-torch.log(torch.rand((2, k, h, w), generator=gen))),
             [(torch.randint(-2, 3, (2, 3), generator=gen),
               -torch.log(-torch.log(torch.rand((4, k, h, w),
                                                generator=gen))))
              for _ in range(2)])
    params = extract_params(scene.geometry, scene.lights)
    fn = make_grad_fn(scene.geometry, scene.lights, scene.num_lights, h, w,
                      feats)
    prev = restir.initial_temporal_state(h, w, k, cam)
    target = torch.zeros((h, w, 3))
    loss, grads = fn(params, target, None, cam, prev, noise)
    direction = torch.randn(getattr(params, leaf).shape, generator=gen)
    analytic = float((getattr(grads, leaf) * direction).sum())
    eps = 1e-3

    def loss_at(sign):
        p = replace(params, **{leaf: getattr(params, leaf)
                               + sign * eps * direction})
        return float(fn(p, target, None, cam, prev, noise)[0])

    fd = (loss_at(1.0) - loss_at(-1.0)) / (2 * eps)
    assert abs(analytic) > 0
    np.testing.assert_allclose(analytic, fd, rtol=2e-2)
