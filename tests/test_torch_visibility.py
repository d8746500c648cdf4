"""Parity of the PyTorch port's any-hit, shadow-ray visibility, the initial
visibility check of RIS and the unbiased combine with the JAX package
(CPU: the kernel wrappers run their plain versions here)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.features import Features
from romis_tpu.ops.pallas_trace import pallas_any
from romis_tpu.ops.wrs import combine_unbiased as jax_combine_unbiased
from romis_tpu.ops.wrs import gen_canonical_samples as jax_gen_canonical
from romis_tpu.ops.wrs import visibility as jax_visibility
from romis_tpu.ops.wrs import visibility_from as jax_visibility_from
from romis_tpu.scene.scene import build_geometry
from romis_tpu_torch.ops.trace import any_hit, any_hit_plain
from romis_tpu_torch.ops.wrs import (
    combine_unbiased, gen_canonical_samples, visibility, visibility_from,
)
from romis_tpu_torch.scene.scene import build_geometry as port_build_geometry
from romis_tpu_torch.scene.scene import flagship_scene

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    jax_ris_uniforms, port_ctx, port_features, port_reservoirs, random_rays,
    random_soup, t,
)

H, W = 8, 24


def _soup(seed, n_tris=48):
    sm = random_soup(np.random.default_rng(seed), n_tris)
    return build_geometry([sm]), port_build_geometry([sm], "cpu")


def test_any_hit_matches_pallas_with_leading_axes():
    jgeo, geo = _soup(2)
    rng = np.random.default_rng(6)
    lead = (2, 3)
    o, d = (np.stack(a).reshape(lead + (3, H, W)) for a in zip(
        *(random_rays(rng, H, W) for _ in range(6))))
    t_max = rng.uniform(0.5, 6.0, lead + (H, W)).astype(np.float32)
    expect = np.asarray(pallas_any(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max), jgeo, interpret=True))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
            geo)
    got = any_hit(*args)
    assert got.dtype == torch.bool and got.shape == lead + (H, W)
    assert 0.05 < expect.mean() < 0.95
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(any_hit_plain(*args).numpy(), expect)


def test_any_hit_broadcasts_one_direction_field():
    _, geo = _soup(3)
    rng = np.random.default_rng(1)
    o, d = random_rays(rng, H, W)
    o2 = np.stack([o, o + 0.1]).astype(np.float32)
    t_max = np.full((2, H, W), 5.0, np.float32)
    got = any_hit(torch.from_numpy(o2), torch.from_numpy(d),
                  torch.from_numpy(t_max), geo)
    full = any_hit(torch.from_numpy(o2),
                   torch.from_numpy(np.stack([d, d])),
                   torch.from_numpy(t_max), geo)
    assert torch.equal(got, full)


def test_visibility_matches_jax():
    jgeo, geo = _soup(4)
    rng = np.random.default_rng(7)
    k = 2
    p = rng.uniform(-2, 2, (3, H, W)).astype(np.float32)
    s = rng.uniform(-2, 2, (k, 3, H, W)).astype(np.float32)
    s[0, :, 0, 0] = p[:, 0, 0]  # a coincident pair is visible
    expect = np.asarray(jax_visibility(jnp.asarray(p), jnp.asarray(s), jgeo))
    got = visibility(torch.from_numpy(p), torch.from_numpy(s), geo, any_hit)
    assert 0.05 < expect.mean() < 0.95 and expect[0, 0, 0]
    np.testing.assert_array_equal(got.numpy(), expect)

    origins = rng.uniform(-2, 2, (3, 1, 3, H, W)).astype(np.float32)
    expect = np.asarray(jax_visibility_from(jnp.asarray(origins),
                                            jnp.asarray(s)[None], jgeo))
    got = visibility_from(torch.from_numpy(origins),
                          torch.from_numpy(s)[None], geo, any_hit)
    assert got.shape == (3, k, H, W)
    np.testing.assert_array_equal(got.numpy(), expect)


def _occluded_scene(seed=5):
    """The flagship lights over a random soup (the occluders), as (JAX
    geometry, port geometry, JAX lights, port lights)."""
    jgeo, geo = _soup(seed, 64)
    return jgeo, geo, ge._flagship_scene().lights, flagship_scene("cpu").lights


def test_ris_with_initial_visibility_check_matches_jax():
    h, w, s, k = 6, 20, 8, 2
    jgeo, geo, jlights, lights = _occluded_scene()
    _, jctx = random_reservoirs_and_ctx(np.random.default_rng(2), h, w, k)
    feats = Features(initial_light_samples=s, num_samples_in_reservoir=k,
                     initial_samples_visibility_check=True)
    key = jax.random.PRNGKey(3)
    expect = jax_gen_canonical(key, jctx, jlights, 512, jgeo, feats)
    got = gen_canonical_samples(
        port_ctx(jctx), lights, 512, geo, port_features(feats),
        uniforms=torch.from_numpy(jax_ris_uniforms(key, s, k, h, w)))
    unchecked = jax_gen_canonical(
        key, jctx, jlights, 512, jgeo,
        feats.replace(initial_samples_visibility_check=False))
    killed = (np.asarray(unchecked.big_w) > 0) & (np.asarray(expect.big_w)
                                                  == 0)
    assert killed.mean() > 0.02  # the check zeroed some occluded winners
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(expect.pos),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.big_w.numpy() == 0,
                                  np.asarray(expect.big_w) == 0)
    np.testing.assert_allclose(got.big_w.numpy(), np.asarray(expect.big_w),
                               rtol=1e-4)


@pytest.mark.parametrize("vis_check", [False, True],
                         ids=["novis", "vischeck"])
def test_combine_unbiased_matches_jax(vis_check):
    h, w, k, r = 6, 16, 2, 3
    jgeo, geo, _, _ = _occluded_scene(6)
    rng = np.random.default_rng(12)
    jin, jin_ctx = random_reservoirs_and_ctx(rng, h, w, k)
    jstack = jax.tree.map(lambda a: jnp.stack([a] * r), jin)
    # Each input's own geometry: shift the positions per input.
    jctxs = jax.tree.map(lambda a: jnp.stack([a] * r), jin_ctx)
    jctxs = jctxs.replace(position=jctxs.position + jnp.asarray(
        rng.normal(0, 0.3, (r, 3, h, w)), jnp.float32))
    jstack = jstack.replace(pos=jstack.pos + jnp.asarray(
        rng.normal(0, 0.5, (r, k, 3, h, w)), jnp.float32))
    in_mask = rng.uniform(size=(r, h, w)) > 0.2
    gumbel = rng.gumbel(size=(r, k, h, w)).astype(np.float32)
    feats = Features(spatial_reuse_visibility_check=vis_check)
    expect = jax_combine_unbiased(jax.random.PRNGKey(0), jin_ctx, jstack,
                                  jnp.asarray(in_mask), jctxs, jgeo, feats,
                                  jnp.asarray(gumbel))
    got = combine_unbiased(port_ctx(jin_ctx), port_reservoirs(jstack),
                           t(in_mask), port_ctx(jctxs), port_features(feats),
                           t(gumbel), geo, any_hit)
    assert (np.asarray(expect.big_w) > 0).mean() > 0.3
    for f in ("pos", "w_sum", "m", "big_w", "chosen_w"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(expect, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
