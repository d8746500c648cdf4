"""Parity of the PyTorch port's RIS candidate generation and reservoir
combination with the JAX package, and RIS lane statistics (CPU: the RIS
wrapper runs its plain version here)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.features import Features
from romis_tpu.ops.wrs import clamp_temporal_m as jax_clamp_m
from romis_tpu.ops.wrs import combine_biased as jax_combine_biased
from romis_tpu.ops.wrs import gen_canonical_samples as jax_gen_canonical
from romis_tpu_torch.core.types import Reservoirs, ShadeCtx
from romis_tpu_torch.ops.shading import target_pdf
from romis_tpu_torch.ops.wrs import (
    _lane_layout, clamp_temporal_m, combine_biased, gen_canonical_samples,
)
from romis_tpu_torch.scene.lights import LightListBuilder
from romis_tpu_torch.scene.scene import flagship_scene

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    jax_ris_uniforms, port_ctx, port_features, port_reservoirs, t,
)


@pytest.mark.parametrize("s,k", [(32, 2), (5, 2), (6, 3)])
def test_ris_matches_jax_xla_path(s, k):
    h, w = 6, 20
    jax_scene = ge._flagship_scene()
    scene = flagship_scene("cpu")
    jres_in, jctx = random_reservoirs_and_ctx(np.random.default_rng(s), h, w,
                                              k)
    feats = Features(initial_light_samples=s, num_samples_in_reservoir=k,
                     spatial_reuse=False)
    key = jax.random.PRNGKey(11 * s + k)
    expect = jax_gen_canonical(key, jctx, jax_scene.lights, 512,
                               jax_scene.geometry, feats)
    uniforms = torch.from_numpy(jax_ris_uniforms(key, s, k, h, w))
    got = gen_canonical_samples(port_ctx(jctx), scene.lights, 512,
                                scene.geometry, port_features(feats),
                                uniforms=uniforms)
    assert (np.asarray(expect.w_sum) > 0).mean() > 0.5
    # Same winners: the selected sample positions and colors agree.
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(expect.pos),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(expect.color),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(expect.m))
    np.testing.assert_allclose(got.w_sum.numpy(), np.asarray(expect.w_sum),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chosen_w.numpy(),
                               np.asarray(expect.chosen_w), rtol=1e-5)
    np.testing.assert_allclose(got.big_w.numpy(), np.asarray(expect.big_w),
                               rtol=1e-4)


def _flat_ctx(n):
    """n surface points on z=0 facing +z at the origin, white diffuse."""
    def planes(v):
        return torch.tensor(v, dtype=torch.float32)[:, None, None].expand(
            3, 1, n).contiguous()

    return ShadeCtx(valid=torch.ones((1, n), dtype=torch.bool),
                    position=planes([0.0, 0.0, 0.0]),
                    normal=planes([0.0, 0.0, 1.0]),
                    view_origin=planes([0.0, 0.0, 3.0]),
                    kd=planes([1.0, 1.0, 1.0]), ks=planes([0.0, 0.0, 0.0]),
                    shininess=torch.ones((1, n)),
                    geom_id=torch.zeros((1, n), dtype=torch.int32),
                    depth_t=torch.full((1, n), 3.0))


def _point_lights(positions, colors):
    b = LightListBuilder()
    for p, c in zip(positions, colors):
        b.add_point(p, c)
    return b.build("cpu"), len(b)


@pytest.mark.parametrize("s,frac", [(1, 0.5), (32, 0.8)])
def test_ris_lane_winner_distribution(s, frac):
    """Lights straight above at distances 1 and 2: p_hat ∝ 1/d², so light 0
    has 4x light 1's weight. One candidate picks uniformly (50/50); 32
    candidates resample toward the 4x light, P → 4/5."""
    n = 4000
    lights, nl = _point_lights([(0, 0, 1), (0, 0, 2)], [(1, 1, 1)] * 2)
    feats = port_features(Features(initial_light_samples=s,
                                   num_samples_in_reservoir=1,
                                   spatial_reuse=False))
    res = gen_canonical_samples(_flat_ctx(n), lights, nl, None, feats,
                                generator=torch.Generator().manual_seed(s))
    near = (res.pos[0, 2] == 1.0).float().mean().item()
    assert abs(near - frac) < 0.03, near


def test_ris_bookkeeping_and_unbiased_estimate():
    """M = candidates per lane, W = wSum / (p_hat·M) where p_hat > 0, and
    E[p_hat(y)·W] = Σ_lights p_hat (RIS)."""
    n = 2048
    ctx = _flat_ctx(n)
    pos = [(0, 0, 1), (0.5, 0.5, 2), (-0.5, 0, 1.2)]
    col = [(1, 1, 1), (1, 0.2, 0.1), (0.1, 0.5, 1.0)]
    lights, nl = _point_lights(pos, col)
    feats = port_features(Features(initial_light_samples=5,
                                   num_samples_in_reservoir=2,
                                   spatial_reuse=False))
    res = gen_canonical_samples(ctx, lights, nl, None, feats,
                                generator=torch.Generator().manual_seed(3))
    _, counts, _ = _lane_layout(5, 2)
    np.testing.assert_array_equal(res.m[:, 0, 0].numpy(), counts)
    p_hat = target_pdf(ctx, res.pos, res.color, feats)
    ok = p_hat > 0
    np.testing.assert_allclose(
        res.big_w[ok].numpy(),
        (res.w_sum / (p_hat * res.m))[ok].numpy(), rtol=1e-5)
    truth = sum(float(target_pdf(
        _flat_ctx(1), torch.tensor(p, dtype=torch.float32)[:, None, None],
        torch.tensor(c, dtype=torch.float32)[:, None, None], feats))
        for p, c in zip(pos, col))
    est = (p_hat * res.big_w).mean().item()
    assert abs(est - truth) / truth < 0.03, (est, truth)


def _stack(*rs):
    return Reservoirs(*(torch.stack([getattr(r, f) for r in rs]) for f in (
        "pos", "color", "w_sum", "m", "big_w", "chosen_w")))


def test_combine_biased_matches_jax_with_injected_noise():
    h, w, k, r = 5, 24, 2, 2
    rng = np.random.default_rng(21)
    ins = [random_reservoirs_and_ctx(rng, h, w, k) for _ in range(r)]
    jctx = ins[0][1]
    jinputs = jax.tree.map(lambda *a: jnp.stack(a), *(x[0] for x in ins))
    mask = rng.uniform(size=(r, h, w)) > 0.3
    mask[0] = True
    gumbel = rng.gumbel(size=(r, k, h, w)).astype(np.float32)
    feats = Features(spatial_reuse=False)
    expect = jax_combine_biased(None, jctx, jinputs, jnp.asarray(mask), feats,
                                gumbel=jnp.asarray(gumbel))
    got = combine_biased(port_ctx(jctx),
                         _stack(*(port_reservoirs(x[0]) for x in ins)),
                         torch.from_numpy(mask), port_features(feats),
                         torch.from_numpy(gumbel))
    for name, rtol in (("pos", 1e-6), ("color", 1e-6), ("m", 0),
                       ("w_sum", 1e-5), ("chosen_w", 1e-5), ("big_w", 1e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(expect, name)),
                                   rtol=rtol, atol=1e-7, err_msg=name)


def test_clamp_temporal_m_matches_jax():
    h, w, k = 4, 16, 2
    rng = np.random.default_rng(9)
    jres, _ = random_reservoirs_and_ctx(rng, h, w, k)
    jres = jres.replace(m=jnp.asarray(
        rng.integers(0, 400, (k, h, w)).astype(np.float32)))
    cur = rng.integers(1, 20, (h, w)).astype(np.float32)
    expect = jax_clamp_m(jres, jnp.asarray(cur), 20.0)
    got = clamp_temporal_m(port_reservoirs(jres), t(cur), 20.0)
    assert (np.asarray(expect.m) != np.asarray(jres.m)).any()
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(expect.m))
    np.testing.assert_allclose(got.w_sum.numpy(), np.asarray(expect.w_sum),
                               rtol=1e-6)
