"""Parity of the PyTorch port's spatial reuse (the halo offset gather and the
biased and unbiased passes) with the JAX package: the XLA path given the
same offsets and race noise, and the Pallas kernels in interpret mode (CPU:
the kernel wrappers run their plain versions here)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from romis_tpu.core.features import Features
from romis_tpu.ops.pallas_spatial import (
    halo_offset_gather_pallas, pack_center_ctx as jax_pack_center_ctx,
    pack_gates as jax_pack_gates, spatial_pass_pallas,
    spatial_pass_unbiased_pallas,
)
from romis_tpu.render.restir import (
    pack_pixel_planes as jax_pack_pixel_planes,
    pack_reservoir_planes as jax_pack_reservoir_planes,
    spatial_reuse as jax_spatial_reuse,
    unpack_pixel_planes as jax_unpack_pixel_planes,
    unpack_reservoir_planes as jax_unpack_reservoir_planes,
)
from romis_tpu_torch.core.features import Features as PortFeatures
from romis_tpu_torch.core.types import (
    pack_reservoir_planes, unpack_reservoir_planes,
)
from romis_tpu_torch.ops import spatial
from romis_tpu_torch.ops.shade import pack_center_ctx
from romis_tpu_torch.render import restir

from helpers import random_reservoirs_and_ctx
from torch_parity import port_ctx, port_features, port_reservoirs


def _state(seed, h, w, k):
    jres, jctx = random_reservoirs_and_ctx(np.random.default_rng(seed), h,
                                           w, k)
    return jres, jctx, port_reservoirs(jres), port_ctx(jctx)


def test_halo_offset_gather_matches_pallas_exactly():
    h, w, r, d_n, c = 40, 150, 4, 2, 3
    rng = np.random.default_rng(6)
    planes = rng.normal(size=(c, h, w)).astype(np.float32)
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    ny = np.clip(ys + rng.integers(-r, r + 1, (d_n, h, w)), 0, h - 1)
    nx = np.clip(xs + rng.integers(-r, r + 1, (d_n, h, w)), 0, w - 1)
    dy = (ny - ys).astype(np.int32)
    dx = (nx - xs).astype(np.int32)
    expect = np.asarray(halo_offset_gather_pallas(
        jnp.asarray(planes), jnp.asarray(dy), jnp.asarray(dx), r,
        interpret=pltpu.InterpretParams()))
    got = spatial.halo_offset_gather(torch.from_numpy(planes),
                                     torch.from_numpy(dy),
                                     torch.from_numpy(dx))
    assert got.shape == (d_n, c, h, w)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_halo_offset_gather_clamps_into_the_image():
    planes = torch.arange(2 * 5 * 7, dtype=torch.float32).reshape(2, 5, 7)
    dy = torch.full((1, 5, 7), -100, dtype=torch.int32)
    dx = torch.full((1, 5, 7), 100, dtype=torch.int32)
    got = spatial.halo_offset_gather(planes, dy, dx)
    # Every pixel reads the top-right corner of its plane.
    assert torch.equal(got[0], planes[:, :1, 6:7].expand(2, 5, 7))


@pytest.mark.parametrize("unbiased", [False, True],
                         ids=["biased", "unbiased"])
def test_spatial_reuse_matches_jax_xla_path(unbiased):
    """Two passes with the same per-pixel offsets and race noise: the plain
    passes (through the kernel wrappers) against spatial_reuse(inject=)."""
    h, w, k, r, radius = 12, 20, 2, 3, 2
    feats = Features(num_samples_in_reservoir=k, num_neighbours_to_sample=r,
                     spatial_resample_radius=radius,
                     unbiased_combination=unbiased)
    jres, jctx, res, ctx = _state(4, h, w, k)
    rng = np.random.default_rng(9)
    inject = [(rng.integers(-radius, radius + 1, (2, r, h, w)).astype(
                   np.int32),
               rng.gumbel(size=(r + 1, k, h, w)).astype(np.float32))
              for _ in range(feats.spatial_resampling_passes)]
    expect = jax_spatial_reuse(
        jax.random.PRNGKey(0), jctx, jres, h, w, None, feats,
        inject=[(jnp.asarray(o), jnp.asarray(g)) for o, g in inject])
    got = restir.spatial_reuse(
        None, ctx, res, h, w, port_features(feats),
        inject=[(torch.from_numpy(o), torch.from_numpy(g))
                for o, g in inject])
    assert (np.asarray(expect.big_w) > 0).mean() > 0.3
    for f in ("pos", "color", "w_sum", "m", "big_w", "chosen_w"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(expect, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def _replay_noise(h, w, k, r, radius):
    """What the Pallas kernels draw in interpret mode (zero PRNG bits):
    every offset (-r, -r) and one constant race clock."""
    offs = torch.full((2, r, h, w), -radius, dtype=torch.int32)
    return offs, torch.zeros((r + 1, k, h, w))


@pytest.mark.parametrize("unbiased", [False, True],
                         ids=["biased", "unbiased"])
def test_pass_matches_pallas_kernel_in_interpret_mode(unbiased):
    """One pass against the Pallas kernel (interpret mode) on the noise it
    draws there. The kernel's streams run [self, neighbours...] and ours
    [neighbours..., self]; with every neighbour the same pixel and constant
    noise both pick the first stream of largest w, so they agree wherever
    a lane has a positive weight (ties between self and neighbour aside,
    which random state does not produce). Each pass fixes its own combine,
    whatever ``unbiased_combination`` says."""
    h, w, k, r, radius = 40, 150, 2, 2, 3
    feats = Features(unbiased_combination=not unbiased)
    jres, jctx, res, ctx = _state(3, h, w, k)
    if unbiased:
        expect = spatial_pass_unbiased_pallas(
            5, jax_pack_reservoir_planes(jres), jax_pack_center_ctx(jctx), k,
            r, radius, interpret=pltpu.InterpretParams())
        got = spatial.spatial_pass_unbiased_fused(
            pack_reservoir_planes(res), pack_center_ctx(ctx), k, r, radius,
            port_features(feats), inject=_replay_noise(h, w, k, r, radius))
    else:
        expect = spatial_pass_pallas(
            5, jax_pack_reservoir_planes(jres), jax_pack_gates(jctx),
            jax_pack_center_ctx(jctx), k, r, radius,
            interpret=pltpu.InterpretParams())
        got = spatial.spatial_pass_fused(
            pack_reservoir_planes(res), spatial.pack_gates(ctx),
            pack_center_ctx(ctx), k, r, radius, port_features(feats),
            inject=_replay_noise(h, w, k, r, radius))
    expect = jax_unpack_reservoir_planes(expect, k)
    got = unpack_reservoir_planes(got, k)
    live = np.asarray(expect.w_sum) > 0
    assert live.mean() > 0.3
    np.testing.assert_allclose(got.w_sum.numpy(), np.asarray(expect.w_sum),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(expect.m),
                               rtol=1e-6)
    np.testing.assert_allclose(got.big_w.numpy(), np.asarray(expect.big_w),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got.pos.numpy() * live[:, None],
                               np.asarray(expect.pos) * live[:, None],
                               rtol=2e-4, atol=1e-5)


def test_pixel_planes_round_trip_matches_jax():
    h, w, k = 6, 9, 2
    jres, jctx, res, ctx = _state(8, h, w, k)
    planes = restir.pack_pixel_planes(res, ctx)
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(jax_pack_pixel_planes(jres,
                                                                   jctx)))
    got_res, got_ctx = restir.unpack_pixel_planes(planes[None], k)
    exp_res, exp_ctx = jax_unpack_pixel_planes(jnp.asarray(planes.numpy())[
        None], k)
    for f in ("pos", "color", "w_sum", "m", "big_w", "chosen_w"):
        np.testing.assert_array_equal(getattr(got_res, f).numpy(),
                                      np.asarray(getattr(exp_res, f)))
    for f in ("valid", "position", "normal", "view_origin", "kd", "ks",
              "shininess", "depth_t", "geom_id"):
        np.testing.assert_array_equal(getattr(got_ctx, f).numpy(),
                                      np.asarray(getattr(exp_ctx, f)))


def test_kernel_wrappers_refuse_what_they_cannot_run():
    h, w, k = 4, 6, 2
    _, _, res, ctx = _state(1, h, w, k)
    rp, cen = pack_reservoir_planes(res), pack_center_ctx(ctx)
    with pytest.raises(ValueError, match="Generator"):
        spatial.spatial_pass_fused(rp, spatial.pack_gates(ctx), cen, k, 2, 1,
                                   PortFeatures())
    # On the card a CPU-only tensor is never silently moved: the wrapper
    # dispatches on the device of the tensor it is given.
    out = spatial.spatial_pass_fused(
        rp, spatial.pack_gates(ctx), cen, k, 2, 1, PortFeatures(),
        inject=_replay_noise(h, w, k, 2, 1))
    assert out.device.type == "cpu" and out.shape == (10 * k, h, w)
