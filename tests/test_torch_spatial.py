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


def _records_state(seed, h, w, k):
    """Planes with some invalid pixels and some zero view vectors (the
    view origin on the surface)."""
    _, _, res, ctx = _state(seed, h, w, k)
    rp, cen = pack_reservoir_planes(res), pack_center_ctx(ctx)
    cen[6:9, 0, :3] = cen[0:3, 0, :3]
    assert (cen[17] < 0.5).any() and (cen[17] > 0.5).any()
    return rp, cen


@pytest.mark.parametrize("k", [1, 2, 4])
def test_records_round_trip(k):
    """Kernel 11's records hold the planes bit for bit: the reservoir
    record a lane's pos | col | m | W, the context record's position, normal,
    shininess and kd, ks where valid (0 where invalid), and the unit view
    as the plain Phong computes it."""
    h, w = 5, 7
    rp, cen = _records_state(2, h, w, k)
    rres, rctx = spatial.pack_records(rp, cen, k)
    n = h * w
    assert rres.shape == (n, 8 * k) and rctx.shape == (n, spatial.CTX_RECORD)
    planes, c = rp.reshape(10 * k, n), cen.reshape(18, n)
    lanes = rres.t().reshape(k, 8, n)
    for l in range(k):
        assert torch.equal(lanes[l, 0:3], planes[3 * l:3 * l + 3])
        assert torch.equal(lanes[l, 3:6], planes[3 * k + 3 * l:3 * k + 3 * l
                                                 + 3])
        assert torch.equal(lanes[l, 6], planes[7 * k + l])  # m
        assert torch.equal(lanes[l, 7], planes[8 * k + l])  # W
    r = rctx.t()
    assert torch.equal(r[0:6], c[0:6]) and torch.equal(r[15], c[15])
    valid = c[17] > 0.5
    assert torch.equal(r[9:15], torch.where(valid, c[9:15], 0.0))
    v0 = c[6:9] - c[0:3]  # ops/shading.phong_shade_planes' view
    vsq = v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2]
    vok = vsq > 1e-30
    vn = torch.where(vok, torch.sqrt(torch.where(vok, vsq, 1.0)), 0.0)
    assert torch.equal(r[6:9], v0 * (1.0 / torch.clamp_min(vn, 1e-20)))
    assert torch.equal(r[6:9, :3], torch.zeros(3, 3))
    _, unshaded = spatial.pack_records(rp, cen, k, unshaded=True)
    assert torch.equal(unshaded.t()[9:15], c[9:15])


@pytest.mark.parametrize("shaded", [True, False], ids=["shaded", "unshaded"])
def test_record_contexts_give_the_plain_pass(shaded):
    """The context records stand an invalid pixel in as a valid one with
    kd = ks = 0 when shaded (its Phong is then 0, as the dead receiver's):
    the plain unbiased pass and its vis_check form on contexts so encoded
    are bit-equal to those on the planes."""
    h, w, k, r, radius = 12, 20, 2, 3, 2
    rp, cen = _records_state(5, h, w, k)
    _, rctx = spatial.pack_records(rp, cen, k, unshaded=not shaded)
    enc = cen.clone()
    enc[9:15] = rctx.t()[9:15].reshape(6, h, w)
    enc[17] = 1.0
    feats = PortFeatures(num_samples_in_reservoir=k, num_neighbours_to_sample=r,
                         spatial_resample_radius=radius,
                         unbiased_combination=True, enable_shading=shaded)
    inject = spatial.spatial_noise(torch.Generator().manual_seed(3), r, k,
                                   radius, h, w)
    a = spatial.spatial_pass_unbiased_plain(rp, cen, k, r, radius, feats,
                                            inject=inject)
    b = spatial.spatial_pass_unbiased_plain(rp, enc, k, r, radius, feats,
                                            inject=inject)
    assert torch.equal(a, b)
    assert (unpack_reservoir_planes(a, k).w_sum > 0).float().mean() > 0.5
    for x, y in zip(spatial.spatial_pass_unbiased_vis_plain(
            rp, cen, k, r, radius, feats, inject=inject),
            spatial.spatial_pass_unbiased_vis_plain(
                rp, enc, k, r, radius, feats, inject=inject)):
        assert torch.equal(x, y)


class _OnTheCard:
    """A stand-in plane block on the card: the wrappers check it before
    they touch its data."""

    is_cuda = True
    dtype = torch.float32
    device = "cuda"

    def __init__(self, c, h, w):
        self.shape = (c, h, w)

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("case", ["k5", "r9", "pixels", "no_noise",
                                  "vis_no_geometry"])
def test_unbiased_wrapper_refuses_what_kernel_11_cannot_run(case):
    """Kernel 11 is built for K = 1..4, at most 8 neighbours, 32-bit pixel
    indices and a Philox key or injected noise, and its vis_check mode
    traces against geometry; on the card anything else raises before a
    launch."""
    k, n_nbr, hw, kw, match = {
        "k5": (5, 5, (4, 6), {}, "K=5"),
        "r9": (2, 9, (4, 6), {}, "neighbours"),
        "pixels": (2, 5, (46341, 46341), {}, "32-bit"),
        "no_noise": (2, 5, (4, 6), {}, "Philox key"),
        "vis_no_geometry": (2, 5, (4, 6), {"vis": True}, "geometry"),
    }[case]
    feats = PortFeatures(unbiased_combination=True,
                         spatial_reuse_visibility_check="vis" in kw)
    with pytest.raises(ValueError, match=match):
        spatial.spatial_pass_unbiased_fused(
            _OnTheCard(10 * k, *hw), _OnTheCard(18, *hw), k, n_nbr, 10,
            feats)
