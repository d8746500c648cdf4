"""Parity of the port's Z-count visibility with the JAX package: the plain
version of kernel 7 (``ops.trace.zcount_occ_plain``) against
``pallas_zcount_occ`` in interpret mode and against ``visibility_from``,
and the unbiased pass's vis_check mode (its plain form, then
``z_visibility``) against ``spatial_pass_unbiased_pallas(vis_check=True)``
in interpret mode (zero PRNG bits: every offset (-r, -r))."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from romis_tpu.ops.pallas_spatial import (
    pack_center_ctx as jax_pack_center_ctx, spatial_pass_unbiased_pallas,
)
from romis_tpu.ops.pallas_trace import pallas_zcount_occ
from romis_tpu.ops.wrs import visibility_from
from romis_tpu.render.restir import (
    pack_reservoir_planes as jax_pack_reservoir_planes,
    unpack_reservoir_planes as jax_unpack_reservoir_planes,
)
from romis_tpu.scene.scene import build_geometry as jax_build_geometry
from romis_tpu_torch.core.features import Features
from romis_tpu_torch.core.types import (
    pack_reservoir_planes, unpack_reservoir_planes,
)
from romis_tpu_torch.ops import spatial, trace
from romis_tpu_torch.ops.shade import pack_center_ctx
from romis_tpu_torch.utils import stats

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    jax_torus_field, port_ctx, port_reservoirs, port_scene, random_soup,
)

EPS = 1e-3  # ops/wrs.SHADOW_RAY_EPSILON


def _jax_soup(n_tris, seed):
    return jax_build_geometry([random_soup(np.random.default_rng(seed),
                                           n_tris)])


def _port_geometry(jg):
    """A JAX soup → the port's geometry (through numpy)."""
    from romis_tpu.scene.lights import LightListBuilder
    from romis_tpu.scene.scene import Scene

    lights = LightListBuilder()
    lights.add_point((0.0, 5.0, 0.0), (1.0, 1.0, 1.0))
    return port_scene(Scene(geometry=jg, lights=lights.build(),
                            num_lights=1)).geometry


def _rays(rng, r1, k, h, w, half):
    """Origins and targets in the scene's box, with coincident pairs on a
    few pixels (origin 0 at target 0, and origin 1 at target 1 nudged by
    less than eps)."""
    o = rng.uniform(-half, half, (r1, 3, h, w)).astype(np.float32)
    t = rng.uniform(-half, half, (k, 3, h, w)).astype(np.float32)
    t[0, :, 0, :4] = o[0, :, 0, :4]
    t[1 % k, :, 1, :4] = o[1, :, 1, :4] + 3e-4
    return o, t


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", ["soup", "torus"])
def test_zcount_plain_matches_pallas_and_visibility_from(name, masked):
    r1, k, h, w = 4, 2, 8, 16
    rng = np.random.default_rng(17)
    jg = _jax_soup(96, 3) if name == "soup" else jax_torus_field(1).geometry
    half = 1.6 if name == "soup" else 1.2
    geometry = _port_geometry(jg)
    o, t = _rays(rng, r1, k, h, w, half)
    mask = rng.uniform(size=(r1, k, h, w)) > 0.3 if masked else None
    got = trace.zcount_occ(torch.from_numpy(o), torch.from_numpy(t),
                           geometry, EPS,
                           None if mask is None else torch.from_numpy(mask))
    assert got.shape == (r1, k, h, w) and got.dtype == torch.bool
    expect = np.asarray(pallas_zcount_occ(
        jnp.asarray(o), jnp.asarray(t), jg, eps=EPS,
        mask=None if mask is None else jnp.asarray(mask), interpret=True))
    vis = np.asarray(visibility_from(jnp.asarray(o)[:, None],
                                     jnp.asarray(t)[None], jg))
    alive = np.ones_like(expect) if mask is None else mask
    occ = got.numpy()
    np.testing.assert_array_equal(occ[alive], expect[alive])
    np.testing.assert_array_equal(~occ[alive], vis[alive])
    # The coincident pairs are never occluded; some rays are.
    assert not occ[0, 0, 0, :4].any() and not occ[1, 1 % k, 1, :4].any()
    assert 0.05 < occ[alive].mean() < 0.95
    if mask is not None:
        assert not occ[~mask].any()


def test_zcount_wrapper_runs_the_plain_version_on_cpu():
    geometry = _port_geometry(_jax_soup(64, 4))
    rng = np.random.default_rng(1)
    o, t = (torch.from_numpy(a) for a in _rays(rng, 3, 2, 4, 6, 1.6))
    stats.launches.clear()
    assert torch.equal(trace.zcount_occ(o, t, geometry),
                       trace.zcount_occ_plain(o, t, geometry))
    assert stats.launches == {}


def _pass_inputs(seed, h, w, k):
    jres, jctx = random_reservoirs_and_ctx(np.random.default_rng(seed), h,
                                           w, k)
    return (jres, jctx, pack_reservoir_planes(port_reservoirs(jres)),
            pack_center_ctx(port_ctx(jctx)))


def test_vis_check_pass_matches_pallas_kernel_in_interpret_mode():
    """The vis_check pass against the Pallas kernel on the noise it draws in
    interpret mode; Z loses the inputs that do not see the winner through
    the soup."""
    h, w, k, r, radius = 16, 128, 2, 2, 3
    jg = _jax_soup(128, 5)
    geometry = _port_geometry(jg)
    jres, jctx, rp, cen = _pass_inputs(3, h, w, k)
    expect = jax_unpack_reservoir_planes(spatial_pass_unbiased_pallas(
        5, jax_pack_reservoir_planes(jres), jax_pack_center_ctx(jctx), k, r,
        radius, geometry=jg, vis_check=True,
        interpret=pltpu.InterpretParams()), k)
    novis = jax_unpack_reservoir_planes(spatial_pass_unbiased_pallas(
        5, jax_pack_reservoir_planes(jres), jax_pack_center_ctx(jctx), k, r,
        radius, interpret=pltpu.InterpretParams()), k)
    inject = (torch.full((2, r, h, w), -radius, dtype=torch.int32),
              torch.zeros((r + 1, k, h, w)))
    feats = Features(unbiased_combination=True,
                     spatial_reuse_visibility_check=True)
    got = unpack_reservoir_planes(spatial.spatial_pass_unbiased_fused(
        rp, cen, k, r, radius, feats, inject=inject, geometry=geometry), k)
    planes, block = spatial.spatial_pass_unbiased_vis(
        rp, cen, k, r, radius, feats, inject=inject)
    assert block.shape == (spatial.vis_check_planes(k, r), h, w)
    via = unpack_reservoir_planes(spatial.z_visibility(
        planes, block, rp, cen, geometry, k, r), k)
    live = np.asarray(expect.w_sum) > 0
    assert live.mean() > 0.3
    # The check changed W somewhere: Z lost occluded inputs.
    changed = np.abs(np.asarray(expect.big_w) - np.asarray(novis.big_w)) \
        > 1e-3 * np.abs(np.asarray(novis.big_w))
    assert changed.mean() > 0.02
    for res in (got, via):
        np.testing.assert_allclose(res.w_sum.numpy(),
                                   np.asarray(expect.w_sum), rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res.m.numpy(), np.asarray(expect.m),
                                   rtol=1e-6)
        np.testing.assert_allclose(res.big_w.numpy(),
                                   np.asarray(expect.big_w), rtol=2e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(res.pos.numpy() * live[:, None],
                                   np.asarray(expect.pos) * live[:, None],
                                   rtol=2e-4, atol=1e-5)


def test_vis_check_planes_plain_form():
    """The plain form's block: Z before visibility equals the non-vis pass's
    Z (its W agrees), p̂* and the m-flags are those of the winner, the
    positions are the neighbours' own (offsets (-r, -r), clamped)."""
    h, w, k, r, radius = 10, 14, 2, 3, 2
    _, _, rp, cen = _pass_inputs(8, h, w, k)
    feats = Features(unbiased_combination=True)
    inject = (torch.full((2, r, h, w), -radius, dtype=torch.int32),
              torch.from_numpy(np.random.default_rng(2).gumbel(
                  size=(r + 1, k, h, w)).astype(np.float32)))
    planes, block = spatial.spatial_pass_unbiased_vis(rp, cen, k, r, radius,
                                                      feats, inject=inject)
    plain = spatial.spatial_pass_unbiased_fused(rp, cen, k, r, radius, feats,
                                                inject=inject)
    torch.testing.assert_close(planes, plain, rtol=1e-5, atol=1e-6)
    ys = np.clip(np.arange(h) - radius, 0, h - 1)
    xs = np.clip(np.arange(w) - radius, 0, w - 1)
    nbr_pos = block[2 * k:2 * k + 3 * r].reshape(r, 3, h, w)
    for s in range(r):
        assert torch.equal(nbr_pos[s], cen[0:3][:, ys][:, :, xs])
    z, m_flags = block[:k], block[2 * k + 3 * r:].reshape(r, k, h, w)
    m_nbr = rp[7 * k:8 * k][:, ys][:, :, xs]
    assert bool(((m_flags == 0) | (m_flags == m_nbr[None])).all())
    m_self = rp[7 * k:8 * k]
    assert bool((z <= m_flags.sum(0) + m_self).all())
