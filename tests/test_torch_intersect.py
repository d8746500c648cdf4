"""Parity of the PyTorch port's closest hit, any-hit, row gather and hit
attributes with the JAX package on a 64-triangle random soup (CPU: the
kernel wrappers run their plain versions here)."""

import numpy as np
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from romis_tpu.core.features import Features
from romis_tpu.core.types import Rays as JaxRays
from romis_tpu.ops.intersect import intersect_any as jax_intersect_any
from romis_tpu.ops.intersect import intersect_closest as jax_closest
from romis_tpu.ops.intersect import make_hit_record as jax_hit_record
from romis_tpu.ops.intersect import make_shade_ctx as jax_shade_ctx
from romis_tpu.ops.pallas_rows import _rows_gather_pallas
from romis_tpu.ops.pallas_trace import pallas_closest
from romis_tpu.scene.scene import build_geometry
from romis_tpu_torch.core.types import Rays
from romis_tpu_torch.ops.intersect import (
    intersect_any, make_hit_record, make_shade_ctx,
)
from romis_tpu_torch.ops.rows import gather_rows
from romis_tpu_torch.ops.trace import closest_hit
from romis_tpu_torch.scene.scene import build_geometry as port_build_geometry

from torch_parity import port_features, random_rays, random_soup

H, W = 16, 64


def _soup(seed=0, n_tris=64):
    sm = random_soup(np.random.default_rng(seed), n_tris)
    return build_geometry([sm]), port_build_geometry([sm], "cpu")


def _rays(seed=1):
    o, d = random_rays(np.random.default_rng(seed), H, W)
    return (JaxRays(origin=jnp.asarray(o), direction=jnp.asarray(d)),
            Rays(origin=torch.from_numpy(o), direction=torch.from_numpy(d)))


def _finite(a):
    a = np.asarray(a)
    return np.where(np.isfinite(a), a, -1.0)


def test_closest_hit_matches_jax_and_pallas():
    jgeo, geo = _soup()
    jrays, rays = _rays()
    t, tri, u, v = closest_hit(rays, geo)
    assert tri.dtype == torch.int32
    hit_share = (tri >= 0).float().mean().item()
    assert 0.2 < hit_share < 0.95, hit_share
    for ref in (jax_closest(jrays, jgeo),
                pallas_closest(jrays, jgeo, interpret=True)):
        t_r, tri_r, u_r, v_r = ref
        np.testing.assert_array_equal(tri.numpy(), np.asarray(tri_r))
        np.testing.assert_allclose(_finite(t.numpy()), _finite(t_r),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(u.numpy(), np.asarray(u_r), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_r), rtol=1e-4,
                                   atol=1e-6)


def test_closest_hit_lowest_index_wins_ties():
    """Two copies of the same triangle: every hit reports the first."""
    sm = random_soup(np.random.default_rng(4), 8)
    sm.triangles = np.concatenate([sm.triangles, sm.triangles[:8]])
    geo = port_build_geometry([sm], "cpu")
    _, rays = _rays(5)
    _, tri, _, _ = closest_hit(rays, geo)
    assert (tri < 8).all()


def test_intersect_any_matches_jax():
    jgeo, geo = _soup(2)
    rng = np.random.default_rng(6)
    k = 3
    o, d = (np.stack(a) for a in zip(*(random_rays(rng, H, W)
                                       for _ in range(k))))
    t_max = rng.uniform(0.5, 6.0, (k, H, W)).astype(np.float32)
    expect = np.asarray(jax_intersect_any(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jgeo))
    got = intersect_any(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(t_max), geo)
    assert 0.05 < expect.mean() < 0.95
    np.testing.assert_array_equal(got.numpy(), expect)


def test_gather_rows_matches_pallas_exactly():
    rng = np.random.default_rng(7)
    for t_rows, c in ((300, 24), (5, 8)):
        table = rng.normal(size=(t_rows, c)).astype(np.float32)
        idx = rng.integers(0, t_rows, (H, W)).astype(np.int32)
        expect = np.asarray(_rows_gather_pallas(
            jnp.asarray(table), jnp.asarray(idx),
            interpret=pltpu.InterpretParams()))
        got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
        assert got.shape == (c, H, W)
        np.testing.assert_array_equal(got.numpy(), expect)
    # Leading index axes stay in place: [K, H, W] → [C, K, H, W].
    idx3 = rng.integers(0, 5, (2, H, W)).astype(np.int32)
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx3))
    np.testing.assert_array_equal(got.numpy(),
                                  np.moveaxis(table[idx3], -1, 0))


def test_make_shade_ctx_matches_jax():
    jgeo, geo = _soup(3)
    jrays, rays = _rays(8)
    feats = Features()
    jhits = jax_hit_record(jrays, jgeo, *jax_closest(jrays, jgeo))
    jctx = jax_shade_ctx(jrays, jhits, jgeo, feats)
    hits = make_hit_record(rays, geo, *closest_hit(rays, geo))
    ctx = make_shade_ctx(rays, hits, geo, port_features(feats))
    for name in ("valid", "mat_id", "geom_id", "prim_id"):
        np.testing.assert_array_equal(getattr(hits, name).numpy(),
                                      np.asarray(getattr(jhits, name)))
    for name in ("normal", "uv"):
        np.testing.assert_allclose(getattr(hits, name).numpy(),
                                   np.asarray(getattr(jhits, name)),
                                   rtol=1e-5, atol=1e-6)
    for name in ("position", "normal", "view_origin", "kd", "ks",
                 "shininess", "depth_t"):
        np.testing.assert_allclose(getattr(ctx, name).numpy(),
                                   np.asarray(getattr(jctx, name)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ctx.valid.numpy(), np.asarray(jctx.valid))
