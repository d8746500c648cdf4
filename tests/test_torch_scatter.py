"""Parity of the PyTorch port's backward kernels' plain versions and its
autograd wrappers with the JAX package (CPU: every wrapper runs its plain
version here): the row scatter-add against the Pallas kernel in interpret
mode and np.add.at, the halo offset scatter against its Pallas kernel and
the gather's segment-sum VJP, and the backward of the row gather, the halo
gather, the closest hit and the final shade against jax.vjp of the JAX
functions. Tolerances: sums of float32 terms in another order, 1e-5
relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from romis_tpu.core.features import Features
from romis_tpu.core.types import Rays as JaxRays
from romis_tpu.ops.intersect import closest_hit_diff
from romis_tpu.ops.pallas_rows import gather_rows as jax_gather_rows
from romis_tpu.ops.pallas_scatter import scatter_rows_add as jax_scatter
from romis_tpu.ops.pallas_spatial import (
    halo_offset_gather as jax_halo_gather, halo_offset_scatter_pallas,
)
from romis_tpu.render.restir import _final_shade_xla
from romis_tpu.scene.scene import build_geometry
from romis_tpu_torch.core.types import Rays
from romis_tpu_torch.ops import rows, scatter, spatial, trace
from romis_tpu_torch.ops.shade import final_shade_fused
from romis_tpu_torch.scene.scene import build_geometry as port_build_geometry

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    port_ctx, port_features, port_reservoirs, random_rays, random_soup, t,
)


def _add_at(ct, idx, n_rows):
    c = ct.shape[0]
    out = np.zeros((n_rows, c), np.float32)
    np.add.at(out, np.clip(idx, 0, n_rows - 1).ravel(), ct.reshape(c, -1).T)
    return out


@pytest.mark.parametrize("c,lead,h,w,n_rows", [
    (24, (), 48, 200, 512), (9, (2,), 13, 40, 83)], ids=["2d", "lanes"])
def test_scatter_rows_add_matches_jax_kernel_and_add_at(c, lead, h, w,
                                                        n_rows):
    rng = np.random.default_rng(0)
    ct = rng.normal(size=(c,) + lead + (h, w)).astype(np.float32)
    idx = rng.integers(0, n_rows, lead + (h, w)).astype(np.int32)
    got = scatter.scatter_rows_add(torch.from_numpy(ct),
                                   torch.from_numpy(idx), n_rows).numpy()
    assert got.shape == (n_rows, c)
    expect = np.asarray(jax_scatter(jnp.asarray(ct), jnp.asarray(idx),
                                    n_rows, interpret=True))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, _add_at(ct, idx, n_rows), rtol=1e-5,
                               atol=1e-4)


def test_scatter_rows_add_is_the_clamped_gathers_transpose():
    """Out-of-range indices gather the clamped row, so their cotangents go
    back to it: <gather(T, i), ct> = <T, scatter(ct, i)>."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-3, 10, (6, 9)).astype(np.int32))
    ct = torch.from_numpy(rng.normal(size=(5, 6, 9)).astype(np.float32))
    lhs = (rows.gather_rows(table, idx) * ct).sum()
    rhs = (table * scatter.scatter_rows_add(ct, idx, 7)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)
    np.testing.assert_allclose(scatter.scatter_rows_add(ct, idx, 7).numpy(),
                               _add_at(ct.numpy(), idx.numpy(), 7),
                               rtol=1e-5, atol=1e-5)


def _offsets(rng, d_n, h, w, r):
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    ny = np.clip(ys + rng.integers(-r, r + 1, (d_n, h, w)), 0, h - 1)
    nx = np.clip(xs + rng.integers(-r, r + 1, (d_n, h, w)), 0, w - 1)
    return (ny - ys).astype(np.int32), (nx - xs).astype(np.int32)


def test_halo_offset_scatter_matches_jax_kernel_and_vjp():
    h, w, r, d_n, c = 40, 150, 4, 3, 2
    rng = np.random.default_rng(2)
    dy, dx = _offsets(rng, d_n, h, w, r)
    ct = rng.normal(size=(d_n, c, h, w)).astype(np.float32)
    got = spatial.halo_offset_scatter(torch.from_numpy(ct),
                                      torch.from_numpy(dy),
                                      torch.from_numpy(dx)).numpy()
    assert got.shape == (c, h, w)
    expect = np.asarray(halo_offset_scatter_pallas(
        jnp.asarray(ct), jnp.asarray(dy), jnp.asarray(dx), r,
        interpret=pltpu.InterpretParams()))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda p: jax_halo_gather(p, jnp.asarray(dy),
                                               jnp.asarray(dx), r),
                     jnp.zeros((c, h, w)))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-5, atol=1e-5)


def test_gather_rows_vjp_matches_jax():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(83, 24)).astype(np.float32)
    idx = rng.integers(0, 83, (2, 13, 40)).astype(np.int32)
    ct = rng.normal(size=(24, 2, 13, 40)).astype(np.float32)
    tab = torch.from_numpy(table).requires_grad_()
    out = rows.gather_rows(tab, torch.from_numpy(idx))
    (got,) = torch.autograd.grad(out, tab, torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda x: jax_gather_rows(x, jnp.asarray(idx)),
                     jnp.asarray(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(
        jnp.asarray(ct))[0]), rtol=1e-5, atol=1e-5)


def test_halo_offset_gather_vjp_matches_jax():
    h, w, r, d_n, c = 24, 40, 3, 5, 2
    rng = np.random.default_rng(4)
    dy, dx = _offsets(rng, d_n, h, w, r)
    planes = rng.normal(size=(c, h, w)).astype(np.float32)
    ct = rng.normal(size=(d_n, c, h, w)).astype(np.float32)
    p = torch.from_numpy(planes).requires_grad_()
    out = spatial.halo_offset_gather(p, torch.from_numpy(dy),
                                     torch.from_numpy(dx))
    (got,) = torch.autograd.grad(out, p, torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda x: jax_halo_gather(x, jnp.asarray(dy),
                                               jnp.asarray(dx), r),
                     jnp.asarray(planes))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(
        jnp.asarray(ct))[0]), rtol=1e-5, atol=1e-5)


def test_closest_hit_vjp_matches_jax():
    """The re-evaluation backward: cotangents of (t, u, v) into the vertex
    columns, misses included (their t is inf)."""
    h, w = 24, 32
    rng = np.random.default_rng(5)
    sm = random_soup(rng, 40)
    jgeo, geo = build_geometry([sm]), port_build_geometry([sm], "cpu")
    o, d = random_rays(rng, h, w)
    cts = [rng.normal(size=(h, w)).astype(np.float32) for _ in range(3)]

    def jax_f(v0, e1, e2):
        t_, _, u_, v_ = closest_hit_diff(
            JaxRays(jnp.asarray(o), jnp.asarray(d)),
            jgeo.replace(v0=v0, e1=e1, e2=e2))
        return t_, u_, v_

    (tj, uj, vj), vjp = jax.vjp(jax_f, jgeo.v0, jgeo.e1, jgeo.e2)
    ct_t = np.where(np.isfinite(np.asarray(tj)), cts[0], 0.0)
    expect = vjp((jnp.asarray(ct_t, jnp.float32), jnp.asarray(cts[1]),
                  jnp.asarray(cts[2])))

    cols = [getattr(geo, f).clone().requires_grad_() for f in
            ("v0", "e1", "e2")]
    geo.v0, geo.e1, geo.e2 = cols
    t_, tri, u_, v_ = trace.closest_hit(Rays(t(o), t(d)), geo)
    assert not torch.isfinite(t_).all() and torch.isfinite(t_).any()
    got = torch.autograd.grad((t_, u_, v_), cols,
                              (torch.from_numpy(cts[0]),
                               torch.from_numpy(cts[1]),
                               torch.from_numpy(cts[2])))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(
        closest_hit_diff(JaxRays(jnp.asarray(o), jnp.asarray(d)), jgeo)[1]))
    for g, e in zip(got, expect):
        e = np.asarray(e)
        assert np.isfinite(g.numpy()).all() and np.abs(e).max() > 0
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-4,
                                   atol=1e-4 * np.abs(e).max())


def test_final_shade_vjp_matches_jax():
    """The re-evaluation backward (visibility held fixed) against jax.vjp
    of the XLA final shade, into the receiver context and the reservoirs."""
    h, w, k = 16, 24, 2
    sm = random_soup(np.random.default_rng(6), 48)
    jgeo, geo = build_geometry([sm]), port_build_geometry([sm], "cpu")
    jres, jctx = random_reservoirs_and_ctx(np.random.default_rng(7), h, w, k)
    feats = Features()
    ct = np.random.default_rng(8).normal(size=(3, h, w)).astype(np.float32)
    ctx_f = ("position", "normal", "kd", "ks", "shininess")
    res_f = ("pos", "color", "big_w")

    def jax_f(*a):
        c = jctx.replace(**dict(zip(ctx_f, a[:5])))
        r = jres.replace(**dict(zip(res_f, a[5:])))
        return _final_shade_xla(c, r, jgeo, feats)

    out_j, vjp = jax.vjp(jax_f, *[getattr(jctx, f) for f in ctx_f],
                         *[getattr(jres, f) for f in res_f])
    expect = vjp(jnp.asarray(ct))

    ctx, res = port_ctx(jctx), port_reservoirs(jres)
    leaves = []
    for obj, names in ((ctx, ctx_f), (res, res_f)):
        for f in names:
            x = getattr(obj, f).clone().requires_grad_()
            setattr(obj, f, x)
            leaves.append(x)
    out = final_shade_fused(ctx, res, geo, port_features(feats))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for name, g, e in zip(ctx_f + res_f, got, expect):
        e = np.asarray(e)
        scale = max(np.abs(e).max(), 1e-12)
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
