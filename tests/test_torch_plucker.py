"""Parity of the port's Plücker any-hit (kernel 8's plain version,
``ops.trace.any_hit_plucker_plain``) with the JAX package: against the
Pallas ``pallas_any_mxu`` in interpret mode and against the XLA
Möller–Trumbore ``intersect_any``, on a random soup and on the one-torus
field's 970-triangle soup, with a leading sample axis; the side constants
against the reference's ``plucker_matrix``; inactive triangles; and the
wrapper's contract on the CPU.

The Plücker test and Möller–Trumbore are different algebra in float32, and
the reference's product sums in XLA's order, not the kernel's: a ray whose
segment ends or passes within rounding of a triangle's edge or plane may
come out either way. The budget is the reference's own
(``test_pallas.py:79``): at most a 1e-3 share of the rays differ."""

from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from romis_tpu.ops.intersect import intersect_any
from romis_tpu.ops.pallas_trace import pallas_any_mxu, plucker_matrix as jax_plucker_matrix
from romis_tpu.scene.scene import build_geometry as jax_build_geometry
from romis_tpu_torch.ops import trace
from romis_tpu_torch.scene.scene import repack_rows
from romis_tpu_torch.utils import stats

from torch_parity import jax_torus_field, port_scene, random_soup

MISMATCH = 1e-3  # share of rays, the reference's budget
S, H, W = 2, 8, 128


def _geometries(name):
    """(JAX geometry, the port's) of the named soup."""
    from romis_tpu.scene.lights import LightListBuilder
    from romis_tpu.scene.scene import Scene

    if name == "torus":
        jscene = jax_torus_field(1)
    else:
        lights = LightListBuilder()
        lights.add_point((0.0, 5.0, 0.0), (1.0, 1.0, 1.0))
        jscene = Scene(geometry=jax_build_geometry([random_soup(
            np.random.default_rng(3), 96)]), lights=lights.build(),
            num_lights=1)
    return jscene.geometry, port_scene(jscene).geometry


def _segments(seed, half=1.5):
    """Origins in the box, unit directions, t_max in [0.3, 3]: [S, 3, H, W]
    and [S, H, W] numpy."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-half, half, (S, 3, H, W)).astype(np.float32)
    d = rng.normal(size=(S, 3, H, W))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(0.3, 3.0, (S, H, W)).astype(np.float32)
    return o, d, tm


def _plain(o, d, tm, geometry):
    return trace.any_hit_plucker_plain(torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       torch.from_numpy(tm), geometry).numpy()


@pytest.mark.parametrize("name", ["soup", "torus"])
def test_plain_matches_pallas_mxu_kernel(name):
    jg, geometry = _geometries(name)
    o, d, tm = _segments(5)
    got = _plain(o, d, tm, geometry)
    expect = np.asarray(pallas_any_mxu(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(tm), jg, interpret=True))
    assert got.shape == expect.shape == (S, H, W)
    assert (got != expect).mean() <= MISMATCH
    assert 0.05 < got.mean() < 0.95


@pytest.mark.parametrize("name", ["soup", "torus"])
def test_plain_matches_moller_trumbore(name):
    """Against the XLA any-hit and against the port's own plain any-hit
    (the block scan of kernel 6), on the same segments."""
    jg, geometry = _geometries(name)
    o, d, tm = _segments(6)
    got = _plain(o, d, tm, geometry)
    expect = np.asarray(intersect_any(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tm), jg))
    mt = trace.any_hit_plain(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tm), geometry).numpy()
    assert (got != expect).mean() <= MISMATCH
    assert (got != mt).mean() <= MISMATCH
    assert 0.05 < got.mean() < 0.95


def test_plucker_matrix_matches_the_reference():
    for name in ("soup", "torus"):
        jg, geometry = _geometries(name)
        np.testing.assert_array_equal(trace.plucker_matrix(geometry).numpy(),
                                      np.asarray(jax_plucker_matrix(jg)))


@pytest.mark.parametrize("name", ["soup", "torus"])
def test_non_zero_columns_give_the_full_products_bools(name):
    """Every column outside a row's ``PLUCKER_COLS`` is zero, and the full
    10-term products summed left to right give the same bool on every ray
    as the plain version, which sums only those columns."""
    _, geometry = _geometries(name)
    o, d, tm = (torch.from_numpy(a) for a in _segments(8))
    c = trace.plucker_matrix(geometry)
    n = c.shape[0] // 5
    c = c.reshape(5, n, 16)
    for row, (lo, hi) in enumerate(trace.PLUCKER_COLS):
        assert not c[row, :, :lo].any() and not c[row, :, hi:].any()
    r = trace._plucker_rays(o, d, tm).reshape(10, 1, -1)
    sides = []
    for row in range(5):
        acc = c[row, :, 0, None] * r[0]
        for j in range(1, 10):
            acc = acc + c[row, :, j, None] * r[j]
        sides.append(acc)
    e0, e1, e2, s0, ds = sides
    same = (((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0))
            | ((e0 <= 0.0) & (e1 <= 0.0) & (e2 <= 0.0)))
    full = (same & (s0 * (s0 + ds) < 0.0)).any(dim=0).reshape(tm.shape)
    got = trace.any_hit_plucker_plain(o, d, tm, geometry)
    assert torch.equal(got, full)
    assert 0.05 < got.float().mean() < 0.95


def test_inactive_triangle_never_occludes():
    """Rays through the centroids of the soup's triangles, each segment
    crossing its own triangle's plane: occluded while the triangles are
    active, never once they are all inactive (all-zero rows)."""
    _, geometry = _geometries("soup")
    n_tri = 16
    cen = (geometry.v0 + (geometry.e1 + geometry.e2) / 3.0)[:n_tri]
    nrm = torch.linalg.cross(geometry.e1, geometry.e2)[:n_tri]
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
    o = (cen + 0.5 * nrm).t().reshape(3, 1, n_tri)
    d = (-nrm).t().reshape(3, 1, n_tri)
    tm = torch.ones((1, n_tri))
    assert bool(trace.any_hit_plucker(o, d, tm, geometry).all())
    off = repack_rows(replace(geometry, active=torch.zeros_like(
        geometry.active)))
    assert not bool(trace.any_hit_plucker(o, d, tm, off).any())
    assert not trace.plucker_matrix(off).any()


def test_wrapper_runs_the_plain_version_on_cpu_and_refuses_a_bvh():
    from romis_tpu_torch.ops.bvh import with_bvh

    _, geometry = _geometries("soup")
    o, d, tm = (torch.from_numpy(a) for a in _segments(7))
    stats.launches.clear()
    got = trace.any_hit_plucker(o, d[0], tm, geometry)  # dirs broadcast
    assert got.dtype == torch.bool and got.shape == (S, H, W)
    assert torch.equal(got, trace.any_hit_plucker_plain(o, d[0], tm,
                                                        geometry))
    assert torch.equal(got[1], trace.any_hit_plucker(o[1], d[0], tm[1],
                                                     geometry))
    assert stats.launches == {}
    with pytest.raises(ValueError, match="BVH"):
        trace.any_hit_plucker(o, d, tm, with_bvh(geometry))
    with pytest.raises(ValueError, match="do not match"):
        trace.any_hit_plucker(o, d, tm[0], geometry)
