"""The port's BVH build and plain traversal against the JAX package's, on
the 2x2 torus field (3,874 triangles, above the soup kernels' 2048): the
builders' contracts (DFS preorder, leaf ranges, every column permuted),
the SAH cost against the JAX package's native build, the tree carried
across (``convert.bvh_from_numpy``), ``bvh_closest`` and ``bvh_any``
against JAX's ``traverse.bvh_closest`` and ``bvh_any`` on the same tree,
leaves above the reference's 4-slot unroll, and the walk kernels' wrappers
running their plain versions on CPU tensors."""

from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from romis_tpu.ops.bvh import build_bvh as jax_build_bvh
from romis_tpu.ops.bvh import sah_cost as jax_sah_cost
from romis_tpu.ops.traverse import bvh_any as jax_bvh_any
from romis_tpu.ops.traverse import bvh_closest as jax_bvh_closest
from romis_tpu.core.types import Rays as JaxRays
from romis_tpu_torch.core.types import Rays
from romis_tpu_torch.ops import shade, trace, walk
from romis_tpu_torch.ops.bvh import build_bvh, sah_cost, with_bvh
from romis_tpu_torch.ops.intersect import intersect_any, intersect_closest
from romis_tpu_torch.ops.traverse import bvh_any, bvh_closest
from romis_tpu_torch.scene.scene import (
    Material, SubMesh, build_geometry, torus_field,
)
from romis_tpu_torch.utils import stats

from torch_parity import (
    jax_torus_field, port_bvh_scene, port_scene, random_rays, t,
)

FIELD_HALF = 2.6  # the 2x2 field's tori lie within +-2.2 in x and z


@pytest.fixture(scope="module")
def field():
    """(JAX scene with its BVH, the same scene in the port with the tree
    carried across, the port's own scene without a BVH)."""
    jscene = jax_torus_field(2)
    bvh, geo = jax_build_bvh(jscene.geometry)
    jscene.geometry = geo.replace(bvh=bvh)
    return jscene, port_bvh_scene(jscene), torus_field(2, "cpu")


def _rays(seed, h, w):
    """Random rays from outside the field aimed into it → numpy (o, d)."""
    return random_rays(np.random.default_rng(seed), h, w, half=FIELD_HALF)


@pytest.mark.parametrize("builder", ["sah", "median"])
def test_builder_contracts(field, builder):
    """DFS preorder, leaf ranges partitioning [0, T) in node order, and
    every triangle column permuted with the row tables repacked: the walk
    on the permuted geometry hits what the brute force hits on the
    unpermuted soup, attributes included."""
    _, _, scene = field
    geo0 = scene.geometry
    bvh, geo = build_bvh(geo0, builder=builder)
    n_act = int(geo0.active.sum())
    count = bvh.leaf_count.numpy()
    first = bvh.leaf_first.numpy()
    miss = bvh.miss_link.numpy()
    inner = count == 0
    idx = np.arange(bvh.n_nodes)
    # Preorder: an inner node's subtree is [i + 1, miss) and a leaf's
    # miss link is the next node, or -1 at the end.
    assert np.all(miss[~inner] == np.where(idx[~inner] + 1 < bvh.n_nodes,
                                           idx[~inner] + 1, -1))
    assert np.all((miss[inner] > idx[inner] + 1) | (miss[inner] == -1))
    starts, ends = first[~inner], first[~inner] + count[~inner]
    assert starts[0] == 0 and np.array_equal(starts[1:], ends[:-1])
    assert ends[-1] == n_act
    assert bool(geo.active[:n_act].all()) and not bool(geo.active[n_act:].any())
    # Hits on the permuted geometry carry the unpermuted triangle's rows.
    o, d = _rays(3, 24, 32)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    t_v, tri_v, u_v, v_v = bvh_closest(rays, geo, bvh)
    t_b, tri_b, u_b, v_b = intersect_closest(rays, geo0)
    hit = torch.isfinite(t_b)
    assert torch.equal(torch.isfinite(t_v), hit) and hit.float().mean() > 0.3
    torch.testing.assert_close(t_v[hit], t_b[hit], rtol=1e-5, atol=0)
    rows_v = torch.cat([geo.tri_cols.t(), geo.attr_rows], 1)[tri_v[hit]]
    rows_b = torch.cat([geo0.tri_cols.t(), geo0.attr_rows], 1)[tri_b[hit]]
    same = (rows_v == rows_b).all(dim=1)
    # Another triangle only on a tie (a shared edge), at the same t.
    assert same.float().mean() > 0.99
    torch.testing.assert_close(t_v[hit][~same], t_b[hit][~same], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(u_v[hit][same], u_b[hit][same], rtol=1e-5,
                               atol=1e-6)


def test_sah_cost_close_to_jax(field):
    """The port's copy of the SAH builder (compiled without -march=native)
    builds a tree at most 5 % worse by SAH cost than the JAX package's
    prebuilt native library on the same scene."""
    jscene, _, scene = field
    ours = sah_cost(build_bvh(scene.geometry)[0])
    theirs = jax_sah_cost(jscene.geometry.bvh)
    assert ours <= 1.05 * theirs, (ours, theirs)
    median = sah_cost(build_bvh(scene.geometry, builder="median")[0])
    assert ours < median


def test_bvh_from_numpy_reproduces_jax(field):
    jscene, pscene, _ = field
    b, p = jscene.geometry.bvh, pscene.geometry.bvh
    for f in ("bmin_x", "bmin_y", "bmin_z", "bmax_x", "bmax_y", "bmax_z",
              "miss_link", "leaf_first", "leaf_count"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert p.max_leaf_count == int(np.asarray(b.leaf_count).max())
    np.testing.assert_array_equal(pscene.geometry.v0.numpy(),
                                  np.asarray(jscene.geometry.v0))


@pytest.mark.parametrize("cap", [None, 4.0], ids=["no_cap", "t_max"])
def test_closest_matches_jax(field, cap):
    """Random rays, tri exact and t within rtol 1e-5 (u, v: see below), on
    a tree whose
    leaves hold at most 4 triangles (the reference's unroll); with a t_max
    cap both return t_max on a miss and hit only below it."""
    jscene, pscene, _ = field
    assert pscene.geometry.bvh.max_leaf_count <= 4
    h, w = 16, 24
    o, d = _rays(5, h, w)
    tm = None if cap is None else np.full((h, w), cap, np.float32)
    expect = jax_bvh_closest(
        JaxRays(jnp.asarray(o), jnp.asarray(d)), jscene.geometry,
        jscene.geometry.bvh, None if tm is None else jnp.asarray(tm))
    got = bvh_closest(Rays(torch.from_numpy(o), torch.from_numpy(d)),
                      pscene.geometry, pscene.geometry.bvh,
                      None if tm is None else torch.from_numpy(tm))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(expect[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(expect[0]),
                               rtol=1e-5, atol=0)
    # u and v of a small triangle seen from afar are a cancelling dot
    # product over a small determinant: XLA's CPU fusion (multiply-add
    # contraction) and PyTorch's op-by-op rounding part by up to ~1e-5 of
    # the unit barycentric range there.
    for a, b in zip(got[2:], expect[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=3e-5)
    hits = got[1] >= 0
    assert 0.1 < hits.float().mean() < 0.95
    if cap is not None:
        assert bool((got[0][hits] < cap).all())
        assert bool((got[0][~hits] == cap).all())


@pytest.mark.parametrize("planes", [1, 2, 12, 17])
def test_any_matches_jax(field, planes):
    """Shadow-like rays with 1, 2, 12 and 17 leading planes (both any-hit
    kernels' shapes), occlusion exact; the t_max spread makes both classes
    common."""
    jscene, pscene, _ = field
    h, w = 8, 12
    rng = np.random.default_rng(planes)
    o = np.stack([_rays(10 * planes + i, h, w)[0] for i in range(planes)])
    d = np.stack([_rays(10 * planes + i, h, w)[1] for i in range(planes)])
    tm = rng.uniform(2.0, 6.0, (planes, h, w)).astype(np.float32)
    expect = np.asarray(jax_bvh_any(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(tm), jscene.geometry,
                                    jscene.geometry.bvh))
    got = bvh_any(torch.from_numpy(o), torch.from_numpy(d),
                  torch.from_numpy(tm), pscene.geometry, pscene.geometry.bvh)
    np.testing.assert_array_equal(got.numpy(), expect)
    assert 0.05 < expect.mean() < 0.95
    # The dispatch of the plain intersection reaches the same traversal.
    assert torch.equal(intersect_any(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tm), pscene.geometry),
                       got)


def _stacks(n_side=4, per=8):
    """Stacks of ``per`` unit triangles in the z = 0 plane, each lifted by
    i * 3e-9 (centroids apart, boxes equal in float area), on a grid: the
    SAH builder keeps each stack as one leaf of ``per`` triangles."""
    tri = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    pos = []
    for gx in range(n_side):
        for gy in range(n_side):
            for i in range(per):
                p = tri + np.asarray([2.0 * gx, 2.0 * gy, 0.0], np.float32)
                p[:, 2] = np.float32(i * 3e-9)
                pos.append(p)
    pos = np.concatenate(pos)
    n = len(pos) // 3
    return SubMesh(positions=pos,
                   normals=np.tile(np.float32([[0, 0, 1]]), (3 * n, 1)),
                   texcoords=np.zeros((3 * n, 2), np.float32),
                   triangles=np.arange(3 * n, dtype=np.int32).reshape(-1, 3),
                   material=Material(kd=(0.5, 0.5, 0.5)))


def test_leaves_above_four_are_walked_whole():
    """Coincident-centroid stacks give SAH leaves of 8 triangles, above the
    reference's 4-slot unroll; the port's traversal tests every slot and
    matches the brute force, the nearest triangle being anywhere in its
    leaf."""
    soup = build_geometry([_stacks()], "cpu")
    geo = with_bvh(soup)
    assert geo.bvh.max_leaf_count == 8
    rng = np.random.default_rng(0)
    h, w = 8, 16
    g = rng.integers(0, 4, (2, h, w)).astype(np.float32) * 2.0
    frac = rng.uniform(0.05, 0.45, (2, h, w)).astype(np.float32)
    o = np.stack([g[0] + frac[0], g[1] + frac[1],
                  np.full((h, w), 1e-3, np.float32)])
    d = np.broadcast_to(np.float32([0, 0, -1])[:, None, None], (3, h, w))
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d.copy()))
    t_v, tri_v, _, _ = bvh_closest(rays, geo, geo.bvh)
    t_b, tri_b, _, _ = intersect_closest(rays, replace(geo, bvh=None))
    assert bool((tri_b >= 0).all())
    assert torch.equal(tri_v, tri_b) and torch.equal(t_v, t_b)
    slot = np.zeros(geo.num_tris, np.int64)
    for f, c in zip(geo.bvh.leaf_first.numpy(), geo.bvh.leaf_count.numpy()):
        slot[f:f + c] = np.arange(c)
    assert slot[tri_b.numpy()].max() >= 4  # nearest beyond the 4th slot
    occ = bvh_any(rays.origin, rays.direction,
                  torch.full((h, w), 1.0), geo, geo.bvh)
    assert bool(occ.all())


def test_wrappers_run_plain_on_cpu(field):
    """On CPU tensors the walk kernels' wrappers (and the trace and shade
    entry points for BVH geometry) run the plain traversal, and no launch
    counter moves."""
    _, pscene, _ = field
    geo = pscene.geometry
    stats.launches.clear()
    o, d = _rays(9, 6, 8)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    expect = bvh_closest(rays, geo, geo.bvh)
    for got in (walk.closest_hit_bvh(rays, geo), trace.closest_hit(rays, geo),
                trace.closest_hit_plain(rays, geo)):
        for a, b in zip(got, expect):
            assert torch.equal(a, b)
    oo = torch.from_numpy(np.stack([o, o]))
    tm = torch.full((2, 6, 8), 4.0)
    occ = bvh_any(oo, torch.from_numpy(d), tm, geo, geo.bvh)
    for fn in (walk.any_hit_bvh, walk.any_hit_bvh_k, trace.any_hit):
        assert torch.equal(fn(oo, torch.from_numpy(d), tm, geo), occ)
    assert stats.launches == {}
