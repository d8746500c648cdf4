"""What lives in Python around the redesigned kernels 18 (the BVH closest
hit, ``ops.walk.closest_hit_bvh``) and 1 (the soup closest hit,
``ops.trace.closest_hit``), on the CPU.

Kernel 1 culls a soup of more than 16 triangles by the blocks of
``ops.trace.soup_blocks`` (kernels 7 and 4's, with each slot's input
index). Its plain model, ``ops.trace.closest_hit_culled`` (box over [0,
best t], the near-parallel guard's box and distance rules, the plain
scan's Möller–Trumbore, (t, input index) order), gives
``closest_hit_plain``'s
(t, tri, u, v) bit for bit: on the one-torus soup through
``chip_smoke.TORUS_CAM``, on a 2048-triangle random soup, on random,
grazing, edge-on and edge-crossing rays (``chip_smoke.hard_z_rays``), on
rays starting inside a block's box, on an empty soup and on soups of at
most 16 triangles (tested as given). Two coincident triangles in different
blocks give the lower input index. Against the JAX package the culled
closest hit of the torus soup matches ``pallas_closest(interpret=True)``
as ``test_torch_intersect.py`` holds the soup's (tri exact, t within rtol
1e-5, u and v within 1e-4: the two packages' arithmetic orders differ).

Kernel 18 walks the tree nearer child first from a derived two-box node
record (``ops.bvh.wide_record``). Its plain model,
``ops.traverse.bvh_closest_ordered``, gives ``bvh_closest``'s bits on the
torus field's rays with the SAH and the median trees, capped or not, and
on rays from inside the field; the record holds the node columns' boxes
and references; in preorder the leaves come in ascending, contiguous
``leaf_first`` (the tie rule rests on it). On CPU tensors both wrappers
run their plain versions and launch nothing."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romis_tpu.core.types import Rays as JaxRays
from romis_tpu.ops.pallas_trace import pallas_closest
from romis_tpu_torch.core.camera import generate_rays, make_camera
from romis_tpu_torch.core.types import Rays
from romis_tpu_torch.ops import trace, walk
from romis_tpu_torch.ops.bvh import with_bvh
from romis_tpu_torch.ops.traverse import bvh_closest, bvh_closest_ordered
from romis_tpu_torch.scene.scene import (
    build_geometry, flagship_camera, flagship_scene, torus_field,
    torus_field_camera,
)
from romis_tpu_torch.utils import stats

from chip_smoke import HARD_RAY_KINDS, TORUS_CAM, hard_z_rays, random_soup
from torch_parity import jax_torus_field, random_rays
from torch_parity import random_soup as parity_soup


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _torus_soup():
    return torus_field(1, "cpu").geometry


def _soup2048():
    return build_geometry([random_soup(2048, (2.57, 1.23, -1.35), 3.0,
                                       seed=7)], "cpu")


def _unit(d):
    return d / torch.linalg.vector_norm(d, dim=0).clamp_min(1e-20)


def _culled(rays, geometry, order=None, **kw):
    """closest_hit_culled beside closest_hit_plain → (culled, plain,
    counts)."""
    counts = {}
    got = trace.closest_hit_culled(rays, geometry, counts=counts,
                                   order=order, **kw)
    return got, trace.closest_hit_plain(rays, geometry, **kw), counts


def test_culled_closest_hit_is_plain_on_the_torus_soup():
    """The one-torus soup at 48x64 through TORUS_CAM: the plain scan's
    bits; the walk tests far fewer triangles than the soup's slots."""
    geometry = _torus_soup()
    rays = generate_rays(make_camera(resolution=(48, 64), device="cpu",
                                     **TORUS_CAM), 48, 64)
    got, plain, n = _culled(rays, geometry)
    assert _same(got, plain)
    assert 0.1 < torch.isfinite(plain[0]).float().mean().item() < 0.9
    n_blocks = trace.soup_blocks(geometry)[1].shape[1]
    assert (n["box"] == n_blocks).all()  # no deferred block on the torus
    assert n["tri"].float().mean().item() < geometry.tri_cols.shape[1] / 3
    # The box alone (the bound's walk): no guard, no more triangle tests.
    box_only = {}
    trace.closest_hit_culled(rays, geometry, counts=box_only, guard=False)
    assert (box_only["guard"] == 0).all() and (box_only["box"] == n_blocks).all()
    assert (box_only["tri"] <= n["tri"]).all()


@pytest.mark.parametrize("t_max", [float("inf"), 2.5])
def test_culled_closest_hit_is_plain_on_soup2048(t_max):
    """Random rays through the 2048-triangle soup (every block deferred),
    with and without a cap on t."""
    geometry = _soup2048()
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-1.0, 6.0, (3, 24, 32)).astype(
        np.float32))
    d = _unit(torch.from_numpy(rng.normal(size=(3, 24, 32)).astype(
        np.float32)))
    got, plain, n = _culled(Rays(o, d), geometry, t_max=t_max)
    assert _same(got, plain)
    assert torch.isfinite(plain[0]).any() and not torch.isfinite(
        plain[0]).all()
    assert (n["tri"] < geometry.tri_cols.shape[1]).all()


@pytest.mark.parametrize("kind", HARD_RAY_KINDS)
@pytest.mark.parametrize("name", ["torus", "soup2048"])
def test_culled_closest_hit_is_plain_on_hard_rays(name, kind):
    """Random, grazing, edge-on and edge-crossing rays (hard_z_rays'
    origins toward their targets), where the guard decides."""
    geometry = _torus_soup() if name == "torus" else _soup2048()
    o, t = (torch.from_numpy(a)[0] for a in hard_z_rays(
        np.random.default_rng(110 + HARD_RAY_KINDS.index(kind)), kind,
        geometry.tri_cols.numpy(), 1, 1, 12, 16))
    got, plain, _ = _culled(Rays(o.contiguous(), _unit(t - o)), geometry)
    assert _same(got, plain)


def test_culled_closest_hit_is_plain_from_inside_blocks():
    """Rays that start inside a block's box (at its centre and near its
    corners), in every direction."""
    geometry = _torus_soup()
    boxes = trace.soup_blocks(geometry)[1]
    rng = np.random.default_rng(9)
    b = torch.from_numpy(rng.integers(0, boxes.shape[1], (16, 16)))
    f = torch.from_numpy(rng.uniform(0.05, 0.95, (3, 16, 16)).astype(
        np.float32))
    o = boxes[0:3][:, b] + f * (boxes[3:6][:, b] - boxes[0:3][:, b])
    d = _unit(torch.from_numpy(rng.normal(size=(3, 16, 16)).astype(
        np.float32)))
    got, plain, _ = _culled(Rays(o.contiguous(), d), geometry)
    assert _same(got, plain)
    assert torch.isfinite(plain[0]).any()


def test_culled_closest_hit_small_and_empty_soups():
    """At most 16 triangles: tested as given up to the last active one (no
    blocks built); an empty soup: every ray misses."""
    cam = flagship_camera(24, 32, "cpu")
    rays = generate_rays(cam, 24, 32)
    flagship = flagship_scene("cpu").geometry
    small = build_geometry([random_soup(13, (2.57, 1.23, -1.35), 1.0,
                                        seed=2)], "cpu")
    for geometry in (flagship, small):
        got, plain, n = _culled(rays, geometry)
        assert _same(got, plain)
        assert torch.isfinite(plain[0]).any()
        assert geometry.zcount is None
        active = int(geometry.active.sum())
        assert (n["tri"] == active).all() and (n["box"] == 0).all()
    empty = replace(flagship, tri_cols=flagship.tri_cols[:, :0])
    got, plain, _ = _culled(rays, empty)
    assert _same(got, plain)
    assert (got[1] == -1).all() and torch.isinf(got[0]).all()


@pytest.mark.parametrize("order", [False, True, None])
def test_coincident_triangles_in_two_blocks_give_the_lower_index(order):
    """Triangle 3 copied to slot 37: every ray that hits it reports 3, in
    the input order (the two in blocks 0 and 2), the Morton order (side
    by side) and the kernel's."""
    sm = parity_soup(np.random.default_rng(4), 40)
    sm.triangles = sm.triangles.copy()
    sm.triangles[37] = sm.triangles[3]
    geometry = build_geometry([sm], "cpu")
    if order is False:
        index = trace.soup_blocks(geometry, order)[3].tolist()
        assert index.index(3) // trace.ZCOUNT_BLOCK != \
            index.index(37) // trace.ZCOUNT_BLOCK
    v0, e1, e2 = geometry.v0[3], geometry.e1[3], geometry.e2[3]
    rng = np.random.default_rng(5)
    ab = torch.from_numpy(rng.dirichlet((1, 1, 1), (8, 8)).astype(np.float32))
    p = v0 + ab[..., 1:2] * e1 + ab[..., 2:3] * e2  # [8, 8, 3]
    o = p - 3.0 * torch.nn.functional.normalize(torch.cross(e1, e2, dim=0),
                                                dim=0)
    rays = Rays(o.permute(2, 0, 1).contiguous(),
                _unit((p - o).permute(2, 0, 1).contiguous()))
    got, plain, _ = _culled(rays, geometry, order=order)
    assert _same(got, plain)
    assert (got[1] == 3).float().mean().item() > 0.3
    assert not (got[1] == 37).any()


def test_soup_blocks_index_maps_slots_to_input_triangles():
    """Each slot of the blocks holds its input triangle's columns; padding
    is -1 and inactive; zcount_blocks is soup_blocks without the index."""
    geometry = _torus_soup()
    cols, boxes, guard, index = trace.soup_blocks(geometry)
    live = index >= 0
    assert torch.equal(cols[:, live], geometry.tri_cols[:, index[live].long()])
    assert (cols[9, ~live] == 0).all()
    assert sorted(index[live].tolist()) == list(range(
        geometry.tri_cols.shape[1]))
    assert all(a is b for a, b in zip(trace.zcount_blocks(geometry),
                                      (cols, boxes, guard)))


def test_culled_closest_hit_matches_jax_pallas_on_the_torus_soup():
    """The port's culled closest hit of the one-torus soup against the
    Pallas kernel in interpret mode on the same rays (tri exact, t within
    rtol 1e-5, u, v within 1e-4, as test_torch_intersect.py)."""
    jgeo = jax_torus_field(1).geometry
    geometry = _torus_soup()
    o, d = random_rays(np.random.default_rng(12), 8, 64, half=2.0)
    t, tri, u, v = trace.closest_hit_culled(Rays(torch.from_numpy(o),
                                                 torch.from_numpy(d)),
                                            geometry)
    t_r, tri_r, u_r, v_r = pallas_closest(
        JaxRays(origin=jnp.asarray(o), direction=jnp.asarray(d)), jgeo,
        interpret=True)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(tri_r))
    assert 0.05 < (tri >= 0).float().mean().item()

    def finite(a):
        a = np.asarray(a)
        return np.where(np.isfinite(a), a, -1.0)

    np.testing.assert_allclose(finite(t.numpy()), finite(t_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_r), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_r), rtol=1e-4,
                               atol=1e-6)


@pytest.fixture(scope="module")
def fields():
    field = torus_field(2, "cpu").geometry
    return {b: with_bvh(field, builder=b) for b in ("sah", "median")}


@pytest.mark.parametrize("builder", ["sah", "median"])
def test_nearer_first_model_is_the_plain_walk(fields, builder):
    """bvh_closest_ordered gives bvh_closest's bits on the torus field's
    rays, uncapped and capped, and on rays from inside the field; it
    makes fewer box and triangle tests (two boxes a step) and walks no
    ray again here."""
    geometry = fields[builder]
    bvh = geometry.bvh
    rays = generate_rays(torus_field_camera(32, 48, "cpu"), 32, 48)
    rng = np.random.default_rng(17)
    o = torch.from_numpy(rng.uniform(-2.0, 2.0, (3, 16, 16)).astype(
        np.float32))
    o[1] = torch.from_numpy(rng.uniform(-0.5, 0.8, (16, 16)).astype(
        np.float32))
    inside = Rays(o, _unit(torch.from_numpy(rng.normal(size=(3, 16, 16))
                                            .astype(np.float32))))
    for r, cap in ((rays, None), (rays, torch.full((32, 48), 9.0)),
                   (inside, None)):
        n_o, n_p = {}, {}
        got = bvh_closest_ordered(r, geometry, bvh, cap, n_o)
        plain = bvh_closest(r, geometry, bvh, cap, n_p)
        assert _same(got, plain)
        assert torch.isfinite(plain[0]).any()
        assert not n_o["again"].any()
        assert n_o["tri"].sum() <= n_p["tri"].sum()
    assert n_o["box"].sum() < 2 * n_p["box"].sum()


@pytest.mark.parametrize("builder", ["sah", "median"])
def test_preorder_leaves_ascend(fields, builder):
    """In preorder the leaves come in ascending leaf_first and partition
    the triangles: the first hit in preorder is the lowest index."""
    bvh = fields[builder].bvh
    count = bvh.leaf_count.numpy()
    first = bvh.leaf_first.numpy()[count > 0]
    ends = first + count[count > 0]
    assert first[0] == 0 and (first[1:] == ends[:-1]).all()
    assert ends[-1] == int(fields[builder].active.sum())


@pytest.mark.parametrize("builder", ["sah", "median"])
def test_wide_record_holds_the_node_columns(fields, builder):
    """Row i of bvh.wide: the boxes of node i's children i + 1 and
    miss_link[i + 1], x | y | z as (lo, hi) left then right, and their
    references (an inner child's index, a leaf's negated word); a leaf's
    row is zero."""
    bvh = fields[builder].bvh
    wide = bvh.wide
    refs = wide.view(torch.int32)
    inner = (bvh.leaf_count == 0).nonzero().squeeze(1)
    left = inner + 1
    right = bvh.miss_link[left].long()
    lo = torch.stack([bvh.bmin_x, bvh.bmin_y, bvh.bmin_z])
    hi = torch.stack([bvh.bmax_x, bvh.bmax_y, bvh.bmax_z])
    for side, child in ((0, left), (2, right)):
        for axis in range(3):
            assert torch.equal(wide[inner, 4 * axis + side], lo[axis, child])
            assert torch.equal(wide[inner, 4 * axis + side + 1],
                               hi[axis, child])
        word = (bvh.leaf_first[child] << 5) | bvh.leaf_count[child]
        ref = torch.where(bvh.leaf_count[child] > 0, -word, child.int())
        assert torch.equal(refs[inner, 12 + side // 2], ref)
    assert (wide[bvh.leaf_count > 0] == 0).all()
    depth = {0: 1}
    for i, lft, rgt in zip(inner.tolist(), left.tolist(), right.tolist()):
        depth[lft] = depth[rgt] = depth[i] + 1
    assert bvh.depth == max(depth.values())


def test_wrappers_take_the_plain_versions_on_the_cpu(fields):
    """On CPU tensors kernel 18's and kernel 1's wrappers run the plain
    versions and count no launch."""
    geometry = fields["sah"]
    rays = generate_rays(torus_field_camera(8, 12, "cpu"), 8, 12)
    stats.launches.clear()
    assert _same(walk.closest_hit_bvh(rays, geometry),
                 bvh_closest(rays, geometry, geometry.bvh))
    soup = _torus_soup()
    assert _same(trace.closest_hit(rays, soup),
                 trace.closest_hit_plain(rays, soup))
    assert stats.launches == {}
    assert geometry.records is None and soup.zcount is None
