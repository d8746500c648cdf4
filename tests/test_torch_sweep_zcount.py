"""What lives in Python around the redesigned kernels 7 and 17, on the CPU:
kernel 7's block boxes (``ops.trace.zcount_blocks``) against the triangles
they hold and against the JAX package's ``_block_aabbs``; the plain model
of kernel 7's culled walk (``ops.trace.zcount_occ_culled``) against
``zcount_occ_plain`` (itself held to ``pallas_zcount_occ`` in
``test_torch_zcount.py``) on random, grazing, edge-on and edge-crossing
rays, masked and unmasked, in Morton and in input order, and the tests it
counts against the plain version's; and the refusals of the two wrappers
on the card (32-bit in-plane indices)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from romis_tpu.ops.pallas_trace import _block_aabbs, _tri_columns
from romis_tpu_torch.core.features import Features
from romis_tpu_torch.ops import mis, trace

from chip_smoke import hard_z_rays
from test_torch_zcount import _jax_soup, _port_geometry
from torch_parity import jax_torus_field

EPS = 1e-3  # ops/wrs.SHADOW_RAY_EPSILON
B = trace.ZCOUNT_BLOCK


def _jax_geometry(name):
    return _jax_soup(150, 5) if name == "soup" else \
        jax_torus_field(1).geometry


def _with_inactive(geometry, rng):
    """A copy of the soup with about a fifth of its triangles inactive,
    moved far outside the scene (they must not widen any box)."""
    cols = geometry.tri_cols.clone()
    off = torch.from_numpy(rng.uniform(size=cols.shape[1]) < 0.2)
    cols[0:3, off] = 50.0
    cols[9, off] = 0.0
    return replace(geometry, tri_cols=cols)


def _corners(cols):
    """[10, T] columns → the corners [3 (v0, v1, v2), 3, T]."""
    v0 = cols[0:3]
    return torch.stack([v0, v0 + cols[3:6], v0 + cols[6:9]])


@pytest.mark.parametrize("order", [True, False], ids=["morton", "input"])
@pytest.mark.parametrize("name", ["soup", "torus"])
def test_block_boxes_hold_their_triangles(name, order):
    rng = np.random.default_rng(11)
    geometry = _with_inactive(_port_geometry(_jax_geometry(name)), rng)
    src = geometry.tri_cols
    cols, boxes, nrm = trace.zcount_blocks(geometry, order)
    t = src.shape[1]
    assert cols.shape == (10, -(-t // B) * B) and boxes.shape == (
        13, cols.shape[1] // B) and nrm.shape == (5, cols.shape[1])
    # The guard's normals: finite on active triangles, inf elsewhere.
    assert torch.isfinite(nrm[:3, cols[9] > 0.0]).all()
    assert torch.isinf(nrm[:3, cols[9] <= 0.0]).all()
    # The same triangles, each once; padding is inactive.
    act_src = src[:, src[9] > 0.0]
    act = cols[:, cols[9] > 0.0]
    assert act.shape == act_src.shape
    key = lambda c: sorted(map(tuple, c.T.tolist()))  # noqa: E731
    assert key(act) == key(act_src)
    assert int((cols[9, t:] > 0.0).sum()) == 0
    corners = _corners(cols)
    big = corners[:, :, cols[9] > 0.0].abs().max()
    for b in range(boxes.shape[1]):
        live = cols[9, b * B:(b + 1) * B] > 0.0
        lo, hi = boxes[:3, b], boxes[3:6, b]
        assert boxes[11, b] == (live.nonzero().max() + 1 if live.any() else 0)
        if not live.any():  # a block that no window reaches
            assert torch.all(lo == 1e30) and torch.all(hi == 1e30)
            continue
        c = corners[:, :, b * B:(b + 1) * B][:, :, live]  # [3, 3, n]
        c_lo, c_hi = c.amin(dim=(0, 2)), c.amax(dim=(0, 2))
        grow = 1e-4 + 1e-5 * big + trace.ZCOUNT_GROW * (c_hi - c_lo).max()
        # Every active corner strictly inside, by at least the fixed part
        # of the growth; inactive triangles widen nothing.
        assert torch.all(lo <= c_lo - 0.999e-4) and torch.all(
            hi >= c_hi + 0.999e-4)
        assert torch.all(lo >= c_lo - grow * 1.001) and torch.all(
            hi <= c_hi + grow * 1.001)


@pytest.mark.parametrize("name", ["soup", "torus"])
def test_block_boxes_contain_jax_block_aabbs(name):
    """In the input order the blocks are the JAX kernel's TRI_UNROLL blocks;
    each box holds the reference's ε-inflated box."""
    jg = _jax_geometry(name)
    expect = np.asarray(_block_aabbs(jg, _tri_columns(jg)))
    got = trace.zcount_blocks(_port_geometry(jg), order=False)[1].numpy()
    live = expect[0] < 1e29
    assert got.shape[1] == expect.shape[1] and live.any()
    assert np.all(got[:3, live] <= expect[:3, live])
    assert np.all(got[3:6, live] >= expect[3:, live])


def _rays(rng, kind, geometry, r1=3, k=2, h=6, w=16):
    """``chip_smoke.hard_z_rays`` (random, grazing, edge-on and
    edge-crossing rays) on the geometry's columns, as tensors."""
    o, t = hard_z_rays(rng, kind, geometry.tri_cols.numpy(), r1, k, h, w)
    return torch.from_numpy(o), torch.from_numpy(t)


@pytest.mark.parametrize("lazy", [False, True, None],
                         ids=["eager", "lazy", "flagged"])
@pytest.mark.parametrize("order", [True, False, None],
                         ids=["morton", "input", "chosen"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("kind", ["random", "grazing", "edge_on", "edge"])
@pytest.mark.parametrize("name", ["soup", "torus"])
def test_culled_model_gives_the_plain_bool(name, kind, masked, order, lazy):
    seed = ["random", "grazing", "edge_on", "edge"].index(kind)
    rng = np.random.default_rng(40 + seed + 10 * (name == "torus"))
    geometry = _port_geometry(_jax_geometry(name))
    o, t = _rays(rng, kind, geometry)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(o.shape[0], t.shape[0])
                                            + tuple(o.shape[-2:])) > 0.3)
    expect = trace.zcount_occ_plain(o, t, geometry, EPS, mask)
    got = trace.zcount_occ_culled(o, t, geometry, EPS, mask, order=order,
                                  lazy=lazy)
    assert got.dtype == torch.bool and torch.equal(got, expect)
    if kind == "random":
        assert 0.05 < expect.float().mean() < 0.95


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("order", [True, False], ids=["morton", "input"])
@pytest.mark.parametrize("name", ["soup", "torus"])
def test_culled_counts_at_most_plain(name, order, lazy):
    """The culled walk tests fewer triangles than the plain scan: in the
    input order on every ray (it tests a subset of the same prefix), in
    Morton order in total; each ray tests at most every box (twice with
    the lazy guard); an origin's set-ups lie between its rays' largest and
    summed triangle tests."""
    rng = np.random.default_rng(7)
    geometry = _port_geometry(_jax_geometry(name))
    o, t = _rays(rng, "random", geometry, h=8, w=24)
    cnt, pc = {}, {}
    occ = trace.zcount_occ_culled(o, t, geometry, EPS, None, cnt, order,
                                  lazy)
    trace.zcount_occ_plain(o, t, geometry, EPS, None, counts=pc)
    tri, plain = cnt["tri"], pc["tests"]
    assert occ.any() and (~occ).any()
    if order:
        assert tri.sum() < plain.sum()
    else:
        assert torch.all(tri <= plain)
    unoccluded = ~occ & (plain > 0)
    assert torch.all(tri[unoccluded] <= plain[unoccluded])
    n_blocks = trace.zcount_blocks(geometry, order)[1].shape[1]
    assert torch.all(cnt["box"] <= (2 if lazy else 1) * n_blocks)
    assert torch.all(cnt["guard"] <= cnt["box"])
    assert torch.all(cnt["box"][plain == 0] == 0)
    assert torch.all(cnt["origin"] >= tri.amax(dim=1))
    assert torch.all(cnt["origin"] <= tri.sum(dim=1))


class _OnTheCard:
    """A stand-in tensor on the card of 46341 x 46341 pixels: the wrappers
    read its shape before they touch its data."""

    is_cuda = True

    def __init__(self, *lead):
        self.shape = tuple(lead) + (46341, 46341)


def test_wrappers_refuse_64bit_pixel_counts():
    """Kernels 7 and 17 index a plane with 32 bits: 46341² ≥ 2^31 pixels
    raise before any launch."""
    soup = _port_geometry(_jax_soup(16, 1))
    with pytest.raises(ValueError, match="32-bit"):
        mis.mis_iteration(_OnTheCard(18), _OnTheCard(16), _OnTheCard(10),
                          soup, 2, "romis", 1, Features(), nbr_ctx=object())
    with pytest.raises(ValueError, match="32-bit"):
        trace.zcount_occ(_OnTheCard(6, 3), _OnTheCard(2, 3), soup)


@pytest.mark.parametrize("name", ["soup", "torus"])
def test_zcount_blocks_kept_per_soup(name):
    """The default order is the one whose boxes have the smaller summed
    area; its blocks are kept on the geometry with the columns tensor they
    came from, and rebuilt after the tensor is written to or replaced."""
    geometry = _port_geometry(_jax_geometry(name))
    geometry = replace(geometry, tri_cols=geometry.tri_cols.clone())
    got = trace.zcount_blocks(geometry)
    areas = [trace._box_area(trace.zcount_blocks(geometry, o)[1])
             for o in (True, False)]
    assert trace._box_area(got[1]) == min(areas)
    assert geometry.zcount[0] is geometry.tri_cols and geometry.zcount[2] \
        is got
    assert all(a is b for a, b in zip(trace.zcount_blocks(geometry), got))
    assert all(torch.equal(a, b) for a, b in zip(
        trace.build_zcount_blocks(geometry.tri_cols), got))
    geometry.tri_cols[0:3] += 1.0
    moved = trace.zcount_blocks(geometry)
    fresh = trace.zcount_blocks(replace(geometry,
                                        tri_cols=geometry.tri_cols.clone()))
    assert moved[0] is not got[0]
    assert all(torch.equal(a, b) for a, b in zip(moved, fresh))
    assert not torch.equal(moved[1], got[1])


def test_zcount_blocks_build_outside_autograd():
    """Columns that carry a graph (a gradient step repacks them from the
    parameters) give blocks without one: the geometry keeps no graph."""
    geometry = _port_geometry(_jax_geometry("torus"))
    v0 = geometry.v0.clone().requires_grad_(True)
    geometry = replace(geometry, tri_cols=torch.cat(
        [v0.t(), geometry.tri_cols[3:]]))
    assert geometry.tri_cols.requires_grad
    got = trace.zcount_blocks(geometry)
    assert not any(a.requires_grad or a.grad_fn is not None for a in got)
    plain = trace.zcount_blocks(replace(
        geometry, tri_cols=geometry.tri_cols.detach()))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("name", ["soup", "torus"])
def test_box_alone_is_wrong_on_edge_on_rays(name):
    """The near-parallel guard is what keeps the cull exact: with the box
    alone deciding (``guard=False``) the walk loses hits on edge-on rays
    that the plain test's rounding accepts; with the guard it does not."""
    geometry = _port_geometry(_jax_geometry(name))
    wrong = 0
    for seed in range(3):
        o, t = _rays(np.random.default_rng(100 + seed), "edge_on", geometry,
                     h=32, w=32)
        expect = trace.zcount_occ_plain(o, t, geometry, EPS)
        assert torch.equal(trace.zcount_occ_culled(o, t, geometry, EPS),
                           expect)
        wrong += int((trace.zcount_occ_culled(o, t, geometry, EPS,
                                              guard=False) != expect).sum())
    assert wrong > 0
