"""What lives in Python around the redesigned kernels 6 (the soup any-hit,
``ops.trace.any_hit``) and 8 (the Plücker any-hit,
``ops.trace.any_hit_plucker``), on the CPU.

Both walk the soup culled by the blocks of ``soup_blocks`` with the walk
kernel 4 shares (``csrc/cull.cuh``'s ``soup_any``). Kernel 8's plain model,
``ops.trace.any_hit_plucker_culled`` (its own near-parallel guard, whose
reach its docstring derives from the Plücker test's world-frame rounding),
gives ``any_hit_plucker_plain``'s bool on every segment: random segments
in the soup's box on the one-torus soup, a random 96-triangle soup and a
2048-triangle soup; ``chip_smoke.hard_z_rays``' grazing, edge-on and
edge-crossing segments on the first two; small triangles moved 100 and
1000 units from the origin, where the Plücker error lives (the box alone
then misses hits the guard keeps); an empty soup and a one-block soup;
negative windows. Kernel 6's model, ``any_hit_culled``, gives
``any_hit_plain``'s bool on a leading sample axis, on the moved soup and
on directions of any length. Kernel 8's kept table is ``plucker_matrix``'s
rows permuted into the blocks' order, bit for bit, its slots hold the same
floats, and it is rebuilt when the columns are written to. The culled
Plücker model is within ``test_torch_plucker.MISMATCH`` of the JAX
package's ``pallas_any_mxu`` in interpret mode. On CPU tensors both
wrappers run their plain versions and launch nothing."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romis_tpu.ops.pallas_trace import pallas_any_mxu
from romis_tpu_torch.ops import trace
from romis_tpu_torch.scene.scene import build_geometry, flagship_scene
from romis_tpu_torch.utils import stats

from chip_smoke import (
    HARD_RAY_KINDS, box_segments, hard_z_rays, moved_soup, random_soup,
    seg_rays,
)
from test_torch_plucker import MISMATCH, _geometries

S, H, W = 2, 8, 64


def _soup(name):
    """The port's geometry of the named soup (CPU)."""
    if name == "torus":
        return _geometries("torus")[1]
    if name == "soup96":
        return _geometries("soup")[1]
    if name == "soup2048":
        return build_geometry([random_soup(2048, (0.0, 0.0, 0.0), 3.0,
                                           seed=7)], "cpu")
    # "moved_100": small triangles far from the origin
    return build_geometry([moved_soup(float(name.split("_")[1]))], "cpu")


def _segments(geometry, seed, pad=0.3, shape=(S, H, W)):
    """Segments between random points of the soup's box (grown by pad):
    origins [S, 3, H, W], unit directions, t_max [S, H, W]."""
    return box_segments(torch, geometry, np.random.default_rng(seed),
                        *shape, pad)


def _hard(geometry, kind, seed):
    """``hard_z_rays``' segments from one origin to two targets."""
    return seg_rays(torch, *(torch.from_numpy(a) for a in hard_z_rays(
        np.random.default_rng(seed), kind, geometry.tri_cols.numpy(), 1, 2,
        H, W)))


def _check_plucker(rays, geometry):
    """The culled model against the plain version, with and without the
    counts; its counts' bounds → (counts, box-alone counts, bool)."""
    expect = trace.any_hit_plucker_plain(*rays, geometry)
    cnt, cnt_box = {}, {}
    assert torch.equal(trace.any_hit_plucker_culled(*rays, geometry), expect)
    got = trace.any_hit_plucker_culled(*rays, geometry, cnt)
    assert got.dtype == torch.bool and torch.equal(got, expect)
    trace.any_hit_plucker_culled(*rays, geometry, cnt_box, guard=False)
    n_t = geometry.tri_cols.shape[1]
    if n_t > trace.ZCOUNT_BLOCK:
        nb = trace.zcount_blocks(geometry)[1].shape[1]
        # every block's guard deferred: at most two box tests a block
        assert torch.all(cnt["box"] <= 2 * nb)
        assert torch.all(cnt["guard"] <= cnt["box"])
        # the pairs tried at most twice a guarded block: at the box
        # rule's reach, then at the line rule's
        assert torch.all(cnt["guard_tri"]
                         <= cnt["guard"] * 2 * trace.ZCOUNT_BLOCK)
        assert int(cnt_box["guard"].sum()) == 0
    assert torch.all(cnt["tri"][expect] >= 1)
    return cnt, cnt_box, expect


@pytest.mark.parametrize("name", ["torus", "soup96", "soup2048"])
def test_culled_plucker_gives_the_plain_bool(name):
    """Random segments in the soup's box: the plain bool on every one, and
    the box alone tests fewer triangles than the plain scan."""
    geometry = _soup(name)
    rays = _segments(geometry, 3 + len(name))
    cnt, cnt_box, expect = _check_plucker(rays, geometry)
    assert 0.05 < expect.float().mean() < 0.95
    full = {}
    trace.any_hit_plucker_plain(*rays, geometry, full)
    assert cnt_box["tri"].sum() < full["tests"].sum()


@pytest.mark.parametrize("kind", HARD_RAY_KINDS)
@pytest.mark.parametrize("name", ["torus", "soup96"])
def test_culled_plucker_on_hard_segments(name, kind):
    """Segments grazing, edge-on to and crossing the edges of the soup's
    triangles (and random ones), ends 0 to 1e-3 off the planes."""
    geometry = _soup(name)
    seed = 20 + HARD_RAY_KINDS.index(kind) + 10 * (name == "torus")
    _check_plucker(_hard(geometry, kind, seed), geometry)


@pytest.mark.parametrize("off", [100, 1000])
def test_culled_plucker_far_from_the_origin(off):
    """Small triangles (~0.04 across) 100 and 1000 units out, where the
    sides' rounding reaches far beyond the boxes' growth: the guard keeps
    the plain bool on every segment, where the box alone misses hits."""
    geometry = _soup(f"moved_{off}")
    rays = _segments(geometry, 40 + off, pad=0.05, shape=(S, 16, 64))
    _, _, expect = _check_plucker(rays, geometry)
    box_alone = trace.any_hit_plucker_culled(*rays, geometry, guard=False)
    assert (box_alone != expect).any()
    assert torch.equal(trace.any_hit_culled(*rays, geometry),
                       trace.any_hit_plain(*rays, geometry))


def test_culled_plucker_on_an_empty_and_a_one_block_soup():
    """An empty soup hits nothing and counts no test; the flagship's 2
    triangles (one block) are tested as given, with no blocks built."""
    scene = flagship_scene("cpu")
    empty = dataclasses.replace(
        scene.geometry, tri_cols=scene.geometry.tri_cols[:, :0].contiguous(),
        zcount=None, plucker=None)
    rays = _segments(scene.geometry, 9)
    cnt = {}
    assert not trace.any_hit_plucker_culled(*rays, empty, cnt).any()
    assert all(int(v.sum()) == 0 for v in cnt.values())
    geometry = dataclasses.replace(scene.geometry, zcount=None, plucker=None)
    cnt, _, expect = _check_plucker(rays, geometry)
    assert expect.any() and (~expect).any()
    assert int(cnt["box"].sum()) == 0
    assert geometry.zcount is None and geometry.plucker[2][2] is None


def test_culled_plucker_on_negative_windows():
    """A negative t_max is the segment p0 + t·d, t in [t_max, 0]: the plain
    version reads it so, and the model walks (−d, −t_max)."""
    geometry = _soup("torus")
    o, d, tm = _segments(geometry, 12)
    neg = torch.from_numpy(np.random.default_rng(4).uniform(size=tm.shape)
                           < 0.5)
    tm = torch.where(neg, -tm, tm)
    tm[0, 0, :4] = 0.0
    _, _, expect = _check_plucker((o, d, tm), geometry)
    assert expect[neg].any() and not expect[0, 0, :4].any()


@pytest.mark.parametrize("name", ["torus", "soup96"])
def test_kept_table_is_a_row_permutation(name):
    """The kept table: row k·T' + j is ``plucker_matrix``'s row k·T +
    index[j] (zero on padding), bit for bit; its slots hold each row's
    ``PLUCKER_COLS``; kept with the columns and rebuilt after a write."""
    geometry = dataclasses.replace(_soup(name), zcount=None, plucker=None)
    table, slots, boxes, guard, blocks = trace.plucker_blocks(geometry)
    index = trace.soup_blocks(geometry)[3].long()
    full = trace.plucker_matrix(geometry).reshape(5, -1, 16)
    got = table.reshape(5, -1, 16)
    real = index >= 0
    assert torch.equal(got[:, real], full[:, index[real]])
    assert not got[:, ~real].any()
    assert real.sum() == geometry.tri_cols.shape[1]
    for k, j, slot in trace._SLOT_OF:
        assert torch.equal(slots[:, slot], got[k, :, j])
    assert slots.shape == (table.shape[0] // 5, trace.PLUCKER_SLOTS)
    assert guard.shape == (5, slots.shape[0])
    assert blocks.shape == (2, boxes.shape[1])
    assert trace.plucker_blocks(geometry)[0] is table  # kept
    geometry.tri_cols[0, 0] += 0.25  # written to: rebuilt
    again = trace.plucker_blocks(geometry)[0]
    assert again is not table
    assert not torch.equal(again, table)


@pytest.mark.parametrize("name", ["soup96", "torus"])
def test_culled_plucker_matches_pallas_mxu(name):
    """Against the JAX package's ``pallas_any_mxu`` in interpret mode,
    within ``test_torch_plucker``'s budget (the reference sums its
    product in XLA's order)."""
    jg, geometry = _geometries(name)
    rng = np.random.default_rng(5)
    o = rng.uniform(-1.5, 1.5, (S, 3, H, W)).astype(np.float32)
    d = rng.normal(size=(S, 3, H, W))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(0.3, 3.0, (S, H, W)).astype(np.float32)
    got = trace.any_hit_plucker_culled(*(torch.from_numpy(a) for a in
                                         (o, d, tm)), geometry).numpy()
    expect = np.asarray(pallas_any_mxu(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(tm), jg, interpret=True))
    assert (got != expect).mean() <= MISMATCH
    assert 0.05 < got.mean() < 0.95


def test_culled_mt_on_a_leading_axis_and_any_length():
    """``any_hit_culled`` (kernel 6's walk) on 3 sample planes with the
    directions broadcast from one plane, and on directions scaled by
    factors from 1e-3 to 1e3 with the windows scaled back: the plain
    any-hit's bool on every segment."""
    geometry = _soup("torus")
    o, d, tm = _segments(geometry, 15, shape=(3, H, W))
    got = trace.any_hit_culled(o, d[0], tm, geometry)
    assert got.shape == (3, H, W)
    assert torch.equal(got, trace.any_hit_plain(o, d[0], tm, geometry))
    scale = torch.from_numpy(10.0 ** np.random.default_rng(2).uniform(
        -3, 3, tm.shape).astype(np.float32))
    ds, ts = d * scale[:, None], tm / scale
    expect = trace.any_hit_plain(o, ds, ts, geometry)
    assert torch.equal(trace.any_hit_culled(o, ds, ts, geometry), expect)
    assert 0.05 < expect.float().mean() < 0.95


def test_wrappers_run_their_plain_versions_on_cpu():
    """CPU tensors: ``any_hit`` and ``any_hit_plucker`` return their plain
    versions' bools and launch nothing."""
    geometry = _soup("torus")
    rays = _segments(geometry, 17)
    stats.launches.clear()
    assert torch.equal(trace.any_hit(*rays, geometry),
                       trace.any_hit_plain(*rays, geometry))
    assert torch.equal(trace.any_hit_plucker(*rays, geometry),
                       trace.any_hit_plucker_plain(*rays, geometry))
    assert stats.launches == {}
