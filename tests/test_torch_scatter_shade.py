"""The plain versions and the Python around the redesigned kernels 13 (the
row scatter-add, ``ops.scatter.scatter_rows_add``) and 21 (the BVH final
shade, ``ops.shade.final_shade_bvh``).

Kernel 13's plain version is held to a float64 ``np.add.at`` on the
gradient steps' table shapes: the torus field's 24,202 triangle rows at
C = 9 and 24 (beyond the JAX kernel's 2048-row cap), the 1-row and 2-row
contention cases, K lanes of 512 and of 3 light rows. A numpy model of the
kernel's partition (tiles dealt to persistent blocks, a warp's columns,
up to HELD rows held in registers, the direct adds, one flush a block;
and the device path's warp runs) counts every index once in every column
and gives the float64 sum; the pre-pass's tags leave the owners on
distinct rows; ``scatter_tile`` and ``warp_cols`` pick what the kernel's
shared memory and registers hold.

Kernel 21's mapping: a thread per (pixel, lane), a pixel's lanes side by
side in one warp (idle threads where 32 is not a multiple of K), each
lane's occlusion from ``ops.traverse.bvh_any`` on its own ray, its term
and the pixel's lane-order sum give ``final_shade_plain``'s bits on a
small torus field at K = 1 to 4, shaded and unshaded. On CPU tensors both
wrappers run their plain versions and launch nothing."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from romis_tpu.ops.pallas_scatter import MAX_SCATTER_ROWS
from romis_tpu_torch import Features
from romis_tpu_torch.core.camera import generate_rays, make_camera
from romis_tpu_torch.core.vec import e, vnorm
from romis_tpu_torch.ops import scatter, shade
from romis_tpu_torch.ops.bvh import with_bvh
from romis_tpu_torch.ops.shading import phong_shade
from romis_tpu_torch.ops.traverse import bvh_any
from romis_tpu_torch.ops.wrs import (
    SHADOW_RAY_EPSILON, gen_canonical_samples_plain,
)
from romis_tpu_torch.render import restir
from romis_tpu_torch.scene.scene import torus_field

TORUS_ROWS = 24202  # the 5x5 torus field's triangles (chip_smoke.LARGE_TRIS)
HELD = scatter.HELD  # csrc/scatter.cu kHeld


def _add_at64(ct, idx, n_rows):
    c = ct.shape[0]
    out = np.zeros((n_rows, c))
    np.add.at(out, np.clip(idx, 0, n_rows - 1).ravel(),
              ct.reshape(c, -1).T.astype(np.float64))
    return out


def _indices(rng, kind, shape, n_rows):
    """int32 indices of one kind: ``random`` (uniform over the rows),
    ``runs`` (an image's coherent runs of a row, 1 to 200 long, with some
    out of range to clamp), ``one`` (every index on row 0) or ``two``
    (rows 0 and 1 in runs, as two triangles of a quad)."""
    n = int(np.prod(shape))
    if kind == "random":
        idx = rng.integers(0, n_rows, n)
    elif kind == "one":
        idx = np.zeros(n, np.int64)
    else:
        lengths = rng.integers(1, 200, n)
        rows = (rng.integers(0, 2, n) if kind == "two"
                else rng.integers(-3, n_rows + 3, n))
        idx = np.repeat(rows, lengths)[:n]
    return idx.reshape(shape).astype(np.int32)


SHAPES = {  # (C, leading axes, rows, index kind)
    "torus triangles C=9": (9, (), TORUS_ROWS, "runs"),
    "torus triangles C=24": (24, (), TORUS_ROWS, "runs"),
    "material, 1 row": (8, (), 1, "one"),
    "triangles, 2 rows": (9, (), 2, "two"),
    "attributes, 2 rows": (24, (), 2, "two"),
    "lights, K=2 lanes of 512 rows": (24, (2,), 512, "random"),
    "torus lights, 3 rows": (24, (2,), 3, "random"),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_scatter_plain_matches_float64_sum(case):
    """The plain version (``index_add_``) on the steps' table shapes: each
    (row, component) within 1e-5 of the float64 sum relative to the sum of
    |contributions| there (float32 terms added in another order)."""
    c, lead, n_rows, kind = SHAPES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    h, w = 40, 64
    idx = _indices(rng, kind, lead + (h, w), n_rows)
    ct = rng.normal(size=(c,) + lead + (h, w)).astype(np.float32)
    got = scatter.scatter_rows_add_plain(torch.from_numpy(ct),
                                         torch.from_numpy(idx), n_rows)
    assert got.shape == (n_rows, c) and got.dtype == torch.float32
    mag = np.maximum(_add_at64(np.abs(ct), idx, n_rows), 1e-30)
    err = np.abs(got.numpy() - _add_at64(ct, idx, n_rows)) / mag
    assert err.max() <= 1e-5
    if n_rows == TORUS_ROWS:  # beyond the TPU kernel's one-hot table
        assert n_rows > MAX_SCATTER_ROWS


def test_scatter_tile_fits_the_tables():
    """The tiled path for the steps' tables (the flagship's and the torus
    field's lights, materials and triangle rows, the 2048-triangle soup's),
    the device-memory path (tile 0) for the torus field's 24,202 triangle
    rows; a table takes the tiled path exactly when its shared memory (the
    table, two tiles of indices, a record of HELD + 1 ints a group, TAGS
    ints a warp) fits in a block's."""
    for c, rows in ((24, 512), (8, 1), (9, 8), (24, 8), (9, 2048), (24, 3),
                    (8, 26)):
        assert scatter.scatter_tile(c, rows) == scatter.TILE
    for c in (9, 24):
        assert scatter.scatter_tile(c, TORUS_ROWS) == 0
    for c, rows in ((24, 512), (8, 1), (9, 2048), (9, 4000), (9, 6000),
                    (33, 1000), (33, 1200)):
        smem = scatter.scatter_smem(c, rows)
        warps = min(max(-(-c // scatter.warp_cols(c, rows)), 4), 32)
        assert smem == 4 * (-(-rows * (c | 1) // 4) * 4 + 2 * scatter.TILE
                            + (HELD + 1) * scatter.TILE // 32
                            + scatter.TAGS * warps)
        assert (scatter.scatter_tile(c, rows) > 0) == (
            smem <= scatter.SMEM_BYTES)
    assert scatter.TILE % (32 * 8) == 0  # whole batches of groups
    assert [scatter.warp_cols(c, 512) for c in (8, 9, 15, 16, 24, 40)] == [
        1, 1, 1, 2, 2, 2]
    assert [scatter.warp_cols(c, r) for c, r in ((24, 3), (24, 8), (24, 64),
                                                 (9, 3))] == [3, 3, 3, 1]


def _tiled_model(ct, idx, n_rows, tile, blocks):
    """Kernel 13's tiled path in float64: tile t to block t mod ``blocks``;
    per tile each index's clamped row and each group of 32 classed by its
    distinct rows (few: at most HELD); each column summed group by group
    (a warp's columns share their held rows, which depend on the groups
    alone): a lane whose row is held adds to that row's register; where
    some lane's is not, a few-row group flushes the held rows into the
    block's table and holds its own, a many-row group adds those lanes'
    values straight into the table; one flush of each block's table. →
    (sum, uses: how often each (column, index) was added)."""
    c_n = ct.shape[0]
    vals = ct.reshape(c_n, -1).astype(np.float64)
    flat = idx.ravel()
    n = flat.size
    out = np.zeros((n_rows, c_n))
    uses = np.zeros((c_n, n), np.int64)
    n_tiles = -(-n // tile)
    for b in range(min(blocks, n_tiles)):
        tab = np.zeros((n_rows, c_n))
        for t in range(b, n_tiles, blocks):
            p = t * tile + np.arange(tile)
            live = p < n
            rows = np.where(live, np.clip(flat[np.minimum(p, n - 1)], 0,
                                          n_rows - 1), -1)
            for c in range(c_n):
                acc = {}  # held row -> the lanes' partial sums

                def flush():
                    for r, a in acc.items():
                        if r >= 0:
                            tab[r, c] += a.sum()
                    acc.clear()

                for g in range(0, tile, 32):
                    r_g, p_g, l_g = rows[g:g + 32], p[g:g + 32], \
                        live[g:g + 32]
                    x = np.where(l_g, vals[c, np.minimum(p_g, n - 1)],
                                 0.0)
                    hit = np.isin(r_g, list(acc))
                    for r in acc:
                        acc[r] = acc[r] + np.where(r_g == r, x, 0.0)
                    added = hit.copy()
                    if not hit.all():
                        distinct = list(dict.fromkeys(r_g.tolist()))
                        if len(distinct) <= HELD:
                            flush()
                            for r in distinct:
                                acc[r] = np.where((r_g == r) & ~hit, x,
                                                  0.0)
                            added |= ~hit
                        else:
                            for lane in np.flatnonzero(~hit & (r_g >= 0)):
                                tab[r_g[lane], c] += x[lane]
                                added[lane] = True
                    np.add.at(uses[c], p_g[l_g & added], 1)
                flush()
        out += tab  # the block's one flush (device atomics)
    return out, uses


RUN = 16 * 32  # csrc/scatter.cu kRunGroups groups of 32: a warp's run


@pytest.mark.parametrize("path", ["tiled", "device"])
@pytest.mark.parametrize("kind,n_rows", [
    ("random", 512), ("random", 3), ("one", 1), ("two", 2), ("runs", 300)])
def test_partition_counts_every_index_once(kind, n_rows, path):
    """The model of kernel 13's partition at a small tile and few blocks
    (``tiled``: many tiles a block, a ragged last tile) and as the device
    path takes it (each warp's run of 16 groups alone, its held rows
    flushed into device memory: the same model with one run a block), with
    clamped indices where the kind has them: every index is added once in
    every column, and the sum is the float64 sum."""
    rng = np.random.default_rng(n_rows)
    c_n, shape = 5, (2, 23, 61)  # 2806 indices
    idx = _indices(rng, kind, shape, n_rows)
    ct = rng.normal(size=(c_n,) + shape).astype(np.float32)
    if path == "tiled":
        out, uses = _tiled_model(ct, idx, n_rows, tile=256, blocks=3)
    else:
        out, uses = _tiled_model(ct, idx, n_rows, tile=RUN,
                                 blocks=-(-idx.size // RUN))
    assert (uses == 1).all()
    np.testing.assert_allclose(out, _add_at64(ct, idx, n_rows), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("kind,n_rows", [
    ("random", 512), ("random", 40), ("random", 8), ("collide", 3000)])
def test_tag_owners_have_distinct_rows(kind, n_rows):
    """Kernel 13's tiled pre-pass on a group of more than HELD rows: each
    lane writes its id to tag r mod TAGS of its warp, one write a tag
    lands (any one: drawn at random here), and a lane owns its row if it
    reads back its own id. The owners' rows are distinct, so their plain
    read-modify-writes (one instruction) hit distinct addresses; every
    other lane adds with an atomic after them, and each value is added
    once. ``collide``: rows TAGS apart, which share a tag."""
    rng = np.random.default_rng(n_rows)
    if kind == "collide":
        idx = (rng.integers(0, 6, (300, 32)) * scatter.TAGS
               + rng.integers(0, 3, (300, 32))).astype(np.int32)
    else:
        idx = _indices(rng, kind, (300, 32), n_rows)
    many = 0
    for r in idx:
        if len(set(r.tolist())) <= HELD:
            continue
        many += 1
        tag = {}
        for lane in rng.permutation(32):  # the write that lands last wins
            tag[r[lane] % scatter.TAGS] = lane
        owner = np.array([tag[r[lane] % scatter.TAGS] == lane
                          for lane in range(32)])
        assert len(set(r[owner].tolist())) == owner.sum() > 0
        x = rng.normal(size=32)
        table = np.zeros(n_rows)
        table[r[owner]] += x[owner]             # the owners' plain adds
        np.add.at(table, r[~owner], x[~owner])  # then the atomics
        np.testing.assert_allclose(table, np.bincount(
            r, weights=x, minlength=n_rows), rtol=0, atol=1e-12)
    assert many > 50


def test_scatter_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(4)
    ct = torch.from_numpy(rng.normal(size=(9, 2, 7, 11)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, 40, (2, 7, 11)).astype(np.int32))
    scatter.scatter_rows_add.launches = 0
    assert torch.equal(scatter.scatter_rows_add(ct, idx, 37),
                       scatter.scatter_rows_add_plain(ct, idx, 37))
    assert scatter.scatter_rows_add.launches == 0


@pytest.fixture(scope="module")
def field():
    """The port's 2x2 torus field with its BVH, the receivers of a 20x28
    frame seen from above the tori."""
    scene = torus_field(2, "cpu")
    scene = replace(scene, geometry=with_bvh(scene.geometry))
    cam = make_camera(look_at=(0.0, -0.3, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                      distance=6.0, fov_deg=50.0, resolution=(20, 28),
                      device="cpu")
    _, ctx = restir.trace_primary(generate_rays(cam, 20, 28), scene.geometry,
                                  Features(), restir.PLAIN)
    return scene, ctx


def _threads(k: int, n_pix: int):
    """Kernel 21's threads → (pixel, lane), -1 for an idle thread: thread
    slot * K + lane of warp v shades lane ``lane`` of pixel v * (32 // K) +
    slot."""
    per_warp = 32 // k
    n_warps = -(-n_pix // per_warp)
    wl = np.arange(32)
    slot, lane = wl // k, wl % k
    pix = np.arange(n_warps)[:, None] * per_warp + slot[None, :]
    ok = (slot[None, :] < per_warp) & (pix < n_pix)
    return (np.where(ok, pix, -1), np.where(ok, lane[None, :], -1))


@pytest.mark.parametrize("unshaded", [False, True], ids=["shaded", "unshaded"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bvh_shade_mapping_gives_the_plain_bits(field, k, unshaded):
    """A thread per (pixel, lane) covering each pair once, no pixel's lanes
    in two warps; each lane's occlusion from ``bvh_any`` on its own ray
    (traced only if live), its term (lit ? Phong : 0) x W, and the pixel's
    first thread summing the K terms in lane order from 0 and dividing by
    K give ``final_shade_plain``'s bits."""
    scene, ctx = field
    geo = scene.geometry
    feats = Features(num_samples_in_reservoir=k,
                     enable_shading=not unshaded)
    gen = torch.Generator().manual_seed(k)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=gen)
    h, w = ctx.valid.shape
    n_pix = h * w
    pix, lane = _threads(k, n_pix)
    live = pix >= 0
    pairs = pix[live] * k + lane[live]
    assert np.array_equal(np.sort(pairs), np.arange(n_pix * k))
    assert (pix == -1).sum() == pix.shape[0] * (32 % k) + (
        pix.shape[0] * (32 // k) - n_pix) * k
    for v in range(pix.shape[0]):  # a pixel's lanes stay in its warp
        row = pix[v][pix[v] >= 0]
        assert all((row == q).sum() == k for q in np.unique(row))

    # Each lane's shadow ray as ops.wrs.visibility builds it, traced alone
    # where it is live (the kernel's dead-lane test).
    to = res.pos - ctx.position
    dist = vnorm(to)
    d = to / e(torch.clamp_min(dist, 1e-20))
    origin = ctx.position + SHADOW_RAY_EPSILON * d
    t_max = vnorm(res.pos - origin)
    lmax = e(torch.clamp_min(torch.sqrt(torch.clamp_min(
        (to * to).sum(dim=-3), 1e-24)), 1e-20))
    dot_nl = (ctx.normal * (to / lmax)).sum(dim=-3)
    pending = ((unshaded | (ctx.valid & (dot_nl >= 0.0)))
               & (res.big_w != 0.0) & (dist > SHADOW_RAY_EPSILON))
    occluded = torch.zeros_like(pending)
    for i in range(k):
        occluded[i] = pending[i] & bvh_any(origin[i], d[i], t_max[i], geo,
                                           geo.bvh)
    shade_k = phong_shade(ctx, res.pos, res.color, feats)  # [K, 3, H, W]
    term = (torch.where(e(~occluded), shade_k, 0.0)
            * e(res.big_w)).reshape(k, 3, -1)
    # Thread (pixel, lane) holds term[lane, :, pixel]; the pixel's first
    # thread adds its K lanes' terms in order.
    acc = torch.zeros((3, n_pix))
    for j in range(k):
        acc = acc + term[j]
    model = (acc / k).reshape(3, h, w)
    plain = shade.final_shade_plain(ctx, res, geo, feats)
    assert torch.equal(model.view(torch.int32), plain.view(torch.int32))
    assert (plain > 0).float().mean() > 0.2
    shade.final_shade_bvh.launches = 0
    assert torch.equal(shade.final_shade_bvh(ctx, res, geo, feats), plain)
    assert shade.final_shade_bvh.launches == 0
