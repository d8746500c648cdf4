"""The plain versions and the Python around the two redesigned kernels:
kernel 10 (the halo offset scatter, ``ops.spatial.halo_offset_scatter``)
and kernel 20 (the K-ray BVH any-hit, ``ops.walk.any_hit_bvh_k``).

Kernel 10's plain version is held to a float64 numpy sum on offsets that
cover every branch of the kernel: within ±r, beyond its margin and clamped
at the borders; a numpy model of the kernel's partition (each source tile
adds its near sources into a window, the tile ± the margin, and its far
ones straight to their targets) gives the same sum, with every near target
inside its window. Kernel 20's plain
version at S = 16 on the torus field is held to the brute-force block scan
on the soup, and its triangle records to the columns they come from. On CPU
tensors both wrappers run their plain versions and launch nothing."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from romis_tpu_torch.ops import spatial, trace, walk
from romis_tpu_torch.ops.bvh import with_bvh
from romis_tpu_torch.ops.intersect import intersect_any
from romis_tpu_torch.ops.traverse import bvh_any
from romis_tpu_torch.scene.scene import torus_field

from torch_parity import random_rays

TILE, MARGIN = (16, 32), spatial.HALO_SCATTER_MARGIN  # csrc/halo.cu


def _offsets(rng, case, d_n, h, w, r=10):
    """dy, dx [D, H, W] int32 of one kind: ``near`` (clamped ±r, the
    spatial passes'), ``far`` (clamped ±500: beyond any margin, mostly at a
    border), ``raw`` (unclamped ±500, clamped only by the scatter),
    ``mixed`` (each source drawn from one of the three)."""
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]

    def draw(rr, clamp):
        oy = rng.integers(-rr, rr + 1, (d_n, h, w))
        ox = rng.integers(-rr, rr + 1, (d_n, h, w))
        if clamp:
            oy = np.clip(ys + oy, 0, h - 1) - ys
            ox = np.clip(xs + ox, 0, w - 1) - xs
        return oy, ox

    if case == "near":
        oy, ox = draw(r, True)
    elif case == "far":
        oy, ox = draw(500, True)
    elif case == "raw":
        oy, ox = draw(500, False)
    else:
        parts = [draw(r, True), draw(500, True), draw(500, False)]
        pick = rng.integers(0, 3, (d_n, h, w))
        oy = np.choose(pick, [p[0] for p in parts])
        ox = np.choose(pick, [p[1] for p in parts])
    return oy.astype(np.int32), ox.astype(np.int32)


def _scatter64(ct, dy, dx):
    """out[c, clamp(i + dy), clamp(j + dx)] += ct[d, c, i, j] in float64."""
    d_n, c_n, h, w = ct.shape
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    q = (np.clip(ys + dy.astype(np.int64), 0, h - 1) * w
         + np.clip(xs + dx.astype(np.int64), 0, w - 1))
    out = np.zeros((c_n, h * w))
    for c in range(c_n):
        np.add.at(out[c], q.ravel(), ct[:, c].astype(np.float64).ravel())
    return out.reshape(c_n, h, w)


@pytest.mark.parametrize("case", ["near", "far", "raw", "mixed"])
def test_halo_scatter_plain_matches_float64_sum(case):
    """The plain version (``index_add_`` in float32) against the float64
    sum, relative to the sum of |ct| landing on each pixel; the border
    pixels of the clamped cases take hundreds of terms."""
    h, w, d_n, c_n = 37, 83, 5, 2
    rng = np.random.default_rng(["near", "far", "raw", "mixed"].index(case))
    dy, dx = _offsets(rng, case, d_n, h, w)
    ct = rng.normal(size=(d_n, c_n, h, w)).astype(np.float32)
    got = spatial.halo_offset_scatter_plain(
        torch.from_numpy(ct), torch.from_numpy(dy),
        torch.from_numpy(dx)).numpy()
    expect = _scatter64(ct, dy, dx)
    mag = np.maximum(_scatter64(np.abs(ct), dy, dx), 1e-30)
    rel = (np.abs(got - expect) / mag).max()
    assert rel <= 1e-6, rel  # float32 sums of up to ~500 terms
    # every source lands somewhere: the totals agree
    np.testing.assert_allclose(got.sum(axis=(1, 2)),
                               ct.astype(np.float64).sum(axis=(0, 2, 3)),
                               rtol=1e-5, atol=1e-3)


def _push_model(ct, dy, dx, tile, margin):
    """Kernel 10's partition of the work, in numpy: every source tile
    (tile = (rows, columns)) adds its near sources into its window (the
    tile ± margin) and its far ones
    straight to their targets, then adds the window's cells that lie in the
    image → (the float64 sum, the largest |sum| the windows held in cells
    outside the image, which the kernel's flush skips)."""
    d_n, c_n, h, w = ct.shape
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    ty = np.clip(ys + dy.astype(np.int64), 0, h - 1)
    tx = np.clip(xs + dx.astype(np.int64), 0, w - 1)
    near = (np.abs(ty - ys) <= margin) & (np.abs(tx - xs) <= margin)
    out = np.zeros((c_n, h * w))
    lost = 0.0
    th, tw = tile
    eh, ew = th + 2 * margin, tw + 2 * margin
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            src = (slice(None), slice(y0, y0 + th), slice(x0, x0 + tw))
            n_s, f_s = near[src], ~near[src]
            wy = ty[src] - y0 + margin
            wx = tx[src] - x0 + margin
            assert (wy[n_s] >= 0).all() and (wy[n_s] < eh).all()
            assert (wx[n_s] >= 0).all() and (wx[n_s] < ew).all()
            acc = np.zeros((c_n, eh * ew))
            q_far = (ty[src] * w + tx[src])[f_s]
            for c in range(c_n):
                v = ct[:, c][src].astype(np.float64)
                np.add.at(acc[c], (wy * ew + wx)[n_s], v[n_s])
                np.add.at(out[c], q_far, v[f_s])
            gy = np.arange(eh)[:, None] + y0 - margin
            gx = np.arange(ew)[None, :] + x0 - margin
            inside = ((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)).ravel()
            lost = max(lost, np.abs(acc[:, ~inside]).max(initial=0.0))
            cell = (np.clip(gy, 0, h - 1) * w + np.clip(gx, 0, w - 1)).ravel()
            for c in range(c_n):
                np.add.at(out[c], cell[inside], acc[c, inside])
    return out.reshape(c_n, h, w), lost


@pytest.mark.parametrize("tile,margin", [(TILE, MARGIN), ((4, 8), 3)],
                         ids=["kernel", "small"])
@pytest.mark.parametrize("case", ["near", "mixed"])
def test_push_windows_hold_every_near_target(case, tile, margin):
    """The kernel's partition at its own tile and margin and at a small one
    (many tiles, many far sources): every near target falls in its source
    tile's window, no window cell outside the image receives anything, the
    sum is the plain scatter's, and ``beyond_margin`` marks the far ones."""
    h, w, d_n, c_n = 70, 133, 3, 2
    rng = np.random.default_rng(7)
    dy, dx = _offsets(rng, case, d_n, h, w, r=margin)  # near: up to ±margin
    ct = rng.normal(size=(d_n, c_n, h, w)).astype(np.float32)
    out, lost = _push_model(ct, dy, dx, tile, margin)
    assert lost == 0.0
    np.testing.assert_allclose(out, _scatter64(ct, dy, dx), rtol=0,
                               atol=1e-9)
    far = spatial.beyond_margin(torch.from_numpy(dy), torch.from_numpy(dx),
                                margin).numpy()
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    ty = np.clip(ys + dy, 0, h - 1)
    tx = np.clip(xs + dx, 0, w - 1)
    np.testing.assert_array_equal(
        far, (np.abs(ty - ys) > margin) | (np.abs(tx - xs) > margin))
    if case == "near":
        assert not far.any()
    else:
        assert 0.3 < far.mean() < 0.9


def test_halo_scatter_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(3)
    dy, dx = _offsets(rng, "mixed", 4, 21, 34)
    ct = torch.from_numpy(rng.normal(size=(4, 3, 21, 34)).astype(np.float32))
    spatial.halo_offset_scatter.launches = 0
    got = spatial.halo_offset_scatter(ct, torch.from_numpy(dy),
                                      torch.from_numpy(dx))
    assert torch.equal(got, spatial.halo_offset_scatter_plain(
        ct, torch.from_numpy(dy), torch.from_numpy(dx)))
    assert spatial.halo_offset_scatter.launches == 0


@pytest.fixture(scope="module")
def field():
    """The port's 2x2 torus field with its BVH (3,874 triangles)."""
    scene = torus_field(2, "cpu")
    return replace(scene, geometry=with_bvh(scene.geometry))


def test_tri_records_are_the_columns(field):
    """[10, T] columns → [T, 12] rows: v0, e1, e2, active, then two zeros;
    48 bytes a record, so a record is three aligned float4."""
    cols = field.geometry.tri_cols
    recs = walk.tri_records(cols)
    assert recs.shape == (cols.shape[1], 12) and recs.is_contiguous()
    assert recs.dtype == torch.float32 and recs.stride() == (12, 1)
    assert torch.equal(recs[:, :10], cols.t())
    assert not recs[:, 10:].any()
    assert torch.equal(recs[:, 9] > 0, field.geometry.active)


def test_bvh_any_s16_matches_brute_force(field):
    """16 rays a pixel (kernel 20's widest case): the plain traversal's
    bool equals the block scan over the whole soup on every ray, and the
    kernel's wrapper on CPU tensors returns it without a launch."""
    geo = field.geometry
    h, w, s = 6, 10, 16
    o = np.stack([random_rays(np.random.default_rng(100 + i), h, w,
                              half=2.6)[0] for i in range(s)])
    d = np.stack([random_rays(np.random.default_rng(100 + i), h, w,
                              half=2.6)[1] for i in range(s)])
    tm = np.random.default_rng(5).uniform(2.0, 6.0, (s, h, w)
                                          ).astype(np.float32)
    o, d, tm = (torch.from_numpy(a) for a in (o, d, tm))
    occ = bvh_any(o, d, tm, geo, geo.bvh)
    brute = intersect_any(o, d, tm, replace(geo, bvh=None))
    assert torch.equal(occ, brute)
    assert 0.05 < occ.float().mean() < 0.95
    walk.any_hit_bvh_k.launches = 0
    o4, d4, tm4 = (a.reshape((4, 4) + a.shape[1:]) for a in (o, d, tm))
    for fn in (walk.any_hit_bvh_k, trace.any_hit):
        assert torch.equal(fn(o4, d4, tm4, geo), occ.reshape(4, 4, h, w))
    assert walk.any_hit_bvh_k.launches == 0
