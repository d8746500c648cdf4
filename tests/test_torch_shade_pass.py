"""What lives in Python around the redesigned kernels 4 (the final shade on
a triangle soup, ``ops.shade.final_shade_soup``) and 5 (the biased spatial
pass, ``ops.spatial.spatial_pass_fused``), on the CPU.

Kernel 4 walks its shadow rays over the soup culled as kernel 7 culls it.
Its plain model, ``ops.trace.any_hit_culled`` (the blocks of
``zcount_blocks``, box, near-parallel guard, the plain any-hit's
division-form Möller–Trumbore), gives ``any_hit_plain``'s bool on every
shadow ray of a small one-torus-soup frame and of random, grazing, edge-on
and edge-crossing rays (``chip_smoke.hard_z_rays`` made into receivers and
samples, ends 0 to 1e-3 off the plane), on the torus soup and on a random
soup, and counts the tests that feed the kernel's bound. Kernel 4's thread
mapping (a pixel's lanes side by side in a warp) with each lane's
occlusion from that model, its term and the lane-order sum give
``final_shade_plain``'s bits at K = 1 to 4, shaded and unshaded; the final
shade of the one-torus soup from the fields agrees with the JAX package's
at 16x24 (rtol 2e-4, atol 1e-5, as ``test_torch_shade.py``). A soup of one
block is tested as given, with no blocks built; an empty soup leaves every
lane visible.

Kernel 5 reads its neighbours from records: its gate records (normal 3 |
depth, the depth NaN where the pixel is invalid) and its reservoir records
(a lane's pos 3 | col 3 | m | W) hold the planes' values bit for bit, and a
plain pass over the records (``spatial_pass_records_plain``) gives
``spatial_pass_plain``'s planes bit for bit on injected noise at K = 1, 2
and 4, shaded and unshaded. On CPU tensors both wrappers run their plain
versions and launch nothing. The byte counts of ``chip_smoke.py``'s bounds
(``sector_bytes``, ``shade_bytes``, ``pass_work``) count each touched
32-byte sector once and lie between what a pixel must move and every plane
counted whole."""

import dataclasses

import numpy as np
import pytest
import torch

from romis_tpu.core.features import Features as JaxFeatures
from romis_tpu.render.restir import _final_shade_xla
from romis_tpu_torch import Features
from romis_tpu_torch.core.camera import generate_rays, make_camera
from romis_tpu_torch.core.types import pack_reservoir_planes
from romis_tpu_torch.ops import shade, spatial, trace
from romis_tpu_torch.ops.shading import phong_shade
from romis_tpu_torch.ops.wrs import (
    gen_canonical_samples_plain, visibility_from,
)
from romis_tpu_torch.render import restir
from romis_tpu_torch.scene.scene import (
    flagship_camera, flagship_scene, torus_field,
)
from romis_tpu_torch.utils import stats

from chip_smoke import (
    HARD_RAY_KINDS, TORUS_CAM, hard_z_rays, pass_work, sector_bytes,
    shade_bytes,
)
from helpers import random_reservoirs_and_ctx
from test_torch_zcount import _jax_soup, _port_geometry
from torch_parity import (
    jax_torus_field, port_ctx, port_features, port_reservoirs, port_scene,
)


@pytest.fixture(scope="module")
def torus():
    """The one-torus field as a soup (970 triangles), the receivers of a
    16x24 frame of ``chip_smoke.TORUS_CAM``."""
    scene = torus_field(1, "cpu")
    assert scene.geometry.bvh is None
    cam = make_camera(resolution=(16, 24), device="cpu", **TORUS_CAM)
    _, ctx = restir.trace_primary(generate_rays(cam, 16, 24), scene.geometry,
                                  Features(), restir.PLAIN)
    return scene, ctx


def _geometry(name):
    return (torus_field(1, "cpu").geometry if name == "torus"
            else _port_geometry(_jax_soup(150, 5)))


def _shadow_rays(origins, targets, geometry):
    """The shadow rays ``ops.wrs.visibility_from`` traces from each origin
    [R+1, 3, H, W] to each target [K, 3, H, W] → (origins, dirs, t_max),
    [R+1, K, ...]."""
    got = {}

    def grab(o, d, t_max, _g):
        got["rays"] = (o, d.expand(o.shape), t_max)
        return torch.zeros(t_max.shape, dtype=torch.bool)

    visibility_from(origins[:, None], targets[None], geometry, grab)
    return got["rays"]


@pytest.mark.parametrize("kind", HARD_RAY_KINDS)
@pytest.mark.parametrize("name", ["torus", "soup"])
def test_culled_shadow_walk_gives_the_plain_bool(name, kind):
    """``any_hit_culled`` against ``any_hit_plain`` on every ray: random
    rays in the scene's box, and rays grazing, edge-on to and crossing the
    edges of the soup's triangles; its counts: at most a box test a block
    (two for a block whose guard is deferred), every guarded block a
    failed box, a hit ray's triangle tests at least
    one; the box alone (the tests the cull needs) tests no more blocks'
    triangles than the guarded walk."""
    seed = HARD_RAY_KINDS.index(kind) + 10 * (name == "torus")
    rng = np.random.default_rng(60 + seed)
    geometry = _geometry(name)
    o, t = (torch.from_numpy(a) for a in hard_z_rays(
        rng, kind, geometry.tri_cols.numpy(), 3, 2, 6, 16))
    rays = _shadow_rays(o, t, geometry)
    expect = trace.any_hit_plain(*rays, geometry)
    cnt, cnt_box = {}, {}
    got = trace.any_hit_culled(*rays, geometry, cnt)
    assert got.dtype == torch.bool and torch.equal(got, expect)
    if kind == "random":
        assert 0.05 < expect.float().mean() < 0.95
    boxes = trace.zcount_blocks(geometry)[1]
    assert boxes.shape[1] > 1
    assert torch.all(cnt["box"] <= boxes.shape[1] + (boxes[12] > 0.5).sum())
    assert torch.all(cnt["guard"] <= cnt["box"])
    assert torch.all(cnt["tri"][expect] >= 1)
    trace.any_hit_culled(*rays, geometry, cnt_box, guard=False)
    assert cnt_box["tri"].sum() <= cnt["tri"].sum()
    assert int(cnt_box["guard"].sum()) == 0


def test_culled_shadow_walk_on_a_frame(torus):
    """The shadow rays of a 16x24 frame of the one-torus soup (K = 2, the
    RIS winners of 512 light samples): the culled walk's bool is the plain
    any-hit's on every ray, the lanes kernel 4 reports occluded are the
    plain model's, and the walk tests fewer triangles than the plain scan
    up to each ray's first hit."""
    scene, ctx = torus
    feats = Features()
    gen = torch.Generator().manual_seed(2)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=gen)
    got = {}

    def grab(o, d, t_max, _g):
        got["rays"] = (o, d.expand(o.shape), t_max)
        return torch.zeros(t_max.shape, dtype=torch.bool)

    shade.shadow_occlusion_plain(ctx, res, scene.geometry, feats, grab)
    rays = got["rays"]
    cnt, plain_cnt = {}, {}
    expect = trace.any_hit_plain(*rays, scene.geometry, plain_cnt)
    assert torch.equal(trace.any_hit_culled(*rays, scene.geometry, cnt),
                       expect)
    assert 0.05 < expect.float().mean() < 0.95
    assert cnt["tri"].sum() < plain_cnt["tests"].sum()
    assert torch.equal(
        shade.shadow_occlusion_plain(ctx, res, scene.geometry, feats,
                                     lambda *a: trace.any_hit_culled(*a)),
        shade.shadow_occlusion_plain(ctx, res, scene.geometry, feats))


def test_one_block_takes_the_direct_loop():
    """A soup of one block (the flagship's 2 triangles) has nothing to
    cull: the model tests the block's triangles directly, no box test."""
    scene = flagship_scene("cpu")
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-8, 8, (3, 3, 6, 16)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-8, 8, (2, 3, 6, 16)).astype(np.float32))
    o[:, 1] = 3.0
    t[:, 1] = torch.where(torch.from_numpy(rng.uniform(size=(2, 6, 16))
                                           < 0.5), -3.0, 1.0)
    # half the segments cross the ground plane's height
    rays = _shadow_rays(o, t, scene.geometry)
    cnt = {}
    got = trace.any_hit_culled(*rays, scene.geometry, cnt)
    assert torch.equal(got, trace.any_hit_plain(*rays, scene.geometry))
    assert got.any() and (~got).any()
    assert int(cnt["box"].sum()) == 0 and int(cnt["tri"].min()) >= 1
    assert scene.geometry.zcount is None  # no blocks built for it


def _empty_soup(geometry):
    return dataclasses.replace(
        geometry, tri_cols=geometry.tri_cols[:, :0].contiguous(),
        zcount=None)


@pytest.mark.parametrize("k", [1, 2])
def test_empty_soup_shades_every_lane_visible(k):
    """A soup with no triangle (kernel 4's direct loop over nothing): every
    lane visible, so the colour is Phong x W of every lane; no lane
    reported occluded; the culled model's bool False on every ray, with
    no test counted."""
    scene = flagship_scene("cpu")
    empty = _empty_soup(scene.geometry)
    h, w = 12, 20
    feats = Features(num_samples_in_reservoir=k)
    _, ctx = restir.trace_primary(generate_rays(flagship_camera(
        h, w, "cpu"), h, w), scene.geometry, feats, restir.PLAIN)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=torch.Generator()
                                      .manual_seed(30 + k))
    color, occ = shade.final_shade_soup(ctx, res, empty, feats,
                                        occlusion=True)
    every = torch.ones((k, h, w), dtype=torch.bool)
    assert torch.equal(color, shade._shade(ctx, res, every, feats))
    assert (color > 0).any() and not occ.any()
    rays = _shadow_rays(ctx.position[None], res.pos, empty)
    cnt = {}
    assert not trace.any_hit_culled(*rays, empty, cnt).any()
    assert all(int(v.sum()) == 0 for v in cnt.values())
    assert empty.zcount is None


def test_sector_bytes_counts_each_touched_sector_once():
    """The bounds' byte count: each 32-byte sector of each plane that holds
    a needed element, once (float and byte planes; a plane whose size is
    not a multiple of a sector padded at its end)."""
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.uniform(size=(3, 6, 40)) < 0.05)
    for elem in (1, 4):
        per = 32 // elem
        expect = sum(len({int(i) // per for i in np.flatnonzero(row)})
                     for row in mask.reshape(3, -1).numpy()) * 32
        assert sector_bytes(torch, mask, elem) == expect
    assert sector_bytes(torch, torch.zeros((2, 4, 8), dtype=torch.bool)) == 0


@pytest.mark.parametrize("shaded", [True, False], ids=["shaded", "unshaded"])
def test_needed_bytes_lie_within_the_planes(shaded):
    """Kernels 4's and 5's bounds on a flagship frame: the bytes their data
    needs at least what they must write and read at every pixel (the
    colour, W and valid; the pass's 10K planes out and valid), at most
    every plane they read counted whole."""
    k, h, w = 2, 16, 32
    scene = flagship_scene("cpu")
    feats = Features(enable_shading=shaded)
    _, ctx = restir.trace_primary(generate_rays(flagship_camera(
        h, w, "cpu"), h, w), scene.geometry, feats, restir.PLAIN)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=torch.Generator()
                                      .manual_seed(40))
    occ = shade.shadow_occlusion_plain(ctx, res, scene.geometry, feats)
    need = shade_bytes(torch, ctx, res, occ, shaded)
    hw = h * w
    assert hw * (1 + 4 * k + 12) < need < hw * (4 * (16 + 7 * k + 3) + 1)
    key = spatial.philox_key(torch.Generator().manual_seed(41))
    _, _, need5 = pass_work(torch, spatial, ctx, spatial.pack_gates(ctx), key,
                            5, 10, k, shaded)
    assert hw * (40 * k + 4) < need5 < hw * 4 * (8 * k + 5 + 18 + 10 * k)


def _threads(k: int, n_pix: int):
    """Kernel 4's threads (kernel 21's mapping) → (pixel, lane), -1 for an
    idle thread: thread slot * K + lane of warp v shades lane ``lane`` of
    pixel v * (32 // K) + slot."""
    per_warp = 32 // k
    n_warps = -(-n_pix // per_warp)
    wl = np.arange(32)
    slot, lane = wl // k, wl % k
    pix = np.arange(n_warps)[:, None] * per_warp + slot[None, :]
    ok = (slot[None, :] < per_warp) & (pix < n_pix)
    return np.where(ok, pix, -1), np.where(ok, lane[None, :], -1)


@pytest.mark.parametrize("unshaded", [False, True], ids=["shaded", "unshaded"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_soup_shade_mapping_gives_the_plain_bits(torus, k, unshaded):
    """Kernel 4's threads cover each (pixel, lane) once; each lane's
    occlusion from the culled walk (traced only where the lane is live),
    its term (lit ? Phong : 0) x W, and the pixel's first thread summing
    the K terms in lane order from 0 and dividing by K give
    ``final_shade_plain``'s bits on the one-torus soup."""
    scene, ctx = torus
    geo = scene.geometry
    feats = Features(num_samples_in_reservoir=k, enable_shading=not unshaded)
    gen = torch.Generator().manual_seed(k)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=gen)
    h, w = ctx.valid.shape
    pix, lane = _threads(k, h * w)
    live = pix >= 0
    assert np.array_equal(np.sort(pix[live] * k + lane[live]),
                          np.arange(h * w * k))
    occ = shade.shadow_occlusion_plain(ctx, res, geo, feats,
                                       lambda *a: trace.any_hit_culled(*a))
    assert occ.any()
    lit_shade = phong_shade(ctx, res.pos, res.color, feats)  # [K, 3, H, W]
    term = torch.where(~occ[:, None], lit_shade, 0.0) * res.big_w[:, None]
    acc = torch.zeros((3, h * w))
    flat = term.reshape(k, 3, h * w)
    for v in range(pix.shape[0]):
        for slot in range(32 // k):
            p = pix[v, slot * k]
            if p < 0:
                continue
            for j in range(k):  # the shuffles, in lane order
                acc[:, p] = acc[:, p] + flat[j, :, p]
    got = (acc / float(k)).reshape(3, h, w)
    expect = shade.final_shade_plain(ctx, res, geo, feats)
    assert torch.equal(got, expect)


def test_torus_soup_shade_matches_jax():
    """The final shade of the one-torus soup from the fields (on the card
    kernel 4, here its plain version) against the JAX package's
    ``_final_shade_xla`` on the same soup, at 16x24."""
    jscene = jax_torus_field(1)
    scene = port_scene(jscene)
    jres, jctx = random_reservoirs_and_ctx(np.random.default_rng(8), 16, 24,
                                           2)
    feats = JaxFeatures()
    expect = np.asarray(_final_shade_xla(jctx, jres, jscene.geometry, feats))
    ctx, res = port_ctx(jctx), port_reservoirs(jres)
    got = shade.final_shade_soup(ctx, res, scene.geometry,
                                 port_features(feats)).numpy()
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=1e-5)
    assert (expect > 0).mean() > 0.2
    occ = shade.shadow_occlusion_plain(ctx, res, scene.geometry,
                                       port_features(feats))
    assert occ.any()


def test_soup_shade_wrapper_runs_plain_on_cpu(torus):
    scene, ctx = torus
    feats = Features()
    gen = torch.Generator().manual_seed(9)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=gen)
    stats.launches.clear()
    color, occ = shade.final_shade_soup(ctx, res, scene.geometry, feats,
                                        occlusion=True)
    assert torch.equal(color, shade.final_shade_plain(ctx, res,
                                                      scene.geometry, feats))
    assert torch.equal(occ, shade.shadow_occlusion_plain(
        ctx, res, scene.geometry, feats))
    assert torch.equal(shade.final_shade_fused(ctx, res, scene.geometry,
                                               feats), color)
    assert stats.launches == {}


def _pass_inputs(k, unshaded, h=24, w=40):
    """The flagship's receivers at h x w (most pixels invalid: the sky),
    RIS reservoirs and one pass's injected noise."""
    scene = flagship_scene("cpu")
    feats = Features(num_samples_in_reservoir=k, enable_shading=not unshaded)
    _, ctx = restir.trace_primary(generate_rays(flagship_camera(
        h, w, "cpu"), h, w), scene.geometry, feats, restir.PLAIN)
    gen = torch.Generator().manual_seed(20 + k)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=gen)
    inject = spatial.spatial_noise(gen, 5, k, 10, h, w)
    return (ctx, pack_reservoir_planes(res), spatial.pack_gates(ctx), feats,
            inject)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_pass_records_hold_the_planes(k):
    """Kernel 5's records bit for bit: a gate record is the pixel's normal
    and depth, its depth NaN exactly where the pixel is invalid; a
    reservoir record is the lane's pos 3 | col 3 | m | W, lane after
    lane."""
    ctx, rp, gates, _, _ = _pass_inputs(k, False)
    n = ctx.valid.numel()
    grec = spatial.gate_records(gates)
    assert grec.shape == (n, spatial.GATE_RECORD) and grec.is_contiguous()
    valid = ctx.valid.reshape(-1)
    assert (~valid).any() and valid.any()
    assert torch.equal(grec[:, 0:3], ctx.normal.reshape(3, n).t())
    assert torch.equal(grec[valid, 3], ctx.depth_t.reshape(-1)[valid])
    assert torch.isnan(grec[~valid, 3]).all()
    assert not torch.isnan(grec[valid, 3]).any()
    rres = spatial.reservoir_records(rp, k)
    assert rres.shape == (n, 8 * k) and rres.is_contiguous()
    planes = rp.reshape(10 * k, n)
    for lane in range(k):
        rec = rres[:, 8 * lane:8 * lane + 8]
        assert torch.equal(rec[:, 0:3], planes[3 * lane:3 * lane + 3].t())
        assert torch.equal(rec[:, 3:6],
                           planes[3 * k + 3 * lane:3 * k + 3 * lane + 3].t())
        assert torch.equal(rec[:, 6], planes[7 * k + lane])
        assert torch.equal(rec[:, 7], planes[8 * k + lane])


@pytest.mark.parametrize("unshaded", [False, True], ids=["shaded", "unshaded"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_pass_over_records_gives_the_plain_bits(k, unshaded):
    """The biased pass reading every neighbour and the receiver's own
    reservoir from the reservoir records and the neighbours' gates from the
    gate records (validity as a NaN depth) gives ``spatial_pass_plain``'s
    planes bit for bit, on a frame whose neighbours are often invalid."""
    ctx, rp, gates, feats, inject = _pass_inputs(k, unshaded)
    expect = spatial.spatial_pass_plain(rp, gates,
                                        shade.pack_center_ctx(ctx), k, 5, 10,
                                        feats, inject=inject)
    got = spatial.spatial_pass_records_plain(
        spatial.reservoir_records(rp, k), spatial.gate_records(gates),
        shade.pack_center_ctx(ctx), k, 5, 10, feats, inject)
    assert torch.equal(got, expect)
    w_sum = expect[6 * k:7 * k]
    assert (w_sum > 0).any() and (unshaded or (w_sum == 0).any())


def test_pass_wrapper_runs_plain_on_cpu():
    ctx, rp, gates, feats, inject = _pass_inputs(2, False, 8, 12)
    stats.launches.clear()
    cen = shade.pack_center_ctx(ctx)
    assert torch.equal(
        spatial.spatial_pass_fused(rp, gates, cen, 2, 5, 10, feats,
                                   inject=inject),
        spatial.spatial_pass_plain(rp, gates, cen, 2, 5, 10, feats,
                                   inject=inject))
    assert stats.launches == {}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_missed_receivers_fast_path_gives_the_plain_bits(k):
    """Kernel 5's fast path for a missed receiver (shaded): its race keeps
    stream 0's sample with no weight, so its planes are neighbour 0's
    sample (pos, colour), w_sum = (0 + 0) + 0·W·m and m = (0 + 0) + m of
    its own reservoir, W = 0 and the chosen weight 0: the plain pass's
    bits on every invalid pixel."""
    ctx, rp, gates, feats, inject = _pass_inputs(k, False)
    out = spatial.spatial_pass_plain(rp, gates, shade.pack_center_ctx(ctx),
                                     k, 5, 10, feats, inject=inject)
    h, w = ctx.valid.shape
    dy, dx = spatial.clamped_offsets(inject[0], h, w)
    rows = torch.arange(h)[:, None]
    cols = torch.arange(w)[None, :]
    q0 = ((rows + dy[0]) * w + (cols + dx[0])).reshape(-1)
    rres = spatial.reservoir_records(rp, k)
    miss = ~ctx.valid.reshape(-1)
    planes = out.reshape(10 * k, -1)[:, miss]
    zero = torch.zeros(int(miss.sum()))
    for lane in range(k):
        src = rres[q0[miss], 8 * lane:8 * lane + 8]
        own = rres[miss, 8 * lane:8 * lane + 8]
        assert torch.equal(planes[3 * lane:3 * lane + 3], src[:, 0:3].t())
        assert torch.equal(planes[3 * k + 3 * lane:3 * k + 3 * lane + 3],
                           src[:, 3:6].t())
        assert torch.equal(planes[6 * k + lane],
                           (zero + zero) + zero * own[:, 7] * own[:, 6])
        assert torch.equal(planes[7 * k + lane], (zero + zero) + own[:, 6])
        assert torch.equal(planes[8 * k + lane], zero)
        assert torch.equal(planes[9 * k + lane], zero)
