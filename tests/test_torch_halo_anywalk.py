"""What lives in Python around the redesigned kernels 9 (the halo offset
gather, ``ops.spatial.halo_offset_gather``) and 19 (the BVH any-hit,
``ops.walk.any_hit_bvh``), on the CPU.

Kernel 9 at D >= 2 owns 32×32 tiles of output pixels, stages each tile's
window (± 16 pixels) a chunk of channels at a time, and reads a source
outside the window straight from the planes. Its decomposition in PyTorch
(``ops.spatial.halo_gather_windowed``) gives ``halo_offset_gather_plain``'s
bits (compared as 32-bit patterns: infinities, NaNs and signed zeros
included) and the JAX package's ``halo_offset_gather_pallas`` in interpret
mode: offsets within the margin, beyond it and beyond the image, D = 1 to
6, a channel count that is not a multiple of the chunk, an image that is
not a multiple of the tile. ``ops.spatial.beyond_window`` marks the far
sources.

Kernel 19 walks the two-box records (``ops.bvh.wide_record``), the left
child first. Its plain model, ``ops.traverse.bvh_any_wide``, gives
``bvh_any``'s bool and JAX's ``romis_tpu.ops.traverse.bvh_any``'s on the
2x2 torus field (the JAX package's tree carried across) with 1, 2 and 17
planes of rays; ``bvh_any``'s on random, grazing, edge-on and
edge-crossing rays (``chip_smoke.hard_any_rays``), where JAX's own
rounding differs on a few degenerate rays; and on rays whose t_max is
their closest hit's t, where JAX is held just below and just above it.
With a stack of 0 or 1 entry its rays overflow and are walked again, with
the same bool.
On CPU tensors the wrappers of kernels 9, 19, 20 and 21 run their plain
versions and launch nothing."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from romis_tpu.ops.bvh import build_bvh as jax_build_bvh
from romis_tpu.ops.pallas_spatial import halo_offset_gather_pallas
from romis_tpu.ops.traverse import bvh_any as jax_bvh_any
from romis_tpu_torch import Features
from romis_tpu_torch.core.camera import generate_rays
from romis_tpu_torch.ops import ris, shade, spatial, walk
from romis_tpu_torch.ops.bvh import with_bvh
from romis_tpu_torch.ops.traverse import bvh_any, bvh_any_wide
from romis_tpu_torch.render import restir
from romis_tpu_torch.scene.scene import torus_field, torus_field_camera
from romis_tpu_torch.utils import stats

from chip_smoke import HARD_RAY_KINDS, hard_any_rays
from torch_parity import jax_torus_field, port_bvh_scene, random_rays

TILE, MARGIN = spatial.HALO_GATHER_TILE, spatial.HALO_GATHER_MARGIN


def _bits(a):
    return a.contiguous().view(torch.int32)


def _offsets(rng, case, d_n, h, w):
    """dy, dx [D, H, W] int32: ``inside`` within ±10 and ``beyond`` within
    ±40, both clamped into the image (the callers' offsets); ``image``
    within ±100, not clamped (the kernel clamps)."""
    r = {"inside": 10, "beyond": 40, "image": 100}[case]
    dy = rng.integers(-r, r + 1, (d_n, h, w))
    dx = rng.integers(-r, r + 1, (d_n, h, w))
    if case != "image":
        ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
        dy = np.clip(ys + dy, 0, h - 1) - ys
        dx = np.clip(xs + dx, 0, w - 1) - xs
    return (torch.from_numpy(dy.astype(np.int32)),
            torch.from_numpy(dx.astype(np.int32)))


def _planes(rng, c_n, h, w, special=False):
    p = rng.normal(size=(c_n, h, w)).astype(np.float32)
    if special:  # a missed pixel's t, NaNs with payloads, signed zeros
        flat = p.reshape(-1).view(np.int32)
        idx = rng.choice(flat.size, (5, flat.size // 20), replace=False)
        flat[idx[0]] = np.float32(np.inf).view(np.int32)
        flat[idx[1]] = np.float32(-np.inf).view(np.int32)
        flat[idx[2]] = 0x7FC00000 | rng.integers(1, 1 << 20, idx.shape[1])
        flat[idx[3]] = np.int32(-2 ** 31)  # -0.0
        flat[idx[4]] = 0
    return torch.from_numpy(p)


@pytest.mark.parametrize("d_n", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("case", ["inside", "beyond", "image"])
def test_windowed_gather_is_plain(case, d_n):
    """The tile/window/far decomposition on a 70x101 image (not a multiple
    of the 32x32 tile) with 7 channels (not a multiple of the chunk): the
    plain gather's bits; far sources only where an offset can leave the
    window."""
    h, w, c_n = 70, 101, 7
    rng = np.random.default_rng(10 * d_n + len(case))
    dy, dx = _offsets(rng, case, d_n, h, w)
    planes = _planes(rng, c_n, h, w)
    got, far = spatial.halo_gather_windowed(planes, dy, dx)
    assert got.shape == (d_n, c_n, h, w)
    assert torch.equal(_bits(got), _bits(spatial.halo_offset_gather_plain(
        planes, dy, dx)))
    if case == "inside":
        assert not far.any()
    else:
        assert 0.05 < far.float().mean().item() < 0.95


@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
def test_windowed_gather_keeps_every_bit(chunk):
    """Infinities, NaNs with payloads and signed zeros pass as they are,
    whatever the channel chunk, near and far."""
    rng = np.random.default_rng(chunk)
    h, w = 45, 70
    planes = _planes(rng, 9, h, w, special=True)
    dy, dx = _offsets(rng, "beyond", 5, h, w)
    got, far = spatial.halo_gather_windowed(planes, dy, dx, chunk=chunk)
    assert far.any() and not far.all()
    assert torch.equal(_bits(got), _bits(spatial.halo_offset_gather_plain(
        planes, dy, dx)))


@pytest.mark.parametrize("case,d_n,c_n,r", [("inside", 3, 7, 10),
                                             ("beyond", 2, 5, 40)])
def test_windowed_gather_matches_pallas(case, d_n, c_n, r):
    """Against the JAX package's kernel in interpret mode (its offsets in
    the image and within its radius) on a 37x70 image."""
    h, w = 37, 70
    rng = np.random.default_rng(r)
    dy, dx = _offsets(rng, case, d_n, h, w)
    planes = _planes(rng, c_n, h, w)
    expect = np.asarray(halo_offset_gather_pallas(
        jnp.asarray(planes.numpy()), jnp.asarray(dy.numpy()),
        jnp.asarray(dx.numpy()), r, interpret=pltpu.InterpretParams()))
    got, far = spatial.halo_gather_windowed(planes, dy, dx)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  expect.view(np.int32))
    assert far.any() == (case == "beyond")


@pytest.mark.parametrize("tile,margin", [(TILE, MARGIN), ((8, 8), 2)],
                         ids=["kernel", "small"])
def test_beyond_window_marks_the_far_sources(tile, margin):
    """A source is far where its clamped coordinates leave its tile's window
    (numpy, pixel by pixel); a source within the margin of its pixel never
    is."""
    h, w, d_n = 40, 77, 3
    rng = np.random.default_rng(5)
    dy, dx = _offsets(rng, "image", d_n, h, w)
    far = spatial.beyond_window(dy, dx, tile, margin).numpy()
    th, tw = tile
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    sy = np.clip(ys + dy.numpy(), 0, h - 1)
    sx = np.clip(xs + dx.numpy(), 0, w - 1)
    y0, x0 = ys // th * th, xs // tw * tw
    expect = ((sy < y0 - margin) | (sy >= y0 + th + margin)
              | (sx < x0 - margin) | (sx >= x0 + tw + margin))
    np.testing.assert_array_equal(far, expect)
    near = (np.abs(sy - ys) <= margin) & (np.abs(sx - xs) <= margin)
    assert near.any() and not far[near].any()


def test_halo_gather_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(2)
    planes = _planes(rng, 6, 21, 34, special=True)
    dy, dx = _offsets(rng, "image", 5, 21, 34)
    stats.launches.clear()
    got = spatial.halo_offset_gather(planes, dy, dx)
    assert torch.equal(_bits(got), _bits(spatial.halo_offset_gather_plain(
        planes, dy, dx)))
    assert stats.launches == {}


@pytest.fixture(scope="module")
def field():
    """(JAX scene with its BVH, the same scene in the port with the tree
    carried across): the 2x2 torus field, 3,874 triangles."""
    jscene = jax_torus_field(2)
    bvh, geo = jax_build_bvh(jscene.geometry)
    jscene.geometry = geo.replace(bvh=bvh)
    return jscene, port_bvh_scene(jscene)


def _three_way(jscene, geometry, o, d, tm, **kw):
    """bvh_any_wide, bvh_any and JAX's bvh_any on the same rays →
    (ordered, plain, jax, counts)."""
    counts = {}
    got = bvh_any_wide(o, d, tm, geometry, geometry.bvh, counts=counts,
                          **kw)
    plain = bvh_any(o, d, tm, geometry, geometry.bvh)
    expect = np.asarray(jax_bvh_any(jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy()),
                                    jnp.asarray(tm.numpy()), jscene.geometry,
                                    jscene.geometry.bvh))
    return got, plain, expect, counts


@pytest.mark.parametrize("planes", [1, 2, 17])
def test_any_ordered_is_plain_and_jax(field, planes):
    """Random rays into the field with 1, 2 and 17 planes: the same bool
    as the plain walk and JAX's on every ray, no ray walked again, at most
    one box test more than two a step."""
    jscene, pscene = field
    geometry = pscene.geometry
    h, w = 8, 12
    rng = np.random.default_rng(planes)
    rays = [random_rays(np.random.default_rng(10 * planes + i), h, w,
                        half=1.5) for i in range(planes)]
    o = torch.from_numpy(np.stack([r[0] for r in rays]))
    d = torch.from_numpy(np.stack([r[1] for r in rays]))
    tm = torch.from_numpy(rng.uniform(2.0, 6.0, (planes, h, w)).astype(
        np.float32))
    got, plain, expect, n = _three_way(jscene, geometry, o, d, tm)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), expect)
    assert 0.05 < expect.mean() < 0.95
    assert not n["again"].any()
    assert (n["box"] % 2 == 1).all() and (n["tri"] >= got.long()).all()


# Rays of 512 whose bool the JAX package's arithmetic (XLA's order of
# operations in Möller–Trumbore) decides otherwise than the port's plain
# walk: rays in a triangle's plane or through its edge, where the
# determinant or u + v sits at its threshold. The seeds are fixed and the
# run is on the CPU, so the counts are the measured ones, exactly.
JAX_HARD_DIFFER = {"random": 0, "grazing": 2, "edge_on": 6, "edge": 11}
# The float32 rounding a test of mt_one is allowed, in units of float32's
# epsilon times the magnitudes that enter it.
MT_ULPS = 4


def _mt_decisions(o, d, tm, cols):
    """Möller–Trumbore (``ops.intersect.mt_one``, a hit when t < t_max) of
    rays o, d [N, 3], t_max [N] against every active triangle of the
    columns [10, T], in float64 with each test's float32 rounding bounded
    by MT_ULPS epsilons of the magnitudes in it → (ambiguous, occluded)
    bool [N]: ``occluded`` where some triangle passes every test by more
    than its rounding; ``ambiguous`` where none does but some triangle
    passes every test within its rounding, so float32 may decide either
    way."""
    o, d = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    tm = tm.astype(np.float64)[:, None]
    c = cols.astype(np.float64)
    v0, e1, e2 = c[0:3].T[None], c[3:6].T[None], c[6:9].T[None]
    active = c[9] > 0

    def norm(a):
        return np.linalg.norm(a, axis=-1)

    pvec, tvec = np.cross(d, e2), o - v0
    qvec = np.cross(tvec, e1)
    det = (e1 * pvec).sum(-1)
    eps = MT_ULPS * float(np.finfo(np.float32).eps)
    scale = norm(tvec) + norm(o) + norm(v0)  # o - v0 rounds too
    e_det = eps * norm(e1) * norm(d) * norm(e2)
    ad = np.maximum(np.abs(det) - e_det, 1e-300)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (tvec * pvec).sum(-1) / det
        v = (d * qvec).sum(-1) / det
        t = (e2 * qvec).sum(-1) / det
    eu = (eps * scale * norm(d) * norm(e2) + np.abs(u) * e_det) / ad
    ev = (eps * scale * norm(d) * norm(e1) + np.abs(v) * e_det) / ad
    et = (eps * scale * norm(e2) * norm(e1) + np.abs(t) * e_det) / ad
    etm = eps * tm
    sure = (active & (np.abs(det) - e_det > 1e-9) & (u - eu >= 0)
            & (u + eu <= 1) & (v - ev >= 0) & (u + v + eu + ev <= 1)
            & (t - et > 0) & (t + et < tm - etm))
    maybe = (active & (np.abs(det) + e_det > 1e-9) & (u + eu >= 0)
             & (u - eu <= 1) & (v + ev >= 0) & (u + v - eu - ev <= 1)
             & (t + et > 0) & (t - et < tm + etm))
    occluded = sure.any(axis=1)
    return maybe.any(axis=1) & ~occluded, occluded


@pytest.mark.parametrize("kind", HARD_RAY_KINDS)
def test_any_ordered_on_hard_rays(field, kind):
    """Random, grazing, edge-on and edge-crossing shadow rays toward the
    field's triangles: the plain walk's bool on every ray; on every ray
    that no float32 rounding can tip, the float64 decision over every
    triangle; and JAX's but on the measured few rays its rounding decides
    otherwise, each of them one that rounding can tip."""
    jscene, pscene = field
    geometry = pscene.geometry
    rng = np.random.default_rng(len(kind))
    o, d, tm = hard_any_rays(torch, rng, kind, geometry, s=4, h=8, w=16)
    got, plain, expect, _ = _three_way(jscene, geometry, o, d, tm)
    assert torch.equal(got, plain)
    assert 0.05 < got.float().mean().item() <= 1.0
    ambiguous, occluded = _mt_decisions(
        o.permute(0, 2, 3, 1).reshape(-1, 3).numpy(),
        d.permute(0, 2, 3, 1).reshape(-1, 3).numpy(), tm.reshape(-1).numpy(),
        geometry.tri_cols.numpy())
    got, expect = got.numpy().reshape(-1), expect.reshape(-1)
    assert ambiguous.mean() < 0.5
    np.testing.assert_array_equal(got[~ambiguous], occluded[~ambiguous])
    differ = got != expect
    assert differ.sum() == JAX_HARD_DIFFER[kind]
    assert ambiguous[differ].all()


def test_any_ordered_with_t_max_at_the_hit(field):
    """t_max the closest hit's t: the triangle at t_max does not occlude
    and nothing is nearer, so no ray is occluded, in the model as in the
    plain walk. JAX's t rounds otherwise at the last bit, so it is held to
    t_max just below and just above the hit: nothing, then every hit."""
    jscene, pscene = field
    geometry = pscene.geometry
    rng = np.random.default_rng(6)
    o, d, tm = hard_any_rays(torch, rng, "at_hit", geometry, s=4, h=8, w=16)
    got, plain, _, _ = _three_way(jscene, geometry, o, d, tm)
    assert torch.equal(got, plain) and not got.any()
    _, _, hits, _ = _three_way(jscene, geometry, o, d, tm * 2.0)
    for scale in (1.0 - 1e-4, 1.0 + 1e-4):
        got, plain, expect, _ = _three_way(jscene, geometry, o, d,
                                           tm * scale)
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), expect)
    assert expect.sum() == hits.sum() > 0


@pytest.mark.parametrize("stack", [0, 1])
def test_any_ordered_falls_back_on_a_full_stack(field, stack):
    """With a stack of 0 or 1 entry many rays would push onto a full stack:
    those are walked again by the plain walk (counted, both walks' tests
    summed), and every bool stays the plain walk's."""
    jscene, pscene = field
    geometry = pscene.geometry
    rng = np.random.default_rng(7)
    o, d, tm = hard_any_rays(torch, rng, "random", geometry, s=3, h=8, w=16)
    got, plain, expect, n = _three_way(jscene, geometry, o, d, tm,
                                       stack=stack)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), expect)
    assert n["again"].any()
    ref = {}
    bvh_any(o, d, tm, geometry, geometry.bvh, counts=ref)
    again = n["again"]
    assert (n["box"][again] > ref["box"][again]).all()


def test_any_wrappers_run_plain_on_cpu():
    """Kernels 19, 20 and 21 on CPU tensors: their plain versions, no
    launch; the kept triangle records (kernels 18-21) are kept until the
    columns are written."""
    scene = torus_field(2, "cpu")
    geometry = with_bvh(scene.geometry)
    scene = replace(scene, geometry=geometry)
    h, w = 12, 16
    feats = Features()
    _, ctx = restir.trace_primary(generate_rays(torus_field_camera(
        h, w, "cpu"), h, w), geometry, feats, restir.PLAIN)
    res = ris.gen_canonical_samples_ris(
        ctx, scene.lights, scene.num_lights, feats,
        generator=torch.Generator().manual_seed(0))
    to = res.pos - ctx.position
    tm = torch.linalg.vector_norm(to, dim=-3)
    d = to / tm.clamp_min(1e-20)[:, None]
    stats.launches.clear()
    occ = bvh_any(ctx.position + 1e-3 * d, d, tm, geometry, geometry.bvh)
    assert torch.equal(walk.any_hit_bvh(ctx.position + 1e-3 * d, d, tm,
                                        geometry), occ)
    assert torch.equal(walk.any_hit_bvh_k(ctx.position + 1e-3 * d, d, tm,
                                          geometry), occ)
    assert torch.equal(shade.final_shade_bvh(ctx, res, geometry, feats),
                       shade.final_shade_plain(ctx, res, geometry, feats))
    assert stats.launches == {}
    recs = walk.kept_records(geometry)
    assert walk.kept_records(geometry) is recs
    assert torch.equal(recs, walk.tri_records(geometry.tri_cols))
    geometry.tri_cols.mul_(1.0)  # a write bumps the version
    assert walk.kept_records(geometry) is not recs
