"""The port's neighbour selection for R-MIS / R-OMIS
(``render.neighbours``, ``ops.nbrsel``) against the JAX package's: exact
coordinates for all four strategies with JAX's own draws rebuilt, the class
counts against the Pallas selection kernel in interpret mode, and the
ranking of the kernel's sorted race (emulated here) against the plain
streamed top-D under ties."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.camera import generate_rays, make_camera
from romis_tpu.core.features import Features, NeighbourSelectionStrategy
from romis_tpu.render.neighbours import select_neighbour_indices as jax_select
from romis_tpu.render.restir import trace_primary
from romis_tpu_torch.ops import nbrsel
from romis_tpu_torch.render.neighbours import select_neighbour_indices

from chip_smoke import filtered_race
from torch_parity import occluder_scene, port_ctx, port_features

H, W, R, D = 12, 16, 3, 3
NORMAL_COS = float(np.cos(0.436332))


@pytest.fixture(scope="module")
def jax_ctx():
    """Receivers of the occluder scene (ground, soup, sky): several
    geometry ids, depths and normals to class."""
    scene = occluder_scene(ge._flagship_scene().lights)
    cam = make_camera(look_at=(0.0, -0.5, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                      distance=6.0, fov_deg=50.0, resolution=(H, W))
    _, ctx = trace_primary(generate_rays(cam, H, W), scene.geometry,
                           Features())
    return ctx


def jax_selection_noise(key, strategy, d=D, r=R):
    """The draws of the JAX XLA path for ``key``: RANDOM's uniforms
    [2, d, H, W] (split(key) → rows, cols), else one Gumbel plane per box
    offset of radius ``r`` from the scan's per-block keys (split(key,
    n_blocks), blocks of 8 offsets)."""
    if strategy == NeighbourSelectionStrategy.RANDOM:
        ky, kx = jax.random.split(key)
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(ky, (d, H, W))),
            np.asarray(jax.random.uniform(kx, (d, H, W)))]))
    n_off = (2 * r + 1) ** 2 - 1
    keys = jax.random.split(key, -(-n_off // 8))
    return torch.from_numpy(np.concatenate([
        np.asarray(jax.random.gumbel(k, (8, H, W))) for k in keys])[:n_off])


@pytest.mark.parametrize("strategy", list(NeighbourSelectionStrategy),
                         ids=lambda s: s.value)
def test_selection_matches_jax(jax_ctx, strategy):
    """Exactly JAX's coordinates, self first, for the same draws."""
    feats = Features(num_neighbours_to_sample=D, spatial_resample_radius=R,
                     neighbour_selection_strategy=strategy)
    key = jax.random.PRNGKey(5)
    jy, jx = jax_select(key, jax_ctx, H, W, feats)
    ny, nx = select_neighbour_indices(None, port_ctx(jax_ctx), H, W,
                                      port_features(feats),
                                      noise=jax_selection_noise(key, strategy))
    assert ny.dtype == torch.int32 and ny.shape == (D + 1, H, W)
    np.testing.assert_array_equal(ny.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jx))
    # Neighbours differ from self wherever the box offers D cells.
    assert (ny[1:] * W + nx[1:] != ny[0] * W + nx[0]).any()


def test_class_counts_match_pallas_kernel(jax_ctx):
    """The per-pixel similar / dissimilar counts over the in-image box
    against the Pallas kernel in interpret mode (its draws are zeros there;
    the counts do not depend on them)."""
    from jax.experimental.pallas import tpu as pltpu
    from romis_tpu.ops.pallas_nbrsel import neighbour_select_pallas

    gates = jnp.concatenate([jax_ctx.geom_id.astype(jnp.float32)[None],
                             jax_ctx.depth_t[None], jax_ctx.normal])
    outs = neighbour_select_pallas(3, gates, D, R, True, True, True, 0.1,
                                   NORMAL_COS,
                                   interpret=pltpu.InterpretParams())
    got = nbrsel.neighbour_select_plain(
        nbrsel.selection_gates(port_ctx(jax_ctx)), D, R, True, True, True,
        0.1, NORMAL_COS, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got[4].numpy(),
                                  np.asarray(outs[4]).astype(np.int32))
    counts = got[4].numpy()
    assert (counts.sum(axis=0) > 0).all() and (counts[1] > 0).any()
    # The real slots per class are min(D, count) in both.
    for cls in range(2):
        np.testing.assert_array_equal(
            np.isfinite(got[2 * cls].numpy()).sum(axis=0),
            np.minimum(D, counts[cls]))


def _sorted_race(scores, gates, two, prefer, same_geom=True, depth_frac=0.1,
                 normal_cos=0.9):
    """The selection kernel's algorithm (csrc/nbrsel.cu), per pixel in
    numpy: walk the box in order and insert into D sorted slots, a new
    entry only if strictly above the last slot, a carried entry sinking
    past lower scores or, at equal score, later offsets."""
    _, h, w = gates.shape
    offs = nbrsel.box_offsets(R)
    side = 2 * R + 1
    s_out = np.full((2, D, h, w), -np.inf, np.float32)
    p_out = np.full((2, D, h, w), -1, np.int32)
    cnt = np.zeros((2, h, w), np.int32)
    f32 = np.float32
    for y in range(h):
        for x in range(w):
            slots = [([-np.inf] * D, [-1] * D) for _ in range(2)]
            for o, (dy, dx) in enumerate(offs):
                yy, xx = y + dy, x + dx
                if not (0 <= yy < h and 0 <= xx < w):
                    continue
                sim = (not same_geom) or gates[0, yy, xx] == gates[0, y, x]
                df = abs(f32(1.0) - gates[1, y, x]
                         / max(gates[1, yy, xx], f32(1e-20)))
                nd = (gates[2, y, x] * gates[2, yy, xx]
                      + gates[3, y, x] * gates[3, yy, xx]
                      + gates[4, y, x] * gates[4, yy, xx])
                sim = sim and df <= f32(depth_frac) and nd >= f32(normal_cos)
                g = scores[o, y, x]
                if two:
                    c, sc = (0 if sim else 1), g
                    cnt[c, y, x] += 1
                else:
                    c = 0
                    cls = sim if prefer else not sim
                    sc = f32(g + (f32(1e6) if cls else f32(0.0)))
                s, p = slots[c]
                if not sc > s[-1]:
                    continue
                cs, cp = sc, (dy + R) * side + (dx + R)
                for i in range(D):
                    if cs > s[i] or (cs == s[i] and cp < p[i]):
                        s[i], cs, p[i], cp = cs, s[i], cp, p[i]
            for c in range(2):
                s_out[c, :, y, x], p_out[c, :, y, x] = slots[c]
    return s_out, p_out, cnt


@pytest.mark.parametrize("two,prefer", [(False, True), (False, False),
                                        (True, True)],
                         ids=["similar", "dissimilar", "two_classes"])
def test_sorted_race_ranks_like_the_plain_merge(two, prefer):
    """On scores quantised to halves (ties everywhere), the kernel's sorted
    race gives the plain version's slots, scores and order exactly."""
    rng = np.random.default_rng(0)
    h, w = 9, 11
    gates = np.zeros((5, h, w), np.float32)
    gates[0] = rng.integers(0, 2, (h, w))
    gates[1] = rng.uniform(1.0, 1.3, (h, w))
    n = rng.normal(size=(3, h, w)) + np.array([0, 0, 3.0])[:, None, None]
    gates[2:] = n / np.linalg.norm(n, axis=0)
    scores = (np.round(rng.normal(size=(len(nbrsel.box_offsets(R)), h, w))
                       * 2) / 2).astype(np.float32)
    got = nbrsel.neighbour_select_plain(
        torch.from_numpy(gates), D, R, two, prefer, True, 0.1, 0.9,
        scores=torch.from_numpy(scores))
    s_out, p_out, cnt = _sorted_race(scores, gates, two, prefer)
    np.testing.assert_array_equal(got[0].numpy(), s_out[0])
    np.testing.assert_array_equal(got[1].numpy(), p_out[0])
    if two:
        np.testing.assert_array_equal(got[2].numpy(), s_out[1])
        np.testing.assert_array_equal(got[3].numpy(), p_out[1])
        np.testing.assert_array_equal(got[4].numpy(), cnt)


def _filtered_race(keys, scores, gates, two, prefer, d=D, radius=R,
                   same_geom=True, depth_frac=0.1, normal_cos=0.9):
    """Kernel 16's filtered race (csrc/nbrsel.cu, Philox mode), per pixel
    in numpy: a key race per class keeps the d largest composite keys
    (class << 24 | key; the key alone with two classes); a cell whose
    composite key is not above the d-th largest is skipped, and in one
    class not gated while even its preferred composite key could not pass;
    the cells that pass wait in a queue and then enter the (score, pack)
    race in their walk order → (scores, packs, counts, cells scored, cells
    gated, gated cells of the same geometry whose depth gate the products
    leave to the division)."""
    _, h, w = gates.shape
    offs = nbrsel.box_offsets(radius)
    side = 2 * radius + 1
    pref = 1 << 24
    f32 = np.float32
    s_out = np.full((2, d, h, w), -np.inf, np.float32)
    p_out = np.full((2, d, h, w), -1, np.int32)
    cnt = np.zeros((2, h, w), np.int32)
    scored = np.zeros((h, w), np.int64)
    gated = np.zeros((h, w), np.int64)
    divided = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            kr = [[-1] * d for _ in range(2)]
            queue = []
            for o, (dy, dx) in enumerate(offs):
                yy, xx = y + dy, x + dx
                if not (0 <= yy < h and 0 <= xx < w):
                    continue
                key = int(keys[o, y, x])
                if not two and (pref | key) <= kr[0][-1]:
                    continue
                gated[y, x] += 1
                sim = (not same_geom) or gates[0, yy, xx] == gates[0, y, x]
                divided[y, x] += sim and not _depth_gate(
                    gates[1, y, x], gates[1, yy, xx], depth_frac)[1]
                df = abs(f32(1.0) - gates[1, y, x]
                         / max(gates[1, yy, xx], f32(1e-20)))
                nd = (gates[2, y, x] * gates[2, yy, xx]
                      + gates[3, y, x] * gates[3, yy, xx]
                      + gates[4, y, x] * gates[4, yy, xx])
                sim = sim and df <= f32(depth_frac) and nd >= f32(normal_cos)
                if two:
                    c, ck = (0 if sim else 1), key
                    cnt[c, y, x] += 1
                else:
                    c = 0
                    cls = sim if prefer else not sim
                    ck = (pref if cls else 0) | key
                if ck <= kr[c][-1]:
                    continue
                kr[c] = sorted(kr[c] + [ck], reverse=True)[:d]
                g = scores[o, y, x]
                sc = g if two else f32(g + (f32(1e6) if cls else f32(0.0)))
                queue.append((c, sc, (dy + radius) * side + (dx + radius)))
            scored[y, x] = len(queue)
            slots = [([-np.inf] * d, [-1] * d) for _ in range(2)]
            for c, sc, cp in queue:
                s, p = slots[c]
                if not sc > s[-1]:
                    continue
                cs = sc
                for i in range(d):
                    if cs > s[i] or (cs == s[i] and cp < p[i]):
                        s[i], cs, p[i], cp = cs, s[i], cp, p[i]
            for c in range(2):
                s_out[c, :, y, x], p_out[c, :, y, x] = slots[c]
    return s_out, p_out, cnt, scored, gated, divided


def _random_gates(rng, h, w):
    gates = np.zeros((5, h, w), np.float32)
    gates[0] = rng.integers(0, 2, (h, w))
    gates[1] = rng.uniform(1.0, 1.3, (h, w))
    n = rng.normal(size=(3, h, w)) + np.array([0, 0, 3.0])[:, None, None]
    gates[2:] = n / np.linalg.norm(n, axis=0)
    return gates


@pytest.mark.parametrize("data", ["uniform", "few_levels", "empty_slots"])
@pytest.mark.parametrize("two,prefer", [(False, True), (False, False),
                                        (True, True)],
                         ids=["similar", "dissimilar", "two_classes"])
def test_filtered_race_gives_the_plain_slots(two, prefer, data):
    """The filtered race (numpy, as the kernel runs it, and
    ``chip_smoke.filtered_race``, vectorised, which counts kernel 16's work
    for its bound on the card) gives the plain version's slots, scores,
    packs and counts exactly: on Philox keys, on keys quantised to 4 levels
    with scores floored (ties between different keys everywhere), and on a
    2x3 image where the box holds fewer cells than D slots; the two models
    skip, gate and divide the same cells."""
    rng = np.random.default_rng(4)
    h, w, d = (2, 3, 8) if data == "empty_slots" else (9, 11, D)
    gates = _random_gates(rng, h, w)
    keys = nbrsel.selection_keys(torch.tensor([0x5DEECE66D]), R, h, w)
    scores = nbrsel.gumbel_of_keys(keys)
    if data == "few_levels":
        keys = keys % 4
        scores = torch.floor(nbrsel.gumbel_of_keys(keys * (1 << 22)))
    s_out, p_out, cnt, scored, gated, divided = _filtered_race(
        keys.numpy(), scores.numpy(), gates, two, prefer, d=d)
    args = (torch.from_numpy(gates), d, R, two, prefer, True, 0.1, 0.9)
    plain = nbrsel.neighbour_select_plain(*args, scores=scores)
    counts = {}
    model = filtered_race(*args, keys, scores, counts)
    expect = ((s_out[0], p_out[0], s_out[1], p_out[1], cnt) if two
              else (s_out[0], p_out[0]))
    for e, p_, m in zip(expect, plain, model):
        np.testing.assert_array_equal(e, p_.numpy())
        np.testing.assert_array_equal(e, m.numpy())
    np.testing.assert_array_equal(counts["scored"].numpy(), scored)
    np.testing.assert_array_equal(counts["gated"].numpy(), gated)
    np.testing.assert_array_equal(counts["divided"].numpy(), divided)
    ys, xs = np.arange(h)[:, None], np.arange(w)[None]
    n_cells = sum(((ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0)
                   & (xs + dx < w)).sum() for dy, dx in nbrsel.box_offsets(R))
    assert gated.sum() <= n_cells and (gated.sum() == n_cells) == (
        two or data == "empty_slots")
    if data == "empty_slots":
        assert (p_out[0] == -1).any()  # fewer cells than slots
        assert scored.sum() == n_cells
    else:
        assert scored.sum() < n_cells


def test_selection_keys_are_the_kernels_philox_words():
    """Key plane o at pixel p is word o % 4 of Philox4x32-10 at counter
    (o // 4, p, 0, 0x4E53 << 16), shifted right by 8, for the same 64-bit
    key; ``gumbel_of_keys`` is ``gumbel_noise``'s transform of u01."""
    from romis_tpu_torch.ops.spatial import philox4x32_10

    key = 0x0123456789ABCDEF
    h, w, radius = 3, 5, 2
    keys = nbrsel.selection_keys(torch.tensor([key]), radius, h, w, chunk=2)
    n_off = (2 * radius + 1) ** 2 - 1
    assert keys.shape == (n_off, h, w) and keys.dtype == torch.int32
    k0, k1 = torch.tensor(key & 0xFFFFFFFF), torch.tensor(key >> 32)
    for o in (0, 3, 5, n_off - 1):
        for p in (0, 7, h * w - 1):
            words = philox4x32_10(
                tuple(torch.tensor([v]) for v in (o // 4, p, 0,
                                                  0x4E53 << 16)), k0, k1)
            assert keys.reshape(n_off, -1)[o, p] == words[o % 4][0] >> 8
    u = keys.double() / 2 ** 24
    g = nbrsel.gumbel_of_keys(keys)
    np.testing.assert_allclose(g.numpy(), (-np.log(-np.log(np.maximum(
        u.numpy(), 1e-37)))), rtol=1e-5, atol=1e-5)
    assert 0 <= int(keys.min()) and int(keys.max()) < 2 ** 24


def test_gumbel_of_keys_is_non_decreasing():
    """The scores the card's Philox check feeds the plain version and the
    filtered race's model (``gumbel_of_keys``, through ``torch.log``) are
    non-decreasing over all 2^24 keys, as the model's skip needs; the
    kernel's own compiled score is held to the same on the card."""
    g = nbrsel.gumbel_of_keys(torch.arange(1 << nbrsel.KEY_BITS,
                                           dtype=torch.int32))
    assert bool(torch.all(g[1:] >= g[:-1]))
    assert bool(torch.isfinite(g).all())
    assert torch.unique(g).numel() > 1 << 20


class _OnTheCard:
    """A stand-in gate block on the card: the wrapper checks it before it
    touches its data."""

    is_cuda = True
    dtype = torch.float32

    def __init__(self, h, w):
        self.shape = (5, h, w)

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("case", ["d0", "d9", "pixels", "no_noise"])
def test_wrapper_refuses_what_the_kernel_cannot_run(case):
    """Kernel 16 is built for D = 1..8, 32-bit pixel indices and a Philox
    key or injected scores; on the card anything else raises before a
    launch."""
    d, hw, match = {"d0": (0, (4, 6), "D=0"), "d9": (9, (4, 6), "D=9"),
                    "pixels": (5, (46341, 46341), "32-bit"),
                    "no_noise": (5, (4, 6), "Philox key")}[case]
    with pytest.raises(ValueError, match=match):
        nbrsel.neighbour_select(_OnTheCard(*hw), d, 3, False, True, True,
                                0.1, 0.9)


def _depth_gate(c, depth, f):
    """``csrc/nbrsel.cu``'s depth_gate in numpy float32 (IEEE rounding, as
    the kernel under --fmad=false) → (its bool, where the products
    decided it)."""
    f32 = np.float32
    f = f32(f)
    d = np.maximum(depth, f32(1e-20))
    m = 1.0 / (1 << 20)
    if 0.0 <= f < 0.5:  # depth_factors: in double, then rounded to float
        fd = float(f)
        lo_in, hi_in = f32((1.0 - fd) * (1.0 + m)), f32((1.0 + fd) * (1.0 - m))
        lo_out, hi_out = (f32((1.0 - fd) * (1.0 - m)),
                          f32((1.0 + fd) * (1.0 + m)))
    else:
        lo_in, hi_in, lo_out, hi_out = (f32(np.inf), f32(-np.inf),
                                        f32(-np.inf), f32(np.inf))
    with np.errstate(all="ignore"):
        small = d < f32(1e30)
        inside = small & (c >= d * lo_in) & (c <= d * hi_in)
        outside = small & ((c < d * lo_out) | (c > d * hi_out))
        division = np.abs(f32(1.0) - c / d) <= f
    return np.where(inside, True, np.where(outside, False, division)), \
        inside | outside, division


@pytest.mark.parametrize("frac", [0.1, 0.0, 0.3, 0.49999997, 0.5, 0.7])
def test_depth_gate_by_products_gives_the_division(frac):
    """Kernel 16 decides the depth gate |1 - c/d| <= f by two products
    except near the gate's edge: the same bool as the division on random
    depths, on depths within 40 ulps of the edge, and on zeros,
    negatives, denormals, huge values, infinities and NaNs; for f outside
    [0, 0.5) every cell divides."""
    rng = np.random.default_rng(9)
    f32 = np.float32
    n = 200_000
    d = np.exp(rng.uniform(-5, 5, n)).astype(f32)
    c = (d * rng.uniform(0.5, 1.5, n)).astype(f32)
    edge = (d * f32(1.0 + frac * rng.choice([-1.0, 1.0], n))).astype(f32)
    edge = (edge.view(np.int32) + rng.integers(-40, 41, n).astype(np.int32)
            ).view(f32)
    special = np.array([0.0, -0.0, -1.0, 1e-45, 1e-38, 1e-20, 1e-19, 1e30,
                        3e38, np.inf, -np.inf, np.nan], f32)
    cs = np.concatenate([c, edge, np.repeat(special, len(special)),
                         special[:, None].repeat(64, 1).ravel()])
    ds = np.concatenate([d, d, np.tile(special, len(special)),
                         np.tile(d[:64], len(special))])
    got, decided, division = _depth_gate(cs, ds, frac)
    np.testing.assert_array_equal(got, division)
    if 0.0 <= frac < 0.5:
        assert decided[:n].mean() > 0.999
    else:
        assert not decided.any()
