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


def jax_selection_noise(key, strategy):
    """The draws of the JAX XLA path for ``key``: RANDOM's uniforms
    [2, D, H, W] (split(key) → rows, cols), else one Gumbel plane per box
    offset from the scan's per-block keys (split(key, n_blocks), blocks of
    8 offsets)."""
    if strategy == NeighbourSelectionStrategy.RANDOM:
        ky, kx = jax.random.split(key)
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(ky, (D, H, W))),
            np.asarray(jax.random.uniform(kx, (D, H, W)))]))
    n_off = (2 * R + 1) ** 2 - 1
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
