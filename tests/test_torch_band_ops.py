"""The kernels' band entries (``ops.band``) on the CPU, where each wrapper
runs its plain version with the same band arguments. A row band's call, on
planes cut from the whole frame's with a halo of radius rows (zeros beyond
the frame, as an edge rank's), equals the whole frame's call's rows bit
for bit: kernels 3, 14 and 15 (the RIS, the surrogate's replay RIS and
the MIS RIS), 5 and 11 (the spatial
passes, 11 also in its vis_check mode), 16 (the neighbour selection in its
three similarity strategies) and 17 (the MIS sweep in its four modes and
with ext_vis), on injected noise and on the generator's draws. Band
arguments that do not fit the planes are refused."""

import numpy as np
import pytest
import torch

from romis_tpu_torch import Features, MISWeight, NeighbourSelectionStrategy
from romis_tpu_torch.core.camera import generate_rays
from romis_tpu_torch.core.types import pack_reservoir_planes
from romis_tpu_torch.ops import mis, nbrsel, ris, spatial
from romis_tpu_torch.ops.shade import pack_center_ctx
from romis_tpu_torch.ops.wrs import gen_canonical_samples_plain
from romis_tpu_torch.render import restir
from romis_tpu_torch.render.neighbours import select_neighbour_indices
from romis_tpu_torch.render.rmis import mis_ext_vis, mis_offsets
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

H, W, K, S, R, RADIUS = 16, 32, 2, 8, 3, 3
FEATS = Features(initial_light_samples=S, num_samples_in_reservoir=K,
                 num_neighbours_to_sample=R, spatial_resample_radius=RADIUS,
                 max_iterations_mis=2)
# (world, rank) of the bands: the edges and an inner band.
BANDS = [(2, 0), (2, 1), (4, 0), (4, 2), (4, 3)]
BAND_IDS = [f"{r}of{w}" for w, r in BANDS]


def _band(world, rank):
    h = H // world
    return h, rank * h


def rows(t, world, rank):
    h, base = _band(world, rank)
    return t[..., base:base + h, :]


def extended(t, world, rank, halo=RADIUS):
    """The band's rows inside a halo cut from the whole frame's planes."""
    h, base = _band(world, rank)
    pad = torch.nn.functional.pad(t, (0, 0, halo, halo))
    return pad[..., base:base + h + 2 * halo, :]


@pytest.fixture(scope="module")
def frame():
    """The flagship scene's receivers at 16x32 and canonical reservoirs."""
    scene, cam = flagship_scene("cpu"), flagship_camera(H, W, "cpu")
    _, ctx = restir.trace_primary(generate_rays(cam, H, W), scene.geometry,
                                  FEATS, restir.PLAIN)
    res = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      FEATS, torch.Generator().manual_seed(1))
    return scene, ctx, res


def _ctx_rows(ctx, world, rank):
    from dataclasses import fields, replace

    return replace(ctx, **{f.name: rows(getattr(ctx, f.name), world, rank)
                           for f in fields(ctx)})


@pytest.mark.parametrize("world,rank", BANDS, ids=BAND_IDS)
def test_ris_band(frame, world, rank):
    """Kernel 3's and kernel 15's bands draw the frame's numbers."""
    scene, ctx, _ = frame
    band = dict(row_base=_band(world, rank)[1], h_global=H)
    args = (scene.lights, scene.num_lights, FEATS)
    full = ris.gen_canonical_samples_ris(
        ctx, *args, generator=torch.Generator().manual_seed(2))
    got = ris.gen_canonical_samples_ris(
        _ctx_rows(ctx, world, rank), *args,
        generator=torch.Generator().manual_seed(2), **band)
    assert torch.equal(pack_reservoir_planes(got),
                       rows(pack_reservoir_planes(full), world, rank))
    for romis in (False, True):
        full = ris.gen_mis_reservoir_planes(
            ctx, *args, 2, romis, generator=torch.Generator().manual_seed(3))
        got = ris.gen_mis_reservoir_planes(
            _ctx_rows(ctx, world, rank), *args, 2, romis,
            generator=torch.Generator().manual_seed(3), **band)
        assert torch.equal(got, rows(full, world, rank))


@pytest.mark.parametrize("draws", ["uniforms", "generator"])
@pytest.mark.parametrize("world,rank", BANDS, ids=BAND_IDS)
def test_replay_band(frame, world, rank, draws):
    """Kernel 14's band: the plain replay with the band's arguments gives
    the whole frame's w_sum and both races' records in the band's rows,
    on the frame's uniforms cut to them and on the generator's draws."""
    scene, ctx, _ = frame
    band = dict(row_base=_band(world, rank)[1], h_global=H)
    args = (scene.lights, scene.num_lights, FEATS)
    uni = None
    if draws == "uniforms":
        uni = torch.rand((S // K, 5, K, H, W),
                         generator=torch.Generator().manual_seed(5))
    full = ris.gen_canonical_replay(
        ctx, *args, generator=torch.Generator().manual_seed(5), uniforms=uni)
    got = ris.gen_canonical_replay(
        _ctx_rows(ctx, world, rank), *args,
        generator=torch.Generator().manual_seed(5),
        uniforms=None if uni is None else rows(uni, world, rank), **band)
    flat = [full[0], *full[1], *full[2]]
    for g, f in zip([got[0], *got[1], *got[2]], flat):
        assert torch.equal(g, rows(f, world, rank))
    assert float(full[0].max()) > 0


def _pass_inputs(frame):
    _, ctx, res = frame
    return (pack_reservoir_planes(res), spatial.pack_gates(ctx),
            pack_center_ctx(ctx))


@pytest.mark.parametrize("draws", ["inject", "generator"])
@pytest.mark.parametrize("world,rank", BANDS, ids=BAND_IDS)
def test_spatial_pass_band(frame, world, rank, draws):
    """Kernel 5's band: its neighbours' rows clamped to the frame."""
    res, gates, cen = _pass_inputs(frame)
    inject = spatial.spatial_noise(torch.Generator().manual_seed(4), R, K,
                                   RADIUS, H, W)

    def noise(band):
        if draws == "generator":
            return dict(generator=torch.Generator().manual_seed(5))
        return dict(inject=inject if not band else
                    tuple(rows(t, world, rank) for t in inject))

    full = spatial.spatial_pass_fused(res, gates, cen, K, R, RADIUS, FEATS,
                                      **noise(False))
    got = spatial.spatial_pass_fused(
        *(extended(t, world, rank) for t in (res, gates, cen)), K, R, RADIUS,
        FEATS, row_base=_band(world, rank)[1], h_global=H, **noise(True))
    assert torch.equal(got, rows(full, world, rank))
    # The pass pooled neighbours (where the rows see the ground).
    assert float(full[7 * K:8 * K].max()) > S / K


@pytest.mark.parametrize("vis", [False, True], ids=["plain", "vis_check"])
@pytest.mark.parametrize("world,rank", BANDS, ids=BAND_IDS)
def test_unbiased_pass_band(frame, world, rank, vis):
    """Kernel 11's band: the neighbours' contexts from the halo; in the
    vis_check mode the block of Z terms too."""
    scene = frame[0]
    res, _, cen = _pass_inputs(frame)
    inject = spatial.spatial_noise(torch.Generator().manual_seed(6), R, K,
                                   RADIUS, H, W)
    band_inject = tuple(rows(t, world, rank) for t in inject)
    ext = [extended(t, world, rank) for t in (res, cen)]
    band = dict(row_base=_band(world, rank)[1], h_global=H)
    if vis:
        full = spatial.spatial_pass_unbiased_vis(res, cen, K, R, RADIUS,
                                                 FEATS, inject=inject)
        got = spatial.spatial_pass_unbiased_vis(*ext, K, R, RADIUS, FEATS,
                                                inject=band_inject, **band)
        for g, f in zip(got, full):
            assert torch.equal(g, rows(f, world, rank))
        return
    feats = FEATS.replace(unbiased_combination=True)
    full = spatial.spatial_pass_unbiased_fused(res, cen, K, R, RADIUS, feats,
                                               inject=inject,
                                               geometry=scene.geometry)
    got = spatial.spatial_pass_unbiased_fused(*ext, K, R, RADIUS, feats,
                                              inject=band_inject,
                                              geometry=scene.geometry, **band)
    assert torch.equal(got, rows(full, world, rank))


@pytest.mark.parametrize("draws", ["scores", "generator"])
@pytest.mark.parametrize("strategy", ["similar", "dissimilar", "two"])
@pytest.mark.parametrize("world,rank", BANDS, ids=BAND_IDS)
def test_neighbour_select_band(frame, world, rank, strategy, draws):
    """Kernel 16's band: the box's cells in the frame's rows."""
    ctx = frame[1]
    gates = nbrsel.selection_gates(ctx)
    two = strategy == "two"
    args = (3, RADIUS, two, strategy != "dissimilar", True, 0.1,
            float(np.cos(0.436332)))
    scores = nbrsel.selection_noise(torch.Generator().manual_seed(7),
                                    RADIUS, H, W)

    def noise(band):
        if draws == "generator":
            return dict(generator=torch.Generator().manual_seed(8))
        return dict(scores=rows(scores, world, rank) if band else scores)

    full = nbrsel.neighbour_select(gates, *args, **noise(False))
    got = nbrsel.neighbour_select(extended(gates, world, rank), *args,
                                  row_base=_band(world, rank)[1], h_global=H,
                                  **noise(True))
    assert len(got) == (5 if two else 2)
    for g, f in zip(got, full):
        assert torch.equal(g, rows(f, world, rank))


MIS_MODES = ["rmis_equal", "rmis_balance", "romis", "romis_progressive",
             "romis_ext_vis"]


@pytest.mark.parametrize("mode", MIS_MODES)
@pytest.mark.parametrize("world,rank", BANDS, ids=BAND_IDS)
def test_mis_iteration_band(frame, world, rank, mode):
    """Kernel 17's band: the pack's members from the halo."""
    scene, ctx, _ = frame
    feats = FEATS.replace(
        mis_weight_rmis=MISWeight.BALANCE,
        neighbour_selection_strategy=NeighbourSelectionStrategy.RANDOM)
    sweep_mode = "romis" if mode.startswith("romis") else mode
    romis = sweep_mode == "romis"
    ny, nx = select_neighbour_indices(torch.Generator().manual_seed(9), ctx,
                                      H, W, feats)
    offs = mis_offsets(ny, nx)
    cen = pack_center_ctx(ctx)
    pack = ris.gen_mis_reservoir_planes(
        ctx, scene.lights, scene.num_lights, feats, 2, romis,
        generator=torch.Generator().manual_seed(10))
    nbr_ctx = mis.resolve_neighbour_ctx(cen, offs)
    alphas = torch.rand((3 * (R + 1), H, W),
                        generator=torch.Generator().manual_seed(11)) \
        if mode == "romis_progressive" else None
    ext_vis = None
    if mode == "romis_ext_vis":
        c_res = mis.mis_pack_planes("romis", K)
        ext_vis = mis_ext_vis(ctx, pack[c_res:c_res + 3 * K], offs,
                              scene.geometry, K, restir.PLAIN)
    kw = dict(nbr_ctx=None if sweep_mode == "rmis_equal" else nbr_ctx,
              alphas=alphas, it_block=1, ext_vis=ext_vis)
    full = mis.mis_iteration(cen, pack, offs, scene.geometry, K, sweep_mode,
                             scene.num_lights, feats, **kw)
    band_kw = {k: v if v is None or k == "it_block" else
               rows(v, world, rank) for k, v in kw.items()}
    got = mis.mis_iteration(
        rows(cen, world, rank), extended(pack, world, rank),
        rows(offs, world, rank), scene.geometry, K, sweep_mode,
        scene.num_lights, feats, row_base=_band(world, rank)[1], h_global=H,
        **band_kw)
    for g, f in zip(got if romis else (got,), full if romis else (full,)):
        assert torch.equal(g, rows(f, world, rank))


def test_band_arguments_refused(frame):
    """A band outside the frame, planes that cannot hold the band inside
    its halo, and a halo pack without a band are refused."""
    scene, ctx, _ = frame
    res, gates, cen = _pass_inputs(frame)
    inject = spatial.spatial_noise(torch.Generator().manual_seed(4), R, K,
                                   RADIUS, H, W)
    with pytest.raises(ValueError, match="outside the frame"):
        spatial.spatial_pass_fused(
            *(extended(t, 2, 1) for t in (res, gates, cen)), K, R, RADIUS,
            FEATS, inject=tuple(rows(t, 2, 1) for t in inject), row_base=12,
            h_global=H)
    with pytest.raises(ValueError, match="halo"):
        nbrsel.neighbour_select(gates[:, :5], 3, RADIUS, False, True, True,
                                0.1, 0.9, scores=torch.zeros(48, 0, W),
                                row_base=0, h_global=H)
    with pytest.raises(ValueError, match="without h_global"):
        ris.gen_canonical_samples_ris(ctx, scene.lights, scene.num_lights,
                                      FEATS, torch.Generator(), row_base=4)
    with pytest.raises(ValueError, match="outside the frame"):
        ris.gen_canonical_replay(ctx, scene.lights, scene.num_lights, FEATS,
                                 torch.Generator(), row_base=4, h_global=H)
    with pytest.raises(ValueError, match="halo"):
        mis.gather_neighbourhood(res[:7 * K, :H - 1], torch.zeros(
            2 * R, H, W, dtype=torch.int32), "rmis_equal", K)
