"""The port's sharded R-MIS / R-OMIS frames (``romis_tpu_torch.parallel.
mis``) on the CPU, in four gloo ranks spawned once that run every case
(``torch_ranks.mis_body``) at world sizes 1, 2 (two subgroups) and 4:

- against the JAX package's ``render_rmis_sharded`` (equal and balance
  weights) and ``render_romis_sharded`` (direct and progressive, with the
  α images) on its 4-device CPU mesh, with the reference's ``inject`` (the
  frame's neighbourhoods and per-iteration reservoirs), after
  ``tests/test_parallel_mis.py``; rtol 1e-4, atol 1e-5 as the frame tests,
  on the scenes ``tests/test_torch_mis.py`` chose for them; and on the
  same injected draws, bit for bit against the port's single-device
  frame;
- against the port's own single-device frames, bit for bit, without
  injected noise: R-MIS balance (two classes of neighbours) and
  progressive R-OMIS on the occluder scene, and R-OMIS direct on the torus
  field with its BVH (the sweep's ext_vis rays).
"""

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.camera import generate_rays, make_camera
from romis_tpu.core.features import (
    Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
)
from romis_tpu.ops.wrs import gen_canonical_samples
from romis_tpu.parallel.mesh import make_mesh
from romis_tpu.parallel.mis import (
    render_rmis_sharded as jax_rmis_sharded,
    render_romis_sharded as jax_romis_sharded,
)
from romis_tpu.render.neighbours import select_neighbour_indices
from romis_tpu.render.restir import trace_primary
from romis_tpu_torch.core.camera import make_camera as port_make_camera
from romis_tpu_torch.ops.bvh import with_bvh
from romis_tpu_torch.scene.scene import torus_field, torus_field_camera

import torch_ranks
from torch_parity import (
    occluder_scene, port_camera, port_features, port_reservoirs, port_scene,
    t,
)

H, W = 16, 32
FEATS = Features(initial_light_samples=8, num_samples_in_reservoir=2,
                 num_neighbours_to_sample=3, spatial_resample_radius=3,
                 max_iterations_mis=3)
OCCLUDER_CAM = dict(look_at=(0.0, -0.5, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                    distance=6.0, fov_deg=50.0)
JAX_MODES = ["rmis_equal", "rmis_balance", "romis_direct",
             "romis_progressive"]
EQUAL_CASES = ["rmis_balance", "romis_progressive", "bvh_romis"]


def _jax_case(mode):
    """(JAX scene, camera, Features) of a mode, as tests/test_torch_mis.py
    chose them: the flagship quad, and for progressive R-OMIS the occluder
    scene with random neighbourhoods and α refreshed every second
    iteration (the flat quad's technique matrix is near rank one there)."""
    feats = FEATS.replace(
        ray_trace_mode=(RayTraceMode.RMIS if mode.startswith("rmis")
                        else RayTraceMode.ROMIS),
        mis_weight_rmis=(MISWeight.BALANCE if mode == "rmis_balance"
                         else MISWeight.EQUAL),
        use_progressive_romis=mode == "romis_progressive")
    if mode != "romis_progressive":
        return ge._flagship_scene(), ge._flagship_camera(H, W), feats
    feats = feats.replace(
        max_iterations_mis=5, progressive_update_mod=2,
        neighbour_selection_strategy=NeighbourSelectionStrategy.RANDOM)
    return (occluder_scene(ge._flagship_scene().lights),
            make_camera(resolution=(H, W), **OCCLUDER_CAM), feats)


def _inject(jscene, jcam, feats):
    """The reference's hook: the frame's neighbourhoods and one canonical
    reservoir set per iteration."""
    key = jax.random.PRNGKey(3)

    @jax.jit
    def draws(key):
        _, ctx = trace_primary(generate_rays(jcam, H, W), jscene.geometry,
                               feats)
        ny, nx = select_neighbour_indices(key, ctx, H, W, feats)
        keys = jax.random.split(jax.random.fold_in(key, 9),
                                feats.max_iterations_mis)
        return ny, nx, [gen_canonical_samples(
            k, ctx, jscene.lights, jscene.num_lights, jscene.geometry, feats)
            for k in keys]
    return key, draws(key)


def _equal_cases():
    from romis_tpu_torch import Features as PortFeatures
    from romis_tpu_torch import MISWeight as PortWeight
    from romis_tpu_torch import NeighbourSelectionStrategy as PortStrategy
    from romis_tpu_torch import RayTraceMode as PortMode

    occ = port_scene(occluder_scene(ge._flagship_scene().lights))
    cam = port_make_camera(resolution=(H, W), device="cpu", **OCCLUDER_CAM)
    field = torus_field(1, "cpu")
    field.geometry = with_bvh(field.geometry)
    base = dict(initial_light_samples=8, num_neighbours_to_sample=3,
                spatial_resample_radius=3, max_iterations_mis=3)
    return {
        "rmis_balance": (occ, [cam], PortFeatures(
            ray_trace_mode=PortMode.RMIS, mis_weight_rmis=PortWeight.BALANCE,
            neighbour_selection_strategy=(
                PortStrategy.EQUAL_SIMILAR_DISSIMILAR), **base), 4, (H, W)),
        "romis_progressive": (occ, [cam], PortFeatures(
            ray_trace_mode=PortMode.ROMIS, use_progressive_romis=True,
            **base), 5, (H, W)),
        "bvh_romis": (field, [torus_field_camera(H, W, "cpu")], PortFeatures(
            ray_trace_mode=PortMode.ROMIS,
            neighbour_selection_strategy=PortStrategy.RANDOM, **base), 6,
            (H, W)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    jax_cases, port_inputs = {}, {}
    for mode in JAX_MODES:
        jscene, jcam, feats = _jax_case(mode)
        key, (ny, nx, res) = _inject(jscene, jcam, feats)
        jax_cases[mode] = (jscene, jcam, feats, key, (ny, nx, res))
        port_inputs[mode] = (port_scene(jscene), port_camera(jcam),
                             port_features(feats),
                             (t(ny), t(nx), [port_reservoirs(r)
                                             for r in res]), (H, W))
    out, single = torch_ranks.spawn(str(d), "mis", dict(
        jax=port_inputs, equal=_equal_cases()))
    return dict(out=out, single=single, jax=jax_cases)


@pytest.fixture(scope="module")
def jax_expect(runs):
    """mode → the reference's sharded frame on its 4-device mesh with the
    injected draws: the image (R-MIS), or the image and α images
    (R-OMIS)."""
    mesh = make_mesh(4)
    out = {}
    for mode, (jscene, jcam, feats, key, inject) in runs["jax"].items():
        if mode.startswith("rmis"):
            fn = lambda inj: jax_rmis_sharded(  # noqa: E731
                key, jcam, jscene.geometry, jscene.lights, jscene.num_lights,
                H, W, feats, mesh, inject=inj)
        else:
            fn = lambda inj: jax_romis_sharded(  # noqa: E731
                key, jcam, jscene.geometry, jscene.lights, jscene.num_lights,
                H, W, feats, mesh, return_alphas=True, inject=inj)
        out[mode] = jax.tree.map(np.asarray, jax.jit(fn)(inject))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", JAX_MODES)
def test_sharded_mis_matches_jax(runs, jax_expect, mode, world):
    """The port's sharded frame with the reference's ``inject`` against the
    reference's sharded frame (the image, and for R-OMIS the α images)."""
    # Progressive R-OMIS re-solves α from a near-singular technique matrix
    # every second iteration; float32 rounding apart between XLA and
    # PyTorch moves 3 of its 1536 values by up to 1.04e-4 (relative
    # 1.7e-4) on this input, in the single-device frames too (the
    # reference's sharded frame equals its single-device one exactly here,
    # and the port's sharded frame its own single-device one bit for bit,
    # test_sharded_mis_inject_equals_single).
    atol = 2e-4 if mode == "romis_progressive" else 1e-5
    expect = jax_expect[mode]
    got = runs["out"][world][0][mode]
    if mode.startswith("romis"):
        (got, got_alphas), (expect, alphas) = got, expect
        # The α of one technique is ill-determined where the techniques'
        # matrix is near singular, and ulps between XLA and PyTorch move
        # it there; their sum over the techniques is the estimate, and is
        # compared (as tests/test_parallel_mis.py compares the reference's
        # own sharded α).
        assert got_alphas.shape == alphas.shape
        np.testing.assert_allclose(got_alphas.sum(dim=0).numpy(),
                                   alphas.sum(axis=0), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=atol)
    assert float(expect.mean()) > 0.05


@pytest.mark.parametrize("world", torch_ranks.WORLDS)
@pytest.mark.parametrize("case", EQUAL_CASES)
def test_sharded_mis_equals_single(runs, case, world):
    """Without injected noise the sharded frame is the single-device frame
    bit for bit."""
    (want,), _ = runs["single"]["equal"][case]
    (got,), _ = runs["out"][world][0]["equal"][case]
    assert torch.equal(got, want)
    assert float(want.mean()) > 0.01


@pytest.mark.parametrize("world", torch_ranks.WORLDS)
@pytest.mark.parametrize("mode", JAX_MODES)
def test_sharded_mis_inject_equals_single(runs, mode, world):
    """On the reference's injected draws the sharded frame is the port's
    single-device frame bit for bit (R-OMIS: the α images too)."""
    want = runs["single"]["inject"][mode]
    got = runs["out"][world][0][mode]
    for g, w in zip(*((got, want) if mode.startswith("romis")
                      else ((got,), (want,)))):
        assert torch.equal(g, w)
