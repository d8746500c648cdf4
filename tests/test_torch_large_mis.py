"""The port's R-MIS and R-OMIS on a scene above the soup kernels' 2048
triangles (the 2x2 torus field with the JAX package's BVH carried across)
against the JAX package's XLA formulation, which walks the same tree on the
CPU: R-OMIS direct and R-MIS equal frames, the sweep's ``ext_vis`` mode
against the sweep that traces its own shadow rays, in its four modes, and a
soup of that size without a BVH refusing, naming ``with_bvh``."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from romis_tpu.core.camera import generate_rays, make_camera
from romis_tpu.core.features import Features, RayTraceMode
from romis_tpu.ops.bvh import with_bvh as jax_with_bvh
from romis_tpu.ops.wrs import gen_canonical_samples
from romis_tpu.render.neighbours import select_neighbour_indices
from romis_tpu.render.restir import trace_primary
from romis_tpu.render.rmis import PH_ITER, PH_NEIGHBOURS, render_rmis
from romis_tpu.render.romis import render_romis
from romis_tpu_torch.ops import mis
from romis_tpu_torch.ops.shade import pack_center_ctx
from romis_tpu_torch.render.pipeline import render_frame
from romis_tpu_torch.render.rmis import mis_ext_vis, mis_offsets

from torch_parity import (
    jax_ris_uniforms, jax_torus_field, port_bvh_scene, port_camera,
    port_ctx, port_features, port_reservoirs, t,
)
from test_torch_nbrsel import jax_selection_noise

CAM = dict(look_at=(0.0, -0.3, 0.0), distance=6.0, fov_deg=50.0)


@pytest.fixture(scope="module")
def field():
    """(JAX scene with its BVH, the port's scene with the same tree)."""
    jscene = jax_torus_field(2)
    jscene.geometry = jax_with_bvh(jscene.geometry)
    return jscene, port_bvh_scene(jscene)


H, W, S, K, D, R = 12, 16, 8, 2, 3, 3
MIS_FEATS = Features(initial_light_samples=S, num_samples_in_reservoir=K,
                     num_neighbours_to_sample=D, spatial_resample_radius=R,
                     max_iterations_mis=3)


@pytest.mark.parametrize("mode", ["romis_direct", "rmis_equal"])
def test_mis_frames_match_jax(field, mode):
    """A whole R-OMIS (direct) or R-MIS (equal weights) frame through
    render_frame on JAX's rebuilt draws, rtol 1e-4; the port's sweep runs
    in its ext_vis mode, JAX's XLA formulation walks the tree itself."""
    jscene, scene = field
    feats = MIS_FEATS.replace(ray_trace_mode=(
        RayTraceMode.RMIS if mode == "rmis_equal" else RayTraceMode.ROMIS))
    jcam = make_camera(rotation_deg=(25.0, 30.0, 0.0), resolution=(H, W),
                       **CAM)
    fn = render_rmis if mode == "rmis_equal" else render_romis
    key = jax.random.PRNGKey(6)
    expect = np.asarray(jax.jit(fn, static_argnums=(4, 5, 6, 7))(
        key, jcam, jscene.geometry, jscene.lights, jscene.num_lights, H, W,
        feats))
    it_keys = jax.random.split(jax.random.fold_in(key, PH_ITER),
                               feats.max_iterations_mis)
    noise = (jax_selection_noise(jax.random.fold_in(key, PH_NEIGHBOURS),
                                 feats.neighbour_selection_strategy),
             torch.from_numpy(np.stack([jax_ris_uniforms(k, S, K, H, W)
                                        for k in it_keys])))
    got, _ = render_frame(None, port_camera(jcam), scene, H, W,
                          port_features(feats), noise=noise)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-5)
    assert float(expect.mean()) > 0.05


@pytest.mark.parametrize("mode", ["rmis_equal", "rmis_balance", "romis",
                                  "romis_progressive"])
def test_ext_vis_sweep_equals_traced_sweep(field, mode):
    """The plain sweep fed ``mis_ext_vis`` planes equals the plain sweep
    that traces its own shadow rays (through the plain traversal), in all
    four modes, on JAX's receivers, neighbourhoods and reservoirs."""
    jscene, scene = field
    jcam = make_camera(rotation_deg=(25.0, 30.0, 0.0), resolution=(H, W),
                       **CAM)
    _, jctx = trace_primary(generate_rays(jcam, H, W), jscene.geometry,
                            MIS_FEATS)
    key = jax.random.PRNGKey(8)
    ny, nx = select_neighbour_indices(key, jctx, H, W, MIS_FEATS)
    res = gen_canonical_samples(jax.random.fold_in(key, 1), jctx,
                                jscene.lights, jscene.num_lights,
                                jscene.geometry, MIS_FEATS)
    m = "romis" if mode.startswith("romis") else mode
    ctx = port_ctx(jctx)
    cen = pack_center_ctx(ctx)
    offs = mis_offsets(t(ny), t(nx))
    pack = mis.pack_mis_reservoirs(port_reservoirs(res), m == "romis")
    nbr_ctx = None if m == "rmis_equal" else mis.resolve_neighbour_ctx(cen,
                                                                       offs)
    alphas = None
    if mode == "romis_progressive":
        alphas = torch.from_numpy(np.random.default_rng(2).uniform(
            -0.5, 0.5, (3 * (D + 1), H, W)).astype(np.float32))
    ext = mis_ext_vis(ctx, pack[:3 * K], offs, scene.geometry, K)
    assert ext.shape == ((D + 1) * K, H, W) and 0 < float(ext.mean()) < 1
    kw = dict(nbr_ctx=nbr_ctx, alphas=alphas)
    args = (cen, pack, offs, scene.geometry, K, m, scene.num_lights,
            port_features(MIS_FEATS))
    traced = mis.mis_iteration_plain(*args, **kw)
    fed = mis.mis_iteration_plain(*args, ext_vis=ext, **kw)
    traced = traced if isinstance(traced, tuple) else (traced,)
    fed = fed if isinstance(fed, tuple) else (fed,)
    for a, b in zip(fed, traced):
        assert torch.equal(a, b)
    assert float(traced[0].abs().max()) > 0


def test_soup_above_the_kernels_without_bvh_refuses_mis(field):
    """R-MIS / R-OMIS on a soup above 2048 triangles without a BVH refuses,
    naming with_bvh; with the BVH the same scene renders (above)."""
    _, scene = field
    soup = dataclasses.replace(scene, geometry=dataclasses.replace(
        scene.geometry, bvh=None))
    cam = port_camera(make_camera(rotation_deg=(25.0, 30.0, 0.0),
                                  resolution=(4, 4), **CAM))
    with pytest.raises(ValueError, match="with_bvh"):
        render_frame(torch.Generator(), cam, soup, 4, 4, port_features(
            MIS_FEATS.replace(ray_trace_mode=RayTraceMode.RMIS)))
