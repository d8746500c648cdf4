"""The port's frames with the unbiased combine's Z-count visibility check,
and the two repaired features, against the JAX package: a vis-check frame
pair on the occluder scene (Z really loses occluded inputs) and on the 2x2
torus field with its BVH (JAX without ``jit``, as in
``test_torch_large.py``); ``enable_shading=False`` ReSTIR and R-OMIS
frames; and the spatial passes' gate on ``fused_spatial_gather``, held on
a stand-in tensor whose ``is_cuda`` is True (CPU tensors never take the
fused branch)."""

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.camera import make_camera
from romis_tpu.core.features import Features, RayTraceMode
from romis_tpu.ops.bvh import with_bvh as jax_with_bvh
from romis_tpu.render.restir import (
    initial_temporal_state as jax_initial_state,
    render_restir_frame as jax_render_frame,
)
from romis_tpu.render.rmis import PH_ITER, PH_NEIGHBOURS
from romis_tpu.render.romis import render_romis as jax_render_romis
from romis_tpu_torch.render import restir
from romis_tpu_torch.render.pipeline import render_frame

from test_torch_nbrsel import jax_selection_noise
from torch_parity import (
    jax_frame_noise, jax_ris_uniforms, jax_torus_field, occluder_scene,
    port_bvh_scene, port_camera, port_features, port_scene,
)

VIS = dict(unbiased_combination=True, spatial_reuse_visibility_check=True)
OCCLUDER_CAM = dict(look_at=(0.0, -0.5, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                    distance=6.0, fov_deg=50.0)


def _frames(jscene, scene, jcam, feats, h, w, n, jit=True):
    """n frames carrying the temporal state, JAX's draws replayed → (JAX
    images, the port's images)."""
    fn = jax.jit(jax_render_frame, static_argnums=(4, 5, 6, 7)) if jit \
        else jax_render_frame
    cam = port_camera(jcam)
    k = feats.num_samples_in_reservoir
    jstate, state = jax_initial_state(h, w, k, jcam), None
    expect, got = [], []
    for f in range(n):
        key = jax.random.PRNGKey(30 + f)
        img, jstate = fn(key, jcam, jscene.geometry, jscene.lights,
                         jscene.num_lights, h, w, feats, jstate)
        expect.append(np.asarray(img))
        img, state = render_frame(None, cam, scene, h, w,
                                  port_features(feats), state,
                                  noise=jax_frame_noise(key, feats, h, w))
        got.append(img.numpy())
    return expect, got


def test_vischeck_frames_on_the_occluder_scene_match_jax():
    """Two frames with the visibility check on the ground under the random
    soup, rtol 1e-4; the check changes the image there (occluded inputs
    leave Z)."""
    h, w = 16, 24
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=3, **VIS)
    jscene = occluder_scene(ge._flagship_scene().lights)
    scene = port_scene(jscene)
    jcam = make_camera(resolution=(h, w), **OCCLUDER_CAM)
    expect, got = _frames(jscene, scene, jcam, feats, h, w, 2)
    for f in range(2):
        np.testing.assert_allclose(got[f], expect[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f"frame {f}")
    _, novis = _frames(jscene, scene, jcam, feats.replace(
        spatial_reuse_visibility_check=False), h, w, 2)
    assert np.abs(novis[1] - got[1]).max() > 1e-3
    assert float(np.mean(expect)) > 0.05


def test_vischeck_frames_on_a_bvh_match_jax():
    """The 2x2 torus field (3,874 triangles) with the JAX package's BVH
    carried across: the Z rays walk the tree (on the card kernel 20)."""
    h, w = 16, 24
    jscene = jax_torus_field(2)
    jscene.geometry = jax_with_bvh(jscene.geometry)
    scene = port_bvh_scene(jscene)
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=3, **VIS)
    jcam = make_camera(look_at=(0.0, -0.3, 0.0), rotation_deg=(25.0, 30.0,
                                                               0.0),
                       distance=6.0, fov_deg=50.0, resolution=(h, w))
    expect, got = _frames(jscene, scene, jcam, feats, h, w, 2, jit=False)
    for f in range(2):
        np.testing.assert_allclose(got[f], expect[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f"frame {f}")
    assert float(np.mean(expect)) > 0.05


def test_unshaded_restir_frames_match_jax():
    """enable_shading=False: every shade is kd and every p̂ its norm."""
    h, w = 12, 16
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=3, enable_shading=False)
    jscene = ge._flagship_scene()
    expect, got = _frames(jscene, port_scene(jscene),
                          ge._flagship_camera(h, w), feats, h, w, 2)
    for f in range(2):
        np.testing.assert_allclose(got[f], expect[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f"frame {f}")
    assert float(np.mean(expect)) > 0.05


def test_unshaded_romis_frame_matches_jax():
    h, w, s, k = 12, 16, 8, 2
    feats = Features(ray_trace_mode=RayTraceMode.ROMIS, enable_shading=False,
                     initial_light_samples=s, num_neighbours_to_sample=3,
                     spatial_resample_radius=3, max_iterations_mis=3)
    jscene, jcam = ge._flagship_scene(), ge._flagship_camera(h, w)
    key = jax.random.PRNGKey(3)
    expect = np.asarray(jax.jit(jax_render_romis, static_argnums=(4, 5, 6, 7))(
        key, jcam, jscene.geometry, jscene.lights, jscene.num_lights, h, w,
        feats))
    it_keys = jax.random.split(jax.random.fold_in(key, PH_ITER),
                               feats.max_iterations_mis)
    noise = (jax_selection_noise(jax.random.fold_in(key, PH_NEIGHBOURS),
                                 feats.neighbour_selection_strategy),
             torch.from_numpy(np.stack([jax_ris_uniforms(kk, s, k, h, w)
                                        for kk in it_keys])))
    got, _ = render_frame(None, port_camera(jcam), port_scene(jscene), h, w,
                          port_features(feats), noise=noise)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-5)
    assert float(expect.mean()) > 0.05


class _OnTheCard:
    """A stand-in tensor: the gates read nothing but ``is_cuda``."""

    is_cuda = True


@pytest.mark.parametrize("gather", [True, False], ids=["fused", "gather"])
def test_spatial_gate_honours_fused_spatial_gather(gather):
    """On the card the spatial pass kernels run only with fused_resampling
    and fused_spatial_gather (the reference's gate); the RIS kernel's gate
    is fused_resampling alone."""
    f = port_features(Features(fused_spatial_gather=gather))
    assert restir._fused_spatial(f, _OnTheCard()) is gather
    assert restir._fused(f, _OnTheCard())
    off = f.replace(fused_resampling=False)
    assert not restir._fused_spatial(off, _OnTheCard())
    assert not restir._fused_spatial(f, torch.zeros(1))
