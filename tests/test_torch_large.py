"""The port's ReSTIR frames on a scene above the soup kernels' 2048
triangles (the 2x2 torus field, 3,874 triangles, with the JAX package's BVH
carried across) against the JAX package's, which traces the same tree with
its XLA traversal on the CPU: frames with config 5's features and with the
animated features (whose initial check takes the K-ray branch on the
card), the final shade against ``_final_shade_xla``, and the gradient step
refusing BVH geometry. R-MIS and R-OMIS: ``test_torch_large_mis.py``."""

import numpy as np
import jax
import pytest

from romis_tpu.core.camera import make_camera
from romis_tpu.core.features import Features
from romis_tpu.ops.bvh import with_bvh as jax_with_bvh
from romis_tpu.render.animation import interpolate_cameras as jax_interpolate
from romis_tpu.render.restir import (
    _final_shade_xla, initial_temporal_state as jax_initial_state,
    render_restir_frame as jax_render_frame,
)
from romis_tpu_torch.diff.grad import make_grad_fn
from romis_tpu_torch.ops.shade import final_shade_fused
from romis_tpu_torch.render.animation import render_animation, stack_cameras

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    jax_frame_noise, jax_torus_field, port_bvh_scene, port_camera, port_ctx,
    port_features, port_reservoirs,
)

CAM = dict(look_at=(0.0, -0.3, 0.0), distance=6.0, fov_deg=50.0)


@pytest.fixture(scope="module")
def field():
    """(JAX scene with its BVH, the port's scene with the same tree)."""
    jscene = jax_torus_field(2)
    jscene.geometry = jax_with_bvh(jscene.geometry)
    return jscene, port_bvh_scene(jscene)


@pytest.mark.parametrize("path", ["config5", "animated"])
def test_restir_frames_match_jax(field, path):
    """Two frames carrying the temporal state, JAX's draws replayed, rtol
    1e-4 as for the flagship frames. ``animated``: a turning camera with
    reprojection, the unbiased combine and the initial visibility check.
    JAX renders frame by frame without ``jit`` (the frames of its
    ``render_animation``, same keys): the tori's silhouettes put some
    spatial-reuse gates within float rounding of their thresholds, and
    XLA's fusion of a whole frame (multiply-add contraction) rounds them
    differently from op-by-op execution, its own included."""
    jscene, scene = field
    h, w = 24, 40
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=3)
    if path == "animated":
        feats = feats.replace(temporal_reprojection=True,
                              unbiased_combination=True,
                              initial_samples_visibility_check=True)
    jcams = jax_interpolate(
        make_camera(rotation_deg=(25.0, 30.0, 0.0), resolution=(h, w), **CAM),
        make_camera(rotation_deg=(25.0, 33.0, 0.0), resolution=(h, w), **CAM),
        2)
    args = (jscene.geometry, jscene.lights, jscene.num_lights, h, w, feats)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    jstate = jax_initial_state(h, w, 2, jax.tree.map(lambda a: a[0], jcams))
    expect = []
    for f in range(2):
        img, jstate = jax_render_frame(
            keys[f], jax.tree.map(lambda a, i=f: a[i], jcams), *args, jstate)
        expect.append(img)
    noises = [jax_frame_noise(keys[f], feats, h, w) for f in range(2)]
    cams = stack_cameras([port_camera(jax.tree.map(lambda a, i=i: a[i],
                                                   jcams)) for i in range(2)])
    images, _ = render_animation(None, cams, scene.geometry, scene.lights,
                                 scene.num_lights, h, w, port_features(feats),
                                 noises=noises)
    for f in range(2):
        np.testing.assert_allclose(images[f].numpy(), np.asarray(expect[f]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"frame {f}")
    assert float(np.asarray(expect).mean()) > 0.05


def test_final_shade_matches_jax(field):
    """The final shade on BVH geometry (on the card kernel 21) against
    JAX's ``_final_shade_xla``, whose shadow rays walk the same tree."""
    jscene, scene = field
    jres, jctx = random_reservoirs_and_ctx(np.random.default_rng(3), 16, 24,
                                           2)
    feats = Features()
    expect = np.asarray(_final_shade_xla(jctx, jres, jscene.geometry, feats))
    got = final_shade_fused(port_ctx(jctx), port_reservoirs(jres),
                            scene.geometry, port_features(feats)).numpy()
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=1e-5)
    assert (expect > 0).mean() > 0.2


def test_grad_refuses_bvh_geometry(field):
    """A vertex update would leave the tree's boxes stale: make_grad_fn
    refuses BVH geometry, naming the slice that brings it."""
    _, scene = field
    with pytest.raises(NotImplementedError, match="slice 7"):
        make_grad_fn(scene.geometry, scene.lights, scene.num_lights, 4, 4,
                     port_features(Features(enable_tone_mapping=False)))
