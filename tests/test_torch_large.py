"""The port's ReSTIR frames on a scene above the soup kernels' 2048
triangles (the 2x2 torus field, 3,874 triangles, with the JAX package's BVH
carried across) against the JAX package's, which traces the same tree with
its XLA traversal on the CPU: frames with config 5's features and with the
animated features (whose initial check takes the K-ray branch on the
card), the final shade against ``_final_shade_xla``, and the gradient step
on the tree as built (as the reference takes it) against JAX's and against
finite differences. R-MIS and R-OMIS: ``test_torch_large_mis.py``."""

from dataclasses import fields, replace

import numpy as np
import jax
import pytest
import torch

from romis_tpu.core.camera import make_camera
from romis_tpu.core.features import Features
from romis_tpu.diff.grad import (
    extract_params as jax_extract_params, make_grad_fn as jax_make_grad_fn,
    render_with_params as jax_render_with_params,
)
from romis_tpu.ops.bvh import with_bvh as jax_with_bvh
from romis_tpu.render.animation import interpolate_cameras as jax_interpolate
from romis_tpu.render.restir import (
    _final_shade_xla, initial_temporal_state as jax_initial_state,
    render_restir_frame as jax_render_frame,
)
from romis_tpu_torch.core.camera import generate_rays
from romis_tpu_torch.diff.grad import extract_params, make_grad_fn
from romis_tpu_torch.ops.trace import closest_hit_plain
from romis_tpu_torch.ops.shade import final_shade_fused
from romis_tpu_torch.render.animation import render_animation, stack_cameras
from romis_tpu_torch.render.restir import initial_temporal_state

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    jax_frame_noise, jax_torus_field, port_bvh_scene, port_camera, port_ctx,
    port_features, port_params, port_reservoirs, port_state, t,
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


GRAD_REL = 2e-3  # of each leaf's largest |g|, as in test_torch_grad.py
GRAD_HW = (6, 10)
MARGIN = 0.05  # barycentric distance of a hit from its triangle's edges
GRAD_FEATURES = Features(enable_tone_mapping=False, initial_light_samples=8,
                         num_neighbours_to_sample=3, spatial_resample_radius=2,
                         surrogate_resampling_grad=True)


def test_grad_step_on_bvh_geometry_matches_jax(field):
    """``make_grad_fn`` on the field with its BVH (the tree as built, as the
    reference leaves it) against the JAX package's jitted step on the same
    tree: the loss and all 13 leaves, JAX's draws replayed."""
    h, w = GRAD_HW
    jscene, scene = field
    feats = GRAD_FEATURES
    effective = feats.replace(fused_resampling=False,
                              coherent_spatial_offsets=True)
    jcam = make_camera(rotation_deg=(25.0, 30.0, 0.0), resolution=(h, w),
                       **CAM)
    jparams = jax_extract_params(jscene.geometry, jscene.lights)
    args = (jscene.geometry, jscene.lights, jscene.num_lights, h, w, feats)
    render = jax.jit(jax_render_with_params, static_argnums=(5, 6, 7, 8))
    _, jprev = render(jparams, jax.random.PRNGKey(1), jcam, *args,
                      jax_initial_state(h, w, 2, jcam))
    dim = jparams.replace(light_c0=jparams.light_c0 * 0.8)
    target, _ = render(dim, jax.random.PRNGKey(2), jcam, *args, jprev)
    key = jax.random.PRNGKey(3)
    jfn = jax.jit(jax_make_grad_fn(*args))
    jloss, jgrads = jfn(jparams, target, key, jcam, jprev)

    cam = port_camera(jcam)
    fn = make_grad_fn(scene.geometry, scene.lights, scene.num_lights, h, w,
                      port_features(feats))
    loss, grads = fn(port_params(jparams), t(target), None, cam,
                     port_state(jprev, cam),
                     noise=jax_frame_noise(key, effective, h, w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for f in fields(grads):
        g, e = getattr(grads, f.name), np.asarray(getattr(jgrads, f.name))
        assert bool(torch.isfinite(g).all()), f.name
        scale = max(float(np.abs(e).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), e, rtol=GRAD_REL,
                                   atol=GRAD_REL * scale, err_msg=f.name)
    for name in ("light_c0", "mat_kd", "tri_v0"):
        assert float(getattr(grads, name).abs().max()) > 0, name


@pytest.mark.parametrize("leaf", ["tri_v0", "mat_kd"])
def test_bvh_gradient_matches_finite_differences(field, leaf):
    """The port's gradient on the field with its BVH (no JAX), one
    component of ``leaf`` against central differences of the loss, every
    draw fixed: the plain versions trace through the tree, the backward
    re-evaluates the selected triangles. The component is the one with the
    largest gradient; for ``tri_v0`` among the triangles whose primary hits
    all lie at least MARGIN inside them in barycentrics, so that a step
    moves no hit onto another triangle (the discrete choice carries no
    gradient, and a pixel at a triangle's edge would measure the jump)."""
    _, scene = field
    h, w = GRAD_HW
    k, s = 2, 8
    feats = port_features(GRAD_FEATURES.replace(
        surrogate_resampling_grad=False))
    cam = port_camera(make_camera(rotation_deg=(25.0, 30.0, 0.0),
                                  resolution=(h, w), **CAM))
    gen = torch.Generator().manual_seed(0)
    noise = (torch.rand((s // k, 4, k, h, w), generator=gen),
             -torch.log(-torch.log(torch.rand((2, k, h, w), generator=gen))),
             [(torch.randint(-2, 3, (2, 3), generator=gen),
               -torch.log(-torch.log(torch.rand((4, k, h, w),
                                                generator=gen))))
              for _ in range(2)])
    params = extract_params(scene.geometry, scene.lights)
    fn = make_grad_fn(scene.geometry, scene.lights, scene.num_lights, h, w,
                      feats)
    prev = initial_temporal_state(h, w, k, cam)
    target = torch.zeros((h, w, 3))
    _, grads = fn(params, target, None, cam, prev, noise)
    g = getattr(grads, leaf).clone()
    if leaf == "tri_v0":
        _, tri, u, v = closest_hit_plain(generate_rays(cam, h, w),
                                         scene.geometry)
        edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        near = tri[(tri >= 0) & (edge < MARGIN)].long()
        g[near] = 0.0
    idx = np.unravel_index(int(g.abs().argmax()), tuple(g.shape))
    assert float(g[idx]) != 0.0
    eps = 1e-3

    def loss_at(delta):
        p = getattr(params, leaf).clone()
        p[idx] += delta
        return float(fn(replace(params, **{leaf: p}), target, None, cam,
                        prev, noise)[0])

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(float(g[idx]), fd, rtol=2e-2)
