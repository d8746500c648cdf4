"""Parity of the PyTorch port's camera paths, reprojection and animation
loops with the JAX package."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from romis_tpu.core.camera import make_camera as jax_make_camera
from romis_tpu.core.camera import project_to_pixel as jax_project
from romis_tpu.render.animation import (
    interpolate_cameras as jax_interpolate, stack_cameras as jax_stack,
)
from romis_tpu_torch.core.camera import (
    generate_rays, make_camera, project_to_pixel,
)
from romis_tpu_torch.core.features import Features
from romis_tpu_torch.render import restir
from romis_tpu_torch.render.animation import (
    camera_at, interpolate_cameras, render_animation, render_camera_batch,
    stack_cameras,
)
from romis_tpu_torch.render.pipeline import render_frame
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

from torch_parity import port_camera

FIELDS = ("look_at", "rotation", "distance", "fovy", "aspect")
CAM_A = dict(look_at=(2.57, 1.23, -1.35), rotation_deg=(10.3, 30.0, 0.0),
             distance=25.0, fov_deg=30.0, resolution=(24, 40))
CAM_B = dict(CAM_A, look_at=(2.0, 1.5, -1.0), rotation_deg=(12.0, 34.0, 1.0),
             distance=22.0)


def test_interpolate_and_stack_cameras_match_jax():
    n = 5
    expect = jax_interpolate(jax_make_camera(**CAM_A),
                             jax_make_camera(**CAM_B), n)
    got = interpolate_cameras(make_camera(device="cpu", **CAM_A),
                              make_camera(device="cpu", **CAM_B), n)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(expect, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    cams = [camera_at(got, i) for i in range(n)]
    restacked = stack_cameras(cams)
    jstacked = jax_stack([jax.tree.map(lambda a, i=i: a[i], expect)
                          for i in range(n)])
    for f in FIELDS:
        assert torch.equal(getattr(restacked, f), getattr(got, f))
        assert getattr(restacked, f).shape == np.shape(getattr(jstacked, f))


def test_project_to_pixel_matches_jax():
    h, w = 24, 40
    jcam = jax_make_camera(**CAM_B)
    rng = np.random.default_rng(0)
    points = rng.uniform(-6, 6, (2, 3, h, w)).astype(np.float32)
    rows, cols, front = jax_project(jcam, jnp.asarray(points), h, w)
    got = project_to_pixel(port_camera(jcam), torch.from_numpy(points), h, w)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(rows), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(cols), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(front))


def test_project_to_pixel_inverts_generate_rays():
    h, w = 18, 30
    cam = flagship_camera(h, w, "cpu")
    rays = generate_rays(cam, h, w)
    rows, cols, front = project_to_pixel(cam, rays.origin + 7.0
                                         * rays.direction, h, w)
    assert bool(front.all())
    np.testing.assert_allclose(rows.numpy(), np.arange(h)[:, None]
                               * np.ones((1, w)), atol=1e-3)
    np.testing.assert_allclose(cols.numpy(), np.ones((h, 1))
                               * np.arange(w)[None, :], atol=1e-3)


def test_render_animation_is_the_frame_loop():
    h, w = 10, 14
    feats = Features(initial_light_samples=4, num_neighbours_to_sample=2,
                     spatial_resample_radius=2, temporal_reprojection=True)
    scene = flagship_scene("cpu")
    cams = interpolate_cameras(flagship_camera(h, w, "cpu"),
                               make_camera(device="cpu",
                                           **dict(CAM_B, resolution=(h, w))),
                               3)
    images, state = render_animation(
        torch.Generator().manual_seed(3), cams, scene.geometry, scene.lights,
        scene.num_lights, h, w, feats, ops=restir.PLAIN)
    assert images.shape == (3, h, w, 3)
    gen = torch.Generator().manual_seed(3)
    st = None
    for f in range(3):
        img, st = render_frame(gen, camera_at(cams, f), scene, h, w, feats,
                               st, ops=restir.PLAIN)
        assert torch.equal(img, images[f])
    assert torch.equal(st.reservoirs.big_w, state.reservoirs.big_w)


def test_render_camera_batch_renders_first_frames():
    h, w = 8, 12
    feats = Features(initial_light_samples=4, num_neighbours_to_sample=2,
                     spatial_resample_radius=2)
    scene = flagship_scene("cpu")
    cams = stack_cameras([flagship_camera(h, w, "cpu"),
                          make_camera(device="cpu",
                                      **dict(CAM_B, resolution=(h, w)))])
    images = render_camera_batch(torch.Generator().manual_seed(1), cams,
                                 scene.geometry, scene.lights,
                                 scene.num_lights, h, w, feats)
    gen = torch.Generator().manual_seed(1)
    for i in range(2):
        img, _ = render_frame(gen, camera_at(cams, i), scene, h, w, feats)
        assert torch.equal(img, images[i])
    assert not torch.equal(images[0], images[1])
