"""Parity of the PyTorch port's camera, scene tables and light sampling with
the JAX package (CPU, small sizes, inputs from a numpy seed)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.camera import generate_rays as jax_generate_rays
from romis_tpu.core.camera import make_camera as jax_make_camera
from romis_tpu.ops.pallas_trace import _tri_columns
from romis_tpu.scene.lights import sample_lights_planes as jax_sample_planes
from romis_tpu_torch.core.camera import generate_rays, make_camera
from romis_tpu_torch.scene.lights import sample_lights_planes
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

from torch_parity import port_camera, port_scene

CAMERAS = [
    dict(look_at=(2.57, 1.23, -1.35), rotation_deg=(10.3, 30.0, 0.0),
         distance=25.0, fov_deg=30.0, resolution=(12, 20)),
    dict(look_at=(0.0, 0.0, 0.0), rotation_deg=(20.0, 20.0, 0.0),
         distance=3.0, fov_deg=50.0, resolution=(9, 7)),
    dict(look_at=(-1.0, 2.0, 0.5), rotation_deg=(-35.0, 140.0, 12.0),
         distance=7.5, fov_deg=70.0, resolution=(16, 16)),
]


@pytest.mark.parametrize("cfg", CAMERAS)
def test_generate_rays_matches_jax(cfg):
    h, w = cfg["resolution"]
    expect = jax_generate_rays(jax_make_camera(**cfg), h, w)
    got = generate_rays(make_camera(device="cpu", **cfg), h, w)
    for a, b in ((got.origin, expect.origin),
                 (got.direction, expect.direction)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_camera_from_numpy_matches_make_camera():
    h, w = 12, 20
    cam = port_camera(ge._flagship_camera(h, w))
    ref = flagship_camera(h, w, "cpu")
    for f in ("look_at", "rotation", "distance", "fovy", "aspect"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(),
                                      getattr(ref, f).numpy())


def test_flagship_scene_tables_match_jax():
    jax_scene = ge._flagship_scene()
    assert jax_scene.name == "procedural_nightclub"
    scene = flagship_scene("cpu")
    assert scene.num_lights == jax_scene.num_lights == 512
    g, jg = scene.geometry, jax_scene.geometry
    for name in ("attr_rows", "mat_rows", "v0", "e1", "e2",
                 "mat_id", "geom_id", "active", "mat_kd", "mat_shininess"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    n = g.num_tris
    np.testing.assert_array_equal(g.tri_cols.numpy(),
                                  np.asarray(_tri_columns(jg))[:, :n])
    for name in ("rows", "v0", "edge01", "edge02", "c0", "c3", "kind"):
        np.testing.assert_array_equal(getattr(scene.lights, name).numpy(),
                                      np.asarray(getattr(jax_scene.lights,
                                                         name)))
    # The converter carries the same scene over from the JAX arrays.
    carried = port_scene(jax_scene)
    for name in ("tri_cols", "attr_rows", "mat_rows"):
        assert torch.equal(getattr(carried.geometry, name),
                           getattr(g, name))
    assert torch.equal(carried.lights.rows, scene.lights.rows)


def test_sample_lights_planes_matches_jax():
    rng = np.random.default_rng(3)
    jax_scene = ge._flagship_scene()
    lights = flagship_scene("cpu").lights
    k, h, w = 2, 6, 10
    idx = rng.integers(0, 512, (k, h, w)).astype(np.int32)
    u = rng.uniform(size=(k, h, w)).astype(np.float32)
    v = rng.uniform(size=(k, h, w)).astype(np.float32)
    expect = jax_sample_planes(jax_scene.lights, jnp.asarray(idx),
                               jnp.asarray(u), jnp.asarray(v))
    got = sample_lights_planes(lights, torch.from_numpy(idx),
                               torch.from_numpy(u), torch.from_numpy(v))
    for a, b in zip(got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
