"""Helpers for the parity tests of the PyTorch port against the JAX package:
carry JAX scenes, cameras and per-pixel state over as numpy arrays, and
build small procedural scenes with numpy."""

import numpy as np
import jax
import torch

from romis_tpu.scene.objloader import Material, SubMesh
from romis_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from romis_tpu_torch.core.types import Reservoirs, ShadeCtx
from romis_tpu_torch.scene.lights import COLUMNS as LIGHT_COLUMNS
from romis_tpu_torch.scene.scene import COLUMNS as GEOMETRY_COLUMNS


def port_scene(jax_scene):
    """A JAX Scene → the port's Scene (through numpy)."""
    g, li = jax_scene.geometry, jax_scene.lights
    return scene_from_numpy(
        {c: np.asarray(getattr(g, c)) for c in GEOMETRY_COLUMNS},
        {c: np.asarray(getattr(li, c)) for c in LIGHT_COLUMNS + ("kind",)},
        jax_scene.num_lights)


def port_camera(jax_cam):
    return camera_from_numpy(*(np.asarray(getattr(jax_cam, f)) for f in (
        "look_at", "rotation", "distance", "fovy", "aspect")))


def t(a):
    """numpy / JAX array → CPU tensor (a copy)."""
    return torch.as_tensor(np.array(a))


def port_ctx(jax_ctx):
    fields = ("valid", "position", "normal", "view_origin", "kd", "ks",
              "shininess", "geom_id", "depth_t")
    return ShadeCtx(**{f: t(getattr(jax_ctx, f)) for f in fields})


def port_reservoirs(jax_res):
    fields = ("pos", "color", "w_sum", "m", "big_w", "chosen_w")
    return Reservoirs(**{f: t(getattr(jax_res, f)) for f in fields})


def random_soup(rng, n_tris, half=1.5, edge=0.6):
    """A SubMesh of n_tris random triangles in the box [-half, half]^3."""
    c = rng.uniform(-half, half, (n_tris, 1, 3))
    v = (c + rng.normal(0.0, edge, (n_tris, 3, 3))).astype(np.float32)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return SubMesh(positions=v.reshape(-1, 3),
                   normals=np.repeat(nrm, 3, axis=0).astype(np.float32),
                   texcoords=rng.uniform(0, 1, (3 * n_tris, 2)).astype(
                       np.float32),
                   triangles=np.arange(3 * n_tris,
                                       dtype=np.int32).reshape(-1, 3),
                   material=Material(kd=(0.6, 0.5, 0.4), ks=(0.3, 0.3, 0.3),
                                     shininess=20.0))


def random_rays(rng, h, w, half=1.5):
    """Origins outside the box aimed at points inside it → (o, d) numpy
    [3, h, w] each."""
    n = h * w
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    target = rng.uniform(-half, half, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def planes(a):
        return a.T.reshape(3, h, w).astype(np.float32)

    return planes(o), planes(d)


def jax_ris_uniforms(key, s, k, h, w):
    """The uniforms the JAX XLA path draws for RIS: one u4 [4, K, H, W] per
    slot from jax.random.split(key, S/K) (ops/wrs.py gen_canonical_samples)
    → [S/K, 4, K, H, W]."""
    sk = -(-s // k)
    keys = jax.random.split(key, sk)
    return np.stack([np.asarray(jax.random.uniform(keys[i], (4, k, h, w)))
                     for i in range(sk)])


def jax_frame_noise(key, features, h, w):
    """Every random draw the JAX XLA path makes in render_restir_frame with
    ``key``, as the port's ``noise`` hook: RIS uniforms, the temporal race
    Gumbel noise, and per spatial pass the offsets
    randint(fold_in(fold_in(key, PH_SPATIAL), p)) and the race noise
    gumbel(fold_in(kp, 1000), (R+1, K, H, W))."""
    from romis_tpu.render.restir import (
        PH_CANDIDATES, PH_SPATIAL, PH_TEMPORAL,
    )

    s, k = features.initial_light_samples, features.num_samples_in_reservoir
    r = features.num_neighbours_to_sample
    radius = features.spatial_resample_radius
    fold = jax.random.fold_in
    spatial = []
    for p in range(features.spatial_resampling_passes):
        kp = fold(fold(key, PH_SPATIAL), p)
        spatial.append((
            t(jax.random.randint(kp, (2, r, h, w), -radius, radius + 1)),
            t(jax.random.gumbel(fold(kp, 1000), (r + 1, k, h, w)))))
    return (torch.from_numpy(jax_ris_uniforms(fold(key, PH_CANDIDATES), s, k,
                                              h, w)),
            t(jax.random.gumbel(fold(key, PH_TEMPORAL), (2, k, h, w))),
            spatial)
