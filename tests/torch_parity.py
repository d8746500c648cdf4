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


def jax_ris_uniforms(key, s, k, h, w, replay=False):
    """The uniforms the JAX XLA path draws for RIS: one u4 [4, K, H, W] per
    slot from jax.random.split(key, S/K) (ops/wrs.py gen_canonical_samples)
    → [S/K, 4, K, H, W]. With ``replay`` (the surrogate scan,
    ops/wrs._gen_canonical_surrogate) each slot adds the second race's
    uniform from fold_in(slot_key, 77) → [S/K, 5, K, H, W]."""
    sk = -(-s // k)
    keys = jax.random.split(key, sk)
    out = []
    for i in range(sk):
        u = [np.asarray(jax.random.uniform(keys[i], (4, k, h, w)))]
        if replay:
            u.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(keys[i], 77), (k, h, w)))[None])
        out.append(np.concatenate(u))
    return np.stack(out)


def jax_frame_noise(key, features, h, w):
    """Every random draw the JAX XLA path makes in render_restir_frame with
    ``key``, as the port's ``noise`` hook: RIS uniforms (with the surrogate
    RIS, its second race's too), the temporal race Gumbel noise, and per
    spatial pass the offsets randint(fold_in(fold_in(key, PH_SPATIAL), p))
    ([2, R] with coherent_spatial_offsets, else [2, R, H, W]), the race
    noise gumbel(fold_in(kp, 1000), (R+1, K, H, W)) and, for the biased
    surrogate combine, its second race's gumbel(fold_in(that key, 77))."""
    from romis_tpu.render.restir import (
        PH_CANDIDATES, PH_SPATIAL, PH_TEMPORAL,
    )

    s, k = features.initial_light_samples, features.num_samples_in_reservoir
    r = features.num_neighbours_to_sample
    radius = features.spatial_resample_radius
    surrogate = features.surrogate_resampling_grad
    fold = jax.random.fold_in
    spatial = []
    for p in range(features.spatial_resampling_passes):
        kp = fold(fold(key, PH_SPATIAL), p)
        shape = (2, r) if features.coherent_spatial_offsets else (2, r, h, w)
        ck = fold(kp, 1000)
        draws = [t(jax.random.randint(kp, shape, -radius, radius + 1)),
                 t(jax.random.gumbel(ck, (r + 1, k, h, w)))]
        if surrogate and not features.unbiased_combination:
            draws.append(t(jax.random.gumbel(fold(ck, 77), (r + 1, k, h, w))))
        spatial.append(tuple(draws))
    return (torch.from_numpy(jax_ris_uniforms(fold(key, PH_CANDIDATES), s, k,
                                              h, w, replay=surrogate)),
            t(jax.random.gumbel(fold(key, PH_TEMPORAL), (2, k, h, w))),
            spatial)


def port_params(jax_params):
    """A JAX SceneParams → the port's (through numpy)."""
    from romis_tpu_torch.convert import params_from_numpy

    return params_from_numpy({f: np.asarray(getattr(jax_params, f))
                              for f in vars(jax_params)})


def port_state(jax_state, cam):
    """A JAX TemporalState → the port's, with the port camera ``cam``."""
    from romis_tpu_torch.render.restir import TemporalState

    return TemporalState(reservoirs=port_reservoirs(jax_state.reservoirs),
                         ctx=port_ctx(jax_state.ctx), cam=cam,
                         has_prev=bool(jax_state.has_prev))
