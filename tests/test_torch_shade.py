"""Parity of the PyTorch port's shading and final shade with the JAX package
(CPU: the final-shade wrapper runs its plain version here)."""

import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from romis_tpu.core.features import Features
from romis_tpu.ops.pallas_shade import final_shade_pallas
from romis_tpu.ops.pallas_spatial import pack_center_ctx as jax_pack_center
from romis_tpu.ops.shading import acquire_texel as jax_acquire_texel
from romis_tpu.ops.shading import exposure_tone_mapping as jax_tone_map
from romis_tpu.ops.shading import phong_shade as jax_phong_shade
from romis_tpu.ops.shading import target_pdf_planes as jax_target_pdf_planes
from romis_tpu.render.restir import _final_shade_xla, pack_reservoir_planes
from romis_tpu.scene.scene import build_geometry
from romis_tpu_torch.core.types import pack_reservoir_planes as port_pack_res
from romis_tpu_torch.ops.shade import final_shade_fused, pack_center_ctx
from romis_tpu_torch.ops.shading import (
    acquire_texel, exposure_tone_mapping, phong_shade, target_pdf_planes,
)
from romis_tpu_torch.scene.scene import build_geometry as port_build_geometry

from helpers import random_reservoirs_and_ctx
from torch_parity import (
    port_ctx, port_features, port_reservoirs, random_soup, t,
)

H, W, K = 16, 64, 2


def test_final_shade_matches_jax_and_pallas():
    sm = random_soup(np.random.default_rng(0), 64)
    jgeo, geo = build_geometry([sm]), port_build_geometry([sm], "cpu")
    jres, jctx = random_reservoirs_and_ctx(np.random.default_rng(5), H, W, K)
    # The receivers carry the soup's material shininess, as in a frame (the
    # Pallas kernel specialises on the scene's one shared shininess).
    jctx = jctx.replace(shininess=jnp.full((H, W), sm.material.shininess,
                                           jnp.float32))
    feats = Features()
    got = final_shade_fused(port_ctx(jctx), port_reservoirs(jres), geo,
                            port_features(feats)).numpy()
    assert got.shape == (3, H, W)
    xla = np.asarray(_final_shade_xla(jctx, jres, jgeo, feats))
    fused = np.asarray(final_shade_pallas(
        jax_pack_center(jctx), pack_reservoir_planes(jres), jgeo, K,
        interpret=pltpu.InterpretParams()))
    assert (xla > 0).mean() > 0.3
    np.testing.assert_allclose(got, xla, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got, fused, rtol=2e-4, atol=1e-5)


def test_kernel_packings_match_jax():
    jres, jctx = random_reservoirs_and_ctx(np.random.default_rng(1), 4, 8, K)
    np.testing.assert_array_equal(pack_center_ctx(port_ctx(jctx)).numpy(),
                                  np.asarray(jax_pack_center(jctx)))
    np.testing.assert_array_equal(port_pack_res(port_reservoirs(jres)).numpy(),
                                  np.asarray(pack_reservoir_planes(jres)))


def test_phong_and_target_pdf_match_jax():
    rng = np.random.default_rng(2)
    jres, jctx = random_reservoirs_and_ctx(rng, 6, 20, K)
    feats = Features()
    ctx, res = port_ctx(jctx), port_reservoirs(jres)
    np.testing.assert_allclose(
        phong_shade(ctx, res.pos, res.color, port_features(feats)).numpy(),
        np.asarray(jax_phong_shade(jctx, jres.pos, jres.color, feats)),
        rtol=1e-5, atol=1e-7)
    comps = [res.pos[:, i] for i in range(3)] + [res.color[:, i]
                                                 for i in range(3)]
    jcomps = [jres.pos[:, i] for i in range(3)] + [jres.color[:, i]
                                                   for i in range(3)]
    np.testing.assert_allclose(
        target_pdf_planes(ctx, *comps, port_features(feats)).numpy(),
        np.asarray(jax_target_pdf_planes(jctx, *jcomps, feats)),
        rtol=1e-5, atol=1e-7)
    color = rng.uniform(0, 3, (3, 6, 20)).astype(np.float32)
    for f in (feats, Features(exposure=0.7, gamma=2.2)):
        np.testing.assert_allclose(
            exposure_tone_mapping(t(color), port_features(f)).numpy(),
            np.asarray(jax_tone_map(jnp.asarray(color), f)), rtol=1e-6)


def test_acquire_texel_matches_jax():
    rng = np.random.default_rng(3)
    tex = rng.uniform(size=(2, 5, 7, 3)).astype(np.float32)
    size = np.array([[5, 7], [3, 4]], np.int32)
    tex_id = rng.integers(-1, 2, (6, 9)).astype(np.int32)
    uv = rng.uniform(size=(2, 6, 9)).astype(np.float32)
    expect = np.asarray(jax_acquire_texel(jnp.asarray(tex), jnp.asarray(size),
                                          jnp.asarray(tex_id),
                                          jnp.asarray(uv)))
    got = acquire_texel(t(tex), t(size), t(tex_id), t(uv))
    np.testing.assert_array_equal(got.numpy(), expect)
