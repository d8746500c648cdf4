"""The port's ReSTIR frame as a whole against the JAX package's over 3
frames that carry the temporal state, with every random draw injected:
without spatial reuse, with the reference defaults (config 5), and along an
animated camera path with reprojection, the unbiased combine and the
initial visibility check; the Z-count option of a later slice refusing, and
the gradient-path options that used to refuse rendering as JAX does; and
the port importing, rendering and taking a gradient step without JAX."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.camera import make_camera as jax_make_camera
from romis_tpu.core.features import Features, RayTraceMode
from romis_tpu.render.animation import (
    interpolate_cameras as jax_interpolate,
    render_animation as jax_render_animation,
)
from romis_tpu.render.restir import (
    PH_CANDIDATES, PH_TEMPORAL, initial_temporal_state as jax_initial_state,
    render_restir_frame as jax_render_frame,
)
from romis_tpu.scene.objloader import Material, SubMesh
from romis_tpu.scene.scene import Scene as JaxScene
from romis_tpu.scene.scene import build_geometry as jax_build_geometry
from romis_tpu_torch.render import restir
from romis_tpu_torch.render.animation import (
    render_animation, render_camera_batch, stack_cameras,
)
from romis_tpu_torch.render.pipeline import render_frame
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

from torch_parity import (
    jax_frame_noise, jax_ris_uniforms, port_camera, port_scene, random_soup,
)


def test_frame_matches_jax_with_injected_noise():
    h, w, s, k = 24, 40, 8, 2
    feats = Features(spatial_reuse=False, initial_light_samples=s,
                     num_samples_in_reservoir=k)
    jax_scene = ge._flagship_scene()
    jcam = ge._flagship_camera(h, w)
    scene, cam = port_scene(jax_scene), port_camera(jcam)
    fn = jax.jit(jax_render_frame, static_argnums=(4, 5, 6, 7))
    jstate = jax_initial_state(h, w, k, jcam)
    state = restir.initial_temporal_state(h, w, k, cam)
    for frame in range(3):
        key = jax.random.PRNGKey(frame)
        expect, jstate = fn(key, jcam, jax_scene.geometry, jax_scene.lights,
                            jax_scene.num_lights, h, w, feats, jstate)
        noise = (
            torch.from_numpy(jax_ris_uniforms(
                jax.random.fold_in(key, PH_CANDIDATES), s, k, h, w)),
            torch.from_numpy(np.array(jax.random.gumbel(
                jax.random.fold_in(key, PH_TEMPORAL), (2, k, h, w)))))
        image, state = restir.render_restir_frame(
            None, cam, scene.geometry, scene.lights, scene.num_lights, h, w,
            feats, state, noise=noise)
        assert image.shape == (h, w, 3)
        np.testing.assert_allclose(image.numpy(), np.asarray(expect),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(state.reservoirs.m.numpy(),
                                   np.asarray(jstate.reservoirs.m))
    assert float(np.asarray(expect).mean()) > 0.05


def test_kernel_and_plain_ops_agree_on_cpu():
    """On CPU tensors the kernel wrappers run their plain versions, so the
    two FrameOps render the same frames (every kernel of both paths) from
    the same generator seed."""
    h, w = 12, 16
    feats = Features(initial_light_samples=4, num_neighbours_to_sample=3,
                     spatial_resample_radius=2, unbiased_combination=True,
                     temporal_reprojection=True,
                     initial_samples_visibility_check=True)
    scene, cam = flagship_scene(), flagship_camera(h, w)
    images = []
    for ops in (restir.KERNELS, restir.PLAIN):
        gen = torch.Generator().manual_seed(0)
        state = None
        for _ in range(2):
            image, state = render_frame(gen, cam, scene, h, w, feats, state,
                                        ops=ops)
        images.append(image)
    assert torch.equal(images[0], images[1])


def test_config5_frame_matches_jax():
    """Features() (the reference defaults of bench.py config 5: temporal
    reuse, then 2 biased spatial passes) at a small S, R and radius, with
    JAX's own spatial draws replayed."""
    h, w = 24, 40
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=3)
    jax_scene = ge._flagship_scene()
    jcam = ge._flagship_camera(h, w)
    scene, cam = port_scene(jax_scene), port_camera(jcam)
    fn = jax.jit(jax_render_frame, static_argnums=(4, 5, 6, 7))
    k = feats.num_samples_in_reservoir
    jstate = jax_initial_state(h, w, k, jcam)
    state = None
    for frame in range(3):
        key = jax.random.PRNGKey(20 + frame)
        expect, jstate = fn(key, jcam, jax_scene.geometry, jax_scene.lights,
                            jax_scene.num_lights, h, w, feats, jstate)
        image, state = render_frame(None, cam, scene, h, w, feats, state,
                                    noise=jax_frame_noise(key, feats, h, w))
        np.testing.assert_allclose(image.numpy(), np.asarray(expect),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(state.reservoirs.m.numpy(),
                                   np.asarray(jstate.reservoirs.m),
                                   rtol=1e-6)
    # Spatial reuse pooled neighbours: M grew past RIS + one temporal step.
    assert float(np.asarray(jstate.reservoirs.m).max()) > 3 * 8 / k
    assert float(np.asarray(expect).mean()) > 0.05


def _occluder_scene(jax_lights):
    """A ground plane under a random soup (the occluders), lit by the
    flagship lights: the initial visibility check has shadows to find."""
    ground = SubMesh(
        positions=np.array([[-10, -1.6, -10], [10, -1.6, -10],
                            [10, -1.6, 10], [-10, -1.6, 10]], np.float32),
        normals=np.tile(np.array([0, 1, 0], np.float32), (4, 1)),
        texcoords=np.zeros((4, 2), np.float32),
        triangles=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material=Material(kd=(0.7, 0.7, 0.7)))
    soup = random_soup(np.random.default_rng(21), 40)
    return JaxScene(geometry=jax_build_geometry([ground, soup]),
                    lights=jax_lights, num_lights=512)


def test_animated_path_matches_jax():
    """A camera moving about 1.5 pixels per frame, with temporal
    reprojection, the unbiased spatial combine and the initial visibility
    check: the port's render_animation against JAX's, frame by frame."""
    h, w, n = 24, 40, 3
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=3, temporal_reprojection=True,
                     unbiased_combination=True,
                     initial_samples_visibility_check=True)
    jax_scene = _occluder_scene(ge._flagship_scene().lights)
    scene = port_scene(jax_scene)
    cam_kw = dict(look_at=(0.0, -0.5, 0.0), distance=6.0, fov_deg=50.0,
                  resolution=(h, w))
    jcams = jax_interpolate(
        jax_make_camera(rotation_deg=(25.0, 30.0, 0.0), **cam_kw),
        jax_make_camera(rotation_deg=(25.0, 36.0, 0.0), **cam_kw), n)
    key = jax.random.PRNGKey(7)
    expect, jstate = jax.jit(jax_render_animation,
                             static_argnums=(4, 5, 6, 7))(
        key, jcams, jax_scene.geometry, jax_scene.lights, 512, h, w, feats)
    keys = jax.random.split(key, n)
    cams = stack_cameras([port_camera(jax.tree.map(lambda a, i=i: a[i],
                                                   jcams))
                          for i in range(n)])
    images, state = render_animation(
        None, cams, scene.geometry, scene.lights, 512, h, w, feats,
        noises=[jax_frame_noise(keys[f], feats, h, w) for f in range(n)])
    for f in range(n):
        np.testing.assert_allclose(images[f].numpy(), np.asarray(expect[f]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"frame {f}")
    np.testing.assert_allclose(state.reservoirs.m.numpy(),
                               np.asarray(jstate.reservoirs.m), rtol=1e-6)
    assert float(np.asarray(expect).mean()) > 0.05


LATER = [
    (dict(unbiased_combination=True, spatial_reuse_visibility_check=True),
     "spatial_reuse_visibility_check"),
    (dict(coherent_spatial_offsets=True), "coherent_spatial_offsets"),
    (dict(surrogate_resampling_grad=True), "surrogate_resampling_grad"),
]


def _renders_as_jax(flags, entry):
    """The frame (or a 2-frame animated path) with ``flags`` against JAX's,
    with JAX's own draws replayed."""
    h, w, n = 12, 16, 2
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=2, **flags)
    jax_scene = ge._flagship_scene()
    scene = port_scene(jax_scene)
    args = (jax_scene.geometry, jax_scene.lights, jax_scene.num_lights, h, w,
            feats)
    key = jax.random.PRNGKey(11)
    if entry == "frame":
        jcam = ge._flagship_camera(h, w)
        expect, _ = jax.jit(jax_render_frame, static_argnums=(4, 5, 6, 7))(
            key, jcam, *args, jax_initial_state(h, w, 2, jcam))
        images, _ = render_frame(None, port_camera(jcam), scene, h, w, feats,
                                 noise=jax_frame_noise(key, feats, h, w))
        images, expect = images[None], np.asarray(expect)[None]
    else:
        cam_kw = dict(look_at=(2.57, 1.23, -1.35), distance=25.0,
                      fov_deg=30.0, resolution=(h, w))
        jcams = jax_interpolate(
            jax_make_camera(rotation_deg=(10.3, 30.0, 0.0), **cam_kw),
            jax_make_camera(rotation_deg=(10.3, 31.0, 0.0), **cam_kw), n)
        expect, _ = jax.jit(jax_render_animation,
                            static_argnums=(4, 5, 6, 7))(key, jcams, *args)
        keys = jax.random.split(key, n)
        images, _ = render_animation(
            None, stack_cameras([port_camera(jax.tree.map(
                lambda a, i=i: a[i], jcams)) for i in range(n)]),
            scene.geometry, scene.lights, scene.num_lights, h, w, feats,
            noises=[jax_frame_noise(keys[f], feats, h, w) for f in range(n)])
    for f in range(len(images)):
        np.testing.assert_allclose(images[f].numpy(), np.asarray(expect[f]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"frame {f}")
    assert float(np.asarray(expect).mean()) > 0.05


@pytest.mark.parametrize("entry", ["frame", "animation"])
@pytest.mark.parametrize("flags,match", LATER, ids=[m for _, m in LATER])
def test_later_slices_refuse(flags, match, entry):
    """The unbiased combine's Z-count visibility still refuses, naming its
    option; the gradient-path options, which refused before their slice,
    now render and match JAX."""
    if match != "spatial_reuse_visibility_check":
        _renders_as_jax(flags, entry)
        return
    feats = Features(**flags)
    scene, cam = flagship_scene(), flagship_camera(4, 4)
    with pytest.raises(NotImplementedError, match=match):
        if entry == "frame":
            render_frame(torch.Generator(), cam, scene, 4, 4, feats)
        else:
            render_animation(torch.Generator(), stack_cameras([cam, cam]),
                             scene.geometry, scene.lights, scene.num_lights,
                             4, 4, feats)


def test_biased_visibility_check_is_not_refused():
    """spatial_reuse_visibility_check only changes the unbiased combine's
    Z (as in the reference); with the biased combine the frame renders."""
    feats = Features(spatial_reuse_visibility_check=True,
                     initial_light_samples=4)
    scene = flagship_scene()
    images = render_camera_batch(torch.Generator().manual_seed(0),
                                 stack_cameras([flagship_camera(6, 8)]),
                                 scene.geometry, scene.lights,
                                 scene.num_lights, 6, 8, feats)
    assert images.shape == (1, 6, 8, 3) and bool(torch.isfinite(images).all())


@pytest.mark.parametrize("mode", [RayTraceMode.RMIS, RayTraceMode.ROMIS])
def test_mis_modes_refuse(mode):
    feats = Features(spatial_reuse=False, ray_trace_mode=mode)
    scene, cam = flagship_scene(), flagship_camera(4, 4)
    with pytest.raises(NotImplementedError):
        render_frame(torch.Generator(), cam, scene, 4, 4, feats)


def test_port_imports_and_renders_without_jax(tmp_path):
    script = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import torch
        from romis_tpu_torch import Features
        from romis_tpu_torch.render.pipeline import render_frame, save_image
        from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

        scene, cam = flagship_scene(), flagship_camera(8, 8)
        gen = torch.Generator().manual_seed(0)
        feats = Features(initial_light_samples=8)
        img, state = render_frame(gen, cam, scene, 8, 8, feats)
        img, state = render_frame(gen, cam, scene, 8, 8, feats, state)
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
        save_image(sys.argv[1], img)

        from romis_tpu_torch.diff.grad import extract_params, make_grad_fn
        feats = Features(initial_light_samples=8, enable_tone_mapping=False,
                         surrogate_resampling_grad=True)
        fn = make_grad_fn(scene.geometry, scene.lights, scene.num_lights, 8,
                          8, feats)
        loss, grads = fn(extract_params(scene.geometry, scene.lights),
                         torch.zeros(8, 8, 3), gen, cam, state)
        assert float(loss) > 0
        assert all(bool(torch.isfinite(g).all()) for g in grads.leaves())
        assert float(grads.light_c0.abs().max()) > 0
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")]
        assert not bad, bad
        print("ok")
    """)
    out = tmp_path / "frame.png"
    proc = subprocess.run([sys.executable, "-c", script, str(out)],
                          capture_output=True, text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
