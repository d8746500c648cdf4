"""The port's ReSTIR frame as a whole against the JAX package's over 3
frames that carry the temporal state, with every random draw injected:
without spatial reuse, with the reference defaults (config 5), and along an
animated camera path with reprojection, the unbiased combine and the
initial visibility check; the unbiased combine's Z-count visibility check
and the gradient-path options, which used to refuse, rendering as JAX does; the
R-MIS and R-OMIS modes rendering through render_frame; the port's own
Features and its default device; and the port importing, rendering and
taking a gradient step, a visibility-checked frame and a CLI run without
JAX or the JAX package."""

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
from romis_tpu_torch.render import restir
from romis_tpu_torch.render.animation import (
    render_animation, render_camera_batch, stack_cameras,
)
from romis_tpu_torch.render.pipeline import render_frame
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

from torch_parity import (
    jax_frame_noise, jax_ris_uniforms, occluder_scene, port_camera,
    port_features, port_scene,
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
            port_features(feats), state, noise=noise)
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
    scene, cam = flagship_scene("cpu"), flagship_camera(h, w, "cpu")
    images = []
    for ops in (restir.KERNELS, restir.PLAIN):
        gen = torch.Generator().manual_seed(0)
        state = None
        for _ in range(2):
            image, state = render_frame(gen, cam, scene, h, w,
                                        port_features(feats), state, ops=ops)
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
        image, state = render_frame(None, cam, scene, h, w,
                                    port_features(feats), state,
                                    noise=jax_frame_noise(key, feats, h, w))
        np.testing.assert_allclose(image.numpy(), np.asarray(expect),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(state.reservoirs.m.numpy(),
                                   np.asarray(jstate.reservoirs.m),
                                   rtol=1e-6)
    # Spatial reuse pooled neighbours: M grew past RIS + one temporal step.
    assert float(np.asarray(jstate.reservoirs.m).max()) > 3 * 8 / k
    assert float(np.asarray(expect).mean()) > 0.05


def test_animated_path_matches_jax():
    """A camera moving about 1.5 pixels per frame, with temporal
    reprojection, the unbiased spatial combine and the initial visibility
    check: the port's render_animation against JAX's, frame by frame."""
    h, w, n = 24, 40, 3
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=3, temporal_reprojection=True,
                     unbiased_combination=True,
                     initial_samples_visibility_check=True)
    jax_scene = occluder_scene(ge._flagship_scene().lights)
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
        None, cams, scene.geometry, scene.lights, 512, h, w,
        port_features(feats),
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
        images, _ = render_frame(None, port_camera(jcam), scene, h, w,
                                 port_features(feats),
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
            scene.geometry, scene.lights, scene.num_lights, h, w,
            port_features(feats),
            noises=[jax_frame_noise(keys[f], feats, h, w) for f in range(n)])
    for f in range(len(images)):
        np.testing.assert_allclose(images[f].numpy(), np.asarray(expect[f]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"frame {f}")
    assert float(np.asarray(expect).mean()) > 0.05


@pytest.mark.parametrize("entry", ["frame", "animation"])
@pytest.mark.parametrize("flags,match", LATER, ids=[m for _, m in LATER])
def test_later_slices_refuse(flags, match, entry):
    """The options that refused before their slice (the unbiased combine's
    Z-count visibility, the gradient-path options) now render and match
    JAX."""
    _renders_as_jax(flags, entry)


def test_biased_visibility_check_is_not_refused():
    """spatial_reuse_visibility_check only changes the unbiased combine's
    Z (as in the reference); with the biased combine the frame renders."""
    feats = port_features(Features(spatial_reuse_visibility_check=True,
                                   initial_light_samples=4))
    scene = flagship_scene("cpu")
    images = render_camera_batch(torch.Generator().manual_seed(0),
                                 stack_cameras([flagship_camera(6, 8, "cpu")]),
                                 scene.geometry, scene.lights,
                                 scene.num_lights, 6, 8, feats)
    assert images.shape == (1, 6, 8, 3) and bool(torch.isfinite(images).all())


@pytest.mark.parametrize("mode", [RayTraceMode.RMIS, RayTraceMode.ROMIS])
def test_mis_modes_render(mode):
    """R-MIS and R-OMIS render through render_frame at the reference
    defaults (D=5, r=10, S=32, K=2, 5 iterations) as their own entry
    points render them, with no temporal state."""
    from romis_tpu_torch.render.rmis import render_rmis
    from romis_tpu_torch.render.romis import render_romis

    feats = port_features(Features(spatial_reuse=False, ray_trace_mode=mode))
    scene, cam = flagship_scene("cpu"), flagship_camera(4, 4, "cpu")
    img, state = render_frame(torch.Generator().manual_seed(2), cam, scene,
                              4, 4, feats)
    fn = render_rmis if mode == RayTraceMode.RMIS else render_romis
    expect = fn(torch.Generator().manual_seed(2), cam, scene.geometry,
                scene.lights, scene.num_lights, 4, 4, feats)
    assert state is None and img.shape == (4, 4, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.05
    assert torch.equal(img, expect)


def test_port_features_match_jax_field_by_field():
    """The port's own Features: the reference's fields, in its order, with
    its defaults, and the same JSON form both ways."""
    import dataclasses

    from romis_tpu_torch.core.features import Features as PortFeatures
    from romis_tpu_torch.core.features import RayTraceMode as PortMode

    jf, pf = dataclasses.fields(Features), dataclasses.fields(PortFeatures)
    assert [f.name for f in jf] == [f.name for f in pf]
    for a, b in zip(jf, pf):
        da, db = a.default, b.default
        assert getattr(da, "value", da) == getattr(db, "value", db), a.name
    flags = Features(ray_trace_mode=RayTraceMode.ROMIS, max_iterations_mis=3)
    assert port_features(flags).to_json() == flags.to_json()
    assert port_features(flags) == PortFeatures(
        ray_trace_mode=PortMode.ROMIS, max_iterations_mis=3)


@pytest.mark.parametrize("entry", ["flagship_scene", "flagship_camera",
                                   "make_camera", "empty_reservoirs"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` an entry point places its tensors on the CUDA
    device; with no card it raises, naming device="cpu", rather than run on
    the CPU."""
    from romis_tpu_torch.core.camera import make_camera
    from romis_tpu_torch.core.types import empty_reservoirs

    fn = {"flagship_scene": lambda: flagship_scene().geometry.v0,
          "flagship_camera": lambda: flagship_camera(4, 4).look_at,
          "make_camera": lambda: make_camera().look_at,
          "empty_reservoirs": lambda: empty_reservoirs(2, 2, 1).pos}[entry]
    if torch.cuda.is_available():
        assert fn().is_cuda
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()


def test_port_imports_and_renders_without_jax(tmp_path):
    script = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "romis_tpu"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import torch
        from romis_tpu_torch import Features
        from romis_tpu_torch.render.pipeline import render_frame, save_image
        from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

        scene, cam = flagship_scene("cpu"), flagship_camera(8, 8, "cpu")
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

        from romis_tpu_torch import RayTraceMode
        feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                         spatial_resample_radius=2, max_iterations_mis=2,
                         ray_trace_mode=RayTraceMode.ROMIS)
        img, state = render_frame(gen, cam, scene, 8, 8, feats)
        assert state is None and bool(torch.isfinite(img).all())

        # A scene above the soup kernels' 2048 triangles through a BVH
        # built by the port's own copy of the SAH builder.
        from romis_tpu_torch.ops.bvh import with_bvh
        from romis_tpu_torch.scene.scene import (
            torus_field, torus_field_camera,
        )
        field = torus_field(2, "cpu")
        field.geometry = with_bvh(field.geometry)
        assert field.geometry.num_tris > 2048
        feats = Features(initial_light_samples=8)
        img, state = render_frame(gen, torus_field_camera(8, 8, "cpu"),
                                  field, 8, 8, feats)
        assert bool(torch.isfinite(img).all())
        # The gradient step on the same BVH geometry (the tree as built).
        from romis_tpu_torch.render.restir import initial_temporal_state
        fcam = torus_field_camera(4, 4, "cpu")
        fn = make_grad_fn(field.geometry, field.lights, field.num_lights, 4,
                          4, Features(initial_light_samples=8,
                                      enable_tone_mapping=False))
        loss, grads = fn(extract_params(field.geometry, field.lights),
                         torch.zeros(4, 4, 3), gen, fcam,
                         initial_temporal_state(4, 4, 2, fcam))
        assert all(bool(torch.isfinite(g).all()) for g in grads.leaves())

        # The op-level entries of kernels 8 and 12.
        from romis_tpu_torch.ops.spatial import neighbour_gather, philox_key
        from romis_tpu_torch.ops.trace import any_hit_plucker
        o = torch.tensor([0.0, 1.0, 0.0])[:, None, None].expand(3, 2, 2)
        d = torch.tensor([0.0, -1.0, 0.0])[:, None, None].expand(3, 2, 2)
        assert any_hit_plucker(o, d, torch.full((2, 2), 10.0),
                               scene.geometry).all()
        g = neighbour_gather(torch.rand((4, 6, 8)), 3, 2,
                             key=philox_key(gen))
        assert g.shape == (3, 4, 6, 8)

        # The unbiased combine with the Z-count visibility check.
        feats = Features(initial_light_samples=8, unbiased_combination=True,
                         spatial_reuse_visibility_check=True)
        img, state = render_frame(gen, cam, scene, 8, 8, feats)
        assert bool(torch.isfinite(img).all())

        # The multi-GPU modules, and their frames on one band (no group).
        import romis_tpu_torch.parallel.halo
        import romis_tpu_torch.parallel.launch
        import romis_tpu_torch.parallel.mesh
        import romis_tpu_torch.parallel.mis
        import romis_tpu_torch.parallel.shard
        from romis_tpu_torch.parallel.launch import global_bands
        from romis_tpu_torch.parallel.mis import render_romis_sharded
        from romis_tpu_torch.parallel.shard import render_frame_sharded
        bands = global_bands(8)
        feats = Features(initial_light_samples=8, spatial_resample_radius=2)
        img, _ = render_frame_sharded(gen, cam, scene.geometry, scene.lights,
                                      scene.num_lights, 8, 8, feats, None,
                                      bands)
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
        img = render_romis_sharded(
            gen, cam, scene.geometry, scene.lights, scene.num_lights, 8, 8,
            feats.replace(ray_trace_mode=RayTraceMode.ROMIS,
                          num_neighbours_to_sample=3, max_iterations_mis=2),
            bands)
        assert bool(torch.isfinite(img).all())

        # The app: a TOML config and an OBJ scene through the CLI.
        from pathlib import Path
        from romis_tpu_torch import cli
        from romis_tpu_torch.scene.objloader import write_obj
        from romis_tpu_torch.scene.scene import torus_field_submeshes
        out = Path(sys.argv[1]).parent
        write_obj(str(out / "torus.obj"), torus_field_submeshes(1))
        (out / "cfg.toml").write_text(
            '[features]\\ninitial_light_samples = 4\\n'
            '[[lights]]\\ntype = "point"\\nposition = [0, 3, 0]\\n'
            'color = [5, 5, 5]\\n[[cameras]]\\nlook_at = [0, 0, 0]\\n'
            'distance_from_look_at = 4.0\\n')
        assert cli.main(["--device", "cpu", "--config", str(out / "cfg.toml"),
                         "--scene", str(out / "torus.obj"), "--size", "8",
                         "6", "--frames", "2", "--out",
                         str(out / "cli")]) == 0
        assert len(list((out / "cli").glob("torus_*_cam_0.png"))) == 1
        import os
        if os.path.exists("/proc/self/maps"):  # no JAX-package library
            assert "libromis_native" not in open("/proc/self/maps").read()
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "flax", "romis_tpu")]
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
