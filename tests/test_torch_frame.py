"""The slice as a whole: the PyTorch port's ReSTIR frame with
Features(spatial_reuse=False) against the JAX package's over 3 frames that
carry the temporal state, with every random draw injected; the flags of
later slices refusing; and the port importing without JAX."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.features import Features, RayTraceMode
from romis_tpu.render.restir import (
    PH_CANDIDATES, PH_TEMPORAL, initial_temporal_state as jax_initial_state,
    render_restir_frame as jax_render_frame,
)
from romis_tpu_torch.render import restir
from romis_tpu_torch.render.pipeline import render_frame
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

from torch_parity import jax_ris_uniforms, port_camera, port_scene


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
    two FrameOps render the same frame from the same generator seed."""
    h, w = 12, 16
    feats = Features(spatial_reuse=False, initial_light_samples=4)
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


@pytest.mark.parametrize("flag", [
    "spatial_reuse", "temporal_reprojection", "unbiased_combination",
    "initial_samples_visibility_check"])
def test_later_slices_refuse(flag):
    feats = Features(**{"spatial_reuse": False, flag: True})
    scene, cam = flagship_scene(), flagship_camera(4, 4)
    with pytest.raises(NotImplementedError, match=flag):
        render_frame(torch.Generator(), cam, scene, 4, 4, feats)


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
        img, state = render_frame(gen, cam, scene, 8, 8,
                                  Features(spatial_reuse=False))
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
        save_image(sys.argv[1], img)
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
