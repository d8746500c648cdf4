"""The port's app layer against the JAX package's: the TOML config reader,
the OBJ scene loaders (on OBJ + MTL files written to ``tmp_path``), the
checkpoint and a bit-identical resume, the provenance JSON, the ray
accounting, the reservoir statistics, the debug images' deterministic
channels, and ``python -m romis_tpu_torch.cli`` run in-process on the CPU
(``--device cpu``)."""

import json
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from romis_tpu.core.camera import make_camera as jax_make_camera
from romis_tpu.core.features import Features
from romis_tpu.io.config import read_config_file as jax_read_config
from romis_tpu.scene import scene as jax_scene_mod
from romis_tpu.utils.debug_vis import debug_images as jax_debug_images
from romis_tpu.utils.stats import (
    frame_ray_counts as jax_frame_ray_counts,
    reservoir_stats as jax_reservoir_stats,
)
from romis_tpu_torch import cli
from romis_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from romis_tpu_torch.io.config import read_config_file
from romis_tpu_torch.render.pipeline import render_frame, write_provenance
from romis_tpu_torch.render.restir import initial_temporal_state
from romis_tpu_torch.scene import scene as port_scene_mod
from romis_tpu_torch.scene.lights import COLUMNS as LIGHT_COLUMNS
from romis_tpu_torch.scene.objloader import Material, load_obj, write_obj
from romis_tpu_torch.scene.scene import (
    COLUMNS, flagship_camera, flagship_scene, torus_field_submeshes,
)
from romis_tpu_torch.utils.debug_vis import debug_images
from romis_tpu_torch.utils.stats import frame_ray_counts, reservoir_stats

from helpers import random_reservoirs_and_ctx
from torch_parity import port_camera, port_features, port_reservoirs

REPO = Path(__file__).resolve().parents[1]
INLINE_TOML = """
command_line_rendering = true
window_size = [320, 240]
scene = 4
output_dir = "out"
[features]
ray_trace_mode = "rmis"
initial_light_samples = 12
unbiased_combination = true
enable_shading = true
enable_recursive = true
[[cameras]]
field_of_view = 42.0
distance_from_look_at = 3.5
look_at = [1.0, 2.0, 3.0]
rotation = [10.0, 20.0, 30.0]
[[lights]]
type = "point"
position = [0.0, 1.0, 0.0]
color = [1.0, 1.0, 1.0]
[[lights]]
type = "parallelogram"
corner = [0.0, 0.0, 0.0]
edges = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
colors = [[1,1,1],[0.5,0.5,0.5],[0.5,0.5,0.5],[1,1,1]]
[[lights]]
type = "segment"
endpoints = [[0.0, 2.0, 0.0], [1.0, 2.0, 0.5]]
colors = [[1, 0.5, 0.2], [0.2, 0.5, 1]]
"""


def _light_arrays_jax(builder):
    table = builder.build()
    return {c: np.asarray(getattr(table, c))
            for c in LIGHT_COLUMNS + ("kind",)}


@pytest.mark.parametrize("source", ["cornell", "nightclub", "inline"])
def test_read_config_file_matches_jax(source, tmp_path):
    if source == "inline":
        path = tmp_path / "c.toml"
        path.write_text(INLINE_TOML)
    else:
        path = REPO / "configs" / f"{source}.toml"
    got, expect = read_config_file(str(path)), jax_read_config(str(path))
    assert got.features.to_json() == expect.features.to_json()
    for f in ("cli_rendering_enabled", "window_size", "data_path", "scene",
              "scene_is_file", "output_dir"):
        assert getattr(got, f) == getattr(expect, f), f
    assert [vars(c) for c in got.cameras] == [vars(c) for c in expect.cameras]
    assert len(got.lights) == len(expect.lights)
    if len(expect.lights):
        a, b = got.lights.arrays(), _light_arrays_jax(expect.lights)
        for c in b:
            np.testing.assert_array_equal(a[c], b[c], err_msg=c)


def _small_mesh():
    """Two submeshes of the torus field at n = 1, then a second material:
    970 triangles."""
    subs = torus_field_submeshes(1)
    subs[1].material = Material(kd=(0.2, 0.4, 0.6), ks=(0.1, 0.1, 0.1),
                                shininess=8.0)
    return subs


def _same_scene(port, jax_scene):
    for c in COLUMNS:
        np.testing.assert_array_equal(
            getattr(port.geometry, c).numpy(),
            np.asarray(getattr(jax_scene.geometry, c)), err_msg=c)
    assert port.num_lights == jax_scene.num_lights
    assert port.name == jax_scene.name
    for c in LIGHT_COLUMNS + ("kind",):
        np.testing.assert_array_equal(getattr(port.lights, c).numpy(),
                                      np.asarray(getattr(jax_scene.lights, c)),
                                      err_msg=c)


def test_obj_writer_round_trip(tmp_path):
    subs = _small_mesh()
    write_obj(str(tmp_path / "m.obj"), subs)
    back = load_obj(str(tmp_path / "m.obj"))
    assert len(back) == len(subs)
    for a, b in zip(back, subs):
        for f in ("positions", "normals", "texcoords"):
            np.testing.assert_array_equal(getattr(a, f)[a.triangles],
                                          getattr(b, f)[b.triangles])
        assert a.material.kd == pytest.approx(b.material.kd)


@pytest.mark.parametrize("name", ["single_triangle", "cube", "cornell_box",
                                  "cornell_box_parallelogram_light",
                                  "monkey"])
def test_load_prebuilt_matches_jax(name, tmp_path):
    obj = port_scene_mod._PREBUILT[name][0]
    write_obj(str(tmp_path / obj), _small_mesh())
    got = port_scene_mod.load_prebuilt(name, str(tmp_path), device="cpu")
    _same_scene(got, jax_scene_mod.load_prebuilt(name, str(tmp_path)))


def test_file_scene_and_monkey_field_match_jax(tmp_path, monkeypatch):
    from romis_tpu.scene.lights import LightListBuilder as JaxLights
    from romis_tpu_torch.scene.lights import LightListBuilder

    write_obj(str(tmp_path / "monkey.obj"), _small_mesh()[:1])
    monkeypatch.setenv("ROMIS_DATA_DIR", str(tmp_path))
    assert port_scene_mod.default_data_dir() == str(tmp_path)
    got = port_scene_mod.load_monkey_field(2, device="cpu")
    _same_scene(got, jax_scene_mod.load_monkey_field(2, str(tmp_path)))
    assert got.num_lights == 3
    lights = LightListBuilder().add_point((0, 3, 0), (2, 2, 2))
    jlights = JaxLights().add_point((0, 3, 0), (2, 2, 2))
    path = str(tmp_path / "monkey.obj")
    _same_scene(port_scene_mod.load_scene_from_file(path, lights,
                                                    device="cpu"),
                jax_scene_mod.load_scene_from_file(path, jlights))


def test_missing_data_dir_raises(monkeypatch):
    monkeypatch.setattr(port_scene_mod, "default_data_dir", lambda: None)
    with pytest.raises(FileNotFoundError, match="ROMIS_DATA_DIR"):
        port_scene_mod.load_prebuilt("cube", device="cpu")


def _render(gen, state, n, h=8, w=12):
    scene, cam = flagship_scene("cpu"), flagship_camera(h, w, "cpu")
    feats = port_features(Features(initial_light_samples=4,
                                   num_neighbours_to_sample=2,
                                   spatial_resample_radius=2))
    img = None
    for _ in range(n):
        img, state = render_frame(gen, cam, scene, h, w, feats, state)
    return img, state


def test_checkpoint_round_trip_and_bit_identical_resume(tmp_path):
    gen = torch.Generator().manual_seed(9)
    full, _ = _render(gen, None, 4)
    gen = torch.Generator().manual_seed(9)
    _, state = _render(gen, None, 2)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state, gen, 1)
    template = initial_temporal_state(8, 12, 2, state.cam)
    back, gen_state, frame = load_checkpoint(path, template)
    assert frame == 1 and back.has_prev
    for part in ("reservoirs", "ctx", "cam"):
        a, b = getattr(back, part), getattr(state, part)
        for f in vars(a):
            assert torch.equal(getattr(a, f), getattr(b, f)), (part, f)
    assert torch.equal(gen_state, gen.get_state())
    resumed = torch.Generator().manual_seed(123)
    resumed.set_state(gen_state)
    img, _ = _render(resumed, back, 2)
    assert torch.equal(img, full)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, initial_temporal_state(4, 12, 2, state.cam))


def _scene_file(tmp_path):
    path = tmp_path / "ring.obj"
    write_obj(str(path), _small_mesh())
    cfg = tmp_path / "app.toml"
    cfg.write_text(
        'output_dir = "unused"\n[features]\ninitial_light_samples = 4\n'
        'num_neighbours_to_sample = 2\nspatial_resample_radius = 2\n'
        'max_iterations_mis = 2\nunbiased_combination = true\n'
        'spatial_reuse_visibility_check = true\n'
        '[[lights]]\ntype = "point"\nposition = [0.5, 3.0, 0.0]\n'
        'color = [6.0, 6.0, 6.0]\n[[cameras]]\nlook_at = [0.0, -0.3, 0.0]\n'
        'rotation = [25.0, 30.0, 0.0]\ndistance_from_look_at = 4.0\n'
        'field_of_view = 50.0\n')
    return str(path), str(cfg)


def _cli(cfg, scene, out, *extra):
    return cli.main(["--device", "cpu", "--config", cfg, "--scene", scene,
                     "--size", "12", "8", "--format", "npy", "--out",
                     str(out), *extra])


def test_cli_resumes_bit_identically(tmp_path):
    scene, cfg = _scene_file(tmp_path)
    assert _cli(cfg, scene, tmp_path / "a", "--frames", "4",
                "--checkpoint", str(tmp_path / "ck_a")) == 0
    assert _cli(cfg, scene, tmp_path / "b", "--frames", "2",
                "--checkpoint", str(tmp_path / "ck_b")) == 0
    assert _cli(cfg, scene, tmp_path / "c", "--frames", "4",
                "--checkpoint", str(tmp_path / "ck_b")) == 0
    a, c = (np.load(next((tmp_path / d).glob("ring_*_cam_0.npy")))
            for d in ("a", "c"))
    assert a.shape == (8, 12, 3) and np.isfinite(a).all() and a.mean() > 0
    np.testing.assert_array_equal(a, c)
    b = np.load(next((tmp_path / "b").glob("ring_*_cam_0.npy")))
    assert not np.array_equal(a, b)
    with pytest.raises(SystemExit, match="already covers"):
        _cli(cfg, scene, tmp_path / "d", "--frames", "4", "--checkpoint",
             str(tmp_path / "ck_b"))
    # The provenance JSON is the JAX package's Features.to_json().
    prov = [p for p in (tmp_path / "a").glob("*.json")]
    assert len(prov) == 1
    assert json.loads(prov[0].read_text()) == json.loads(
        jax_read_config(cfg).features.to_json())


def test_cli_save_alphas_and_debug_vis(tmp_path):
    scene, cfg = _scene_file(tmp_path)
    out = tmp_path / "romis"
    assert _cli(cfg, scene, out, "--mode", "romis", "--save-alphas",
                "--debug-vis") == 0
    alphas = sorted(out.glob("ring_*_alpha_*.npy"))
    assert len(alphas) == 3 * 3  # D1 = 3 techniques x 3 channels
    assert all(np.isfinite(np.load(a)).all() for a in alphas)
    assert len(list(out.glob("ring_*_debug_*.png"))) == 9
    assert len(list(out.glob("ring_*_cam_0.npy"))) == 1


def test_cli_default_save_alphas_writes_18(tmp_path):
    """At the reference's D = 5: 6 techniques x 3 channels."""
    scene, _ = _scene_file(tmp_path)
    cfg = tmp_path / "d5.toml"
    cfg.write_text('[features]\ninitial_light_samples = 4\n'
                   'max_iterations_mis = 1\nspatial_resample_radius = 2\n'
                   '[[lights]]\ntype = "point"\nposition = [0.5, 3.0, 0.0]\n'
                   'color = [6.0, 6.0, 6.0]\n[[cameras]]\n'
                   'look_at = [0.0, -0.3, 0.0]\ndistance_from_look_at = 4.0\n')
    out = tmp_path / "d5"
    assert _cli(str(cfg), scene, out, "--mode", "romis",
                "--save-alphas") == 0
    assert len(list(out.glob("ring_*_alpha_*.npy"))) == 18


def test_cli_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    scene, cfg = _scene_file(tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["--config", cfg, "--scene", scene, "--out",
                  str(tmp_path / "x")])


FEATURE_SETS = [
    dict(),
    dict(unbiased_combination=True, spatial_reuse_visibility_check=True),
    dict(initial_samples_visibility_check=True, temporal_reuse=False),
    dict(spatial_reuse=False, num_samples_in_reservoir=4,
         spatial_reuse_visibility_check=True),
]


@pytest.mark.parametrize("flags", FEATURE_SETS,
                         ids=["config5", "vischeck", "initcheck", "k4"])
def test_frame_ray_counts_match_jax(flags):
    f = Features(**flags)
    assert frame_ray_counts(270, 480, port_features(f)) == \
        jax_frame_ray_counts(270, 480, f)


def test_vischeck_counts_24_z_rays_a_pixel():
    counts = frame_ray_counts(1, 1, port_features(Features(
        unbiased_combination=True, spatial_reuse_visibility_check=True)))
    base = frame_ray_counts(1, 1, port_features(Features(
        unbiased_combination=True)))
    assert counts["shadow_rays"] - base["shadow_rays"] == 2 * 6 * 2


def test_reservoir_stats_match_jax():
    jres, _ = random_reservoirs_and_ctx(np.random.default_rng(4), 9, 11, 2)
    got, expect = reservoir_stats(port_reservoirs(jres)), \
        jax_reservoir_stats(jres)
    assert got.keys() == expect.keys()
    for k in got:
        assert got[k] == pytest.approx(expect[k], rel=1e-5), k


def test_debug_images_match_jax():
    """The deterministic channels (primary hits and materials) equal JAX's;
    the sample channels are finite images of the same size."""
    import __graft_entry__ as ge

    from torch_parity import port_scene

    h, w = 12, 16
    jscene = ge._flagship_scene()
    jcam = jax_make_camera(look_at=(2.57, 1.23, -1.35),
                           rotation_deg=(10.3, 30.0, 0.0), distance=25.0,
                           fov_deg=30.0, resolution=(h, w))
    feats = Features(initial_light_samples=4)
    expect = jax_debug_images(jax.random.PRNGKey(0), jcam, jscene, h, w, feats)
    got = debug_images(torch.Generator().manual_seed(0), port_camera(jcam),
                       port_scene(jscene), h, w, port_features(feats))
    assert got.keys() == expect.keys()
    for name in ("hit_mask", "depth", "normals", "albedo", "geom_id"):
        np.testing.assert_allclose(got[name], np.asarray(expect[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for img in got.values():
        assert img.shape == (h, w, 3) and np.isfinite(img).all()


def test_write_provenance(tmp_path):
    f = Features(unbiased_combination=True)
    path = write_provenance(port_features(f), str(tmp_path / "p"))
    assert Path(path).read_text() == f.to_json()
