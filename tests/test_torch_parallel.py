"""The port's sharded ReSTIR frame (``romis_tpu_torch.parallel``) on the
CPU, in four gloo ranks spawned once that run every case
(``torch_ranks.restir_body``) at world sizes 1, 2 (two subgroups) and 4:

- against the JAX package on its 8-device CPU mesh: the halo exchange
  against ``_halo_extend`` under ``shard_map``; ``spatial_reuse_halo`` on
  injected offsets and race noise, biased and unbiased; the sharded frame
  on the JAX package's own draws (``torch_parity.jax_frame_noise``) over
  two frames that carry the state; rtol 1e-4, atol 1e-5 as the frame
  tests;
- against the port's own single-device frame, bit for bit, without
  injected noise: config 5's features, the unbiased combine with its
  visibility check on the occluder scene, and an animated camera with
  temporal reprojection (its 16-row halo);
- the refusals, ``maybe_init_distributed`` without a cluster, the cluster
  variables, and two processes joined through the reference's
  environment variables.
"""

import os
import socket
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from romis_tpu.core.camera import generate_rays as jax_generate_rays
from romis_tpu.core.features import Features
from romis_tpu.ops.wrs import gen_canonical_samples as jax_canonical
from romis_tpu.parallel.halo import _halo_extend
from romis_tpu.parallel.halo import spatial_reuse_halo as jax_spatial_halo
from romis_tpu.parallel.mesh import TILE_AXIS, make_mesh
from romis_tpu.parallel.shard import render_frame_sharded as jax_sharded
from romis_tpu.render.restir import initial_temporal_state as jax_initial
from romis_tpu.render.restir import trace_primary as jax_trace_primary
from romis_tpu_torch.core.camera import make_camera
from romis_tpu_torch.core.types import pack_reservoir_planes
from romis_tpu_torch.parallel import launch
from romis_tpu_torch.parallel.mesh import Bands
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

import torch_ranks
from torch_parity import (
    jax_frame_noise, occluder_scene, port_camera, port_ctx, port_features,
    port_reservoirs, port_scene, t,
)

H, W = 16, 32
RADIUS = 3
WORLDS = (1, 2, 4)
FEATS = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                 spatial_resample_radius=RADIUS)
# The animated case: a frame tall enough for reprojection's 16-row halo on
# four bands, a camera turning about 2 rows and 1.3 columns a frame.
AH, AW = 64, 16
OCCLUDER_CAM = dict(look_at=(0.0, -0.5, 0.0), distance=6.0, fov_deg=50.0)


def _spatial_case(unbiased: bool):
    """JAX's receivers, canonical reservoirs and injected pass noise."""
    feats = FEATS.replace(unbiased_combination=unbiased)
    jscene = ge._flagship_scene()
    jcam = ge._flagship_camera(H, W)
    _, ctx = jax_trace_primary(jax_generate_rays(jcam, H, W),
                               jscene.geometry, feats)
    key = jax.random.PRNGKey(4)
    res = jax_canonical(jax.random.fold_in(key, 1), ctx, jscene.lights,
                        jscene.num_lights, jscene.geometry, feats)
    r, k = feats.num_neighbours_to_sample, feats.num_samples_in_reservoir
    inject = []
    for p in range(feats.spatial_resampling_passes):
        kp = jax.random.fold_in(key, 100 + p)
        inject.append((jax.random.randint(kp, (2, r, H, W), -RADIUS,
                                          RADIUS + 1),
                       jax.random.gumbel(jax.random.fold_in(kp, 1),
                                         (r + 1, k, H, W))))
    return jscene, ctx, res, feats, inject


def _equal_cases():
    """(scene, cameras, Features, seed, (H, W)) of the bit-for-bit cases."""
    from romis_tpu_torch import Features as PortFeatures

    flag = flagship_scene("cpu")
    occ = port_scene(occluder_scene(ge._flagship_scene().lights))
    occ_cam = make_camera(rotation_deg=(25.0, 30.0, 0.0), resolution=(H, W),
                          device="cpu", **OCCLUDER_CAM)
    base = dict(initial_light_samples=8, num_neighbours_to_sample=3,
                spatial_resample_radius=RADIUS)
    turning = [make_camera(rotation_deg=(25.0 + 1.5 * f, 30.0 + 4.0 * f, 0.0),
                           resolution=(AH, AW), device="cpu", **OCCLUDER_CAM)
               for f in range(3)]
    return {
        "config5": (flag, [flagship_camera(H, W, "cpu")] * 2,
                    PortFeatures(**base), 1, (H, W)),
        "vischeck": (occ, [occ_cam] * 2, PortFeatures(
            unbiased_combination=True, spatial_reuse_visibility_check=True,
            **base), 2, (H, W)),
        "animated": (occ, turning, PortFeatures(
            temporal_reprojection=True, unbiased_combination=True,
            initial_samples_visibility_check=True, **base), 3, (AH, AW)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's ranks' results, and the inputs they ran on."""
    d = tmp_path_factory.mktemp("ranks")
    x = torch.arange(2 * H * W, dtype=torch.float32).reshape(2, H, W)
    spatial, jax_inputs = {}, {}
    for name, unbiased in (("biased", False), ("unbiased", True)):
        jscene, ctx, res, feats, inject = _spatial_case(unbiased)
        jax_inputs[name] = (jscene, ctx, res, feats, inject)
        spatial[name] = (port_scene(jscene), port_ctx(ctx),
                         port_reservoirs(res), port_features(feats),
                         [(t(o), t(g)) for o, g in inject], (H, W))
    jscene, jcam = ge._flagship_scene(), ge._flagship_camera(H, W)
    keys = [jax.random.PRNGKey(20 + f) for f in range(2)]
    inputs = dict(
        halo=(x, RADIUS), spatial=spatial,
        frame=(port_scene(jscene), port_camera(jcam), port_features(FEATS),
               [jax_frame_noise(k, FEATS, H, W) for k in keys], (H, W)),
        equal=_equal_cases())
    out, single = torch_ranks.spawn(str(d), "restir", inputs)
    return dict(out=out, single=single, inputs=inputs, jax=jax_inputs,
                frame=(jscene, jcam, keys))


@pytest.fixture(scope="module")
def jax_frames(runs):
    """The reference's sharded frames on its 4-device mesh (two frames, the
    state carried): GSPMD keeps the frame's draws, so its frames do not
    depend on the mesh's size."""
    jscene, jcam, keys = runs["frame"]
    mesh = make_mesh(4)
    fn = jax.jit(lambda key, prev: jax_sharded(
        key, jcam, jscene.geometry, jscene.lights, jscene.num_lights, H, W,
        FEATS, prev, mesh))
    state = jax_initial(H, W, FEATS.num_samples_in_reservoir, jcam)
    images = []
    for key in keys:
        image, state = fn(key, state)
        images.append(np.asarray(image))
    return images, np.asarray(state.reservoirs.m)


def _rows(parts):
    return torch.cat(list(parts), dim=-2)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_extend_matches_jax(runs, world):
    """Each rank's extended band equals the reference's ``_halo_extend``
    band under ``shard_map`` (edge ranks' outer rows zero)."""
    x, radius = runs["inputs"]["halo"]
    mesh = make_mesh(world)

    @partial(shard_map, mesh=mesh, in_specs=P(None, TILE_AXIS, None),
             out_specs=P(None, TILE_AXIS, None))
    def ext(xl):
        return _halo_extend(xl, radius, world)

    expect = np.asarray(ext(x.numpy()))
    got = _rows(o["halo"] for o in runs["out"][world])
    np.testing.assert_array_equal(got.numpy(), expect)
    h_loc = H // world
    assert got.shape == (2, world * (h_loc + 2 * radius), W)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["biased", "unbiased"])
def test_spatial_reuse_halo_matches_jax(runs, mode, world):
    """``spatial_reuse_halo`` with the reference's ``inject`` (the frame's
    offsets and race noise) against the reference's on a mesh of the same
    size."""
    jscene, ctx, res, feats, inject = runs["jax"][mode]
    mesh = make_mesh(world)
    expect = jax.jit(lambda c, r, inj: jax_spatial_halo(
        jax.random.PRNGKey(0), c, r, H, W, jscene.geometry, feats, mesh,
        inject=inj))(ctx, res, inject)
    got = _rows(o[mode] for o in runs["out"][world])
    want = pack_reservoir_planes(port_reservoirs(expect))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    # The passes pooled neighbours: M grew past the canonical counts.
    assert float(got[7 * 2:8 * 2].max()) > 8 / 2


@pytest.mark.parametrize("world", [2, 4])
def test_frame_sharded_matches_jax(runs, jax_frames, world):
    """Two config-5 frames through ``render_frame_sharded`` on the JAX
    package's draws against the reference's sharded frame; the state
    carries."""
    expect, expect_m = jax_frames
    images, _ = runs["out"][world][0]["frame"]
    for got, want in zip(images, expect):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    got_m = _rows(o["frame"][1] for o in runs["out"][world])
    np.testing.assert_allclose(got_m.numpy(), expect_m, rtol=1e-6)
    assert float(expect[-1].mean()) > 0.05


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["config5", "vischeck", "animated"])
def test_sharded_frame_equals_single(runs, case, world):
    """Without injected noise the sharded frame is the single-device frame
    bit for bit: every image, and the last state's reservoir planes,
    band by band."""
    outs = runs["out"][world]
    single_images, single_planes = runs["single"]["equal"][case]
    images, _ = outs[0]["equal"][case]
    assert len(images) == len(single_images)
    for got, want in zip(images, single_images):
        assert torch.equal(got, want)
    planes = _rows(o["equal"][case][1] for o in outs)
    assert torch.equal(planes, single_planes)
    assert float(single_images[-1].mean()) > 0.05


def test_animated_case_reprojects():
    """The animated case's camera turn moves the reprojected predecessor by
    whole rows and columns, so its halo rows are read."""
    from romis_tpu_torch.core.camera import project_to_pixel, generate_rays
    from romis_tpu_torch.render.restir import trace_primary

    scene, cams, feats, _, (h, w) = _equal_cases()["animated"]
    _, ctx = trace_primary(generate_rays(cams[1], h, w), scene.geometry,
                           feats)
    rows, cols, _ = project_to_pixel(cams[0], ctx.position, h, w)
    dy = torch.round(rows) - torch.arange(h)[:, None]
    dx = torch.round(cols) - torch.arange(w)[None, :]
    assert float(dy[ctx.valid].abs().max()) >= 1
    assert float(dx[ctx.valid].abs().max()) >= 1


def test_refusals():
    """The split rules, each refused with a ValueError that names it; the
    gradient options, once refused, render."""
    with pytest.raises(ValueError, match="divide"):
        Bands(30, 4)
    with pytest.raises(ValueError, match="rank"):
        Bands(32, 4, 4)
    bands = Bands(16, 4)
    with pytest.raises(ValueError, match="cover the halo radius"):
        bands.extend(torch.zeros(3, 4, 8), 5)
    with pytest.raises(ValueError, match="cover the halo radius"):
        bands.check_halo(16)
    with pytest.raises(ValueError, match="rows"):
        bands.band_rows(torch.zeros(3, 12, 8))
    # The gradient options render on a band: the surrogate's frame (its
    # replay RIS on the band) is the single frame's, bit for bit.
    from romis_tpu_torch import Features as PortFeatures
    from romis_tpu_torch.parallel.shard import render_frame_sharded
    from romis_tpu_torch.render.pipeline import render_frame

    scene, cam = flagship_scene("cpu"), flagship_camera(16, 8, "cpu")
    feats = PortFeatures(surrogate_resampling_grad=True,
                         initial_light_samples=8, spatial_resample_radius=2)
    img, _ = render_frame_sharded(torch.Generator().manual_seed(9), cam,
                                  scene.geometry, scene.lights,
                                  scene.num_lights, 16, 8, feats, None,
                                  Bands(16))
    ref, _ = render_frame(torch.Generator().manual_seed(9), cam, scene, 16, 8,
                          feats)
    assert torch.equal(img, ref)
    assert float(ref.mean()) > 0.01


def test_maybe_init_distributed_without_cluster(monkeypatch):
    """Without the cluster variables it returns False and starts no
    group; a single process renders its whole image as one band."""
    import torch.distributed as dist

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert launch.maybe_init_distributed("cpu") is False
    assert not dist.is_initialized()
    bands = launch.global_bands(12)
    assert (bands.world, bands.rank, bands.h_loc, bands.row_base) == \
        (1, 0, 12, 0)


def test_cluster_variables(monkeypatch):
    """The reference's variables take precedence over torchrun's."""
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert launch._cluster() == ("env://", 4, 2)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "host0:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    assert launch._cluster() == ("tcp://host0:1234", 2, 1)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from romis_tpu_torch import Features
    from romis_tpu_torch.parallel.launch import (
        global_bands, maybe_init_distributed)
    from romis_tpu_torch.parallel.shard import render_frame_sharded
    from romis_tpu_torch.render.pipeline import render_frame
    from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

    assert maybe_init_distributed("cpu", timeout_s=60)
    import torch.distributed as dist
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    h, w = 16, 16
    bands = global_bands(h)
    assert bands.h_loc == 8
    scene, cam = flagship_scene("cpu"), flagship_camera(h, w, "cpu")
    feats = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                     spatial_resample_radius=2)
    gen = torch.Generator().manual_seed(11)
    img, state = render_frame_sharded(gen, cam, scene.geometry, scene.lights,
                                      scene.num_lights, h, w, feats, None,
                                      bands)
    ref, _ = render_frame(torch.Generator().manual_seed(11), cam, scene, h,
                          w, feats)
    assert torch.equal(img, ref), "sharded frame differs"
    assert state.reservoirs.m.shape[-2] == 8
    dist.destroy_process_group()
    print("rank", int(sys.argv[1]), "ok", flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_through_environment(tmp_path):
    """Two OS processes join one gloo group through the reference's
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID and render one frame
    on two bands, equal to the single-device frame on both ranks."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    root = Path(__file__).resolve().parents[1]
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid)],
        env=dict(env, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 NUM_PROCESSES="2", PROCESS_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"rank {pid} ok" in out
