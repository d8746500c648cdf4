"""The port's sharded R-MIS / R-OMIS training step (``parallel.mis.
make_sharded_mis_train_step``) on the CPU, in four gloo ranks spawned once
that run every case (``torch_ranks.grad_body``) at world sizes 1, 2 (two
subgroups) and 4, on 16 x 32 images with a neighbour radius of 2, D = 2,
K = 2 and two iterations (three, α refreshed on the third, for
progressive R-OMIS), while this process runs the reference:

(d) the step's loss and gradients against ``jax.grad`` through the
    reference's ``render_rmis_sharded`` / ``render_romis_sharded`` with
    ``inject`` (after ``tests/test_parallel_mis.py``): R-MIS balance and
    R-OMIS direct on the flagship, progressive R-OMIS on the occluder scene
    with random neighbourhoods (as ``test_torch_mis_grad.py`` chose them);
    the loss within rtol 1e-4, each leaf within GRAD_REL of its largest
    |g|. The reference runs each mode on one mesh (JAX_MESH: 2 or 4
    devices; each compilation costs ~20 s), and the port's worlds 2 and 4
    are held to it: the reference's sharded frames on injected draws are
    its single-device frames up to float32 rounding on any mesh;
(e) the step against the port's single-device ``make_mis_grad_fn`` without
    ``inject``: the image rows bit for bit, the loss within rtol 1e-6, each
    leaf within rtol 1e-5 and 1e-5 of its largest |g| (float32 sums in
    another order): R-MIS balance, progressive R-OMIS and R-OMIS with the
    surrogate (the replay records and kernel 14's plain band replay);
(f) after a step every rank holds the same parameters, the loss is finite
    and positive, and light_c0's gradient is not zero.
"""

from dataclasses import fields

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from romis_tpu.core.camera import generate_rays, make_camera
from romis_tpu.core.features import (
    Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
)
from romis_tpu.diff.grad import (
    apply_params as jax_apply_params, extract_params as jax_extract_params,
)
from romis_tpu.ops.wrs import gen_canonical_samples
from romis_tpu.parallel.mesh import make_mesh
from romis_tpu.parallel.mis import (
    render_rmis_sharded as jax_rmis_sharded,
    render_romis_sharded as jax_romis_sharded,
)
from romis_tpu.render.neighbours import select_neighbour_indices
from romis_tpu.render.restir import trace_primary

import torch_ranks
from torch_parity import (
    occluder_scene, port_camera, port_features, port_params,
    port_reservoirs, port_scene, t,
)

H, W, RADIUS = 16, 32, 2
GRAD_REL = 2e-3
MIS_GEN = ["rmis_balance", "romis_progressive", "romis_surrogate"]
# The reference's mesh for each mode (see (d)).
JAX_MESH = {"rmis_balance": 2, "romis_direct": 4, "romis_progressive": 2}
OCCLUDER_CAM = dict(look_at=(0.0, -0.5, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                    distance=6.0, fov_deg=50.0)


def _target(seed):
    return np.random.default_rng(seed).uniform(0.0, 0.3, (H, W, 3)).astype(
        np.float32)


def _mis_case(mode):
    """(JAX scene, camera, Features) of a mode: the flagship, and for
    progressive R-OMIS the occluder scene with random neighbourhoods."""
    progressive = mode == "romis_progressive"
    feats = Features(
        enable_tone_mapping=False, initial_light_samples=8,
        num_samples_in_reservoir=2, num_neighbours_to_sample=2,
        spatial_resample_radius=RADIUS,
        max_iterations_mis=3 if progressive else 2, progressive_update_mod=2,
        ray_trace_mode=(RayTraceMode.RMIS if mode.startswith("rmis")
                        else RayTraceMode.ROMIS),
        mis_weight_rmis=MISWeight.BALANCE,
        neighbour_selection_strategy=(
            NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR
            if mode == "rmis_balance" else NeighbourSelectionStrategy.SIMILAR),
        use_progressive_romis=progressive,
        surrogate_resampling_grad=mode == "romis_surrogate")
    if not progressive:
        return ge._flagship_scene(), ge._flagship_camera(H, W), feats
    feats = feats.replace(
        neighbour_selection_strategy=NeighbourSelectionStrategy.RANDOM)
    return (occluder_scene(ge._flagship_scene().lights),
            make_camera(resolution=(H, W), **OCCLUDER_CAM), feats)


def _inject(jscene, jcam, feats):
    """The reference's hook: the frame's neighbourhoods and one canonical
    reservoir set per iteration."""
    @jax.jit
    def draws(key):
        _, ctx = trace_primary(generate_rays(jcam, H, W), jscene.geometry,
                               feats)
        ny, nx = select_neighbour_indices(key, ctx, H, W, feats)
        keys = jax.random.split(jax.random.fold_in(key, 9),
                                feats.max_iterations_mis)
        return ny, nx, [gen_canonical_samples(
            k, ctx, jscene.lights, jscene.num_lights, jscene.geometry, feats)
            for k in keys]
    return draws(jax.random.PRNGKey(3))


def _jax_grads(cases, target):
    """mode → (loss, gradients) of jax.grad through the reference's sharded
    frame with ``inject`` on the mode's mesh."""
    out = {}
    for mode, (js, jc, feats, inject) in cases.items():
        feats = feats.replace(fused_resampling=False)
        render = jax_rmis_sharded if mode.startswith("rmis") \
            else jax_romis_sharded
        mesh = make_mesh(JAX_MESH[mode])

        def loss(p, js=js, jc=jc, feats=feats, inject=inject, render=render,
                 mesh=mesh):
            g, li = jax_apply_params(js.geometry, js.lights, p)
            img = render(jax.random.PRNGKey(0), jc, g, li, js.num_lights, H, W,
                         feats, mesh, inject=inject)
            return jnp.mean((img - target) ** 2)

        loss_v, grads = jax.jit(jax.value_and_grad(loss))(
            jax_extract_params(js.geometry, js.lights))
        out[mode] = float(loss_v), {f: np.asarray(getattr(grads, f))
                                    for f in vars(grads)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's ranks' results, the single-device steps, and the
    reference's gradients."""
    mis, jax_cases = {}, {}
    target = _target(2)
    for mode in JAX_MESH:
        js, jc, feats = _mis_case(mode)
        ny, nx, res = _inject(js, jc, feats)
        jax_cases[mode] = (js, jc, feats, (ny, nx, res))
        mis[mode] = (port_scene(js), port_camera(jc), port_features(feats),
                     port_params(jax_extract_params(js.geometry, js.lights)),
                     t(target),
                     (t(ny), t(nx), [port_reservoirs(r) for r in res]), 0)
    for mode in MIS_GEN:
        js, jc, feats = _mis_case(mode)
        mis["gen_" + mode] = (
            port_scene(js), port_camera(jc), port_features(feats),
            port_params(jax_extract_params(js.geometry, js.lights)),
            t(_target(3)), None, 40)
    inputs = dict(mis=mis)
    started = torch_ranks.start(str(tmp_path_factory.mktemp("ranks")),
                                "grad", inputs)
    try:
        expect = _jax_grads(jax_cases, jnp.asarray(target))
    finally:
        out, single = torch_ranks.finish(started)
    return dict(out=out, single=single, inputs=inputs, jax=expect)


# ---- (d) the gradients against the reference's ----


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", JAX_MESH)
def test_sharded_mis_grads_match_jax(runs, mode, world):
    loss_exp, g_exp = runs["jax"][mode]
    got = runs["out"][world][0]["mis"][mode]
    np.testing.assert_allclose(float(got["loss"]), loss_exp, rtol=1e-4)
    for f, e in g_exp.items():
        g = getattr(got["grads"], f).numpy()
        assert np.isfinite(g).all(), f
        scale = max(float(np.abs(e).max()), 1e-12)
        np.testing.assert_allclose(g, e, rtol=GRAD_REL, atol=GRAD_REL * scale,
                                   err_msg=f)
    for f in ("mat_kd", "tri_v0"):
        assert float(np.abs(g_exp[f]).max()) > 0, f


# ---- (e) the step against the port's single-device step ----


@pytest.mark.parametrize("world", torch_ranks.WORLDS)
@pytest.mark.parametrize("mode", MIS_GEN)
def test_sharded_mis_step_equals_single(runs, mode, world):
    want = runs["single"]["mis"]["gen_" + mode]
    outs = [o["mis"]["gen_" + mode] for o in runs["out"][world]]
    image = torch_ranks.image_rows(o["image"] for o in outs)
    assert torch.equal(image, want["image"])
    torch.testing.assert_close(outs[0]["loss"], want["loss"], rtol=1e-6,
                               atol=0)
    torch_ranks.close_grads(outs[0]["grads"], want["grads"])
    assert float(want["image"].mean()) > 0.01


# ---- (f) the step on every rank ----


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", MIS_GEN)
def test_every_rank_takes_the_same_step(runs, mode, world):
    outs = [o["mis"]["gen_" + mode] for o in runs["out"][world]]
    for o in outs[1:]:
        for f in fields(o["params"]):
            assert torch.equal(getattr(o["params"], f.name),
                               getattr(outs[0]["params"], f.name)), f.name
    for o in outs:
        assert bool(torch.isfinite(o["loss"])) and float(o["loss"]) > 0
    assert float(outs[0]["grads"].light_c0.abs().max()) > 0
