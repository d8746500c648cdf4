"""The port's sharded ReSTIR training step (``parallel.shard.
make_sharded_train_step``) and the halo exchange's backward on the CPU, in
four gloo ranks spawned once that run every case
(``torch_ranks.grad_body``) at world sizes 1, 2 (two subgroups) and 4, on
16 x 32 images with a neighbour radius of 2, while this process runs the
reference (the MIS step is ``test_torch_parallel_grad_mis.py``'s):

(a) ``halo_extend``'s backward is its transpose: the sum over the ranks of
    <halo_extend(x), c> equals that of <x, its gradient> in float64, the
    gradient is the band's cotangent plus a neighbour's within r rows of an
    inner band edge, and it equals ``jax.vjp`` of the reference's
    ``_halo_extend`` under ``shard_map`` on 2 and 4 of the 8 CPU devices,
    bit for bit (a radius of 2, and of 3, where a band of 4 rows sends rows
    it also receives on);
(b) the step against the reference's ``make_sharded_train_step``, two
    steps (the second on each side's state) on the reference's draws
    (``torch_parity.jax_frame_noise``), for the default features (coherent
    offsets, temporal reprojection, after ``tests/test_parallel.py``; the
    reprojection's radius is 2, which a band of 4 rows covers, and the
    static camera reprojects each pixel to itself),
    ``surrogate_resampling_grad`` and ``exact_gradients``: the loss within
    rtol 1e-4, each leaf's update p' − p within GRAD_REL of the
    reference's largest update of the leaf, plus one float32 spacing of p'
    (the rounding of p − lr·g on each side). The reference runs each
    feature set on one mesh (JAX_MESH: 2 or 4 devices; each of its
    compilations costs ~20 s): GSPMD partitions one program, whose steps do
    not depend on the mesh's size, and the port's worlds 2 and 4 are held
    to it;
(c) the step's value and gradient against the port's single-device
    ``make_grad_fn`` on the generator's draws, two frames with the state
    carried: the image rows bit for bit, the loss within rtol 1e-6, each
    leaf within rtol 1e-5 and 1e-5 of its largest |g| (float32 sums in
    another order);
(f) after a step every rank holds the same parameters, the loss is finite
    and positive, and light_c0 has moved.
"""

from dataclasses import fields
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from romis_tpu.core.features import Features
from romis_tpu.diff.grad import extract_params as jax_extract_params
from romis_tpu.parallel.halo import _halo_extend
from romis_tpu.parallel.mesh import TILE_AXIS, make_mesh
from romis_tpu.parallel.shard import (
    make_sharded_train_step as jax_sharded_step,
)
from romis_tpu.render.restir import initial_temporal_state as jax_initial

import torch_ranks
from torch_parity import (
    jax_frame_noise, port_camera, port_features, port_params, port_scene, t,
)

H, W, RADIUS = 16, 32, 2
GRAD_REL = 2e-3
LR = 1e-2
BASE = dict(enable_tone_mapping=False, initial_light_samples=8,
            num_neighbours_to_sample=3, spatial_resample_radius=RADIUS)
STEP_FEATURES = {
    "default": dict(temporal_reprojection=True, reprojection_radius=RADIUS),
    "grad_surrogate": dict(surrogate_resampling_grad=True),
    "exact": dict(exact_gradients=True),
}
# The reference's mesh for each feature set (see (b)).
JAX_MESH = {"default": 4, "grad_surrogate": 2, "exact": 4}
HALO_CASES = {"r2": 2, "r3": 3}


def _target(seed):
    return np.random.default_rng(seed).uniform(0.0, 0.3, (H, W, 3)).astype(
        np.float32)


def _jax_steps(jscene, jcam, jparams, target, keys):
    """name → the reference's two steps on its mesh: [(params, loss)]."""
    out = {}
    for name, flags in STEP_FEATURES.items():
        feats = Features(**BASE, **flags)
        step = jax_sharded_step(jscene.geometry, jscene.lights,
                                jscene.num_lights, H, W, feats,
                                make_mesh(JAX_MESH[name]), lr=LR)
        state = jax_initial(H, W, feats.num_samples_in_reservoir, jcam)
        # One compilation for both steps: has_prev an array from the
        # start, and the second step's inputs on the host, as the first's.
        p, state = jparams, state.replace(has_prev=jnp.asarray(False))
        out[name] = []
        for key in keys:
            p, loss, state = jax.tree.map(np.asarray, step(
                p, target, key, jcam, state))
            out[name].append(({f: getattr(p, f).astype(np.float64)
                               for f in vars(p)}, float(loss)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's ranks' results, the single-device steps, and
    what the reference needs to take the same steps."""
    rng = np.random.default_rng(0)
    halo = {}
    for name, r in HALO_CASES.items():
        x = rng.normal(size=(2, H, W))
        cs = {w: rng.normal(size=(2, w * (H // w + 2 * r), W))
              for w in torch_ranks.WORLDS}
        halo[name] = (torch.from_numpy(x), {w: torch.from_numpy(c) for w, c
                                            in cs.items()}, r)
        halo[name + "_f32"] = (halo[name][0].float(), {
            w: c.float() for w, c in halo[name][1].items()}, r)

    jscene, jcam = ge._flagship_scene(), ge._flagship_camera(H, W)
    scene, cam = port_scene(jscene), port_camera(jcam)
    jparams = jax_extract_params(jscene.geometry, jscene.lights)
    params = port_params(jparams)
    target = _target(1)
    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]
    restir = {}
    for name, flags in STEP_FEATURES.items():
        feats = Features(**BASE, **flags)
        effective = feats.replace(
            fused_resampling=False,
            coherent_spatial_offsets=not feats.exact_gradients)
        restir[name] = (scene, cam, port_features(feats), params, t(target),
                        [jax_frame_noise(k, effective, H, W) for k in keys],
                        None)
        restir["gen_" + name] = (scene, cam, port_features(feats), params,
                                 t(target), None, 30)

    inputs = dict(halo=halo, restir=restir)
    started = torch_ranks.start(str(tmp_path_factory.mktemp("ranks")),
                                "grad", inputs)
    try:
        expect = _jax_steps(jscene, jcam, jparams, target, keys)
    finally:
        out, single = torch_ranks.finish(started)
    return dict(out=out, single=single, inputs=inputs, jax=expect)


def _rows(parts):
    return torch.cat(list(parts), dim=-2)


def _leaves(params):
    return {f.name: getattr(params, f.name).numpy().astype(np.float64)
            for f in fields(params)}


# ---- (a) the halo exchange's transpose ----


@pytest.mark.parametrize("world", torch_ranks.WORLDS)
@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_backward_is_transpose(runs, case, world):
    """Over the ranks, <halo_extend(x), c> = <x, grad> in float64, and
    the gradient differs from the band's own cotangent exactly on the rows
    within r of an inner band edge (radius 3 at world 4: each inner
    band's 4 rows take both neighbours' 3)."""
    outs = [o["halo"][case] for o in runs["out"][world]]
    lhs = sum(float(o[0]) for o in outs)
    rhs = sum(float(o[1]) for o in outs)
    np.testing.assert_allclose(rhs, lhs, rtol=1e-12)
    x, cs, r = runs["inputs"]["halo"][case]
    grad = _rows(o[2] for o in outs)
    assert grad.shape == x.shape and grad.dtype == torch.float64
    # The gradient is the band's own cotangent, plus a neighbour's on the
    # rows within r of an inner band edge, and only there.
    h = H // world
    c = cs[world].reshape(2, world, h + 2 * r, W)
    own = c[:, :, r:r + h].reshape(2, H, W)
    moved = (grad - own).abs().amax(dim=(0, 2)) > 0
    edge = torch.zeros(H, dtype=torch.bool)
    for b in range(1, world):
        edge[b * h:b * h + r] = True
        edge[b * h - r:b * h] = True
    assert torch.equal(moved, edge)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_backward_matches_jax(runs, case, world):
    """The float32 gradient against ``jax.vjp`` of the reference's
    ``_halo_extend`` under ``shard_map``, bit for bit."""
    x, cs, r = runs["inputs"]["halo"][case + "_f32"]
    mesh = make_mesh(world)

    @partial(shard_map, mesh=mesh, in_specs=P(None, TILE_AXIS, None),
             out_specs=P(None, TILE_AXIS, None))
    def ext(xl):
        return _halo_extend(xl, r, world)

    _, vjp = jax.vjp(ext, jnp.asarray(x.numpy()))
    (expect,) = vjp(jnp.asarray(cs[world].numpy()))
    got = _rows(o["halo"][case + "_f32"][2] for o in runs["out"][world])
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


# ---- (b) the ReSTIR step against the reference's ----


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", STEP_FEATURES)
def test_sharded_step_matches_jax(runs, name, world):
    got = runs["out"][world][0]["restir"][name]
    expect = runs["jax"][name]
    prev_got = prev_exp = _leaves(runs["inputs"]["restir"][name][3])
    for i, (p_exp, loss_exp) in enumerate(expect):
        np.testing.assert_allclose(float(got["loss"][i]), loss_exp,
                                   rtol=1e-4)
        p_got = _leaves(got["params"][i])
        for f, e in p_exp.items():
            step_exp = e - prev_exp[f]
            step_got = p_got[f] - prev_got[f]
            tol = (GRAD_REL * float(np.abs(step_exp).max())
                   + np.spacing(np.abs(e).astype(np.float32)))
            assert np.all(np.abs(step_got - step_exp) <= tol), (i, f)
        prev_got, prev_exp = p_got, p_exp
    moved = max(float(np.abs(p_exp[f] - _leaves(runs["inputs"]["restir"][
        name][3])[f]).max()) for f in ("light_c0", "mat_kd"))
    assert moved > 0


# ---- (c) the ReSTIR step against the port's single-device step ----


@pytest.mark.parametrize("world", torch_ranks.WORLDS)
@pytest.mark.parametrize("name", STEP_FEATURES)
def test_sharded_step_equals_single(runs, name, world):
    want = runs["single"]["restir"]["gen_" + name]
    outs = [o["restir"]["gen_" + name] for o in runs["out"][world]]
    for i in range(2):
        image = torch_ranks.image_rows(o["images"][i] for o in outs)
        assert torch.equal(image, want["images"][i])
        torch.testing.assert_close(outs[0]["loss"][i], want["loss"][i],
                                   rtol=1e-6, atol=0)
        torch_ranks.close_grads(outs[0]["grads"][i], want["grads"][i])
    assert float(want["images"][-1].mean()) > 0.01


# ---- (f) the step on every rank ----


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", STEP_FEATURES)
def test_every_rank_takes_the_same_step(runs, name, world):
    outs = [o["restir"][name] for o in runs["out"][world]]
    for i in range(2):
        params = [o["params"][i] for o in outs]
        for p in params[1:]:
            for f in fields(p):
                assert torch.equal(getattr(p, f.name),
                                   getattr(params[0], f.name)), f.name
        for o in outs:
            assert bool(torch.isfinite(o["loss"][i])) and \
                float(o["loss"][i]) > 0
    before = runs["inputs"]["restir"][name][3].light_c0
    assert not torch.equal(outs[0]["params"][0].light_c0, before)
