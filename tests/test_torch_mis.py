"""The port's R-MIS / R-OMIS against the JAX package's, at 12x16 with D=3,
r=3, S=8, K=2 (JAX pinned to the CPU): the batched MIS RIS pack against
per-iteration canonical RIS on JAX's rebuilt uniforms; one sweep
iteration (the plain version the CPU runs) in the four modes against the
XLA formulation (``rmis_sample_contrib``, ``romis_iteration_terms``) and
against the Pallas sweep kernel in interpret mode; ``solve_alpha``, with
degenerate systems; and whole R-MIS and R-OMIS frames through
``render_frame`` on JAX's rebuilt draws and through ``inject=``."""

from dataclasses import replace
from types import SimpleNamespace

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
from romis_tpu.ops.pallas_mis import (
    mis_iteration_pallas, pack_mis_reservoirs as jax_pack,
    resolve_neighbour_ctx as jax_resolve,
)
from romis_tpu.ops.pallas_spatial import pack_center_ctx as jax_pack_center
from romis_tpu.ops.wrs import _lane_layout, gen_canonical_samples
from romis_tpu.render.neighbours import select_neighbour_indices
from romis_tpu.render.restir import trace_primary
from romis_tpu.render.rmis import (
    PH_ITER, PH_NEIGHBOURS, _gather_neighbourhood, _mis_offsets,
    render_rmis as jax_render_rmis, rmis_sample_contrib,
)
from romis_tpu.render.romis import (
    render_romis as jax_render_romis, romis_iteration_terms,
    solve_alpha as jax_solve_alpha,
)
from romis_tpu_torch.core.camera import generate_rays as port_generate_rays
from romis_tpu_torch.diff.grad import extract_params, make_mis_grad_fn
from romis_tpu_torch.ops import mis, ris
from romis_tpu_torch.ops.shade import pack_center_ctx
from romis_tpu_torch.render import restir
from romis_tpu_torch.render.pipeline import render_frame
from romis_tpu_torch.render.rmis import render_rmis
from romis_tpu_torch.render.romis import render_romis, solve_alpha
from romis_tpu_torch.scene.scene import (
    build_geometry, flagship_camera, flagship_scene,
)

from torch_parity import (
    jax_ris_uniforms, occluder_scene, port_camera, port_ctx, port_features,
    port_reservoirs, port_scene, random_soup, t,
)
from test_torch_nbrsel import jax_selection_noise

H, W, S, K, D, R = 12, 16, 8, 2, 3, 3
D1 = D + 1
FEATS = Features(initial_light_samples=S, num_samples_in_reservoir=K,
                 num_neighbours_to_sample=D, spatial_resample_radius=R,
                 max_iterations_mis=3)
MODES = ["rmis_equal", "rmis_balance", "romis_direct", "romis_progressive"]
OCCLUDER_CAM = dict(look_at=(0.0, -0.5, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                    distance=6.0, fov_deg=50.0)


@pytest.fixture(scope="module")
def setup():
    """The occluder scene (shadows for the sweep's rays), JAX's receivers,
    neighbourhoods and one iteration's canonical reservoirs."""
    scene = occluder_scene(ge._flagship_scene().lights)
    cam = make_camera(resolution=(H, W), **OCCLUDER_CAM)
    _, ctx = trace_primary(generate_rays(cam, H, W), scene.geometry, FEATS)
    key = jax.random.PRNGKey(7)
    ny, nx = select_neighbour_indices(key, ctx, H, W, FEATS)
    res = gen_canonical_samples(jax.random.fold_in(key, 1), ctx,
                                scene.lights, scene.num_lights,
                                scene.geometry, FEATS)
    return scene, ctx, ny, nx, res


def _mode_features(mode):
    return FEATS.replace(
        mis_weight_rmis=(MISWeight.BALANCE if mode == "rmis_balance"
                         else MISWeight.EQUAL),
        use_progressive_romis=mode == "romis_progressive")


@pytest.mark.parametrize("romis", [False, True], ids=["rmis", "romis"])
def test_mis_ris_pack_matches_jax(setup, romis):
    """Every iteration's pack in one call equals the per-iteration canonical
    RIS of JAX's XLA path, packed, on JAX's uniforms."""
    scene, ctx, _, _, _ = setup
    it_n = 3
    keys = jax.random.split(jax.random.PRNGKey(4), it_n)
    expect = jnp.concatenate([jax_pack(gen_canonical_samples(
        keys[i], ctx, scene.lights, scene.num_lights, scene.geometry, FEATS),
        romis) for i in range(it_n)])
    uniforms = torch.from_numpy(np.stack([
        jax_ris_uniforms(keys[i], S, K, H, W) for i in range(it_n)]))
    pscene = port_scene(scene)
    got = ris.gen_mis_reservoir_planes(port_ctx(ctx), pscene.lights,
                                       pscene.num_lights,
                                       port_features(FEATS), it_n, romis,
                                       uniforms=uniforms)
    assert got.shape == (it_n * (8 if romis else 7) * K, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-6)
    assert float(np.asarray(expect)[6 * K].max()) > 0


def _port_sweep(setup, mode, alphas):
    scene, ctx, ny, nx, res = setup
    m = "romis" if mode.startswith("romis") else mode
    pscene = port_scene(scene)
    cen = pack_center_ctx(port_ctx(ctx))
    offs = t(_mis_offsets(ny, nx))
    pack = mis.pack_mis_reservoirs(port_reservoirs(res), m == "romis")
    nbr_ctx = None if m == "rmis_equal" else mis.resolve_neighbour_ctx(
        cen, offs)
    return mis.mis_iteration(
        cen, pack, offs, pscene.geometry, K, m, scene.num_lights,
        port_features(_mode_features(mode)), nbr_ctx=nbr_ctx,
        alphas=None if alphas is None else t(alphas).reshape(3 * D1, H, W))


def _xla_sweep(setup, mode, alphas):
    """One iteration of the reference's XLA formulation, in the sweep's
    output layout (A upper, b flat, the progressive sum before / D1·K)."""
    scene, ctx, ny, nx, res = setup
    feats = _mode_features(mode)
    nbhd_ctx = _gather_neighbourhood(ctx, ny, nx)
    if mode.startswith("rmis"):
        nb = SimpleNamespace(**_gather_neighbourhood(
            dict(pos=res.pos, color=res.color, big_w=res.big_w), ny, nx))
        return (rmis_sample_contrib(ctx, nbhd_ctx, nb, scene.geometry,
                                    feats),)
    nb = SimpleNamespace(**_gather_neighbourhood(
        dict(pos=res.pos, color=res.color, w_sum=res.w_sum,
             chosen_w=res.chosen_w, m=res.m), ny, nx))
    a, b, prog = romis_iteration_terms(
        ctx, nbhd_ctx, nb, alphas, scene.num_lights, scene.geometry, feats)
    iu, ju = np.triu_indices(D1)
    out = (a[iu, ju], b.reshape(3 * D1, H, W))
    return out + ((prog * (D1 * K),) if alphas is not None else ())


def _pallas_sweep(setup, mode, alphas):
    scene, ctx, ny, nx, res = setup
    m = "romis" if mode.startswith("romis") else mode
    cen = jax_pack_center(ctx)
    offs = _mis_offsets(ny, nx)
    _, lane_counts, _ = _lane_layout(S, K)
    out = mis_iteration_pallas(
        cen, jax_pack(res, m == "romis"), offs, scene.geometry, K, R, m,
        scene.num_lights, lane_counts,
        nbr_ctx=None if m == "rmis_equal" else jax_resolve(cen, offs, R),
        alphas=None if alphas is None else alphas.reshape(3 * D1, H, W),
        interpret=True)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("mode", MODES)
def test_mis_iteration_matches_jax(setup, mode, ref):
    """One sweep iteration (the plain version on the CPU) against the XLA
    formulation: rtol 1e-4 of each output's largest element (float32
    rounding; the receiver's p̂ is the norm of the shade planes here, the
    vector form there). Against the Pallas kernel (interpret mode): its
    visibility is a t-window from the unoffset origin and its p̂ gate is
    > 0, so as in the reference's own kernel test rtol 2e-3 with up to 1 %
    of elements allowed off (a grazing ray flipping)."""
    alphas = None
    if mode == "romis_progressive":
        alphas = jax.random.uniform(jax.random.PRNGKey(3), (3, D1, H, W),
                                    minval=-0.5, maxval=0.5)
    got = _port_sweep(setup, mode, alphas)
    got = got if isinstance(got, tuple) else (got,)
    want = (_xla_sweep if ref == "xla" else _pallas_sweep)(setup, mode,
                                                           alphas)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        scale = np.abs(w).max()
        assert scale > 0
        if ref == "xla":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
        else:
            err = np.abs(g - w) / (np.abs(w) + 0.1 * 2e-3 * scale)
            assert (err > 2e-3).mean() <= 0.01, (err > 2e-3).mean()


def _spd(rng, rank):
    a = rng.normal(size=(H, W, D1, rank)).astype(np.float32)
    return np.einsum("hwir,hwjr->ijhw", a, a).astype(np.float32)


@pytest.mark.parametrize("case", ["full_rank", "rank_one", "zero",
                                  "non_finite"])
def test_solve_alpha_matches_jax(case):
    """The unrolled ridge Cholesky against the reference's on the same
    systems: full rank (rtol 1e-5, and A α = b up to the ridge), rank one
    (A = ww^T: the ridge picks the min-norm direction; rtol 1e-4 of the
    largest α, float32 rounding amplified by near-singular pivots), all
    zero (λ = 1e-20 floors the pivots: large finite α, as in the
    reference) and non-finite A at some pixels (α = 0 there)."""
    rng = np.random.default_rng(1)
    a = {"full_rank": lambda: _spd(rng, D1 + 2),
         "rank_one": lambda: _spd(rng, 1),
         "zero": lambda: np.zeros((D1, D1, H, W), np.float32),
         "non_finite": lambda: _spd(rng, D1 + 2)}[case]()
    b = rng.normal(size=(3, D1, H, W)).astype(np.float32)
    if case == "rank_one":  # b in range(A), as the sweep builds it
        b = np.einsum("ijhw,cjhw->cihw", a, b).astype(np.float32)
    if case == "non_finite":
        a[:, :, 0, :4] = np.inf
    got = solve_alpha(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_solve_alpha(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (3, D1, H, W) and np.isfinite(got).all()
    tol = 1e-4 if case == "rank_one" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    if case == "full_rank":
        resid = np.einsum("ijhw,cjhw->cihw", a, got) - b
        assert np.abs(resid).max() <= 1e-3 * np.abs(b).max()
    if case == "non_finite":
        assert not got[:, :, 0, :4].any() and got[:, :, 1:].any()


def _frame_case(mode):
    """(JAX scene, camera, Features) of a whole-frame test. The direct
    estimator and R-MIS use the flagship ground quad; progressive R-OMIS
    uses the occluder scene with random neighbourhoods and α refreshed every
    second iteration: on the flat quad the technique matrix after one
    iteration is near rank one (condition ~1e29), and the α solved from it
    turn float32 rounding differences between XLA and PyTorch (pow, the
    order of sums) into percent-level differences of the image."""
    kw = dict(ray_trace_mode=(RayTraceMode.RMIS if mode.startswith("rmis")
                              else RayTraceMode.ROMIS))
    feats = _mode_features(mode).replace(**kw)
    if mode != "romis_progressive":
        return ge._flagship_scene(), ge._flagship_camera(H, W), feats
    feats = feats.replace(
        max_iterations_mis=5, progressive_update_mod=2,
        neighbour_selection_strategy=NeighbourSelectionStrategy.RANDOM)
    return (occluder_scene(ge._flagship_scene().lights),
            make_camera(resolution=(H, W), **OCCLUDER_CAM), feats)


@pytest.mark.parametrize("draws", ["rebuilt", "inject"])
@pytest.mark.parametrize("mode", MODES)
def test_frame_matches_jax(mode, draws):
    """A whole frame through render_frame against JAX's render_rmis /
    render_romis, rtol 1e-4: on JAX's own draws rebuilt (neighbour-
    selection noise from fold_in(key, PH_NEIGHBOURS), RIS uniforms from
    split(fold_in(key, PH_ITER), iterations)), or with the neighbourhoods
    and per-iteration reservoirs injected into both."""
    jscene, jcam, feats = _frame_case(mode)
    scene, cam = port_scene(jscene), port_camera(jcam)
    fn = jax_render_rmis if mode.startswith("rmis") else jax_render_romis
    key = jax.random.PRNGKey(3)
    it_keys = jax.random.split(jax.random.fold_in(key, PH_ITER),
                               feats.max_iterations_mis)
    if draws == "rebuilt":
        expect = jax.jit(fn, static_argnums=(4, 5, 6, 7))(
            key, jcam, jscene.geometry, jscene.lights, jscene.num_lights, H,
            W, feats)
        noise = (jax_selection_noise(jax.random.fold_in(key, PH_NEIGHBOURS),
                                     feats.neighbour_selection_strategy),
                 torch.from_numpy(np.stack([jax_ris_uniforms(
                     k, S, K, H, W) for k in it_keys])))
        got, state = render_frame(None, cam, scene, H, W,
                                  port_features(feats), noise=noise)
        assert state is None
    else:
        _, ctx = trace_primary(generate_rays(jcam, H, W), jscene.geometry,
                               feats)
        ny, nx = select_neighbour_indices(key, ctx, H, W, feats)
        res = [gen_canonical_samples(k, ctx, jscene.lights,
                                     jscene.num_lights, jscene.geometry,
                                     feats) for k in it_keys]
        expect = fn(key, cam=jcam, geometry=jscene.geometry,
                    lights=jscene.lights, num_lights=jscene.num_lights,
                    height=H, width=W, features=feats,
                    inject=(ny, nx, res))
        port_fn = render_rmis if mode.startswith("rmis") else render_romis
        got = port_fn(None, cam, scene.geometry, scene.lights,
                      scene.num_lights, H, W, port_features(feats),
                      inject=(t(ny), t(nx), [port_reservoirs(r)
                                             for r in res]))
    expect = np.asarray(expect)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-5)
    assert float(expect.mean()) > 0.05


@pytest.mark.parametrize("mode", ["rmis_balance", "romis_progressive"])
def test_kernel_and_plain_ops_agree_on_cpu(mode):
    """On CPU tensors the kernel wrappers run their plain versions: both
    FrameOps render the same MIS frame from the same generator seed (the
    initial visibility check adds the per-iteration RIS and any-hit)."""
    _, _, feats = _frame_case(mode)
    feats = port_features(feats.replace(
        initial_samples_visibility_check=True,
        neighbour_selection_strategy=(
            NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR)))
    scene, cam = flagship_scene("cpu"), flagship_camera(H, W, "cpu")
    images = [render_frame(torch.Generator().manual_seed(0), cam, scene, H,
                           W, feats, ops=ops)[0]
              for ops in (restir.KERNELS, restir.PLAIN)]
    assert torch.equal(images[0], images[1])
    assert bool(torch.isfinite(images[0]).all())


@pytest.mark.parametrize("draws", ["generator", "inject"])
@pytest.mark.parametrize("rmode", [RayTraceMode.RMIS, RayTraceMode.ROMIS],
                         ids=["rmis", "romis"])
def test_mis_frames_sweep_through_ops(rmode, draws):
    """Every iteration's sweep goes through ``ops.mis_iteration``, injected
    reservoirs included, and the selection through ``ops.neighbour_select``
    (exact call counts), so on the card the kernels run unless the caller
    passes ``restir.PLAIN``."""
    feats = port_features(FEATS.replace(ray_trace_mode=rmode))
    scene, cam = flagship_scene("cpu"), flagship_camera(H, W, "cpu")
    calls = {"mis_iteration": 0, "neighbour_select": 0}

    def counted(name):
        fn = getattr(restir.KERNELS, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    ops = replace(restir.KERNELS, **{n: counted(n) for n in calls})
    gen = torch.Generator().manual_seed(2)
    inject = None
    if draws == "inject":
        rows = torch.arange(H, dtype=torch.int32)[None, :, None]
        cols = torch.arange(W, dtype=torch.int32)[None, None, :]
        ny = torch.clamp(rows + torch.arange(D1)[:, None, None] - 1, 0,
                         H - 1).expand(D1, H, W).int().contiguous()
        nx = cols.expand(D1, H, W).int()
        ny[0] = rows[0]
        _, ctx = restir.trace_primary(port_generate_rays(cam, H, W),
                                      scene.geometry, feats, restir.PLAIN)
        res = [ris.gen_canonical_samples_ris(ctx, scene.lights,
                                             scene.num_lights, feats,
                                             generator=gen)
               for _ in range(feats.max_iterations_mis)]
        inject = (ny, nx.contiguous(), res)
    fn = render_rmis if rmode == RayTraceMode.RMIS else render_romis
    img = fn(gen, cam, scene.geometry, scene.lights, scene.num_lights, H, W,
             feats, inject=inject, ops=ops)
    assert bool(torch.isfinite(img).all())
    assert calls == {"mis_iteration": feats.max_iterations_mis,
                     "neighbour_select": 0 if inject else 1}


def test_return_alphas():
    """With return_alphas R-OMIS also returns the per-technique α images
    [D1, H, W, 3], whose sum over the techniques is the direct estimate."""
    feats = port_features(FEATS.replace(ray_trace_mode=RayTraceMode.ROMIS,
                                        enable_tone_mapping=False))
    scene, cam = flagship_scene("cpu"), flagship_camera(H, W, "cpu")
    img, alphas = render_romis(torch.Generator().manual_seed(1), cam,
                               scene.geometry, scene.lights,
                               scene.num_lights, H, W, feats,
                               return_alphas=True)
    assert alphas.shape == (D1, H, W, 3)
    torch.testing.assert_close(alphas.sum(dim=0), img)


@pytest.mark.parametrize("later", ["surrogate", "large_scene"])
def test_later_slices_refuse(later):
    """A soup above the soup kernels' 2048 triangles without a BVH refuses,
    naming ``with_bvh`` (with one it renders: ``test_torch_large_mis.py``).
    The MIS gradient formulation, which refused here until it was ported,
    now renders: the surrogate R-MIS frame is finite, and its gradient step
    (``make_mis_grad_fn``) reaches the lights' colours."""
    feats = port_features(FEATS.replace(ray_trace_mode=RayTraceMode.RMIS))
    scene, cam = flagship_scene("cpu"), flagship_camera(4, 4, "cpu")
    if later == "surrogate":
        feats = feats.replace(surrogate_resampling_grad=True)
        img, _ = render_frame(torch.Generator(), cam, scene, 4, 4, feats)
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
        fn = make_mis_grad_fn(scene.geometry, scene.lights, scene.num_lights,
                              4, 4, feats)
        _, grads = fn(extract_params(scene.geometry, scene.lights),
                      torch.zeros((4, 4, 3)), torch.Generator(), cam)
        assert float(grads.light_c0.abs().max()) > 0
        return
    soup = build_geometry([random_soup(np.random.default_rng(0), 2100)],
                          "cpu")
    scene = replace(scene, geometry=soup)
    with pytest.raises(ValueError, match="with_bvh"):
        render_frame(torch.Generator(), cam, scene, 4, 4, feats)
