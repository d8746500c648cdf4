"""The port's band-sequential R-MIS / R-OMIS (``diff.banded``) at 12x16 in 3
bands of 4 rows with a halo of r = 2, D = 2, S = 4, K = 2: with the
neighbourhoods and reservoirs injected, the banded frame against the
port's single-pass frame (and its gradients against the single-pass
step's) at the reference's own bounds (``tests/test_grad_banded.py``), and
against JAX's ``render_mis_banded``; without injection, the banded loss's
gradient against central differences; and the band split's refusals."""

from dataclasses import fields, replace

import numpy as np
import jax
import pytest
import torch

from romis_tpu.core.camera import generate_rays
from romis_tpu.diff.banded import render_mis_banded as jax_render_banded
from romis_tpu.ops.wrs import gen_canonical_samples
from romis_tpu.render.neighbours import select_neighbour_indices
from romis_tpu.render.restir import trace_primary
from romis_tpu.render.rmis import PH_ITER, PH_NEIGHBOURS
from romis_tpu_torch.diff import grad as port_grad
from romis_tpu_torch.diff.banded import mis_banded_l2_loss, render_mis_banded
from romis_tpu_torch.diff.grad import extract_params, mis_l2_image_loss
from romis_tpu_torch.render.rmis import render_rmis
from romis_tpu_torch.render.romis import render_romis

from torch_parity import (
    port_camera, port_features, port_reservoirs, port_scene, t,
)
from test_torch_mis_grad import H, MODES, W, _case

N_BANDS = 3


def _inject(jscene, jcam, feats, key=0):
    """JAX's neighbourhoods and per-iteration canonical reservoirs, shared
    by every renderer of a test."""
    _, ctx = trace_primary(generate_rays(jcam, H, W), jscene.geometry, feats)
    k = jax.random.PRNGKey(key)
    ny, nx = select_neighbour_indices(jax.random.fold_in(k, PH_NEIGHBOURS),
                                      ctx, H, W, feats, jscene.geometry)
    it_keys = jax.random.split(jax.random.fold_in(k, PH_ITER),
                               feats.max_iterations_mis)
    res = [gen_canonical_samples(ik, ctx, jscene.lights, jscene.num_lights,
                                 jscene.geometry, feats) for ik in it_keys]
    return ny, nx, res


def _port_inject(inj):
    ny, nx, res = inj
    return t(ny), t(nx), [port_reservoirs(r) for r in res]


def _setup(mode):
    jscene, jcam, feats = _case(mode)
    feats = feats.replace(fused_resampling=False)
    scene, cam = port_scene(jscene), port_camera(jcam)
    args = (cam, scene.geometry, scene.lights, scene.num_lights, H, W,
            port_features(feats))
    return jscene, jcam, feats, scene, args


@pytest.mark.parametrize("mode", MODES)
def test_banded_equals_single_pass_with_injection(mode):
    """Injected, the banded frame is the single-pass frame re-read through
    band slices: within 1e-5, and the 13 leaves of the L2 step within rtol
    5e-4 (atol 2e-5 of each leaf's largest |g|)."""
    jscene, jcam, feats, scene, args = _setup(mode)
    inj = _port_inject(_inject(jscene, jcam, feats))
    single = render_rmis if mode.startswith("rmis") else render_romis
    with torch.no_grad():
        ref = single(None, *args, inject=inj)
        banded = render_mis_banded(None, *args, N_BANDS, inject=inj)
    assert banded.shape == (H, W, 3) and float(ref.mean()) > 0.05
    torch.testing.assert_close(banded, ref, rtol=1e-5, atol=1e-5)
    params = extract_params(scene.geometry, scene.lights)
    target = torch.full((H, W, 3), 0.1)
    _, g_ref = port_grad._value_and_grad(
        lambda p: mis_l2_image_loss(p, target, None, *args, inject=inj),
        params)
    _, g_band = port_grad._value_and_grad(
        lambda p: mis_banded_l2_loss(p, target, None, *args, N_BANDS,
                                     inject=inj), params)
    for f in fields(g_ref):
        a, b = getattr(g_ref, f.name), getattr(g_band, f.name)
        assert bool(torch.isfinite(b).all()), f.name
        scale = max(float(a.abs().max()), 1e-12)
        torch.testing.assert_close(b, a, rtol=5e-4, atol=2e-5 * scale,
                                   msg=f.name)
    assert float(g_band.tri_v0.abs().max()) > 0


@pytest.mark.parametrize("mode", MODES)
def test_banded_matches_jax_with_injection(mode):
    """The banded frame against JAX's render_mis_banded on the same
    injection: rtol 1e-4 as the whole frames of ``test_torch_mis``, and
    atol 4e-4, the reference's own bound between its banded and
    single-pass frames (``tests/test_grad_banded.py``: float32 rounding
    through near-singular α solves; 2.4e-4 measured on 3 pixels of direct
    R-OMIS on the flat quad)."""
    jscene, jcam, feats, _, args = _setup(mode)
    inj = _inject(jscene, jcam, feats)
    expect = np.asarray(jax_render_banded(
        jax.random.PRNGKey(0), jcam, jscene.geometry, jscene.lights,
        jscene.num_lights, H, W, feats, N_BANDS, inject=inj))
    with torch.no_grad():
        got = render_mis_banded(None, *args, N_BANDS,
                                inject=_port_inject(inj))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=4e-4)
    assert float(expect.mean()) > 0.05


@pytest.mark.parametrize("mode", MODES)
def test_banded_light_colour_matches_finite_differences(mode):
    """Without injection (each band's reservoirs drawn from its own
    generator), the banded loss's gradient along a random direction of the
    lights' colours against central differences at 3e-2, every evaluation
    on a generator seeded alike, at the reference's step 1e-3 (below it
    direct R-OMIS's α solve turns float32 rounding into percent-level
    noise). Every leaf is finite.

    A RIS race that flips inside the step is a step in the loss that no
    gradient carries, as a shadow edge is in ``test_torch_mis_grad``: the
    two one-sided differences then disagree by far more than the loss's
    curvature makes them (progressive R-OMIS on this draw: -0.333 against
    -0.0335 at 1e-3, the flip between -1e-3 and -5e-4). While they
    disagree by more than half the larger, the step is halved, at most
    twice, before the central difference is held to the gradient."""
    _, _, _, scene, args = _setup(mode)
    params = extract_params(scene.geometry, scene.lights)
    target = torch.zeros((H, W, 3))

    def loss(p):
        return mis_banded_l2_loss(p, target, torch.Generator().manual_seed(4),
                                  *args, N_BANDS)

    _, grads = port_grad._value_and_grad(loss, params)
    for f in fields(grads):
        assert bool(torch.isfinite(getattr(grads, f.name)).all()), f.name
    direction = torch.randn(params.light_c0.shape,
                            generator=torch.Generator().manual_seed(1))
    analytic = float((grads.light_c0 * direction).sum())

    def at(step):
        with torch.no_grad():
            return float(loss(replace(
                params, light_c0=params.light_c0 + step * direction)))

    base = at(0.0)
    for eps in (1e-3, 5e-4, 2.5e-4):
        hi, lo = at(eps), at(-eps)
        fwd, bwd = (hi - base) / eps, (base - lo) / eps
        if abs(fwd - bwd) <= 0.5 * max(abs(fwd), abs(bwd)):
            break
    fd = (hi - lo) / (2 * eps)
    assert abs(analytic) > 0
    assert abs(fd - analytic) <= 3e-2 * max(abs(fd), abs(analytic)), \
        (fd, analytic, eps)


@pytest.mark.parametrize("bands, match", [(5, "divide into"),
                                          (6, "cover the halo radius")])
def test_band_split_refused(bands, match):
    """12 rows do not split into 5 equal bands, and 6 bands of 2 rows
    cannot hold a halo of radius 3: each refusal names its rule."""
    _, _, feats, _, args = _setup("rmis_equal")
    args = args[:-1] + (args[-1].replace(spatial_resample_radius=3),)
    with pytest.raises(ValueError, match=match):
        render_mis_banded(torch.Generator(), *args, bands)
