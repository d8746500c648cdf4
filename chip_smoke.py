#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``romis_tpu_torch``) on one NVIDIA
GPU.

    python3 chip_smoke.py

1. The device: its name, power limit, and the TF32 switches (both off).
2. The build: every kernel under ``romis_tpu_torch/csrc`` compiled with
   nvcc for sm_90a (one process per source, all at once), with its seconds.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes the 1920x1080 frame gives it on the flagship scene (a ground quad
   under 512 area lights): closest hit, final shade and any-hit also on a
   random soup of 2048 triangles; the halo gather on random offsets and on
   the smooth field of a camera shift; the biased and unbiased spatial
   passes on injected noise (exact) and on their own random streams (means
   within 1 %). Then the gradient step's kernels: the row scatter-add into
   the light table, the material table (every index the same row) and the
   soup's packed vertices; the halo scatter at D=5, C=2; the replay RIS on
   injected uniforms (records exact) and on Philox; and one
   ``torch.autograd.grad`` through each autograd wrapper (row gather, halo
   gather, closest hit, final shade) against autograd of the plain
   version. Tolerances are the constants below.
4. Five main paths, each at 1920x1080, once through the kernels and once
   through the plain versions, with the launch counters set to 0 just
   before and read just after the kernels' run:
   - slice 1: ``Features(spatial_reuse=False)``, 2 frames;
   - config 5: ``Features()`` (the reference defaults of bench.py config 5:
     S=32, K=2, temporal reuse, 2 biased spatial passes of 5 neighbours in
     radius 10), 4 frames;
   - the animated path: a camera turning about 4 pixels per frame, with
     temporal reprojection, the unbiased combine and the initial visibility
     check, 4 frames (``render_animation``).
   - the gradient paths of ``diff.grad.make_grad_fn`` on config 5's
     features without tone mapping: ``grad_surrogate``
     (``surrogate_resampling_grad``: the replay RIS, replay records through
     the reuse phases, coherent spatial offsets) and ``grad_per_pixel``
     (the same with ``exact_gradients``: per-pixel offsets, so big_w goes
     through the halo gather and its scatter), 2 steps each (one on
     injected noise, one on the Philox streams), from the state of one
     forward frame, against a target rendered with the light colours x 0.8.
     The plain run takes the first step's injected noise.
   Every pixel is finite, the last images' means (the losses) agree within
   2 %, the launch counters rose by exactly the per-frame (per-step) counts
   in PATHS, and every gradient leaf is finite, reaches the image where it
   should, and agrees with the plain run's within GRAD_REL of its largest
   element. The last config-5 image goes to ``build/chip_smoke_frame.png``.
5. Timing with CUDA events: ms/frame of each path through the kernels and
   the plain versions (a gradient step beside its forward-only frame, with
   the peak device memory of a step), and each kernel beside its plain
   version.

Any failed check raises, so the exit code is non-zero. The last line is
``{"ok": true, "device": {...}}``; the line before it is the kernel table.
"""

from __future__ import annotations

import json
import math
from dataclasses import replace
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H, W = 1080, 1920
SOUP_TRIS = 2048
PAN_DEG = 0.12  # camera turn per animated frame (~4 px at 1080p, fov 30°)

# Tolerances (kernel vs plain version on the same inputs).
TRACE_T_RTOL = 1e-5  # multiply-add order may differ
MIN_AGREE = 0.9999  # share of pixels / lanes that must agree
RIS_W_SUM_RTOL = 1e-5
RIS_BIG_W_RTOL = 1e-4
SHADE_RTOL, SHADE_ATOL = 2e-4, 1e-5
# Spatial passes: the plain w_sum and M are PyTorch reductions over the
# R+1 streams, whose order of addition on the card may differ from the
# kernel's sequential sum.
PASS_W_SUM_RTOL = 1e-5
PASS_M_RTOL = 1e-6
PASS_BIG_W_RTOL = 1e-4
PHILOX_REL = 0.01  # Philox stream vs torch.rand stream, over the frame
FRAME_REL = 0.02  # last-frame mean, kernels vs plain versions
# Row scatter-add vs index_add_, per (row, component), relative to the sum
# of |contributions| there: both add float32 in no fixed order, and the
# plain version adds up to 2 M terms one by one into the same cell.
SCATTER_REL = 1e-3
SCATTER_F64_REL = 1e-4  # the kernel against a float64 index_add_
HALO_SCATTER_REL = 1e-5  # a few terms per cell, in another order
GRAD_REL = 1e-2  # gradient leaves, kernels vs plain, of the leaf's max |g|

KERNELS = ("closest_hit", "gather_rows", "ris", "final_shade",
           "spatial_pass", "spatial_pass_unbiased", "halo_gather", "any_hit",
           "scatter_rows_add", "halo_scatter", "ris_replay")
SOURCES = {
    "closest_hit": ("romis_tpu_torch/csrc/trace.cu",
                    "romis_tpu/ops/pallas_trace.py:465"),
    "gather_rows": ("romis_tpu_torch/csrc/rows.cu",
                    "romis_tpu/ops/pallas_rows.py:83"),
    "ris": ("romis_tpu_torch/csrc/ris.cu",
            "romis_tpu/ops/pallas_ris.py:473"),
    "final_shade": ("romis_tpu_torch/csrc/shade.cu",
                    "romis_tpu/ops/pallas_shade.py:236"),
    "spatial_pass": ("romis_tpu_torch/csrc/spatial.cu",
                     "romis_tpu/ops/pallas_spatial.py:1151"),
    "spatial_pass_unbiased": ("romis_tpu_torch/csrc/spatial.cu",
                              "romis_tpu/ops/pallas_spatial.py:995"),
    "halo_gather": ("romis_tpu_torch/csrc/halo.cu",
                    "romis_tpu/ops/pallas_spatial.py:283"),
    "any_hit": ("romis_tpu_torch/csrc/any.cu",
                "romis_tpu/ops/pallas_trace.py:506"),
    "scatter_rows_add": ("romis_tpu_torch/csrc/scatter.cu",
                         "romis_tpu/ops/pallas_scatter.py:77"),
    "halo_scatter": ("romis_tpu_torch/csrc/halo.cu",
                     "romis_tpu/ops/pallas_spatial.py:403"),
    "ris_replay": ("romis_tpu_torch/csrc/ris.cu",
                   "romis_tpu/ops/pallas_ris.py:625"),
}
# Launches per frame (per gradient step) of each main path. A gradient
# step's row gathers: hit attributes and materials, the closest hit's
# re-evaluation, the RIS tail's two races, and two replays per spatial
# pass; a scatter for each of them whose table needs a gradient (all but
# the attributes). The any-hit runs in the final shade's backward; the
# per-pixel path adds two halo gathers per pass, one (big_w) with a
# scatter.
PATHS = {
    "slice1": {"closest_hit": 1, "gather_rows": 2, "ris": 1,
               "final_shade": 1},
    "config5": {"closest_hit": 1, "gather_rows": 2, "ris": 1,
                "spatial_pass": 2, "final_shade": 1},
    "animated": {"closest_hit": 1, "gather_rows": 2, "ris": 1, "any_hit": 1,
                 "halo_gather": 1, "spatial_pass_unbiased": 2,
                 "final_shade": 1},
    "grad_surrogate": {"closest_hit": 1, "gather_rows": 9, "ris_replay": 1,
                       "final_shade": 1, "any_hit": 1,
                       "scatter_rows_add": 8},
    "grad_per_pixel": {"closest_hit": 1, "gather_rows": 9, "ris_replay": 1,
                       "final_shade": 1, "any_hit": 1,
                       "scatter_rows_add": 8, "halo_gather": 4,
                       "halo_scatter": 2},
}
FRAMES = {"slice1": 2, "config5": 4, "animated": 4, "grad_surrogate": 2,
          "grad_per_pixel": 2}
GRAD_PATHS = ("grad_surrogate", "grad_per_pixel")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ab_ms(torch, kernel_fn, plain_fn, reps_k: int, reps_p: int):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain and averaged."""
    p1 = cuda_ms(torch, plain_fn, reps_p)
    k1 = cuda_ms(torch, kernel_fn, reps_k)
    k2 = cuda_ms(torch, kernel_fn, reps_k)
    p2 = cuda_ms(torch, plain_fn, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def random_soup(n_tris: int, center, half: float, seed: int):
    """A SubMesh of n_tris random triangles in a box around ``center``."""
    import numpy as np

    from romis_tpu_torch.scene.scene import Material, SubMesh

    rng = np.random.default_rng(seed)
    c = rng.uniform(-half, half, (n_tris, 1, 3)) + np.asarray(center)
    v = (c + rng.normal(0.0, 0.35, (n_tris, 3, 3))).astype(np.float32)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return SubMesh(positions=v.reshape(-1, 3),
                   normals=np.repeat(nrm, 3, axis=0).astype(np.float32),
                   texcoords=np.zeros((3 * n_tris, 2), np.float32),
                   triangles=np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3),
                   material=Material(kd=(0.6, 0.5, 0.4), ks=(0.3, 0.3, 0.3),
                                     shininess=20.0))


def main() -> None:
    import torch

    # ---- 1. the device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import (
        generate_rays, make_camera, project_to_pixel,
    )
    from romis_tpu_torch.core.types import (
        pack_reservoir_planes, unpack_reservoir_planes,
    )
    from romis_tpu_torch.diff.grad import (
        extract_params, make_grad_fn, render_with_params,
    )
    from romis_tpu_torch.ops import (
        _build, rows, ris, scatter, shade, spatial, trace,
    )
    from romis_tpu_torch.ops.wrs import (
        gen_canonical_replay_plain, gen_canonical_samples_plain, gumbel_noise,
        replay_uniforms,
    )
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.animation import (
        camera_at, interpolate_cameras, render_animation,
    )
    from romis_tpu_torch.render.pipeline import render_frame, save_image
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, repack_rows,
    )

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. the build ----
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    entry = ""
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")

    wrappers = {"closest_hit": trace.closest_hit,
                "gather_rows": rows.gather_rows,
                "ris": ris.gen_canonical_samples_ris,
                "final_shade": shade.final_shade_fused,
                "spatial_pass": spatial.spatial_pass_fused,
                "spatial_pass_unbiased": spatial.spatial_pass_unbiased_fused,
                "halo_gather": spatial.halo_offset_gather,
                "any_hit": trace.any_hit,
                "scatter_rows_add": scatter.scatter_rows_add,
                "halo_scatter": spatial.halo_offset_scatter,
                "ris_replay": ris.gen_canonical_replay}

    # ---- 3. each kernel against its plain version ----
    feats = Features()
    k, s = feats.num_samples_in_reservoir, feats.initial_light_samples
    n_nbr, radius = feats.num_neighbours_to_sample, \
        feats.spatial_resample_radius
    sk = -(-s // k)
    scene = flagship_scene(dev)
    cam = flagship_camera(H, W, dev)
    rays = generate_rays(cam, H, W)
    soup = build_geometry([random_soup(SOUP_TRIS, (2.57, 1.23, -1.35), 3.0,
                                       seed=7)], dev)
    require(soup.tri_cols.shape[1] == SOUP_TRIS, "soup size")
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {}

    def check_trace(geometry, label):
        t_k, tri_k, u_k, v_k = trace.closest_hit(rays, geometry)
        t_p, tri_p, u_p, v_p = trace.closest_hit_plain(rays, geometry)
        torch.cuda.synchronize()
        same = tri_k == tri_p
        agree = same.float().mean().item()
        both = same & torch.isfinite(t_p)
        require(torch.equal(torch.isinf(t_k[same]), torch.isinf(t_p[same])),
                f"closest hit {label}: miss flags differ")
        err = (t_k[both] - t_p[both]).abs()
        rel = (err / t_p[both].abs()).max().item() if both.any() else 0.0
        print(f"check closest_hit[{label}]: tri agree {agree:.6f}, "
              f"hits {both.float().mean().item():.4f}, t max rel err {rel:.2e}")
        require(agree >= MIN_AGREE, f"closest hit {label}: tri agree {agree}")
        require(rel <= TRACE_T_RTOL, f"closest hit {label}: t rel err {rel}")
        return err.max().item() if both.any() else 0.0

    errs["closest_hit"] = max(check_trace(scene.geometry, "flagship"),
                              check_trace(soup, "soup2048"))

    t, tri, u, v = trace.closest_hit_plain(rays, scene.geometry)
    idx = torch.clamp_min(tri, 0)
    gathered = rows.gather_rows(scene.geometry.attr_rows, idx)
    exact = torch.equal(gathered, rows.gather_rows_plain(
        scene.geometry.attr_rows, idx))
    rand_idx = torch.randint(0, 4096, (H, W), generator=gen, device=dev,
                             dtype=torch.int32)
    table = torch.rand((4096, 24), generator=gen, device=dev)
    exact &= torch.equal(rows.gather_rows(table, rand_idx),
                         rows.gather_rows_plain(table, rand_idx))
    torch.cuda.synchronize()
    print(f"check gather_rows: bit-exact {exact}")
    require(exact, "gather_rows is not bit-exact")
    errs["gather_rows"] = 0.0

    _, ctx = restir.trace_primary(rays, scene.geometry, feats, restir.PLAIN)
    _, soup_ctx = restir.trace_primary(rays, soup, feats, restir.PLAIN)

    def check_ris(c, label):
        uni = torch.rand((sk, 4, k, H, W), generator=gen, device=dev)
        r_k = ris.gen_canonical_samples_ris(c, scene.lights, scene.num_lights,
                                            feats, uniforms=uni)
        r_p = gen_canonical_samples_plain(c, scene.lights, scene.num_lights,
                                          feats, uniforms=uni)
        torch.cuda.synchronize()
        win = ((r_k.pos - r_p.pos).abs()
               <= 1e-6 + 1e-5 * r_p.pos.abs()).all(dim=1)  # [K, H, W]
        agree = win.float().mean().item()
        ws_rel = ((r_k.w_sum - r_p.w_sum).abs()
                  / r_p.w_sum.abs().clamp_min(1e-30)).max().item()
        bw_err = (r_k.big_w - r_p.big_w).abs()
        bw_rel = (bw_err / r_p.big_w.abs().clamp_min(1e-30))[win].max().item()
        print(f"check ris[{label}, uniforms]: winners agree {agree:.6f}, "
              f"w_sum max rel err {ws_rel:.2e}, big_w max rel err {bw_rel:.2e}")
        require(agree >= MIN_AGREE, f"RIS {label}: winners agree {agree}")
        require(torch.equal(r_k.m, r_p.m), f"RIS {label}: M differs")
        require(ws_rel <= RIS_W_SUM_RTOL, f"RIS {label}: w_sum {ws_rel}")
        require(bw_rel <= RIS_BIG_W_RTOL, f"RIS {label}: big_w {bw_rel}")
        return r_k, max((r_k.w_sum - r_p.w_sum).abs().max().item(),
                        bw_err[win].max().item())

    res_main, errs["ris"] = check_ris(ctx, "flagship")
    res_soup, _ = check_ris(soup_ctx, "soup2048")

    # Philox mode: a different random stream, so compare over the frame.
    r_k = ris.gen_canonical_samples_ris(ctx, scene.lights, scene.num_lights,
                                        feats, generator=gen)
    r_p = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                      feats, generator=gen)
    for lane in range(k):
        mk, mp = r_k.w_sum[lane].mean().item(), r_p.w_sum[lane].mean().item()
        print(f"check ris[philox]: lane {lane} mean w_sum {mk:.6g} vs "
              f"plain {mp:.6g}")
        require(abs(mk - mp) <= PHILOX_REL * abs(mp), "Philox w_sum mean")
    ik = shade.final_shade_plain(ctx, r_k, scene.geometry, feats).mean().item()
    ip = shade.final_shade_plain(ctx, r_p, scene.geometry, feats).mean().item()
    print(f"check ris[philox]: shaded mean {ik:.6g} vs plain {ip:.6g}")
    require(abs(ik - ip) <= PHILOX_REL * abs(ip), "Philox shaded mean")

    def check_shade(c, res, geometry, label):
        o_k = shade.final_shade_fused(c, res, geometry, feats)
        o_p = shade.final_shade_plain(c, res, geometry, feats)
        torch.cuda.synchronize()
        err = (o_k - o_p).abs()
        ok = (err <= SHADE_ATOL + SHADE_RTOL * o_p.abs()).all(dim=0)
        agree = ok.float().mean().item()
        print(f"check final_shade[{label}]: pixels within tolerance "
              f"{agree:.6f}, max abs err {err.max().item():.2e}")
        require(agree >= MIN_AGREE, f"final shade {label}: agree {agree}")
        return err[:, ok].max().item()

    errs["final_shade"] = max(
        check_shade(ctx, res_main, scene.geometry, "flagship"),
        check_shade(soup_ctx, res_soup, soup, "soup2048"))

    # Any-hit: the shadow rays of the initial visibility check (origins
    # pushed toward the RIS winners, t_max the remaining distance).
    def shadow_rays(c, res):
        to = res.pos - c.position
        dist = torch.linalg.vector_norm(to, dim=-3).clamp_min(1e-20)
        d = to / dist[:, None]
        o = c.position + 1e-3 * d
        return o, d, torch.linalg.vector_norm(res.pos - o, dim=-3)

    def check_any(c, res, geometry, label):
        o, d, tm = shadow_rays(c, res)
        occ_k = trace.any_hit(o, d, tm, geometry)
        occ_p = trace.any_hit_plain(o, d, tm, geometry)
        torch.cuda.synchronize()
        same = (occ_k == occ_p).float().mean().item()
        print(f"check any_hit[{label}]: rays {occ_k.numel()}, occluded "
              f"{occ_p.float().mean().item():.4f}, agree {same:.6f}, "
              f"bit-exact {bool(torch.equal(occ_k, occ_p))}")
        require(same >= MIN_AGREE, f"any-hit {label}: agree {same}")
        return 1.0 - same

    errs["any_hit"] = max(check_any(ctx, res_main, scene.geometry, "flagship"),
                          check_any(soup_ctx, res_soup, soup, "soup2048"))

    # Halo gather: the reprojection planes [10K+5, H, W] at D=1.
    rr = feats.reprojection_radius
    halo_planes = torch.cat([pack_reservoir_planes(res_main),
                             spatial.pack_gates(ctx)])
    rand_dy = torch.randint(-rr, rr + 1, (1, H, W), generator=gen, device=dev,
                            dtype=torch.int32)
    rand_dx = torch.randint(-rr, rr + 1, (1, H, W), generator=gen, device=dev,
                            dtype=torch.int32)
    cam_pan = make_camera(look_at=(2.57, 1.23, -1.35),
                          rotation_deg=(10.3 + PAN_DEG, 30.0 + PAN_DEG, 0.0),
                          distance=25.0, fov_deg=30.0, resolution=(H, W),
                          device=dev)
    rows_f, cols_f, _ = project_to_pixel(cam_pan, ctx.position, H, W)
    smooth_dy = (torch.round(rows_f).clamp(0, H - 1).int() - torch.arange(
        H, dtype=torch.int32, device=dev)[:, None]).clamp(-rr, rr)[None]
    smooth_dx = (torch.round(cols_f).clamp(0, W - 1).int() - torch.arange(
        W, dtype=torch.int32, device=dev)[None, :]).clamp(-rr, rr)[None]
    for label, dy, dx in (("random", rand_dy, rand_dx),
                          ("camera-shift", smooth_dy, smooth_dx)):
        g_k = spatial.halo_offset_gather(halo_planes, dy, dx)
        g_p = spatial.halo_offset_gather_plain(halo_planes, dy, dx)
        torch.cuda.synchronize()
        exact = torch.equal(g_k, g_p)
        print(f"check halo_gather[{label}]: planes {halo_planes.shape[0]}, "
              f"mean |dy| {dy.abs().float().mean().item():.3f}, bit-exact "
              f"{exact}")
        require(exact, f"halo gather {label} is not bit-exact")
    errs["halo_gather"] = 0.0

    # Spatial passes on the RIS reservoirs of the flagship frame.
    cen = shade.pack_center_ctx(ctx)
    gates = spatial.pack_gates(ctx)
    res_planes = pack_reservoir_planes(res_main)
    pass_fns = {
        "spatial_pass": (
            lambda **kw: spatial.spatial_pass_fused(
                res_planes, gates, cen, k, n_nbr, radius, feats, **kw),
            lambda **kw: spatial.spatial_pass_plain(
                res_planes, gates, cen, k, n_nbr, radius, feats, **kw)),
        "spatial_pass_unbiased": (
            lambda **kw: spatial.spatial_pass_unbiased_fused(
                res_planes, cen, k, n_nbr, radius, feats, **kw),
            lambda **kw: spatial.spatial_pass_unbiased_plain(
                res_planes, cen, k, n_nbr, radius, feats, **kw)),
    }

    def check_pass(label, kernel_fn, plain_fn):
        inject = spatial.spatial_noise(gen, n_nbr, k, radius, H, W)
        o_k = unpack_reservoir_planes(kernel_fn(inject=inject), k)
        o_p = unpack_reservoir_planes(plain_fn(inject=inject), k)
        torch.cuda.synchronize()
        win = ((o_k.pos - o_p.pos).abs()
               <= 1e-6 + 1e-5 * o_p.pos.abs()).all(dim=1)
        agree = win.float().mean().item()

        def rel(a, b, mask=None):
            r = (a - b).abs() / b.abs().clamp_min(1e-30)
            return (r if mask is None else r[mask]).max().item()

        ws_rel = rel(o_k.w_sum, o_p.w_sum)
        m_rel = rel(o_k.m, o_p.m)
        bw_rel = rel(o_k.big_w, o_p.big_w, win)
        live = (o_p.w_sum > 0).float().mean().item()
        print(f"check {label}[injected]: winners agree {agree:.6f}, live "
              f"lanes {live:.4f}, w_sum max rel err {ws_rel:.2e}, M max rel "
              f"err {m_rel:.2e}, big_w max rel err {bw_rel:.2e}")
        require(agree >= MIN_AGREE, f"{label}: winners agree {agree}")
        require(ws_rel <= PASS_W_SUM_RTOL, f"{label}: w_sum {ws_rel}")
        require(m_rel <= PASS_M_RTOL, f"{label}: M {m_rel}")
        require(bw_rel <= PASS_BIG_W_RTOL, f"{label}: big_w {bw_rel}")
        err = max((o_k.w_sum - o_p.w_sum).abs().max().item(),
                  (o_k.big_w - o_p.big_w).abs()[win].max().item())
        # Philox mode against the plain version's own draws.
        key = spatial.philox_key(gen)
        p_k = unpack_reservoir_planes(kernel_fn(generator=gen, key=key), k)
        p_p = unpack_reservoir_planes(plain_fn(generator=gen), k)
        for lane in range(k):
            mk = p_k.w_sum[lane].mean().item()
            mp = p_p.w_sum[lane].mean().item()
            print(f"check {label}[philox]: lane {lane} mean w_sum {mk:.6g} "
                  f"vs plain {mp:.6g}")
            require(abs(mk - mp) <= PHILOX_REL * abs(mp),
                    f"{label}: Philox w_sum mean")
        ik = shade.final_shade_plain(ctx, p_k, scene.geometry,
                                     feats).mean().item()
        ip = shade.final_shade_plain(ctx, p_p, scene.geometry,
                                     feats).mean().item()
        print(f"check {label}[philox]: shaded mean {ik:.6g} vs plain {ip:.6g}")
        require(abs(ik - ip) <= PHILOX_REL * abs(ip),
                f"{label}: Philox shaded mean")
        return err

    for label, (kernel_fn, plain_fn) in pass_fns.items():
        errs[label] = check_pass(label, kernel_fn, plain_fn)

    # The gradient step's kernels. Row scatter-add: the light table
    # (4 M lane indices over 512 rows), the material table (every pixel on
    # its one row: the contention case) and the packed v0|e1|e2 of the
    # 2048-triangle soup at its closest-hit triangles.
    def check_scatter(label, ct, idx, n_rows):
        o_k = scatter.scatter_rows_add(ct, idx, n_rows)
        o_p = scatter.scatter_rows_add_plain(ct, idx, n_rows)
        o_64 = torch.zeros((n_rows, ct.shape[0]), dtype=torch.float64,
                           device=dev).index_add_(
            0, idx.reshape(-1).long().clamp(0, n_rows - 1),
            ct.reshape(ct.shape[0], -1).t().double())
        mag = scatter.scatter_rows_add_plain(ct.abs(), idx,
                                             n_rows).double().clamp_min(1e-30)
        torch.cuda.synchronize()
        rel = ((o_k - o_p).abs() / mag).max().item()
        rel64 = ((o_k.double() - o_64).abs() / mag).max().item()
        rel_p64 = ((o_p.double() - o_64).abs() / mag).max().item()
        print(f"check scatter_rows_add[{label}]: rows {n_rows}, indices "
              f"{idx.numel()}, max err / sum|ct| vs plain {rel:.2e}, vs "
              f"float64 {rel64:.2e} (plain vs float64 {rel_p64:.2e})")
        require(rel <= SCATTER_REL, f"scatter {label}: vs plain {rel}")
        require(rel64 <= SCATTER_F64_REL, f"scatter {label}: vs f64 {rel64}")
        return (o_k - o_p).abs().max().item()

    light_idx = torch.randint(0, scene.num_lights, (k, H, W), generator=gen,
                              device=dev, dtype=torch.int32)
    light_ct = torch.randn((24, k, H, W), generator=gen, device=dev)
    soup_tri = torch.clamp_min(trace.closest_hit_plain(rays, soup)[1], 0)
    scatter_cases = {
        "lights": (light_ct, light_idx, scene.num_lights),
        "material": (torch.randn((8, H, W), generator=gen, device=dev),
                     torch.zeros((H, W), dtype=torch.int32, device=dev), 1),
        "soup2048": (torch.randn((9, H, W), generator=gen, device=dev),
                     soup_tri, SOUP_TRIS),
    }
    errs["scatter_rows_add"] = max(check_scatter(label, *case)
                                   for label, case in scatter_cases.items())

    # Halo scatter: the per-pixel path's big_w cotangents (D = R = 5,
    # C = K = 2) at clamped offsets within ±radius.
    halo_ct = torch.randn((n_nbr, k, H, W), generator=gen, device=dev)
    sdy, sdx = spatial.clamped_offsets(torch.randint(
        -radius, radius + 1, (2, n_nbr, H, W), generator=gen, device=dev,
        dtype=torch.int32), H, W)
    hs_k = spatial.halo_offset_scatter(halo_ct, sdy, sdx)
    hs_p = spatial.halo_offset_scatter_plain(halo_ct, sdy, sdx)
    hs_mag = spatial.halo_offset_scatter_plain(halo_ct.abs(), sdy,
                                               sdx).clamp_min(1e-30)
    torch.cuda.synchronize()
    hs_rel = ((hs_k - hs_p).abs() / hs_mag).max().item()
    print(f"check halo_scatter: D={n_nbr}, C={k}, max err / sum|ct| "
          f"{hs_rel:.2e}")
    require(hs_rel <= HALO_SCATTER_REL, f"halo scatter: {hs_rel}")
    errs["halo_scatter"] = (hs_k - hs_p).abs().max().item()

    # Replay RIS: injected uniforms (records exact), then Philox.
    def check_replay(c, label):
        uni5 = torch.rand((sk, 5, k, H, W), generator=gen, device=dev)
        w_k, *recs_k = ris.gen_canonical_replay(c, scene.lights,
                                                scene.num_lights, feats,
                                                uniforms=uni5)
        w_p, *recs_p = gen_canonical_replay_plain(c, scene.lights,
                                                  scene.num_lights, feats,
                                                  uniforms=uni5)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for rk, rp in zip(recs_k, recs_p)
                    for a, b in zip(rk, rp))
        ws_rel = ((w_k - w_p).abs() / w_p.abs().clamp_min(1e-30)).max().item()
        print(f"check ris_replay[{label}, uniforms]: records of both races "
              f"exact {exact}, w_sum max rel err {ws_rel:.2e}, live lanes "
              f"{(w_p > 0).float().mean().item():.4f}")
        require(exact, f"replay {label}: records differ")
        require(ws_rel <= RIS_W_SUM_RTOL, f"replay {label}: w_sum {ws_rel}")
        return (w_k - w_p).abs().max().item()

    errs["ris_replay"] = max(check_replay(ctx, "flagship"),
                             check_replay(soup_ctx, "soup2048"))
    w_k = ris.gen_canonical_replay(ctx, scene.lights, scene.num_lights, feats,
                                   generator=gen)[0]
    w_p = gen_canonical_replay_plain(ctx, scene.lights, scene.num_lights,
                                     feats, generator=gen)[0]
    for lane in range(k):
        mk, mp = w_k[lane].mean().item(), w_p[lane].mean().item()
        print(f"check ris_replay[philox]: lane {lane} mean w_sum {mk:.6g} vs "
              f"plain {mp:.6g}")
        require(abs(mk - mp) <= PHILOX_REL * abs(mp), "replay Philox w_sum")

    # One torch.autograd.grad through each autograd wrapper, against
    # autograd of the plain version.
    def check_grad(label, kernel_fn, plain_fn, leaves):
        outs_k, outs_p = kernel_fn(), plain_fn()
        cts = [torch.randn(o.shape, generator=gen, device=dev)
               for o in outs_k]
        g_k = torch.autograd.grad(outs_k, leaves, cts)
        g_p = torch.autograd.grad(outs_p, leaves, cts)
        torch.cuda.synchronize()
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  .item() for a, b in zip(g_k, g_p))
        nz = all(bool(b.abs().max() > 0) for b in g_p)
        print(f"check grad[{label}]: max err / max |g| {rel:.2e}, all leaves "
              f"reached {nz}")
        require(rel <= GRAD_REL and nz, f"grad {label}: {rel}")

    table_g = scene.lights.rows.clone().requires_grad_()
    check_grad("gather_rows", lambda: [rows.gather_rows(table_g, light_idx)],
               lambda: [rows.gather_rows_plain(table_g, light_idx)],
               [table_g])
    planes_g = torch.rand((k, H, W), generator=gen,
                          device=dev).requires_grad_()
    check_grad("halo_gather",
               lambda: [spatial.halo_offset_gather(planes_g, sdy, sdx)],
               lambda: [spatial.halo_offset_gather_plain(planes_g, sdy, sdx)],
               [planes_g])
    verts = [getattr(scene.geometry, f).clone().requires_grad_()
             for f in ("v0", "e1", "e2")]
    geo_g = repack_rows(replace(scene.geometry, v0=verts[0], e1=verts[1],
                                e2=verts[2]))
    hit_mask = torch.isfinite(trace.closest_hit_plain(rays, geo_g)[0])

    def tuv(fn):
        t_, _, u_, v_ = fn(rays, geo_g)
        return [torch.where(hit_mask, t_, 0.0), u_, v_]

    check_grad("closest_hit", lambda: tuv(trace.closest_hit),
               lambda: tuv(trace.closest_hit_plain), verts)
    shade_leaves = [ctx.kd.clone().requires_grad_(),
                    res_main.pos.clone().requires_grad_(),
                    res_main.color.clone().requires_grad_(),
                    res_main.big_w.clone().requires_grad_()]
    ctx_g = replace(ctx, kd=shade_leaves[0])
    res_g = replace(res_main, pos=shade_leaves[1], color=shade_leaves[2],
                    big_w=shade_leaves[3])
    check_grad("final_shade",
               lambda: [shade.final_shade_fused(ctx_g, res_g, scene.geometry,
                                                feats)],
               lambda: [shade.final_shade_plain(ctx_g, res_g, scene.geometry,
                                                feats)], shade_leaves)

    # ---- 4. the main paths through the entry points ----
    path_feats = {
        "slice1": Features(spatial_reuse=False),
        "config5": Features(),
        "animated": Features(temporal_reprojection=True,
                             unbiased_combination=True,
                             initial_samples_visibility_check=True),
    }
    cam_path = interpolate_cameras(
        cam, make_camera(look_at=(2.57, 1.23, -1.35),
                         rotation_deg=(10.3, 30.0 + PAN_DEG
                                       * (FRAMES["animated"] - 1), 0.0),
                         distance=25.0, fov_deg=30.0, resolution=(H, W),
                         device=dev), FRAMES["animated"])

    def run_path(path, ops, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        f = path_feats[path]
        if path == "animated":
            imgs, state = render_animation(g, cam_path, scene.geometry,
                                           scene.lights, scene.num_lights, H,
                                           W, f, ops=ops)
            img = imgs[-1]
        else:
            state, img = None, None
            for _ in range(FRAMES[path]):
                img, state = render_frame(g, cam, scene, H, W, f, state,
                                          ops=ops)
        torch.cuda.synchronize()
        return img, state

    launches = {n: 0 for n in KERNELS}
    for path, per_frame in PATHS.items():
        if path in GRAD_PATHS:
            continue
        for fn in wrappers.values():
            fn.launches = 0
        img_k, state_k = run_path(path, restir.KERNELS, 0)
        got = {n: fn.launches for n, fn in wrappers.items()}
        img_p, _ = run_path(path, restir.PLAIN, 0)
        expect = {n: per_frame.get(n, 0) * FRAMES[path] for n in KERNELS}
        print(f"path {path}: launches over {FRAMES[path]} frames "
              f"{ {n: c for n, c in got.items() if c} }")
        require(got == expect, f"{path}: launch counts {got} != {expect}")
        for n in KERNELS:
            launches[n] += got[n]
        require(tuple(img_k.shape) == (H, W, 3), f"image shape {img_k.shape}")
        require(bool(torch.isfinite(img_k).all()),
                f"{path}: non-finite pixels (kernels)")
        require(bool(torch.isfinite(img_p).all()),
                f"{path}: non-finite pixels (plain)")
        mk, mp = img_k.mean().item(), img_p.mean().item()
        print(f"path {path}: last-frame mean {mk:.6f} (kernels) vs "
              f"{mp:.6f} (plain)")
        require(abs(mk - mp) <= FRAME_REL * abs(mp), f"{path}: means differ")
        require(state_k.has_prev and float(state_k.reservoirs.m.max())
                > s / k, f"{path}: temporal state did not accumulate")
        if path == "config5":
            png = ROOT / "build" / "chip_smoke_frame.png"
            png.parent.mkdir(parents=True, exist_ok=True)
            save_image(str(png), img_k)
            print(f"path {path}: wrote {png.relative_to(ROOT)}")

    # The gradient paths: make_grad_fn from one forward frame's state,
    # against a target rendered with the light colours x 0.8.
    grad_feats = {
        "grad_surrogate": Features(enable_tone_mapping=False,
                                   surrogate_resampling_grad=True),
        "grad_per_pixel": Features(enable_tone_mapping=False,
                                   surrogate_resampling_grad=True,
                                   exact_gradients=True),
    }
    params = extract_params(scene.geometry, scene.lights)
    dim = replace(params, **{f: getattr(params, f) * 0.8 for f in (
        "light_c0", "light_c1", "light_c2", "light_c3")})

    def grad_setup(path):
        """(features, prev state, target image, one step's injected noise)."""
        f = grad_feats[path]
        g = torch.Generator(device=dev).manual_seed(11)
        args = (cam, scene.geometry, scene.lights, scene.num_lights, H, W, f)
        with torch.no_grad():
            _, prev = render_with_params(
                params, g, *args, restir.initial_temporal_state(H, W, k, cam))
            target, _ = render_with_params(dim, g, *args, prev)
        shape = (2, n_nbr, H, W) if f.exact_gradients else (2, n_nbr)
        noise = (replay_uniforms(g, s, k, H, W),
                 gumbel_noise(g, (2, k, H, W)),
                 [(torch.randint(-radius, radius + 1, shape, generator=g,
                                 device=dev, dtype=torch.int32),
                   gumbel_noise(g, (n_nbr + 1, k, H, W)),
                   gumbel_noise(g, (n_nbr + 1, k, H, W)))
                  for _ in range(f.spatial_resampling_passes)])
        return f, prev, target, noise

    grad_reach = ("light_c0", "light_v0", "mat_kd", "tri_v0")
    for path in GRAD_PATHS:
        f, prev, target, noise = grad_setup(path)
        fn_k = make_grad_fn(scene.geometry, scene.lights, scene.num_lights,
                            H, W, f)
        fn_p = make_grad_fn(scene.geometry, scene.lights, scene.num_lights,
                            H, W, f, ops=restir.PLAIN)
        for fn in wrappers.values():
            fn.launches = 0
        loss_k, g_k = fn_k(params, target, None, cam, prev, noise)
        loss_k2, g_k2 = fn_k(params, target,
                             torch.Generator(device=dev).manual_seed(12),
                             cam, prev)
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in wrappers.items()}
        loss_p, g_p = fn_p(params, target, None, cam, prev, noise)
        torch.cuda.synchronize()
        expect = {n: PATHS[path].get(n, 0) * FRAMES[path] for n in KERNELS}
        print(f"path {path}: launches over {FRAMES[path]} steps "
              f"{ {n: c for n, c in got.items() if c} }")
        require(got == expect, f"{path}: launch counts {got} != {expect}")
        for n in KERNELS:
            launches[n] += got[n]
        lk, lp, lk2 = loss_k.item(), loss_p.item(), loss_k2.item()
        print(f"path {path}: loss {lk:.8g} (kernels) vs {lp:.8g} (plain), "
              f"Philox step {lk2:.8g}")
        require(all(map(math.isfinite, (lk, lp, lk2))) and lk > 0,
                f"{path}: loss")
        require(abs(lk - lp) <= FRAME_REL * abs(lp), f"{path}: losses differ")
        worst = 0.0
        for leaf in g_k.__dataclass_fields__:
            a, b, a2 = (getattr(x, leaf) for x in (g_k, g_p, g_k2))
            require(bool(torch.isfinite(a).all() & torch.isfinite(b).all()
                         & torch.isfinite(a2).all()),
                    f"{path}: non-finite gradient {leaf}")
            scale = b.abs().max().item()
            rel = (a - b).abs().max().item() / max(scale, 1e-30)
            worst = max(worst, rel if scale > 0 else 0.0)
            print(f"path {path}: grad {leaf} max |g| {scale:.4e}, max err / "
                  f"max |g| {rel:.2e}")
            require(rel <= GRAD_REL or scale == a.abs().max().item() == 0,
                    f"{path}: gradient {leaf} differs ({rel})")
            if leaf in grad_reach:
                require(scale > 0 and a2.abs().max().item() > 0,
                        f"{path}: no gradient reaches {leaf}")
        print(f"path {path}: worst gradient leaf err / max |g| {worst:.2e}")

    # ---- 5. timing ----
    def one_frame(path, ops):
        g = torch.Generator(device=dev).manual_seed(5)
        f = path_feats[path]
        st = restir.initial_temporal_state(H, W, k, cam)
        i = 0

        def run():
            nonlocal st, i
            c = camera_at(cam_path, i % FRAMES["animated"]) \
                if path == "animated" else cam
            _, st = render_frame(g, c, scene, H, W, f, st, ops=ops)
            i += 1
        return run

    for path in PATHS:
        if path in GRAD_PATHS:
            continue
        f_k, f_p = ab_ms(torch, one_frame(path, restir.KERNELS),
                         one_frame(path, restir.PLAIN), 10, 3)
        print(f"time frame[{path}]: {f_k:.3f} ms/frame kernels, {f_p:.3f} "
              f"ms/frame plain ({H * W * (1 + k) / f_k / 1e3:.1f} Mrays/s) "
              f"[{card}]")

    for path in GRAD_PATHS:
        f, prev, target, _ = grad_setup(path)

        def grad_step(ops):
            fn = make_grad_fn(scene.geometry, scene.lights, scene.num_lights,
                              H, W, f, ops=ops)
            g = torch.Generator(device=dev).manual_seed(5)
            return lambda: fn(params, target, g, cam, prev)

        def forward_frame(ops):
            g = torch.Generator(device=dev).manual_seed(5)

            def run():
                with torch.no_grad():
                    render_with_params(params, g, cam, scene.geometry,
                                       scene.lights, scene.num_lights, H, W,
                                       f, prev, ops=ops)
            return run

        s_k, s_p = ab_ms(torch, grad_step(restir.KERNELS),
                         grad_step(restir.PLAIN), 3, 1)
        f_k, f_p = ab_ms(torch, forward_frame(restir.KERNELS),
                         forward_frame(restir.PLAIN), 5, 2)
        peaks = []
        for ops in (restir.KERNELS, restir.PLAIN):
            step = grad_step(ops)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated(), base))
        (pk, bk), (pp, bp) = peaks
        print(f"time grad[{path}]: {s_k:.3f} ms/step kernels, {s_p:.3f} "
              f"ms/step plain; forward frame {f_k:.3f} ms kernels, "
              f"{f_p:.3f} ms plain [{card}]")
        print(f"memory grad[{path}]: peak {pk / 2**30:.3f} GiB kernels "
              f"({(pk - bk) / 2**30:.3f} above the {bk / 2**30:.3f} GiB "
              f"held before the step), {pp / 2**30:.3f} GiB plain "
              f"({(pp - bp) / 2**30:.3f} above) [{card}]")

    uni = torch.rand((sk, 4, k, H, W), generator=gen, device=dev)
    o, d, tm = shadow_rays(ctx, res_main)
    key = spatial.philox_key(gen)
    timings = {
        "closest_hit": ab_ms(
            torch, lambda: trace.closest_hit(rays, scene.geometry),
            lambda: trace.closest_hit_plain(rays, scene.geometry), 20, 5),
        "gather_rows": ab_ms(
            torch, lambda: rows.gather_rows(scene.geometry.attr_rows, idx),
            lambda: rows.gather_rows_plain(scene.geometry.attr_rows,
                                           idx).contiguous(), 20, 5),
        "ris": ab_ms(
            torch, lambda: ris.gen_canonical_samples_ris(
                ctx, scene.lights, scene.num_lights, feats, uniforms=uni),
            lambda: gen_canonical_samples_plain(
                ctx, scene.lights, scene.num_lights, feats, uniforms=uni),
            10, 3),
        "final_shade": ab_ms(
            torch, lambda: shade.final_shade_fused(ctx, res_main,
                                                   scene.geometry, feats),
            lambda: shade.final_shade_plain(ctx, res_main, scene.geometry,
                                            feats), 20, 5),
        "any_hit": ab_ms(
            torch, lambda: trace.any_hit(o, d, tm, scene.geometry),
            lambda: trace.any_hit_plain(o, d, tm, scene.geometry), 20, 5),
        "halo_gather": ab_ms(
            torch, lambda: spatial.halo_offset_gather(halo_planes, smooth_dy,
                                                      smooth_dx),
            lambda: spatial.halo_offset_gather_plain(
                halo_planes, smooth_dy, smooth_dx).contiguous(), 20, 5),
    }
    for label, (kernel_fn, plain_fn) in pass_fns.items():
        timings[label] = ab_ms(torch, lambda: kernel_fn(generator=gen,
                                                        key=key),
                               lambda: plain_fn(generator=gen), 10, 3)
    for label, (ct, idx_s, n_rows) in scatter_cases.items():
        ms = ab_ms(torch, lambda: scatter.scatter_rows_add(ct, idx_s, n_rows),
                   lambda: scatter.scatter_rows_add_plain(ct, idx_s, n_rows),
                   20, 5)
        print(f"time scatter_rows_add[{label}]: {ms[0]:.4f} ms kernel, "
              f"{ms[1]:.4f} ms plain [{card}]")
        if label == "lights":
            timings["scatter_rows_add"] = ms
    timings["halo_scatter"] = ab_ms(
        torch, lambda: spatial.halo_offset_scatter(halo_ct, sdy, sdx),
        lambda: spatial.halo_offset_scatter_plain(halo_ct, sdy, sdx), 20, 5)
    uni5 = torch.rand((sk, 5, k, H, W), generator=gen, device=dev)
    timings["ris_replay"] = ab_ms(
        torch, lambda: ris.gen_canonical_replay(
            ctx, scene.lights, scene.num_lights, feats, uniforms=uni5),
        lambda: gen_canonical_replay_plain(
            ctx, scene.lights, scene.num_lights, feats, uniforms=uni5), 10, 3)
    for n, (km, pm) in timings.items():
        print(f"time {n}: {km:.4f} ms kernel, {pm:.4f} ms plain [{card}]")
    inject = spatial.spatial_noise(gen, n_nbr, k, radius, H, W)
    for label, (kernel_fn, _) in pass_fns.items():
        ms = cuda_ms(torch, lambda: kernel_fn(inject=inject), 10)
        print(f"time {label} (injected noise): {ms:.4f} ms [{card}]")
    ms = cuda_ms(torch, lambda: spatial.halo_offset_gather(
        halo_planes, rand_dy, rand_dx), 20)
    print(f"time halo_gather (random offsets): {ms:.4f} ms [{card}]")
    ms = cuda_ms(torch, lambda: ris.gen_canonical_samples_ris(
        ctx, scene.lights, scene.num_lights, feats, generator=gen), 10)
    print(f"time ris (philox): {ms:.4f} ms [{card}]")
    ms = cuda_ms(torch, lambda: ris.gen_canonical_replay(
        ctx, scene.lights, scene.num_lights, feats, generator=gen), 10)
    print(f"time ris_replay (philox): {ms:.4f} ms [{card}]")

    table_rows = [{"name": n, "route": "cuda", "source": SOURCES[n][0],
                   "replaces": SOURCES[n][1], "launches": launches[n],
                   "max_abs_err": errs[n], "ms": timings[n][0],
                   "plain_ms": timings[n][1]}
                  for n in KERNELS]
    print(json.dumps({"kernels": table_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
