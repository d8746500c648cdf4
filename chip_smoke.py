#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``romis_tpu_torch``) on one NVIDIA
GPU.

    python3 chip_smoke.py

1. The device: its name, power limit, and the TF32 switches (both off).
2. The build: every kernel under ``romis_tpu_torch/csrc`` compiled with
   nvcc for sm_90a, with its seconds.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes the 1920x1080 frame gives it on the flagship scene (a ground quad
   under 512 area lights); closest hit and final shade also on a random
   soup of 2048 triangles. Tolerances are the constants below.
4. The slice: ``render_frame`` with ``Features(spatial_reuse=False)`` at
   1920x1080, S=32, K=2, temporal reuse on, 4 frames carrying the temporal
   state, once through the kernels and once through the plain versions.
   Every pixel is finite, the last images' means agree within 2 %, and the
   launch counters rose by exactly 1 (closest hit), 2 (rows), 1 (RIS) and
   1 (final shade) per frame. The last image goes to
   ``build/chip_smoke_frame.png``.
5. Timing with CUDA events: ms/frame through the kernels and the plain
   versions, and each kernel beside its plain version.

Any failed check raises, so the exit code is non-zero. The last line is
``{"ok": true, "device": {...}}``; the line before it is the kernel table.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H, W = 1080, 1920
FRAMES = 4
SOUP_TRIS = 2048

# Tolerances (kernel vs plain version on the same inputs).
TRACE_T_RTOL = 1e-5  # multiply-add order may differ
MIN_AGREE = 0.9999  # share of pixels / lanes that must agree
RIS_W_SUM_RTOL = 1e-5
RIS_BIG_W_RTOL = 1e-4
SHADE_RTOL, SHADE_ATOL = 2e-4, 1e-5
PHILOX_REL = 0.01  # Philox stream vs torch.rand stream, over the frame
FRAME_REL = 0.02  # last-frame mean, kernels vs plain versions


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
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import _build, rows, ris, shade, trace
    from romis_tpu_torch.ops.wrs import gen_canonical_samples_plain
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.pipeline import render_frame, save_image
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene,
    )

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} (count {torch.cuda.device_count()})")
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

    # ---- 3. each kernel against its plain version ----
    feats = Features(spatial_reuse=False)
    k, s = feats.num_samples_in_reservoir, feats.initial_light_samples
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

    # ---- 4. the slice through the main entry point ----
    def frames(ops, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        state, img = None, None
        for _ in range(FRAMES):
            img, state = render_frame(g, cam, scene, H, W, feats, state,
                                      ops=ops)
        torch.cuda.synchronize()
        return img, state

    wrappers = {"closest_hit": trace.closest_hit,
                "gather_rows": rows.gather_rows,
                "ris": ris.gen_canonical_samples_ris,
                "final_shade": shade.final_shade_fused}
    for fn in wrappers.values():
        fn.launches = 0
    img_k, state_k = frames(restir.KERNELS, 0)
    launches = {n: fn.launches for n, fn in wrappers.items()}
    img_p, _ = frames(restir.PLAIN, 0)
    print(f"slice: launches over {FRAMES} frames {launches}")
    expect = {"closest_hit": FRAMES, "gather_rows": 2 * FRAMES,
              "ris": FRAMES, "final_shade": FRAMES}
    require(launches == expect, f"launch counts {launches} != {expect}")
    require(tuple(img_k.shape) == (H, W, 3), f"image shape {img_k.shape}")
    require(bool(torch.isfinite(img_k).all()), "non-finite pixels (kernels)")
    require(bool(torch.isfinite(img_p).all()), "non-finite pixels (plain)")
    mk, mp = img_k.mean().item(), img_p.mean().item()
    print(f"slice: last-frame mean {mk:.6f} (kernels) vs {mp:.6f} (plain)")
    require(abs(mk - mp) <= FRAME_REL * abs(mp), "frame means differ")
    require(state_k.has_prev and float(state_k.reservoirs.m.max()) > s / k,
            "temporal state did not accumulate")
    png = ROOT / "build" / "chip_smoke_frame.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    save_image(str(png), img_k)
    print(f"slice: wrote {png.relative_to(ROOT)}")

    # ---- 5. timing ----
    def one_frame(ops):
        g = torch.Generator(device=dev).manual_seed(5)
        st = restir.initial_temporal_state(H, W, k, cam)

        def run():
            nonlocal st
            _, st = render_frame(g, cam, scene, H, W, feats, st, ops=ops)
        return run

    f_k, f_p = ab_ms(torch, one_frame(restir.KERNELS),
                     one_frame(restir.PLAIN), 10, 3)
    rays_per_frame = H * W * (1 + k)
    print(f"time frame: {f_k:.3f} ms/frame kernels, {f_p:.3f} ms/frame plain "
          f"({rays_per_frame / f_k / 1e3:.1f} Mrays/s) [{card}]")

    uni = torch.rand((sk, 4, k, H, W), generator=gen, device=dev)
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
    }
    for n, (km, pm) in timings.items():
        print(f"time {n}: {km:.4f} ms kernel, {pm:.4f} ms plain [{card}]")
    timings["ris_philox"] = (cuda_ms(torch, lambda: ris.gen_canonical_samples_ris(
        ctx, scene.lights, scene.num_lights, feats, generator=gen), 10), None)
    print(f"time ris (philox): {timings['ris_philox'][0]:.4f} ms [{card}]")

    sources = {
        "closest_hit": ("romis_tpu_torch/csrc/trace.cu",
                        "romis_tpu/ops/pallas_trace.py:465"),
        "gather_rows": ("romis_tpu_torch/csrc/rows.cu",
                        "romis_tpu/ops/pallas_rows.py:83"),
        "ris": ("romis_tpu_torch/csrc/ris.cu",
                "romis_tpu/ops/pallas_ris.py:473"),
        "final_shade": ("romis_tpu_torch/csrc/shade.cu",
                        "romis_tpu/ops/pallas_shade.py:236"),
    }
    table_rows = [{"name": n, "route": "cuda", "source": src,
                   "replaces": rep, "launches": launches[n],
                   "max_abs_err": errs[n], "ms": timings[n][0],
                   "plain_ms": timings[n][1]}
                  for n, (src, rep) in sources.items()]
    print(json.dumps({"kernels": table_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
