#!/usr/bin/env python3
"""Microbenchmark: variants of kernels 16 (neighbour selection,
``romis_tpu_torch/csrc/nbrsel.cu``) and 11 (the unbiased spatial pass,
``csrc/spatial.cu``) at the shapes of ``chip_smoke.py``, in one call on one
NVIDIA GPU. It shows what sets each kernel's pace (``PERF.md``). Needs one
GPU and ``nvcc``; builds its own copies of the two kernels,
``scripts/torch_nbrsel_spatial_micro_nbrsel.cu`` and ``..._spatial.cu``
(the package's kernels beside the designs the package leaves out), into
``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_nbrsel_spatial_micro.py

Kernel 16 on the flagship's gates at 1920x1080 (D = 5, r = 10, Philox),
SIMILAR, DISSIMILAR and two classes: the unfiltered race (variant 0), the
filtered race scoring a passing cell at once (1), passing cells queued and
scored in warp rounds (2; also built with queues of 2 and 8), and 2 with
the depth gate decided by products (3); 2 and 3 with the staged window's
path compiled alone (18, 19: the package's design), and 18 with Philox's
round keys computed once a pixel (50). Each variant is
counted once (cells scored and gated, the warp's scoring rounds) and
every variant's outputs are bit-equal to the package kernel's.

Kernel 11 at 1920x1080 (K = 2, R = 5, r = 10) on the flagship's RIS
reservoirs: the package's entry; the plane layout (variant 0, the design
before the records); the first records design (1; its pre-pass (2) and
pass (3) alone); a shared-memory window (4); the first design's records
written through shared memory (5; alone 7) and its pass asking for 3
blocks an SM (6; alone 8); the second design (9: a lane's record fields
together, the records written through shared memory; its pre-pass (11,
the package's) and pass (10) alone, the pass asking for 3 blocks an SM
(12)); and that pass with the next neighbour's records loaded ahead (13),
the receiver read from its own context record (14), the neighbours' m
kept in shared memory (15), all three (16), and 16 (17) or 14 + 15 (18)
asking for 3 blocks an SM, and 18 on 16 x 16 (19, the package's pass) and
64 x 4 blocks (20). On Philox, then on
injected noise with offsets random within ±10, all zero (coalesced) and
within ±1, and in the vis_check mode on the one-torus soup. Every
variant's outputs are the package kernel's, bit for bit.

The last line is one JSON object of the times (ms) and counts.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (constants and timing helpers)

H, W = chip_smoke.H, chip_smoke.W
OUT = ROOT / "build" / "romis_tpu_torch_micro"
STEM = Path(__file__).stem


def build(name, src, defines=()):
    """Start compiling this script's variant source ``src`` (with
    ``defines``); ``load`` waits for it."""
    from romis_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    obj = OUT / f"{name}.o"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I",
           str(_build.CSRC), "-c", "-o", str(obj),
           str(Path(__file__).with_name(f"{STEM}_{src}.cu"))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), obj, name


def load(job, obj, name):
    """Wait for ``build``'s compiler, print its registers, link and load."""
    from romis_tpu_torch.ops import _build

    log = job.communicate()[0]
    if job.returncode != 0:
        chip_smoke.fail(f"nvcc failed:\n{log}")
    entry, spill = "", ""
    for line in log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            print(f"ptxas {name}: {entry} {line.split('Used')[1].strip()}; "
                  f"{spill}")
    lib_path = OUT / f"lib{name}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib_path),
                    str(obj)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    sig = _build.SIGNATURES
    for fn_name, args in (
            ("micro_neighbour_select", list(sig["romis_neighbour_select"])[:-1]
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
            ("micro_spatial_unbiased", list(sig["romis_spatial_pass"])[:-1]
             + [ctypes.c_int, ctypes.c_void_p])):
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def main() -> None:
    import math

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.ops import nbrsel, ris, shade, spatial
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        flagship_camera, flagship_scene, torus_field,
    )

    card = chip_smoke.card_line()
    print(card)
    pending = [build("nbrsel_q4", "nbrsel"),
               build("nbrsel_q2", "nbrsel", ("-DMICRO_QUEUE=2",)),
               build("nbrsel_q8", "nbrsel", ("-DMICRO_QUEUE=8",)),
               build("spatial", "spatial")]
    sel_lib, sel_q2, sel_q8, sp_lib = [load(*p) for p in pending]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    feats = Features()
    k, n_nbr = feats.num_samples_in_reservoir, feats.num_neighbours_to_sample
    radius = feats.spatial_resample_radius
    ms = {}

    # ---- kernel 16 ----
    scene = flagship_scene(dev)
    _, ctx = restir.trace_primary(generate_rays(flagship_camera(H, W, dev),
                                                H, W), scene.geometry, feats,
                                  restir.KERNELS)
    gates = nbrsel.selection_gates(ctx).contiguous()
    sel_args = (feats.neighbour_same_geometry,
                feats.neighbour_max_depth_difference_fraction,
                math.cos(feats.neighbour_max_normal_angle_difference_radians))
    key = spatial.philox_key(gen)
    d = n_nbr
    for label, (two, prefer) in {"similar": (False, True),
                                 "dissimilar": (False, False),
                                 "two_classes": (True, True)}.items():
        ref = nbrsel.neighbour_select(gates, d, radius, two, prefer,
                                      *sel_args, key=key)
        n_cls = 2 if two else 1
        s_out = torch.empty((n_cls, d, H, W), device=dev)
        p_out = torch.empty((n_cls, d, H, W), dtype=torch.int32, device=dev)
        cnt = torch.empty((2, H, W), dtype=torch.int32, device=dev)
        counts = torch.zeros(4, dtype=torch.int64, device=dev)

        def run(variant, lib=sel_lib):
            def go():
                err = lib.micro_neighbour_select(
                    gates.data_ptr(), H, W, d, radius, int(two), int(prefer),
                    int(sel_args[0]), float(sel_args[1]), float(sel_args[2]),
                    key.data_ptr(), nbrsel._TAG << 16, None, s_out.data_ptr(),
                    p_out.data_ptr(), cnt.data_ptr(), variant,
                    counts.data_ptr() if variant & 8 else None, stream())
                if err:
                    chip_smoke.fail(f"selection variant {variant}: CUDA "
                                    f"error {err}")
            return go

        row = {"package": chip_smoke.cuda_ms(torch, lambda: nbrsel.
                                             neighbour_select(
            gates, d, radius, two, prefer, *sel_args, key=key), 10)}
        variants = {"0 unfiltered": (0, sel_lib), "1 filtered, at once":
                    (1, sel_lib), "2 queued (4)": (2, sel_lib),
                    "2 queued (2)": (2, sel_q2), "2 queued (8)": (2, sel_q8),
                    "3 queued, depth by products": (3, sel_lib),
                    "18 = 2, staged path alone": (18, sel_lib),
                    "19 = 3, staged path alone": (19, sel_lib),
                    "50 = 18, round keys once": (50, sel_lib)}
        for name, (v, lib) in variants.items():
            run(v, lib)()
            torch.cuda.synchronize()
            got = ((s_out[0], p_out[0], s_out[1], p_out[1], cnt) if two
                   else (s_out[0], p_out[0]))
            chip_smoke.require(all(torch.equal(a, b) for a, b in
                                   zip(got, ref)),
                               f"selection {label} {name}: outputs differ")
            row[name] = chip_smoke.cuda_ms(torch, run(v, lib), 10)
        for v in (8, 9, 10):
            counts.zero_()
            run(v)()
            c = counts.tolist()
            n_warps = H * W // 32
            row[f"counts {v - 8}"] = dict(
                scored_per_pixel=c[0] / (H * W), gated_per_pixel=c[1] / (H * W),
                rounds_per_warp=c[2] / n_warps, cells_per_pixel=c[3] / (H * W))
        print(f"time neighbour_select[{label}, philox]: {json.dumps(row)} "
              f"[{card}]")
        ms[f"neighbour_select[{label}]"] = row
    del gates

    # ---- kernel 11 ----
    def pass_inputs(sc, cam):
        _, c = restir.trace_primary(generate_rays(cam, H, W), sc.geometry,
                                    feats, restir.KERNELS)
        rp = pack_reservoir_planes(ris.gen_canonical_samples_ris(
            c, sc.lights, sc.num_lights, feats, generator=gen))
        return rp, shade.pack_center_ctx(c)

    def time_pass(label, rp, cen, inject, vis_check, f):
        out = torch.empty((10 * k, H, W), device=dev)
        vis = torch.empty((spatial.vis_check_planes(k, n_nbr), H, W),
                          device=dev) if vis_check else None
        rres, rctx = spatial.record_buffers(H * W, k, dev)
        offs = gum = None
        if inject is not None:
            offs = inject[0].to(torch.int32).contiguous()
            gum = inject[1].contiguous()
        pkey = spatial.philox_key(gen)

        def run(variant):
            def go():
                err = sp_lib.micro_spatial_unbiased(
                    rp.data_ptr(), None, cen.data_ptr(), H, W, k, n_nbr,
                    radius, 1, None if offs is not None else pkey.data_ptr(),
                    spatial._TAG_UNBIASED << 16,
                    None if offs is None else offs.data_ptr(),
                    None if gum is None else gum.data_ptr(),
                    int(not f.enable_shading), out.data_ptr(),
                    None if vis is None else vis.data_ptr(),
                    rres.data_ptr(), rctx.data_ptr(), variant, stream())
                if err:
                    chip_smoke.fail(f"pass variant {variant}: CUDA error "
                                    f"{err}")
            return go

        kw = dict(inject=inject) if inject is not None else dict(key=pkey)
        if vis_check:
            ref = spatial.spatial_pass_unbiased_vis(rp, cen, k, n_nbr,
                                                    radius, f, **kw)
        else:
            ref = (spatial.spatial_pass_unbiased_fused(rp, cen, k, n_nbr,
                                                       radius, f, **kw),)
        row = {"package": chip_smoke.cuda_ms(torch, lambda: (
            spatial.spatial_pass_unbiased_vis if vis_check
            else spatial.spatial_pass_unbiased_fused)(
                rp, cen, k, n_nbr, radius, f, **kw), 10)}
        for name, v in (("0 planes", 0), ("1 first records", 1),
                        ("4 window", 4), ("5 first records staged", 5),
                        ("6 first records, pass at 3 blocks an SM", 6),
                        ("9 second records design", 9)):
            run(v)()
            torch.cuda.synchronize()
            got = (out, vis) if vis_check else (out,)
            chip_smoke.require(all(torch.equal(a, b) for a, b in
                                   zip(got, ref)),
                               f"pass {label} {name}: outputs differ")
            row[name] = chip_smoke.cuda_ms(torch, run(v), 10)
        # Each pass alone runs on the records its own pre-pass just wrote.
        for name, v in (("2 first pre-pass alone", 2),
                        ("3 first pass alone", 3),
                        ("7 first pre-pass staged alone", 7),
                        ("8 first pass at 3 blocks an SM alone", 8),
                        ("11 its pre-pass alone (the package's)", 11),
                        ("10 its pass alone", 10),
                        ("12 its pass at 3 blocks an SM alone", 12),
                        ("13 pass, records loaded ahead", 13),
                        ("14 pass, receiver from its record", 14),
                        ("15 pass, m in shared memory", 15),
                        ("16 pass, 13 + 14 + 15", 16),
                        ("17 = 16 at 3 blocks an SM", 17),
                        ("18 = 14 + 15 at 3 blocks an SM", 18),
                        ("19 = 18 on 16 x 16 blocks (the package's pass)", 19),
                        ("20 = 18 on 64 x 4 blocks", 20)):
            if v >= 13:  # on the package's records: bit-equal outputs
                run(v)()
                torch.cuda.synchronize()
                got = (out, vis) if vis_check else (out,)
                chip_smoke.require(all(torch.equal(a, b) for a, b in
                                       zip(got, ref)),
                                   f"pass {label} {name}: outputs differ")
            row[name] = chip_smoke.cuda_ms(torch, run(v), 10)
        print(f"time spatial_pass_unbiased[{label}]: {json.dumps(row)} "
              f"[{card}]")
        ms[f"spatial_pass_unbiased[{label}]"] = row

    rp, cen = pass_inputs(scene, flagship_camera(H, W, dev))
    time_pass("flagship, philox", rp, cen, None, False, feats)
    offs10, gum = spatial.spatial_noise(gen, n_nbr, k, radius, H, W)
    for label, offs in (("random +-10", offs10),
                        ("zero", torch.zeros_like(offs10)),
                        ("random +-1", torch.randint(
                            -1, 2, offs10.shape, generator=gen, device=dev,
                            dtype=offs10.dtype))):
        time_pass(f"flagship, injected, offsets {label}", rp, cen,
                  (offs, gum), False, feats)
    del rp, cen
    torus1 = torus_field(1, dev)
    tcam = make_camera(resolution=(H, W), device=dev, **chip_smoke.TORUS_CAM)
    vfeats = Features(unbiased_combination=True,
                      spatial_reuse_visibility_check=True)
    trp, tcen = pass_inputs(torus1, tcam)
    time_pass("torus soup, vis_check, philox", trp, tcen, None, True, vfeats)
    print(json.dumps({"card": card, "ms": ms}))


if __name__ == "__main__":
    main()
