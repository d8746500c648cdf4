#!/usr/bin/env python3
"""Microbenchmark: variants of kernels 6 (the soup any-hit,
``romis_tpu_torch/csrc/any.cu``) and 8 (the Plücker any-hit,
``csrc/plucker.cu``) at the shapes of ``chip_smoke.py``, in one call on one
NVIDIA GPU, the parents first. Needs one GPU and ``nvcc``; builds its own
variants, ``scripts/torch_soup_any_micro.cu``, into
``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_soup_any_micro.py

The segment sets, 1920x1080 unless named: the torus soup's shadow rays
(``tshadow``: the one-torus field as a 970-triangle soup through
``chip_smoke.TORUS_CAM``, K = 2 RIS winners), the 2048-triangle soup's
(the flagship camera's receivers), the flagship's (2 triangles), and
``chip_smoke.hard_z_rays``' four kinds made segments (1 origin, 2 targets,
270x480) on the torus soup and the 2048-triangle soup. Kernel 6: the
package's (culled, a pixel's planes in adjacent lanes, no block's guard
deferred), the parent (a thread a segment, no cull), 8 x 4 tiles of a
plane, rows, and every block's guard deferred, none, or the unflagged
blocks'.
Kernel 8: the package's, the parent (no cull, the table in the input
order), and the culled walk with its constants staged (where they fit),
read through the caches or formed in the kernel from the staged columns,
each with every block's guard deferred, none, the blocks
``zcount_blocks`` flags or the others, on a pixel's planes in adjacent
lanes, and the package's source on 8 x 4 tiles of a plane
(``PLUCKER_VARIANTS``). Every bool is held to the plain version's; a
variant's CUDA error is printed and the run goes on. Also the culled walks' tests (``ops.trace.any_hit_culled``,
``any_hit_plucker_culled``, the box alone deciding and with the guard) on
the torus soup's and the 2048-soup's segments, and kernel 8's table build.
Times by CUDA events around each call. The last line is one JSON object
of the times (ms).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (constants and timing helpers)

H, W = chip_smoke.H, chip_smoke.W
OUT = ROOT / "build" / "romis_tpu_torch_micro"
STEM = Path(__file__).stem
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {"micro_any": (_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I,
                         _P, _P),
           "micro_plucker": (_I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                             _P, _P, _P, _I, _P, _I, _P, _P)}
ANY_VARIANTS = {"parent": 1, "package (a pixel's planes adjacent)": 0,
                "8 x 4 tiles": 2, "rows": 3, "every guard deferred": 4,
                "no guard deferred": 5, "the unflagged blocks' deferred": 6,
                "the flagged blocks' deferred (kernel 4's)": 7}
# Kernel 8's variants: name → (variant, triangle source, guard deferral,
# tiles); the source -1 the package's choice, 0 staged constants, 1 cached,
# 2 formed from the columns; the deferral 0 none, 1 all, 2 the flagged
# blocks, 3 the others.
PLUCKER_VARIANTS = {
    "parent": (1, 0, 0, 0), "package": (0, 0, 0, 0),
    "staged, every guard deferred": (2, 0, 1, 0),
    "cached, every guard deferred": (2, 1, 1, 0),
    "columns, every guard deferred": (2, 2, 1, 0),
    "staged, no guard deferred": (2, 0, 0, 0),
    "cached, no guard deferred": (2, 1, 0, 0),
    "columns, no guard deferred": (2, 2, 0, 0),
    "staged, the flagged blocks' deferred": (2, 0, 2, 0),
    "columns, the flagged blocks' deferred": (2, 2, 2, 0),
    "staged, the unflagged blocks' deferred": (2, 0, 3, 0),
    "cached, the unflagged blocks' deferred": (2, 1, 3, 0),
    "columns, the unflagged blocks' deferred": (2, 2, 3, 0),
    "the package's source on 8 x 4 tiles, every guard deferred": (2, -1, 1, 1),
    "the package's source, every guard deferred": (2, -1, 1, 0),
}


def build_variants():
    """Compile, link and load this script's variants → the library."""
    from romis_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    obj = OUT / f"{STEM}.o"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c",
         "-o", str(obj), str(Path(__file__).with_suffix(".cu"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        chip_smoke.fail(f"nvcc failed:\n{done.stdout}")
    entry, spill = "", ""
    for line in done.stdout.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and (
                "any" in entry or "plucker" in entry):
            print(f"ptxas: {entry} {line.split('Used')[1].strip()}; {spill}")
    lib_path = OUT / f"lib{STEM}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib_path),
                    str(obj)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, args in ENTRIES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.ops import _build, ris, trace
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
    )

    card = chip_smoke.card_line()
    print(card)
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_build.build), pool.submit(build_variants)]
        lib = jobs[1].result()
        jobs[0].result()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    f = Features()

    def shadow(scene, geo, cam):
        _, ctx = restir.trace_primary(generate_rays(cam, H, W), geo, f,
                                      restir.KERNELS)
        res = ris.gen_canonical_samples_ris(ctx, scene.lights,
                                            scene.num_lights, f,
                                            generator=gen)
        to = res.pos - ctx.position
        d = to / torch.linalg.vector_norm(to, dim=-3).clamp_min(
            1e-20)[:, None]
        o = ctx.position + 1e-3 * d
        return (o.contiguous(), d.contiguous(),
                torch.linalg.vector_norm(res.pos - o, dim=-3).contiguous())

    def hard(geo, kind, seed):
        o_, t_ = (torch.from_numpy(a).to(dev) for a in chip_smoke.hard_z_rays(
            np.random.default_rng(seed), kind, geo.tri_cols.cpu().numpy(), 1,
            2, LH, LW))
        to = t_ - o_[0]
        dist = torch.linalg.vector_norm(to, dim=1)
        return (o_[0].expand(to.shape).contiguous(),
                (to / dist.clamp_min(1e-20)[:, None]).contiguous(),
                dist.contiguous())

    LH, LW = chip_smoke.LH, chip_smoke.LW
    scene = flagship_scene(dev)
    torus1 = torus_field(1, dev)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    tcam = make_camera(resolution=(H, W), device=dev, **chip_smoke.TORUS_CAM)
    fcam = flagship_camera(H, W, dev)
    sets = {"torus soup": (torus1.geometry, shadow(torus1, torus1.geometry,
                                                   tcam)),
            "soup2048": (soup, shadow(scene, soup, fcam)),
            "flagship": (scene.geometry, shadow(scene, scene.geometry,
                                                fcam))}
    for i, kind in enumerate(chip_smoke.HARD_RAY_KINDS):
        sets[f"torus soup {kind}"] = (torus1.geometry,
                                      hard(torus1.geometry, kind, 90 + i))
        sets[f"soup2048 {kind}"] = (soup, hard(soup, kind, 95 + i))

    # Kernel 8's table build, on a soup seen for the first time.
    for label, geo in (("torus soup", torus1.geometry), ("soup2048", soup),
                       ("flagship", scene.geometry)):
        ms = chip_smoke.cuda_ms(torch, lambda: (setattr(geo, "plucker", None),
                                                trace.plucker_blocks(geo)), 5)
        print(f"time plucker_blocks[{label}] (the kept table, its slots and "
              f"guard, built afresh): {ms:.4f} ms [{card}]")

    times = {}
    for label, (geo, (o, d, tm)) in sets.items():
        planes, h, w = tm.shape
        n_t = geo.tri_cols.shape[1]
        if n_t <= trace.ZCOUNT_BLOCK:
            cols, boxes, guard6 = geo.tri_cols, None, None
        else:
            cols, boxes, guard6 = trace.zcount_blocks(geo)
        _, slots, pboxes, pguard, pblocks = trace.plucker_blocks(geo)
        pcols = None if pboxes is None else cols
        cmat = trace.plucker_matrix(geo).contiguous()
        raw = geo.tri_cols
        want6 = trace.any_hit_plain(o, d, tm, geo)
        want8 = trace.any_hit_plucker_plain(o, d, tm, geo)
        out = torch.empty(tm.shape, dtype=torch.bool, device=dev)

        def ptr(a):
            return None if a is None else a.data_ptr()

        def run6(v):
            return lib.micro_any(v, o.data_ptr(), d.data_ptr(),
                                 tm.data_ptr(), h, w, planes, cols.data_ptr(),
                                 ptr(boxes), ptr(guard6), cols.shape[1],
                                 raw.data_ptr(), raw.shape[1], out.data_ptr(),
                                 stream())

        def run8(v):
            return lib.micro_plucker(*v, o.data_ptr(), d.data_ptr(),
                                     tm.data_ptr(), h, w, planes,
                                     slots.data_ptr(), ptr(pcols),
                                     ptr(pboxes), ptr(pguard), ptr(pblocks),
                                     slots.shape[0], cmat.data_ptr(),
                                     raw.shape[1], out.data_ptr(), stream())

        culled = n_t > trace.ZCOUNT_BLOCK
        row = {}
        for kernel, variants, run, want in (
                (6, ANY_VARIANTS, run6, want6),
                (8, PLUCKER_VARIANTS, run8, want8)):
            for name, v in variants.items():
                if not culled and v not in (0, 1, (0, 0, 0, 0), (1, 0, 0, 0)):
                    continue
                if (kernel == 8 and v[0] == 2 and v[1] == 0
                        and slots.shape[0] * 152 > 227 << 10):
                    continue  # its constants do not fit
                out.zero_()
                err = run(v)
                torch.cuda.synchronize()
                if err:
                    print(f"time kernel {kernel} [{label}] {name}: CUDA "
                          f"error {err} (above 1000: left by an earlier "
                          "call)")
                    continue
                same = torch.equal(out, want)
                ms = chip_smoke.cuda_ms(torch, lambda: run(v), 10)
                row[f"{kernel}:{name}"] = ms
                print(f"time kernel {kernel} [{label}, {planes}x{h}x{w} "
                      f"segments, {n_t} triangle slots] {name}: {ms:.4f} ms; "
                      f"the plain bool on every segment {same} (occluded "
                      f"{want.float().mean().item():.4f}) [{card}]")
                chip_smoke.require(same, f"kernel {kernel} variant {v} "
                                   f"{label}: the bool differs")
        times[label] = row
        if culled and label in ("torus soup", "soup2048"):
            for name, model in (
                    ("any_hit_culled", lambda *a, **kw: trace.any_hit_culled(
                        *a, lazy=False, **kw)),  # kernel 6 defers no guard
                    ("any_hit_plucker_culled", trace.any_hit_plucker_culled)):
                cnt, cnt_b = {}, {}
                got = model(o, d, tm, geo, cnt)
                model(o, d, tm, geo, cnt_b, guard=False)
                want = want8 if "plucker" in name else want6
                print(f"walk {name}[{label}]: the plain bool on every segment "
                      f"{torch.equal(got, want)}; "
                      f"per segment, the box alone: box "
                      f"{cnt_b['box'].float().mean().item():.2f}, triangle "
                      f"{cnt_b['tri'].float().mean().item():.2f}; with the "
                      f"guard: box {cnt['box'].float().mean().item():.2f}, "
                      f"guarded blocks {cnt['guard'].float().mean().item():.2f}, "
                      f"cone products "
                      f"{cnt['guard_cone'].float().mean().item():.2f}, normal "
                      f"products {cnt['guard_tri'].float().mean().item():.2f}, "
                      f"triangle {cnt['tri'].float().mean().item():.2f}")
        del o, d, tm, want6, want8, out
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
