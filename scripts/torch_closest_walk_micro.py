#!/usr/bin/env python3
"""Microbenchmark: variants of kernels 18 (the BVH closest hit,
``romis_tpu_torch/csrc/walk.cu``) and 1 (the soup closest hit,
``csrc/trace.cu``) at the shapes of ``chip_smoke.py``, in one call on one
NVIDIA GPU. It shows what sets each kernel's pace (``PERF.md``). Needs one
GPU and ``nvcc``; builds its own variants,
``scripts/torch_closest_walk_micro.cu``, into
``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_closest_walk_micro.py

Kernel 18 on the 1080p primary rays of the 5x5 torus field (24,202
triangles, a SAH tree): the package's kernel (8 x 4 tiles a warp, 40
registers), a warp's rays a row of 32 with no register bound (variant 1,
the walk's first design), tiles with no register bound (2), the parent's
preorder walk on the triangle records (3), the package's kernel reading
the [10, T] columns (4). Kernel 1 on the flagship's 1080p primary rays (the
package alone: its direct loop over 2 triangles), and on the 1080p primary
rays of the one-torus soup (``chip_smoke.TORUS_CAM``) and of the 2048-triangle soup
(the flagship camera): the package's kernel (tiles, the guard's box and
distance rules, its pair cones tried once a warp), each lane's own guard
with the box rule alone on rows of 32 (1, the first design) and on tiles
(2), the box alone without the guard (3; the
rays whose answer differs are counted), 2 with the blocks visited nearest
first from a block's first ray's origin (4). Every other variant's (t,
tri, u, v) is the package's, bit for bit.

Times by CUDA events around each call (host work included) and the
kernels' device time from ``torch.profiler``. The last line is one JSON
object of the times (ms).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402  (constants and timing helpers)
from torch_scatter_shade_micro import call, device_ms  # noqa: E402

H, W = chip_smoke.H, chip_smoke.W
OUT = ROOT / "build" / "romis_tpu_torch_micro"
STEM = Path(__file__).stem
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {"micro_walk": (_I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _F, _P, _P,
                          _P, _P, _P),
           "micro_soup": (_I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _F, _P, _P,
                          _P, _P, _P)}


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
        elif "Used" in line and "registers" in line and "micro" in entry:
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


def row_line(row):
    return "; ".join(
        f"{n} {r['ms']:.4f} ms (device "
        + (f"{r['device_ms']:.4f}" if r["device_ms"] is not None
           else "not measured") + ")"
        + (f", {r['differ']} rays differ" if "differ" in r else "")
        for n, r in row.items())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.ops import _build, trace, walk
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
        torus_field_camera,
    )

    card = chip_smoke.card_line()
    print(card)
    lib = build_variants()
    _build.build()
    dev = torch.device("cuda", 0)
    times = {}

    def outputs():
        return [torch.empty((H, W), dtype=dt, device=dev) for dt in (
            torch.float32, torch.int32, torch.float32, torch.float32)]

    def measure(label, runs, ref, names, may_differ=()):
        row = {}
        for name, fn in runs.items():
            out = fn()
            differ = sum((a != b).int() for a, b in zip(out, ref)) > 0
            r = dict(ms=chip_smoke.cuda_ms(torch, fn, 10),
                     device_ms=device_ms(torch, fn, 5, names))
            if name.startswith(may_differ):
                r["differ"] = int(differ.sum().item())
            else:
                chip_smoke.require(not differ.any(), f"{label} {name}: not "
                                   "the package's bits")
            row[name] = r
        print(f"micro {label}: {row_line(row)} [{card}]")
        times[label] = row

    # ---- kernel 18 ----
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    lgeo = large.geometry
    rays = generate_rays(torus_field_camera(H, W, dev), H, W)
    recs = walk.kept_records(lgeo)
    cols = lgeo.tri_cols
    ref = walk.closest_hit_bvh(rays, lgeo)

    def walk_variant(v):
        def run():
            out = outputs()
            call(torch, lib.micro_walk, v, rays.origin.data_ptr(),
                 rays.direction.data_ptr(), H, W, lgeo.bvh.nodes.data_ptr(),
                 lgeo.bvh.wide.data_ptr(), recs.data_ptr(), cols.data_ptr(),
                 cols.shape[1], float("inf"), *(a.data_ptr() for a in out))
            return out
        return run

    measure("bvh_closest_hit[torus field 1080p]", {
        "package": lambda: walk.closest_hit_bvh(rays, lgeo),
        "v1 rows of 32, no register bound": walk_variant(1),
        "v2 tiles, no register bound": walk_variant(2),
        "v3 the parent's preorder walk on records": walk_variant(3),
        "v4 the package's walk on columns": walk_variant(4),
    }, ref, ("bvh_closest_kernel", "walk_v"))
    del large, lgeo, rays, recs, cols, ref

    # ---- kernel 1 ----
    # The flagship's 2 triangles (padded to 8): the direct loop, whose
    # time by events is the wrapper's host work where that outlasts it.
    fgeo = flagship_scene(dev).geometry
    frays = generate_rays(flagship_camera(H, W, dev), H, W)
    fref = trace.closest_hit(frays, fgeo)
    measure("closest_hit[flagship 1080p, the direct loop]", {
        "package": lambda: trace.closest_hit(frays, fgeo),
    }, fref, ("closest_hit_kernel",))
    del fgeo, frays, fref
    torus1 = torus_field(1, dev)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    for label, geo, cam in (
            ("torus soup", torus1.geometry, make_camera(
                resolution=(H, W), device=dev, **chip_smoke.TORUS_CAM)),
            ("soup2048", soup, flagship_camera(H, W, dev))):
        rays = generate_rays(cam, H, W)
        cols, boxes, guard, index = trace.soup_blocks(geo)
        ref = trace.closest_hit(rays, geo)

        def soup_variant(v):
            def run():
                out = outputs()
                call(torch, lib.micro_soup, v, rays.origin.data_ptr(),
                     rays.direction.data_ptr(), H, W, cols.data_ptr(),
                     boxes.data_ptr(), guard.data_ptr(), index.data_ptr(),
                     cols.shape[1], float("inf"),
                     *(a.data_ptr() for a in out))
                return out
            return run

        measure(f"closest_hit[{label} 1080p, {cols.shape[1]} slots]", {
            "package": lambda: trace.closest_hit(rays, geo),
            "v1 each lane's box-rule guard, rows of 32": soup_variant(1),
            "v2 each lane's box-rule guard, tiles": soup_variant(2),
            "v3 the box alone (no guard)": soup_variant(3),
            "v4 v2 with the blocks nearest first": soup_variant(4),
        }, ref, ("closest_hit_kernel", "soup_v"), may_differ=("v3",))
        del rays, ref
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
