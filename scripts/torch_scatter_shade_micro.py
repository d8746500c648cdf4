#!/usr/bin/env python3
"""Microbenchmark: variants of kernels 13 (the row scatter-add,
``romis_tpu_torch/csrc/scatter.cu``) and 21 (the BVH final shade,
``csrc/shade.cu``) at the shapes of ``chip_smoke.py``, in one call on one
NVIDIA GPU. It shows what sets each kernel's pace (``PERF.md``). Needs one
GPU and ``nvcc``; builds its own variants,
``scripts/torch_scatter_shade_micro_scatter.cu`` and ``..._shade.cu``, into
``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_scatter_shade_micro.py

Kernel 13 on the tables of the three gradient steps at 1920x1080 (the
flagship's light, material, triangle and attribute-width tables, the
2048-triangle soup's, the 5x5 torus field's; each with the cotangents of
missed pixels set to 0, as the steps give them, where the table is
indexed by the hit triangle): the package's kernel, the package's
device-memory path on every table (tile 0), the kernel's earlier design
(variant 0), that design with the loads of 8 columns in flight (1),
the first tiled design (2, __match_any_sync), its second (3, every lane
of a many-row group adding with a shared-memory atomic) and that design's
device-memory path (4, a device atomic a lane of a many-row group), and
its third (5, the tag owners' plain adds, the values still staged through
shared memory), its fourth (the values read by each warp from device
memory) compiled for 42 registers a thread with 1 or 2 blocks an SM (21,
22), its fifth (6, the values handed to a target lane of their row by
shuffles, no shared-memory atomics), the package's kernel with 1, 2 or 3
columns a warp (31-33); and the light table cut to one tile a block (the
launch, a tile and the flush). Each within the chip_smoke tolerances of
the plain and float64 sums; the time by CUDA events around the wrapper
(its host work included) and the kernel's device time from
``torch.profiler``.

Kernel 21 on the torus field at K = 1, 2 and 4: the package's kernel
(through its wrapper: the context's and reservoirs' own planes), and on
kernel 4's packed planes (packed outside the timed call) the mapping with
every lane's Phong term on the triangle columns (variant 1) and on the
records (2, the mapping's first design), with only lit lanes' Phong terms
(4), and a thread per pixel walking its K rays one after another (3).
Every variant's output is the package's, bit for bit.

The last line is one JSON object of the times (ms).
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
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {"micro_scatter": (_I, _P, _I, _P, _LL, _I, _I, _P, _P),
           "micro_shade_bvh": (_I, _P, _P, _LL, _I, _P, _P, _I, _P, _I, _P,
                               _P)}


def build(src):
    """Start compiling this script's variant source ``src``; ``load``
    waits for it."""
    from romis_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    obj = OUT / f"{src}.o"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c",
           "-o", str(obj), str(Path(__file__).with_name(f"{STEM}_{src}.cu"))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), obj, src


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
        elif "Used" in line and "registers" in line and "micro" in entry:
            print(f"ptxas {name}: {entry} {line.split('Used')[1].strip()}; "
                  f"{spill}")
    lib_path = OUT / f"lib{name}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib_path),
                    str(obj)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, args in ENTRIES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    return lib


def device_ms(torch, fn, reps, names):
    """Mean device time a call of the kernels whose names hold one of
    ``names``, from ``torch.profiler`` (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if any(n in ev.key for n in names):
            total += t
    return total / reps / 1e3 if total else None


def call(torch, fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        chip_smoke.fail(f"{fn.__name__}: CUDA error {err}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.ops import _build, ris, scatter, shade, trace, walk
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
        torus_field_camera,
    )

    card = chip_smoke.card_line()
    print(card)
    jobs = [build("scatter"), build("shade")]
    _build.build()
    libs = {name: load(*job) for job, name in zip(jobs, ("scatter", "shade"))}
    lib_s, lib_h = libs["scatter"], libs["shade"]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    times = {}

    # ---- kernel 13 ----
    scene = flagship_scene(dev)
    rays = generate_rays(flagship_camera(H, W, dev), H, W)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    lgeo = large.geometry
    lrays = generate_rays(torus_field_camera(H, W, dev), H, W)
    k = 2
    ftri = trace.closest_hit_plain(rays, scene.geometry)[1]
    ltri = walk.closest_hit_bvh(lrays, lgeo)[1]
    cases = chip_smoke.scatter_tables(torch, gen, scene, ftri, k)
    cases["soup2048"] = (torch.randn((9, H, W), generator=gen, device=dev),
                         trace.closest_hit_plain(rays, soup)[1].clamp_min(0),
                         chip_smoke.SOUP_TRIS)
    cases.update(chip_smoke.scatter_tables(torch, gen, large, ltri, k,
                                           "torus "))
    for label, tri in (("torus triangles", ltri), ("triangles", ftri)):
        ct, idx, n_rows = cases[label]
        cases[f"{label}, misses 0"] = (ct * (tri >= 0), idx, n_rows)
    # The light table with one 2048-index tile a block (132 SMs): the
    # launch, one tile and the flush alone.
    ct, idx, n_rows = cases["lights"]
    m = 132 * scatter.TILE
    cases["lights, one tile a block"] = (
        ct.reshape(ct.shape[0], -1)[:, :m].contiguous(),
        idx.reshape(-1)[:m].contiguous(), n_rows)

    def variant(v, tile_of=None):
        def run(ct, idx, n_rows):
            c = ct.shape[0]
            flat_ct, flat_idx = ct.reshape(c, -1), idx.reshape(-1)
            out = torch.zeros((n_rows, c), device=dev)
            call(torch, lib_s.micro_scatter, v, flat_ct.data_ptr(), c,
                 flat_idx.data_ptr(), flat_idx.numel(), n_rows,
                 tile_of(c, n_rows) if tile_of else 0, out.data_ptr())
            return out
        return run

    def package(tile, cols):
        """The package's entry with its tile (0: the device path) and
        columns a warp set by hand."""
        def run(ct, idx, n_rows):
            c = ct.shape[0]
            out = torch.zeros((n_rows, c), device=dev)
            _build.launch("romis_scatter_rows_add", ct.data_ptr(), c,
                          idx.data_ptr(), idx.numel(), n_rows,
                          tile(c, n_rows), cols, out.data_ptr())
            return out
        return run

    def tile_of(extra):
        """The largest tile whose shared memory fits, with ``extra(tile)``
        ints beside the table and the two buffers (variants 2, 3 and 5)."""
        def pick(c, n_rows):
            for tile in (2048, 1024, 512, 256):
                tab = (n_rows * (c | 1) + 3) // 4 * 4
                if 4 * (tab + 2 * (c + 1) * tile + extra(tile)) <= \
                        scatter.SMEM_BYTES:
                    return tile
            return 0
        return pick

    run1_tile = tile_of(lambda t: t)
    run2_tile = tile_of(lambda t: t + (scatter.HELD + 1) * (t // 32))

    def run3_tile(c, n_rows):
        return tile_of(lambda t: t + (scatter.HELD + 1) * (t // 32)
                       + scatter.TAGS * min(max(c, 4), 32))(c, n_rows)
    runs = {"package": (scatter.scatter_rows_add, ("scatter_rows_",), None),
            "package device path": (package(lambda c, r: 0, 1),
                                    ("scatter_rows_global",), None),
            "v0 earlier design": (variant(0), ("parent_kernel",), None),
            "v1 v0 + 8 columns' loads": (variant(1), ("parent_kernel",),
                                         None),
            "v2 first tiled": (variant(2, run1_tile), ("tiled",), run1_tile),
            "v3 second tiled": (variant(3, run2_tile), ("tiled",), run2_tile),
            "v4 second device path": (variant(4), ("global",), None),
            "v5 third tiled": (variant(5, run3_tile), ("tiled",), run3_tile)}
    pkg_tile = scatter.scatter_tile
    runs["v6 fifth tiled"] = (variant(6, pkg_tile), ("tiled",), pkg_tile)
    for cols in (1, 2, 3):
        runs[f"v3{cols} package, {cols} columns a warp"] = (
            package(pkg_tile, cols), ("scatter_rows_tiled",), pkg_tile)
    for bps in (1, 2):
        runs[f"v2{bps} 42 registers, {bps} blocks an SM"] = (
            variant(20 + bps, pkg_tile), ("tiled2",), lambda c, r: (
                pkg_tile(c, r) if c <= 24 else 0))
    for label, (ct, idx, n_rows) in cases.items():
        row = {}
        for name, (fn, kernels, tiled) in runs.items():
            if tiled is not None and not tiled(ct.shape[0], n_rows):
                continue
            rel, rel64 = chip_smoke.scatter_rel(torch, fn(ct, idx, n_rows),
                                                ct, idx, n_rows)
            chip_smoke.require(rel <= chip_smoke.SCATTER_REL
                               and rel64 <= chip_smoke.SCATTER_F64_REL,
                               f"scatter {label} {name}: {rel}, {rel64}")
            ms = chip_smoke.cuda_ms(torch, lambda: fn(ct, idx, n_rows), 20)
            dms = device_ms(torch, lambda: fn(ct, idx, n_rows), 10, kernels)
            row[name] = dict(ms=ms, device_ms=dms)
        b_ms, _ = chip_smoke.scatter_bound(ct, idx, n_rows)
        print(f"micro scatter_rows_add[{label}] ({n_rows} x {ct.shape[0]}, "
              f"{idx.numel()} indices, bound {b_ms:.4f} ms): " + "; ".join(
                  f"{n} {r['ms']:.4f} ms (device "
                  + (f"{r['device_ms']:.4f}" if r['device_ms'] else
                     "not measured") + ")" for n, r in row.items())
              + f" [{card}]")
        times[f"scatter_rows_add[{label}]"] = dict(row, bound=b_ms)
    del cases

    # ---- kernel 21 ----
    _, lctx = restir.trace_primary(lrays, lgeo, Features(), restir.KERNELS)
    nodes, cols = walk.checked_tree(lgeo), lgeo.tri_cols
    recs = walk.tri_records(cols)
    for kk in (1, 2, 4):
        f = Features(num_samples_in_reservoir=kk)
        res = ris.gen_canonical_samples_ris(lctx, large.lights,
                                            large.num_lights, f, generator=gen)
        cp = shade.pack_center_ctx(lctx)  # the 18 + 10K packed planes
        rp = pack_reservoir_planes(res)
        ref = shade.final_shade_bvh(lctx, res, lgeo, f)

        def micro(v):
            def run():
                out = torch.empty_like(ref)
                call(torch, lib_h.micro_shade_bvh, v, cp.data_ptr(),
                     rp.data_ptr(), H * W, kk, nodes.data_ptr(),
                     cols.data_ptr(), cols.shape[1], recs.data_ptr(), 0,
                     out.data_ptr())
                return out
            return run

        row = {}
        for name, fn in {
                "package": lambda: shade.final_shade_bvh(lctx, res, lgeo, f),
                "v1 packed, columns": micro(1),
                "v2 packed, records (first design)": micro(2),
                "v4 packed, lit lanes' Phong": micro(4),
                "v3 a thread a pixel": micro(3)}.items():
            chip_smoke.require(torch.equal(fn(), ref),
                               f"shade K={kk} {name}: not the package's bits")
            row[name] = dict(ms=chip_smoke.cuda_ms(torch, fn, 10),
                             device_ms=device_ms(torch, fn, 5, (
                                 "final_shade_bvh", "shade_lanes",
                                 "shade_pixel")))
        print(f"micro bvh_final_shade[K={kk}]: " + "; ".join(
            f"{n} {r['ms']:.4f} ms (device "
            + (f"{r['device_ms']:.4f}" if r['device_ms'] else "not measured")
            + ")" for n, r in row.items()) + f"; bit-equal [{card}]")
        times[f"bvh_final_shade[K={kk}]"] = row
        del res, cp, rp, ref
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
