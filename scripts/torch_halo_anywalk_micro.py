#!/usr/bin/env python3
"""Microbenchmark: variants of kernels 9 (the halo offset gather,
``romis_tpu_torch/csrc/halo.cu``) and 19 (the BVH any-hit, ``csrc/walk.cu``)
at the shapes of ``chip_smoke.py``, in one call on one NVIDIA GPU. It shows
what sets each kernel's pace (``PERF.md``). Needs one GPU and ``nvcc``;
builds its own variants, ``scripts/torch_halo_anywalk_micro.cu``, into
``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_halo_anywalk_micro.py

Kernel 9 at 1920x1080 on the flagship frame's planes at every shape the
frames give it (``chip_smoke.halo_cases``: reprojection's 25 planes at
D = 1 through a camera shift; 39, 45 and 2 planes at D = 5 random
offsets within ±10; 14 and 6 planes at D = 5 selected neighbours' offsets),
and 14 planes at random offsets within ±40 (beyond the window's margin):
the package's kernel, a thread per (d, pixel) (variant 0, the first
design; the package's at D = 1), the shared-memory window staged in turns
with the copies out (1, the first window design), staged double-buffered
by cp.async with its tile, margin, channel chunk, copy width, blocks an
SM, offset fields resolved at once and stores varied (2-5, 7-14; 15 at
the package's settings, which its kernel has folded in) and pixel-major
records read as float4 (6). Every output
is the plain version's, bit for bit (32-bit patterns).

Kernel 19 on the 5x5 torus field (24,202 triangles) at 1080p: the K = 1
initial-check shadow rays (one plane, ``large_k1``'s) and 17 planes of
rays to the sky light: the package's kernel (the two-box walk as a
speculative while-while loop, left child first), its walk with no
register bound (1), on rows of 32 (2), on the columns (6), nearer child
first (8), the two-box walk as one loop testing a leaf where it meets it
with the left (3), the farther (7) or the nearer child (9, the first
design) first, the preorder walk on the records (4) and the parent kernel
(5: the preorder walk on the [10, T] columns, rows of 32). Kernel 20
on its S = 2 and S = 12 rays beside the package's walk in kernel 20's
layout. Every bool is the package's.

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
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {"micro_halo": (_I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
           "micro_any": (_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                         _P),
           "micro_any_k": (_P, _P, _P, _LL, _I, _P, _P, _P, _P, _P)}
HALO_VARIANTS = {
    0: "v0 a thread per (d, pixel)",
    1: "v1 window staged in turns, 32x32, margin 16, 4 channels",
    2: "v2 cp.async window 32x32, margin 16, 2 channels, 2 blocks an SM",
    3: "v3 v2 with 4 channels",
    4: "v4 v2 with margin 12",
    5: "v5 v2 with a 16x32 tile",
    6: "v6 pixel-major records, float4",
    7: "v7 v2 with 4-byte copies",
    8: "v8 v2 with 1 channel",
    9: "v9 v2 at 3 blocks an SM",
    10: "v10 the package's, plain stores",
    11: "v11 margin 12, 2 channels, 4 blocks an SM, 5 fields",
    12: "v12 2 channels, 3 blocks an SM, 5 fields",
    13: "v13 the package's at 5 blocks an SM",
    14: "v14 the package's with 8 fields",
    15: "v15 the window template at the package's settings",
}
ANY_VARIANTS = {
    1: "v1 no register bound",
    2: "v2 rows of 32",
    3: "v3 one loop, left child first",
    4: "v4 preorder walk on records, tiles",
    5: "v5 the parent (preorder on columns, rows)",
    6: "v6 the package's walk on columns",
    7: "v7 one loop, farther child first",
    8: "v8 nearer child first",
    9: "v9 one loop, nearer child first",
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
                "micro" in entry or "halo_gather" in entry
                or "bvh_any_kernel" in entry):
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
           else "not measured") + ")" for n, r in row.items())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.ops import _build, ris, spatial, walk
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.ops.traverse import bvh_any
    from romis_tpu_torch.ops.wrs import visibility
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        flagship_camera, flagship_scene, torus_field, torus_field_camera,
    )

    card = chip_smoke.card_line()
    print(card)
    lib = build_variants()
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    feats = Features()
    times = {}

    def measure(label, runs, same, names):
        row = {}
        ref = None
        for name, fn in runs.items():
            out = fn()
            if ref is None:
                ref = out
            chip_smoke.require(same(out, ref), f"{label} {name}: not the "
                               "package's output")
            row[name] = dict(ms=chip_smoke.cuda_ms(torch, fn, 10),
                             device_ms=device_ms(torch, fn, 5, names))
        print(f"micro {label}: {row_line(row)} [{card}]")
        times[label] = row

    # ---- kernel 9 ----
    scene = flagship_scene(dev)
    rays = generate_rays(flagship_camera(H, W, dev), H, W)
    _, ctx = restir.trace_primary(rays, scene.geometry, feats, restir.KERNELS)
    res = ris.gen_canonical_samples_ris(ctx, scene.lights, scene.num_lights,
                                        feats, generator=gen)
    pan = make_camera(look_at=(2.57, 1.23, -1.35),
                      rotation_deg=(10.3 + chip_smoke.PAN_DEG,
                                    30.0 + chip_smoke.PAN_DEG, 0.0),
                      distance=25.0, fov_deg=30.0, resolution=(H, W),
                      device=dev)
    cases = chip_smoke.halo_cases(torch, gen, ctx, res, feats, pan)
    wide = spatial.clamped_offsets(torch.randint(
        -40, 41, (2, 5, H, W), generator=gen, device=dev, dtype=torch.int32),
        H, W)
    cases["beyond the margin 5x14, random +-40"] = (
        cases["resolve_neighbour_ctx 5x14, selected"][0], *wide)
    for label, (planes, dy, dx) in cases.items():
        planes = planes.contiguous()
        dy, dx = dy.int().contiguous(), dx.int().contiguous()
        c, d = planes.shape[0], dy.shape[0]
        scratch = torch.empty((H * W * 4 * -(-c // 4),), device=dev)

        def variant(v):
            def run():
                out = torch.empty((d, c, H, W), device=dev)
                call(torch, lib.micro_halo, v, planes.data_ptr(), c, H, W, d,
                     dy.data_ptr(), dx.data_ptr(), out.data_ptr(),
                     scratch.data_ptr())
                return out
            return run

        runs = {"package": lambda: spatial.halo_offset_gather(planes, dy,
                                                              dx)}
        runs.update({n: variant(v) for v, n in HALO_VARIANTS.items()})
        plain = spatial.halo_offset_gather_plain(planes, dy, dx)
        chip_smoke.require(chip_smoke.same_bits(torch, runs["package"](),
                                                plain),
                           f"halo gather {label}: not the plain version's")
        far = spatial.beyond_window(dy, dx)
        b_ms, _ = chip_smoke.halo_bound(planes, dy)
        print(f"micro halo_gather[{label}]: D={d}, C={c}, bound "
              f"{b_ms:.4f} ms, far sources {far.float().mean().item():.5f}")
        del plain, far
        measure(f"halo_gather[{label}]", runs,
                lambda a, b: chip_smoke.same_bits(torch, a, b),
                ("halo_gather", "window_variant", "records_kernel"))
        times[f"halo_gather[{label}]"]["bound_ms"] = b_ms
        del scratch
        torch.cuda.empty_cache()
    del cases, ctx, res

    # ---- kernel 19 ----
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    lgeo = large.geometry
    _, lctx = restir.trace_primary(generate_rays(torus_field_camera(H, W, dev),
                                                 H, W), lgeo, feats,
                                   restir.KERNELS)
    lres = ris.gen_canonical_samples_ris(lctx, large.lights, large.num_lights,
                                         feats, generator=gen)

    def vis_rays(targets):
        got = {}

        def grab(o, d, tm, _g):
            got["rays"] = (o.contiguous(), d.expand(o.shape).contiguous(),
                           tm.contiguous())
            return torch.zeros(tm.shape, dtype=torch.bool, device=dev)

        visibility(lctx.position, targets, lgeo, grab)
        return got["rays"]

    sky = large.lights.rows[0]
    uv = torch.rand((2, chip_smoke.SKY_PLANES, 1, H, W), generator=gen,
                    device=dev)
    sky_pts = (sky[0:3, None, None] + uv[0] * sky[3:6, None, None]
               + uv[1] * sky[6:9, None, None])
    recs = walk.kept_records(lgeo)
    cols = lgeo.tri_cols
    nodes, wide_rec = lgeo.bvh.nodes, lgeo.bvh.wide
    lshadow = vis_rays(lres.pos)
    for label, (o, d, tm) in (
            ("1 plane, the K=1 initial check", tuple(a[:1] for a in lshadow)),
            (f"{chip_smoke.SKY_PLANES} planes to the sky light",
             vis_rays(sky_pts))):
        s = tm.shape[0]

        def variant(v):
            def run():
                out = torch.empty(tm.shape, dtype=torch.bool, device=dev)
                call(torch, lib.micro_any, v, o.data_ptr(), d.data_ptr(),
                     tm.data_ptr(), H, W, s, nodes.data_ptr(),
                     wide_rec.data_ptr(), recs.data_ptr(), cols.data_ptr(),
                     cols.shape[1], out.data_ptr())
                return out
            return run

        if s == 1:
            chip_smoke.require(torch.equal(walk.any_hit_bvh(o, d, tm, lgeo),
                                           bvh_any(o, d, tm, lgeo, lgeo.bvh)),
                               "kernel 19: not the plain traversal's bool")
        runs = {"package": lambda: walk.any_hit_bvh(o, d, tm, lgeo)}
        runs.update({n: variant(v) for v, n in ANY_VARIANTS.items()})
        measure(f"bvh_any_hit[torus field, {label}]", runs, torch.equal,
                ("bvh_any_kernel", "any_variant"))
    # Kernel 20 beside the package's kernel 19 walk in kernel 20's layout.
    from romis_tpu_torch.ops import nbrsel
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.rmis import mis_offsets

    k, n_nbr = feats.num_samples_in_reservoir, feats.num_neighbours_to_sample
    lny, lnx = select_neighbour_indices(gen, lctx, H, W, feats,
                                        select=nbrsel.neighbour_select)
    loffs = mis_offsets(lny, lnx)
    lpos = ris.gen_mis_reservoir_planes(lctx, large.lights, large.num_lights,
                                        feats, 1, True, generator=gen)[:3 * k]
    ext = torch.cat([lpos[None], spatial.halo_offset_gather(
        lpos, loffs[:n_nbr], loffs[n_nbr:])]).reshape(n_nbr + 1, k, 3, H, W)
    for label, (o, d, tm) in (("S=2 shadow rays", lshadow),
                              ("S=12 ext_vis rays", vis_rays(ext))):
        s = (n_nbr + 1) * k if tm.dim() == 4 else tm.shape[0]

        def wide_k():
            out = torch.empty(tm.shape, dtype=torch.bool, device=dev)
            call(torch, lib.micro_any_k, o.data_ptr(), d.data_ptr(),
                 tm.data_ptr(), H * W, s, nodes.data_ptr(),
                 wide_rec.data_ptr(), recs.data_ptr(), out.data_ptr())
            return out

        measure(f"bvh_any_hit_k[torus field, {label}]", {
            "package": lambda: walk.any_hit_bvh_k(o, d, tm, lgeo),
            "the kernel 19 walk in kernel 20's layout": wide_k,
        }, torch.equal, ("bvh_any_k", "any_k_wide"))
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
