#!/usr/bin/env python3
"""Microbenchmark: variants of kernels 4 (the final shade on a triangle
soup, ``romis_tpu_torch/csrc/shade.cu``) and 5 (the biased spatial pass,
``csrc/spatial.cu``) at the shapes of ``chip_smoke.py``, in one call on one
NVIDIA GPU. It shows what sets each kernel's pace (``PERF.md``). Needs one
GPU and ``nvcc``; builds its own variants,
``scripts/torch_shade_pass_micro_shade.cu`` and ``..._spatial.cu``, into
``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_shade_pass_micro.py

Kernel 4 at K = 2 on the 1080p receivers of the flagship (2 triangles:
the package alone, its direct loop), of the one-torus soup (970
triangles, ``chip_smoke.TORUS_CAM``) and of the 2048-triangle soup: the
package's kernel, the same in blocks of 1024 threads (variant 1), a
block's triangles dealt out to the warp where few lanes need it (2), the
box alone without the near-parallel guard (3, its colour may differ where
the guard decides: the differing pixels are counted), 1 and 2 together
(4, the package's design), 4 with a warp's pixels a 4x4 tile (5), 4
dealing up to 24 and up to 8 lanes (6, 7; the package: 16), 5 without
the guard (8, counted as 3), and the guard replaced by a near-parallel
pass over the soup's triangles clustered by normal (9, the clusters built
here by ``parallel_sets``). Every other variant's colour is the
package's, bit for bit.

Kernel 5 at K = 2 on the flagship's 1080p receivers (R = 5, r = 10, its
Philox stream): the package's pre-pass and pass, each kernel's device time
apart, and the pass in 32 x 8 blocks (variant 1), with one neighbour of
lookahead (2), for 4 blocks an SM (3), and reading every neighbour's
reservoir record (5). Every variant's output is the package's, bit for
bit.

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
_P, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
    ctypes.c_longlong
ENTRIES = {"micro_shade_soup": (_I,) + (_P,) * 10 + (_LL, _I, _I, _I, _P, _P,
                                                     _P, _I, _I, _P, _P),
           "micro_shade_par": (_P,) * 10 + (_LL,) + (_P,) * 6 + (_I, _I, _I,
                                                              _P, _P),
           "micro_spatial": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _U, _P,
                             _P, _I, _P, _P, _P, _P)}


def build(src):
    """Start compiling this script's variant source ``src``; ``load``
    waits for it."""
    from romis_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    obj = OUT / f"{STEM}_{src}.o"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c",
           "-o", str(obj), str(Path(__file__).with_name(f"{STEM}_{src}.cu"))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), obj, src


def load(job, obj, name):
    """Wait for ``build``'s compiler, print its variants' registers, link
    and load."""
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
    lib_path = OUT / f"lib{STEM}_{name}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib_path),
                    str(obj)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, args in ENTRIES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    return lib


def parallel_sets(torch, cols, boxes, guard):
    """Variant 9's near-parallel sets of the block-ordered soup
    (``ops.trace.zcount_blocks``): its live triangles in the Morton order of
    their unit normals (one sign a plane) in clusters of 16 → (idx [16 nc]
    int32: each slot's triangle, -1 for none; m [3, 16 nc]: its guard
    normal, inf for none; cones [nc, 4]: each cluster's cone, as
    zcount_blocks' pair cones; soup [8]: the centre c, the reach S with L =
    |o - c|₁ + S + dist bounding every block's, the least growth / 8u G)."""
    from romis_tpu_torch.ops.trace import ZCOUNT_BLOCK, _spread_bits

    t = cols.shape[1]
    dev = cols.device
    act = cols[9] > 0.0
    e1, e2 = cols[3:6], cols[6:9]
    cross = torch.linalg.cross(e1, e2, dim=0)
    area = torch.linalg.vector_norm(cross, dim=0)
    den = torch.linalg.vector_norm(e1, dim=0) * torch.linalg.vector_norm(
        e2, dim=0)
    live = act & (den > 0.0)  # zcount_blocks' guard: finite m
    ok = live & (area > 0.0)  # a unit normal
    unit = cross / torch.where(ok, area, 1.0)
    # One sign a plane: the first non-zero of z, y, x positive.
    lead = torch.where(unit[2] != 0.0, unit[2],
                       torch.where(unit[1] != 0.0, unit[1], unit[0]))
    unit = unit * torch.where(lead < 0.0, -1.0, 1.0)
    q = ((unit + 1.0) * 511.5).clamp(0.0, 1023.0).to(torch.int64)
    key = ((_spread_bits(q[0]) << 2) | (_spread_bits(q[1]) << 1)
           | _spread_bits(q[2]))
    key = torch.where(ok, key, torch.where(live, -1, 1 << 31))
    order = torch.argsort(key, stable=True)
    n_live = int(live.sum())
    nc = -(-max(n_live, 1) // ZCOUNT_BLOCK)
    idx = torch.full((nc * ZCOUNT_BLOCK,), -1, dtype=torch.int64, device=dev)
    idx[:n_live] = order[:n_live]
    slot_ok = idx >= 0
    j = idx.clamp_min(0)
    m = torch.where(slot_ok, guard[:3, j], torch.inf)
    u = torch.where(slot_ok & ok[j], unit[:, j], 0.0).reshape(3, nc, -1)
    # Each cluster's cone: its sign-aligned unit normals' axis A, chord
    # radius R and iota, the largest 1/|m| → (A / iota, (R + 1e-5) / iota);
    # a cluster holding a live triangle of no area (m = 0: always near
    # parallel) never rejects (R = inf), an empty one always does.
    first = u[:, :, 0:1]
    u = u * torch.where((u * first).sum(0, keepdim=True) < 0.0, -1.0, 1.0)
    axis = u.sum(-1)
    axis = axis / torch.linalg.vector_norm(axis, dim=0).clamp_min(1e-30)
    has = (u != 0.0).any(0)  # [nc, 16] the members with a unit normal
    rho = torch.where(has, torch.linalg.vector_norm(u - axis[:, :, None],
                                                    dim=0), 0.0).amax(-1)
    m_len = torch.linalg.vector_norm(m, dim=0).reshape(nc, -1)
    iota = torch.where(has, 1.0 / m_len, 0.0).amax(-1)
    any_has = has.any(-1)
    safe = torch.where(any_has, iota, 1.0)
    cones = torch.cat([torch.where(any_has, axis / safe, 0.0),
                       torch.where(any_has, (rho + 1e-5) / safe,
                                   -torch.inf)[None]]).T.contiguous()
    no_area = (slot_ok & live[j] & ~ok[j]).reshape(nc, -1).any(-1)
    cones[no_area, 3] = torch.inf
    # The soup's reach: L = |o - c|_1 + S + dist bounds every block's
    # (zcount_blocks' rows 6-9); below G, every block's growth / 8u, the
    # slab test is trusted.
    full = act.reshape(-1, ZCOUNT_BLOCK).any(-1)
    cb = boxes[6:9]
    lo = torch.where(full, cb, torch.inf).amin(1)
    hi = torch.where(full, cb, -torch.inf).amax(1)
    c = torch.where(torch.isfinite(lo), (lo + hi) * 0.5, 0.0)
    reach = torch.where(full, (cb - c[:, None]).abs().sum(0) + boxes[9],
                        0.0).amax()
    g = torch.where(full, boxes[10], torch.inf).amin()
    soup = torch.cat([c, reach[None], g[None], c.new_zeros(3)])
    return (idx.to(torch.int32).contiguous(), m.contiguous(), cones,
            soup.contiguous())


def row_line(row):
    return "; ".join(
        f"{n} {r['ms']:.4f} ms (device "
        + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                    for k, v in r["device_ms"].items()) + ")"
        + (f", {r['differ']} pixels differ" if "differ" in r else "")
        for n, r in row.items())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.ops import _build, ris, shade, spatial, trace
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
    )

    card = chip_smoke.card_line()
    print(card)
    jobs = [build("shade"), build("spatial")]
    _build.build()
    libs = {name: load(*job) for job, name in zip(jobs, ("shade", "spatial"))}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31)
    times = {}
    f = Features()  # K = 2
    k = f.num_samples_in_reservoir

    # ---- kernel 4 ----
    scene = flagship_scene(dev)
    torus1 = torus_field(1, dev)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    for label, sc, geo, cam in (
            ("flagship", scene, scene.geometry, flagship_camera(H, W, dev)),
            ("torus soup", torus1, torus1.geometry, make_camera(
                resolution=(H, W), device=dev, **chip_smoke.TORUS_CAM)),
            ("soup2048", scene, soup, flagship_camera(H, W, dev))):
        _, ctx = restir.trace_primary(generate_rays(cam, H, W), geo, f,
                                      restir.KERNELS)
        res = ris.gen_canonical_samples_ris(ctx, sc.lights, sc.num_lights, f,
                                            generator=gen)
        planes, _ = shade._fields(ctx, res)
        cols, boxes, guard = trace.zcount_blocks(geo)
        ref = shade.final_shade_soup(ctx, res, geo, f)

        idx, m, cones, soup_data = parallel_sets(torch, cols, boxes, guard)

        def near_parallel():
            out = torch.empty_like(ref)
            call(torch, libs["shade"].micro_shade_par,
                 *(a.data_ptr() for a in planes), H * W, cols.data_ptr(),
                 boxes.data_ptr(), idx.data_ptr(), m.data_ptr(),
                 cones.data_ptr(), soup_data.data_ptr(), cols.shape[1],
                 cones.shape[0], 0, out.data_ptr())
            return out

        def variant(v):
            def run():
                out = torch.empty_like(ref)
                call(torch, libs["shade"].micro_shade_soup, v,
                     *(a.data_ptr() for a in planes), H * W, k, H, W,
                     cols.data_ptr(), boxes.data_ptr(), guard.data_ptr(),
                     cols.shape[1], 0, out.data_ptr())
                return out
            return run

        row = {}
        runs = {
                "package": lambda: shade.final_shade_soup(ctx, res, geo, f),
                "v1 1024 threads a block": variant(1),
                "v2 dealt out": variant(2),
                "v3 the box alone (no guard)": variant(3),
                "v4 dealt out, 1024 threads": variant(4),
                "v5 v4 on 4x4 tiles": variant(5),
                "v6 v4 dealing up to 24 lanes": variant(6),
                "v7 v4 dealing up to 8 lanes": variant(7),
                "v8 v5 without the guard": variant(8),
                "v9 the near-parallel pass": near_parallel}
        if cols.shape[1] == trace.ZCOUNT_BLOCK:  # one block: no cull
            runs = {"package": runs["package"]}
        for name, fn in runs.items():
            out = fn()
            r = dict(ms=chip_smoke.cuda_ms(torch, fn, 5),
                     device_ms={"kernel": device_ms(torch, fn, 3, (
                         "final_shade_kernel", "shade_v", "shade_par"))})
            if name.startswith(("v3", "v8")):
                r["differ"] = int((out != ref).any(dim=0).sum().item())
            else:
                chip_smoke.require(torch.equal(out, ref), f"kernel 4 {label} "
                                   f"{name}: not the package's bits")
            row[name] = r
        print(f"micro final_shade[{label}, K=2, {cols.shape[1]} triangle "
              f"slots]: {row_line(row)} [{card}]")
        times[f"final_shade[{label}]"] = row
        del ctx, res, planes, ref

    # ---- kernel 5 ----
    n_nbr, radius = f.num_neighbours_to_sample, f.spatial_resample_radius
    _, ctx = restir.trace_primary(generate_rays(flagship_camera(H, W, dev),
                                                H, W), scene.geometry, f,
                                  restir.KERNELS)
    rp = pack_reservoir_planes(ris.gen_canonical_samples_ris(
        ctx, scene.lights, scene.num_lights, f, generator=gen))
    cen = shade.pack_center_ctx(ctx)
    gates = spatial.pack_gates(ctx)
    key = spatial.philox_key(gen)
    ref = spatial.spatial_pass_fused(rp, gates, cen, k, n_nbr, radius, f,
                                     key=key)
    rres, rgate = spatial.record_buffers(H * W, k, dev,
                                          spatial.GATE_RECORD)

    def pass_variant(v):
        def run():
            out = torch.empty_like(ref)
            call(torch, libs["spatial"].micro_spatial, v, rp.data_ptr(),
                 gates.data_ptr(), cen.data_ptr(), H, W, k, n_nbr, radius,
                 key.data_ptr(), (spatial._TAG_BIASED << 16), None, None, 0,
                 out.data_ptr(), rres.data_ptr(), rgate.data_ptr())
            return out
        return run

    row = {}
    for name, fn in {
            "package": lambda: spatial.spatial_pass_fused(
                rp, gates, cen, k, n_nbr, radius, f, key=key),
            "v1 32x8 blocks": pass_variant(1),
            "v2 one neighbour of lookahead": pass_variant(2),
            "v3 4 blocks an SM": pass_variant(3),
            "v5 every neighbour's record": pass_variant(5)}.items():
        chip_smoke.require(torch.equal(fn(), ref),
                           f"kernel 5 {name}: not the package's bits")
        row[name] = dict(ms=chip_smoke.cuda_ms(torch, fn, 10), device_ms={
            "pre-pass": device_ms(torch, fn, 5, ("records_kernel",)),
            "pass": device_ms(torch, fn, 5, ("spatial_pass_kernel",
                                             "pass_v"))})
    print(f"micro spatial_pass[K=2, philox, R={n_nbr}, r={radius}]: "
          f"{row_line(row)} [{card}]")
    times["spatial_pass[K=2, philox]"] = row
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
