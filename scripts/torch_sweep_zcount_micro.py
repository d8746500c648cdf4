#!/usr/bin/env python3
"""Microbenchmark: variants of kernels 17 (the R-MIS / R-OMIS sweep,
``romis_tpu_torch/csrc/mis.cu``) and 7 (the Z-count any-hit,
``csrc/zcount.cu``) at the shapes of ``chip_smoke.py``, in one call on one
NVIDIA GPU. It shows what sets each kernel's pace (``PERF.md``).
Needs one GPU and ``nvcc``; builds its own copies of the two sources,
``scripts/torch_sweep_zcount_micro_mis.cu`` and ``..._zcount.cu`` (the
package's kernels with the switches below, which the package leaves out),
into ``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_sweep_zcount_micro.py

Kernel 17 on the flagship at 1920x1080 (D = 5, K = 2, iteration-0 packs,
a SIMILAR selection): R-OMIS, progressive R-OMIS and balance with the
neighbourhood's members staged 1, 2, 3 or all 6 at a time (mode bits 4-7:
a chunk's samples and its colvec or p̂ in shared memory), R-OMIS also
built with ``__launch_bounds__`` asking for 1, 4 or 5 blocks an SM in both
R-OMIS modes (``-DROMIS_MIS_MIN_BLOCKS``; the package asks for 4 in the
progressive mode only), and equal weights; every variant's outputs
bit-equal to the package's kernel, which is also timed.

Kernel 7 on the Z rays of a vis_check pass at 1080p on the one-torus soup
and on the flagship, and on the 2048-triangle soup's rays at 480x270: each
way of testing a block's triangles (variant bits 0-1: 0 each lane its own
rays, 2 the rays dealt out to the warp, a lane a triangle, 3 either,
chosen a block at a time by the rays against the triangles), with rows of
32 pixels or 8x4 tiles (bit 2), with the near-parallel guard eager (a
block a ray's box rejects), lazy (bit 5: only for the rays the walk
leaves unoccluded) or as each block's flag says (bit 6: lazy for the
blocks whose pairs mostly lack a cone; the package runs 71 and, on a soup
of one block, 0), and for variants 6 and 7 also with the guard computed
but not applied (bit 4) or off (bit 3: not the plain bool; its bools are
only counted). Every other variant gives the package's bool on every
ray.
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


def build(name="micro", sources=("mis", "zcount"), defines=()):
    """Start compiling this script's variant sources (with ``defines``);
    ``load`` waits for them."""
    from romis_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs, jobs = [], []
    for src in sources:
        obj = OUT / f"{name}_{src}.o"
        cmd = [nvcc, *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC),
               "-c", "-o", str(obj),
               str(Path(__file__).with_name(f"{Path(__file__).stem}_{src}.cu"))]
        jobs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    return jobs, objs, name


def load(jobs, objs, name):
    """Wait for ``build``'s compilers, link and load."""
    from romis_tpu_torch.ops import _build

    for j in jobs:
        log = j.communicate()[0]
        if j.returncode != 0:
            chip_smoke.fail(f"nvcc failed:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and "registers" in line:
                print(f"ptxas {name}: {entry} {line.split('Used')[1].strip()}")
    lib_path = OUT / f"lib{name}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib_path), *objs],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    sig = _build.SIGNATURES
    zc = list(sig["romis_zcount_occ"])
    for fn_name, args in (
            ("micro_mis_iteration", sig["romis_mis_iteration"]),
            # the package's arguments and `variant` before out
            ("micro_zcount_occ", zc[:-2] + [ctypes.c_int] + zc[-2:])):
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    return lib


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.ops import mis, nbrsel, ris, shade, spatial, trace
    from romis_tpu_torch.ops.wrs import SHADOW_RAY_EPSILON as EPS
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.rmis import mis_offsets
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
    )

    card = chip_smoke.card_line()
    print(card)
    pending = [build()] + [build(f"mis_min{b}", ("mis",), (
        f"-DROMIS_MIS_MIN_BLOCKS(prog)={b}",)) for b in (1, 4, 5)]
    lib, *min_libs = [load(*p) for p in pending]
    libs = {"": lib, **{f", at least {b} blocks an SM": m
                       for b, m in zip((1, 4, 5), min_libs)}}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    feats = Features()
    k, n_nbr = feats.num_samples_in_reservoir, feats.num_neighbours_to_sample
    radius = feats.spatial_resample_radius
    ms = {}

    # ---- kernel 17 ----
    scene = flagship_scene(dev)
    _, ctx = restir.trace_primary(generate_rays(flagship_camera(H, W, dev),
                                                H, W), scene.geometry, feats,
                                  restir.KERNELS)
    ny, nx = select_neighbour_indices(gen, ctx, H, W, feats,
                                      select=nbrsel.neighbour_select)
    offs = mis_offsets(ny, nx).contiguous()
    cen = shade.pack_center_ctx(ctx)
    nbr = mis.resolve_neighbour_ctx(cen, offs)
    packs = {rp: ris.gen_mis_reservoir_planes(
        ctx, scene.lights, scene.num_lights, feats, 1, rp, generator=gen)
        for rp in (False, True)}
    d1 = n_nbr + 1
    al = torch.rand((3 * d1, H, W), generator=gen, device=dev) - 0.5
    cols = scene.geometry.tri_cols

    def sweep(mode, flag, alphas=None, lib=lib):
        romis = mode == "romis"
        outs = ([torch.empty((d1 * (d1 + 1) // 2, H, W), device=dev),
                 torch.empty((3 * d1, H, W), device=dev)] if romis else
                [torch.empty((3, H, W), device=dev)])
        if alphas is not None:
            outs.append(torch.empty((3, H, W), device=dev))
        ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))

        def run():
            err = lib.micro_mis_iteration(
                cen.data_ptr(), packs[romis].data_ptr(), offs.data_ptr(),
                None if mode == "rmis_equal" else nbr.data_ptr(),
                None if alphas is None else alphas.data_ptr(), None,
                cols.data_ptr(), cols.shape[1], H, W, d1, k,
                feats.initial_light_samples, scene.num_lights,
                mis.MODES.index(mode) | flag, 0, *ptrs, stream())
            if err:
                chip_smoke.fail(f"mis {mode} {flag}: CUDA error {err}")
            return outs
        return run

    for label, mode, alphas in (("romis", "romis", None),
                                ("romis_prog", "romis", al),
                                ("rmis_balance", "rmis_balance", None),
                                ("rmis_equal", "rmis_equal", None)):
        ref = mis.mis_iteration(cen, packs[mode == "romis"], offs,
                                scene.geometry, k, mode, scene.num_lights,
                                feats, nbr_ctx=None if mode == "rmis_equal"
                                else nbr, alphas=alphas)
        ref = ref if isinstance(ref, tuple) else (ref,)
        row = {"package": chip_smoke.cuda_ms(torch, lambda: mis.mis_iteration(
            cen, packs[mode == "romis"], offs, scene.geometry, k, mode,
            scene.num_lights, feats, nbr_ctx=None if mode == "rmis_equal"
            else nbr, alphas=alphas), 20)}
        for g in ((1, 2, 3, 6) if mode != "rmis_equal" else (0,)):
            for lib_name, lib_ in libs.items():
                if lib_name and (mode != "romis" or g not in (2, 3)):
                    continue
                name = (f"{g} members a chunk" if g else "copy") + lib_name
                fn = sweep(mode, 16 * g, alphas, lib_)
                got = [o.clone() for o in fn()]
                chip_smoke.require(all(torch.equal(a, b) for a, b in
                                       zip(got, ref)), f"{label} {name}")
                row[name] = chip_smoke.cuda_ms(torch, fn, 20)
        print(f"time mis_iteration[{label}]: {json.dumps(row)} [{card}]")
        ms[f"mis_iteration[{label}]"] = row
    del packs, nbr, al

    # ---- kernel 7 ----
    vfeats = Features(unbiased_combination=True,
                      spatial_reuse_visibility_check=True)

    def z_rays(sc, cam, h, w):
        _, c = restir.trace_primary(generate_rays(cam, h, w), sc.geometry,
                                    feats, restir.KERNELS)
        rp = pack_reservoir_planes(ris.gen_canonical_samples_ris(
            c, sc.lights, sc.num_lights, feats, generator=gen))
        cn = shade.pack_center_ctx(c)
        pl, blk = spatial.spatial_pass_unbiased_vis(
            rp, cn, k, n_nbr, radius, vfeats, generator=gen,
            key=spatial.philox_key(gen))
        nbr_pos = blk[2 * k:2 * k + 3 * n_nbr].reshape(n_nbr, 3, h, w)
        mf = blk[2 * k + 3 * n_nbr:].reshape(n_nbr, k, h, w)
        return (torch.cat([cn[None, 0:3], nbr_pos]).contiguous(),
                pl[:3 * k].reshape(k, 3, h, w).contiguous(),
                torch.cat([(blk[k:2 * k] > 0.0)[None], mf > 0.0])
                .contiguous())

    torus1 = torus_field(1, dev)
    tcam = make_camera(resolution=(H, W), device=dev, **chip_smoke.TORUS_CAM)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    hs, ws = H // 4, W // 4
    _, sctx = restir.trace_primary(generate_rays(flagship_camera(hs, ws, dev),
                                                 hs, ws), soup, feats,
                                   restir.PLAIN)
    zo = torch.cat([sctx.position[None], sctx.position[None] + 0.5
                    * torch.randn((n_nbr, 3, hs, ws), generator=gen,
                                  device=dev)]).contiguous()
    zt = ris.gen_mis_reservoir_planes_plain(
        sctx, scene.lights, scene.num_lights, feats, 1, False,
        generator=gen)[:3 * k].reshape(k, 3, hs, ws).contiguous()
    cases = {"torus soup 1080p": (*z_rays(torus1, tcam, H, W),
                                  torus1.geometry),
             "flagship 1080p": (*z_rays(scene, flagship_camera(H, W, dev),
                                        H, W), scene.geometry),
             "soup2048 480x270": (zo, zt, None, soup)}
    for label, (o, t, m, geo) in cases.items():
        zc, boxes, nrm = trace.zcount_blocks(geo)
        h, w = o.shape[-2:]
        out = torch.empty((o.shape[0], k, h, w), dtype=torch.bool,
                          device=dev)

        def z(v):
            def run():
                err = lib.micro_zcount_occ(
                    o.data_ptr(), t.data_ptr(),
                    None if m is None else m.data_ptr(), h, w, o.shape[0], k,
                    zc.data_ptr(), boxes.data_ptr(), nrm.data_ptr(),
                    zc.shape[1], float(EPS), v, out.data_ptr(), stream())
                if err:
                    chip_smoke.fail(f"zcount {label} {v}: CUDA error {err}")
                return out
            return run

        ref = trace.zcount_occ(o, t, geo, EPS, m)
        row = {"package": chip_smoke.cuda_ms(torch, lambda: trace.zcount_occ(
            o, t, geo, EPS, m), 10)}
        for v in (0, 2, 3, 6, 7, 35, 38, 39, 64, 71):
            for g, gname in ((0, "guard"), (16, "guard not applied"),
                             (8, "no guard")):
                if g and v not in (6, 7):
                    continue
                got = z(v | g)().clone()
                if g == 0:
                    chip_smoke.require(torch.equal(got, ref),
                                       f"zcount {label} variant {v}")
                row[f"variant {v}, {gname}"] = chip_smoke.cuda_ms(
                    torch, z(v | g), 10)
                if g == 8:
                    row[f"variant {v}, no guard, rays apart"] = int(
                        (got != ref).sum().item())
        print(f"time zcount_occ[{label}]: {json.dumps(row)} [{card}]")
        ms[f"zcount_occ[{label}]"] = row
    print(json.dumps({"card": card, "ms": ms}))


if __name__ == "__main__":
    main()
