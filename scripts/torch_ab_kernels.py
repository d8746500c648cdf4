#!/usr/bin/env python3
"""Kernels 10 and 20 of this tree beside those of another tree (the parent
commit), in one call on one NVIDIA GPU, at the shapes of ``chip_smoke.py``.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_ab_kernels.py --parent build/parent

Both trees' kernel libraries are built (the parent's with its own
``ops/_build.py``, into its own ``build/``), and the two kernels are called
through their C entry points on the same tensors, in turns (parent, this
tree, this tree, parent):
- kernel 10, the halo offset scatter, at D = 5, C = 2, 1920x1080: random
  offsets within ±10 (the per-pixel gradient path's), the smooth field of
  a camera shift, a field beyond the kernel's margin (±40) and offsets
  clamped at all four borders; beside ``index_add_`` on the same inputs;
- kernel 20, the K-ray BVH any-hit, on the 5x5 torus field (24,202
  triangles) at 1080p: the S = 2 shadow rays of the K lanes and the S = 12
  ext_vis rays of one R-OMIS iteration; beside kernel 19 (a walk per ray)
  on the same rays, and on the 12 planes also beside kernel 20's walk
  launched plane by plane (S = 1: kernel 19's ray layout);
- the ``large_romis`` and ``large_vischeck`` frames with kernel 20 from
  either tree (``walk.any_hit_bvh_k`` swapped), in turns.
The two trees' kernel 20 give the same bool on every ray, and their
kernel 10 agree within ``chip_smoke.HALO_SCATTER_REL`` of the summed
|cotangents|. The last line is one JSON object of the times (ms).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (constants and timing helpers)

H, W = chip_smoke.H, chip_smoke.W


def load_build(tree: Path):
    """The ``ops/_build.py`` module of another tree, under its own name."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", tree / "romis_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(log: Path, names) -> list[str]:
    """registers and spill stores of the kernels whose mangled name holds
    one of ``names``, from a build's ``-Xptxas -v`` log."""
    out, entry, spill = [], "", 0
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and any(
                n in entry for n in names):
            out.append(f"{entry} {line.split('Used')[1].split()[0]} "
                       f"registers, {spill} B spill stores")
    return out


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other tree (e.g. build/parent)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from romis_tpu_torch import Features, RayTraceMode
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import _build, nbrsel, ris, spatial, walk
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.ops.traverse import bvh_any
    from romis_tpu_torch.ops.wrs import visibility
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.pipeline import render_frame
    from romis_tpu_torch.render.rmis import mis_offsets
    from romis_tpu_torch.scene.scene import torus_field, torus_field_camera

    card = chip_smoke.card_line()
    print(card)
    parent = load_build(args.parent.resolve())
    with ThreadPoolExecutor(2) as pool:  # both builds at once
        jobs = [pool.submit(_build.build), pool.submit(parent.build)]
        for j in jobs:
            j.result()
    plib = parent.library()
    for label, log in (("this tree", _build.BUILD_DIR / "build.log"),
                       ("parent", parent.BUILD_DIR / "build.log")):
        for line in ptxas_lines(log, ("halo_scatter", "bvh_any_k")):
            print(f"ptxas {label}: {line}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)

    def call(fn, *a):
        err = fn(*a, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            chip_smoke.fail(f"{fn.__name__}: CUDA error {err}")

    ms, rate = {}, chip_smoke.ab_ms
    # ---- kernel 10 ----
    n_nbr, k, radius = 5, 2, 10
    ct = torch.randn((n_nbr, k, H, W), generator=gen, device=dev)
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]

    def uniform(r):
        return torch.randint(-r, r + 1, (2, n_nbr, H, W), generator=gen,
                             device=dev, dtype=torch.int32)

    shift = torch.stack([torch.full((n_nbr, H, W), 37, dtype=torch.int32,
                                    device=dev),
                         (-53 + 3 * torch.sin(cols / 50.0 + rows / 70.0)
                          ).int().expand(n_nbr, H, W)])
    cases = {
        "random +-10": spatial.clamped_offsets(uniform(radius), H, W),
        "camera shift (37, -53)": tuple(shift.contiguous()),
        "random +-40": spatial.clamped_offsets(uniform(40), H, W),
        "border +-5000": tuple(uniform(5000)),
    }
    for label, (dy, dx) in cases.items():
        dy, dx = dy.int().contiguous(), dx.int().contiguous()
        far = spatial.beyond_margin(dy, dx).float().mean().item()

        def mine():
            return spatial.halo_offset_scatter(ct, dy, dx)

        def theirs():
            out = torch.zeros((k, H, W), device=dev)
            call(plib.romis_halo_scatter, ct.data_ptr(), k, H, W,
                 dy.data_ptr(), dx.data_ptr(), n_nbr * H * W, out.data_ptr())
            return out

        q = (torch.clamp(rows + dy.long(), 0, H - 1) * W
             + torch.clamp(cols + dx.long(), 0, W - 1)).reshape(-1)
        src = ct.movedim(1, 0).reshape(k, -1).contiguous()

        def library():
            return torch.zeros((k, H * W), device=dev).index_add_(1, q, src)

        mag = spatial.halo_offset_scatter_plain(ct.abs(), dy, dx
                                                ).clamp_min(1e-30)
        plain = spatial.halo_offset_scatter_plain(ct, dy, dx)
        rel = max(((f() - plain).abs() / mag).max().item()
                  for f in (mine, theirs))
        chip_smoke.require(rel <= chip_smoke.HALO_SCATTER_REL,
                           f"halo scatter {label}: {rel}")
        new, old = rate(torch, mine, theirs, 20, 20)
        lib_ms = chip_smoke.cuda_ms(torch, library, 20)
        print(f"time halo_scatter[{label}]: {new:.4f} ms this tree, "
              f"{old:.4f} ms parent, index_add_ {lib_ms:.4f} ms; beyond "
              f"the margin {far:.4f} of the sources; max err / sum|ct| "
              f"{rel:.2e} [{card}]")
        ms[f"halo_scatter[{label}]"] = dict(change=new, parent=old,
                                            index_add=lib_ms, far=far)
    del ct

    # ---- kernel 20 ----
    feats = Features()
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    lgeo = large.geometry
    lrays = generate_rays(torus_field_camera(H, W, dev), H, W)
    _, lctx = restir.trace_primary(lrays, lgeo, feats, restir.KERNELS)
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

    lny, lnx = select_neighbour_indices(gen, lctx, H, W, feats,
                                        select=nbrsel.neighbour_select)
    loffs = mis_offsets(lny, lnx)
    lpos = ris.gen_mis_reservoir_planes(lctx, large.lights, large.num_lights,
                                        feats, 1, True, generator=gen)[:3 * k]
    ext = torch.cat([lpos[None], spatial.halo_offset_gather(
        lpos, loffs[:n_nbr], loffs[n_nbr:])]).reshape(n_nbr + 1, k, 3, H, W)

    def parent_k(origins, dirs, t_max, g_=lgeo):
        """The parent's kernel 20 (its [10, T] columns), called as the
        wrapper calls it."""
        o, d, tm, shape, n_pix = walk._any_args(origins, dirs, t_max,
                                                "parent")
        out = torch.empty(shape, dtype=torch.bool, device=dev)
        call(plib.romis_bvh_any_k, o.data_ptr(), d.data_ptr(), tm.data_ptr(),
             n_pix, out.numel() // n_pix, g_.bvh.nodes.data_ptr(),
             g_.tri_cols.data_ptr(), g_.tri_cols.shape[1], out.data_ptr())
        return out

    for label, rays_ in (("S=2 shadow rays", vis_rays(lres.pos)),
                         ("S=12 ext_vis rays", vis_rays(ext))):
        mine = walk.any_hit_bvh_k(*rays_, lgeo)
        same = torch.equal(mine, parent_k(*rays_))
        if label.startswith("S=2"):  # the plain walk at 1080p: ~2 s
            same = same and torch.equal(mine, bvh_any(*rays_, lgeo, lgeo.bvh))
        chip_smoke.require(same, f"kernel 20 {label}: bools differ")
        new, old = rate(torch, lambda: walk.any_hit_bvh_k(*rays_, lgeo),
                        lambda: parent_k(*rays_), 10, 10)
        k19 = chip_smoke.cuda_ms(torch, lambda: walk.any_hit_bvh(*rays_, lgeo),
                                 10)
        row = dict(change=new, parent=old, kernel19=k19)
        line = (f"time bvh_any_hit_k[{label}]: {new:.4f} ms this tree, "
                f"{old:.4f} ms parent, kernel 19 on the same rays "
                f"{k19:.4f} ms")
        if rays_[2].shape[0] > 2:  # kernel 19's plane-major layout with
            # kernel 20's walk and records: one S = 1 launch a plane
            o12, d12 = (a.reshape(-1, 3, H, W) for a in rays_[:2])
            t12 = rays_[2].reshape(-1, H, W)
            planes = [(o12[i:i + 1], d12[i:i + 1], t12[i:i + 1])
                      for i in range(t12.shape[0])]
            by_plane = chip_smoke.cuda_ms(torch, lambda: [
                walk.any_hit_bvh_k(*pl, lgeo) for pl in planes], 10)
            row.update(by_plane=by_plane)
            line += (f"; kernel 20 plane by plane (S = 1 launches, kernel "
                     f"19's layout) {by_plane:.4f} ms")
        print(line + f"; the same bool on every ray [{card}]")
        ms[f"bvh_any_hit_k[{label}]"] = row
        del rays_

    # ---- the frames kernel 20 carries ----
    mine_k = walk.any_hit_bvh_k
    paths = {
        "large_romis": Features(ray_trace_mode=RayTraceMode.ROMIS),
        "large_vischeck": Features(unbiased_combination=True,
                                   spatial_reuse_visibility_check=True),
    }
    lcam = torus_field_camera(H, W, dev)
    for path, f in paths.items():
        g = torch.Generator(device=dev).manual_seed(5)
        st = [restir.initial_temporal_state(H, W, f.num_samples_in_reservoir,
                                            lcam)]

        def frame(kernel):
            def run():
                walk.any_hit_bvh_k = kernel
                try:
                    _, st[0] = render_frame(g, lcam, large, H, W, f, st[0])
                finally:
                    walk.any_hit_bvh_k = mine_k
            return run

        new, old = rate(torch, frame(mine_k), frame(parent_k), 5, 5)
        print(f"time frame[{path}]: {new:.3f} ms/frame with this tree's "
              f"kernel 20, {old:.3f} with the parent's [{card}]")
        ms[f"frame[{path}]"] = dict(change=new, parent=old)
    print(json.dumps({"card": card, "ms": ms}))


if __name__ == "__main__":
    main()
