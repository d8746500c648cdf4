#!/usr/bin/env python3
"""Kernels of this tree beside those of another tree (the parent commit), in
one call on one NVIDIA GPU, at the shapes of ``chip_smoke.py``.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_ab_kernels.py --parent build/parent [--kernels 13,21]

Both trees' kernel libraries are built (the parent's with its own
``ops/_build.py``, into its own ``build/``), the registers and spill stores
of the compared kernels are printed from both builds' ``-Xptxas -v`` logs,
and the kernels are called on the same tensors, in turns (parent, this
tree, this tree, parent). ``--kernels`` picks the sections (default 13,21):
- 13, the row scatter-add, on every table of the three gradient steps
  (``chip_smoke.scatter_tables``: the flagship's and the 5x5 torus
  field's light, material, triangle and attribute-width tables at 1080p)
  and the 2048-triangle soup's, each beside ``index_add_`` and its bound,
  both trees' outputs within the plain and float64 tolerances; then the
  gradient steps ``grad_surrogate``, ``grad_per_pixel`` and ``large_grad``
  with either tree's kernel 13;
- 21, the BVH final shade, on the torus field at 1080p at K = 1, 2 and 4,
  shaded and unshaded, bit-equal to the parent's, kernel 20 at S = 2 on
  the same rays beside it; kernels 4 (flagship, 2048-triangle soup) and 19
  bit-equal to the parent's and timed beside them; then the frames
  ``large_config5``, ``large_animated``, ``large_vischeck`` and the step
  ``large_grad`` with either tree's kernel 21;
- 16, neighbour selection, on the flagship's gates: SIMILAR, DISSIMILAR
  and two classes, on Philox and on injected scores, D = 5 and 8 at
  r = 10 (1920x1080) and D = 5 at r = 40 (past the staged window, at
  270x480); outputs bit-equal to the parent's. Then the frames ``romis``,
  ``rmis_equal`` and ``large_romis`` with either tree's kernel 16;
- 11, the unbiased spatial pass, at K = 1, 2 and 4 on Philox and on
  injected noise (R = 5, r = 10, 1080p): its plain mode and kernel 5 on
  the flagship, its vis_check mode on the flagship and on the one-torus
  soup; outputs bit-equal to the parent's. Then the frames ``animated``,
  ``vischeck_torus`` and ``large_vischeck`` with either tree's kernel 11;
- 14, the replay RIS, on the flagship's 1080p receivers, on injected
  uniforms (records equal to the plain version's on every lane; the
  parent's share printed) and on Philox; then the gradient steps
  ``grad_surrogate``, ``grad_per_pixel`` and ``large_grad`` with either
  tree's kernel 14;
- 17, the R-MIS / R-OMIS sweep, at 1920x1080 on the flagship (D = 5,
  K = 2): R-OMIS, progressive R-OMIS, equal and balance weights on the
  iteration-0 packs and a SIMILAR selection, and the ext_vis R-OMIS on
  the 5x5 torus field; outputs bit-equal to the parent's. Then the frames
  ``romis``, ``romis_progressive``, ``rmis_balance`` and ``large_romis``
  with either tree's kernel 17;
- 7, the Z-count any-hit, on the Z rays of a vis_check pass at 1080p on
  the one-torus soup (970 triangles) and on the flagship, and on the
  2048-triangle soup's rays at 480x270 (chip_smoke's); the same bool on
  every ray as the parent's. This tree's kernel also with the soup in
  Morton and in input order (the package takes the one with the smaller
  boxes), each on blocks built once (``scripts/torch_sweep_zcount_micro.py``
  times the kernel's other variants); the block build alone, and
  the culled walk's tests (``ops.trace.zcount_occ_culled``) beside the
  plain version's. Then the ``vischeck_torus`` frame with either tree's
  kernel 7;
- 10, the halo offset scatter, at D = 5, C = 2, 1920x1080: random
  offsets within ±10 (the per-pixel gradient path's), the smooth field of
  a camera shift, a field beyond the kernel's margin (±40) and offsets
  clamped at all four borders; beside ``index_add_`` on the same inputs;
- 20, the K-ray BVH any-hit, on the 5x5 torus field (24,202 triangles) at
  1080p: the S = 2 shadow rays of the K lanes and the S = 12 ext_vis rays
  of one R-OMIS iteration; beside kernel 19 (a walk per ray) on the same
  rays, and on the 12 planes also beside kernel 20's walk launched plane
  by plane (S = 1: kernel 19's ray layout); then the ``large_romis`` and
  ``large_vischeck`` frames with kernel 20 from either tree.
The last line is one JSON object of the times (ms).
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


class Ctx:
    """What the sections share: torch, the device, the card line, the
    parent's library, a generator, the results."""

    def __init__(self, torch, parent_lib, card):
        self.torch, self.plib, self.card = torch, parent_lib, card
        self.dev = torch.device("cuda", 0)
        self.gen = torch.Generator(device=self.dev).manual_seed(8)
        self.ms = {}

    def call(self, fn, *a):
        """A C entry of the parent's library on the current stream."""
        err = fn(*a, self.torch.cuda.current_stream().cuda_stream)
        if err != 0:
            chip_smoke.fail(f"{fn.__name__}: CUDA error {err}")


def section_10(c: Ctx) -> None:
    torch, dev, gen, card, plib, ms = (c.torch, c.dev, c.gen, c.card, c.plib,
                                       c.ms)
    call, rate = c.call, chip_smoke.ab_ms
    from romis_tpu_torch.ops import spatial

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



def section_20(c: Ctx) -> None:
    torch, dev, gen, card, plib, ms = (c.torch, c.dev, c.gen, c.card, c.plib,
                                       c.ms)
    call, rate = c.call, chip_smoke.ab_ms
    from romis_tpu_torch import Features, RayTraceMode
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import nbrsel, ris, spatial, walk
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.ops.traverse import bvh_any
    from romis_tpu_torch.ops.wrs import visibility
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.pipeline import render_frame
    from romis_tpu_torch.render.rmis import mis_offsets
    from romis_tpu_torch.scene.scene import torus_field, torus_field_camera

    n_nbr, k = 5, 2
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


def parent_launch(c: Ctx, fn):
    """``fn`` with the parent's library behind ``_build.launch``: a C entry
    whose signature the two trees share runs the parent's kernel."""
    from romis_tpu_torch.ops import _build

    def run(*a, **kw):
        saved = _build.library
        _build.library = lambda: c.plib
        try:
            return fn(*a, **kw)
        finally:
            _build.library = saved
    return run


def section_17(c: Ctx) -> None:
    """Kernel 17 in its four frame modes on the flagship and its ext_vis
    R-OMIS on the torus field, then the MIS frames with either tree's."""
    torch, dev, gen, card, ms = c.torch, c.dev, c.gen, c.card, c.ms
    from dataclasses import replace

    from romis_tpu_torch import (
        Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
    )
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import mis, nbrsel, ris, shade, spatial
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.pipeline import render_frame
    from romis_tpu_torch.render.rmis import mis_ext_vis, mis_offsets
    from romis_tpu_torch.scene.scene import (
        flagship_camera, flagship_scene, torus_field, torus_field_camera,
    )

    feats = Features()
    k = feats.num_samples_in_reservoir
    parent_mis = parent_launch(c, mis.mis_iteration)

    def sweep_inputs(scene, cam):
        _, ctx = restir.trace_primary(generate_rays(cam, H, W),
                                      scene.geometry, feats, restir.KERNELS)
        ny, nx = select_neighbour_indices(gen, ctx, H, W, feats,
                                          select=nbrsel.neighbour_select)
        offs = mis_offsets(ny, nx)
        cen = shade.pack_center_ctx(ctx)
        packs = {rp: ris.gen_mis_reservoir_planes(
            ctx, scene.lights, scene.num_lights, feats, 1, rp, generator=gen)
            for rp in (False, True)}
        return ctx, offs, cen, mis.resolve_neighbour_ctx(cen, offs), packs

    def compare(label, *args, **kw):
        mine = mis.mis_iteration(*args, **kw)
        theirs = parent_mis(*args, **kw)
        mine = mine if isinstance(mine, tuple) else (mine,)
        theirs = theirs if isinstance(theirs, tuple) else (theirs,)
        same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
        chip_smoke.require(same, f"kernel 17 {label}: outputs differ from "
                           "the parent's")
        new, old = chip_smoke.ab_ms(torch, lambda: mis.mis_iteration(
            *args, **kw), lambda: parent_mis(*args, **kw), 20, 20)
        print(f"time mis_iteration[{label}]: {new:.4f} ms this tree, "
              f"{old:.4f} ms parent ({old / new:.2f}x); bit-equal to the "
              f"parent's [{card}]")
        ms[f"mis_iteration[{label}]"] = dict(change=new, parent=old)

    scene = flagship_scene(dev)
    ctx, offs, cen, nbr, packs = sweep_inputs(scene, flagship_camera(H, W,
                                                                     dev))
    d1 = offs.shape[0] // 2 + 1
    al = torch.rand((3 * d1, H, W), generator=gen, device=dev) - 0.5
    for label, mode, kw in (
            ("romis", "romis", dict(nbr_ctx=nbr)),
            ("romis_prog", "romis", dict(nbr_ctx=nbr, alphas=al)),
            ("rmis_equal", "rmis_equal", {}),
            ("rmis_balance", "rmis_balance", dict(nbr_ctx=nbr))):
        compare(label, cen, packs[mode == "romis"], offs, scene.geometry, k,
                mode, scene.num_lights, feats, **kw)
    del ctx, offs, cen, nbr, packs, al
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    lctx, loffs, lcen, lnbr, lpacks = sweep_inputs(
        large, torus_field_camera(H, W, dev))
    lext = mis_ext_vis(lctx, lpacks[True][:3 * k], loffs, large.geometry, k)
    compare("ext_vis romis, torus5x5", lcen, lpacks[True], loffs,
            large.geometry, k, "romis", large.num_lights, feats,
            nbr_ctx=lnbr, ext_vis=lext)
    del lctx, loffs, lcen, lnbr, lpacks, lext

    paths = {
        "romis": (scene, flagship_camera(H, W, dev),
                  Features(ray_trace_mode=RayTraceMode.ROMIS)),
        "romis_progressive": (scene, flagship_camera(H, W, dev), Features(
            ray_trace_mode=RayTraceMode.ROMIS, use_progressive_romis=True)),
        "rmis_balance": (scene, flagship_camera(H, W, dev), Features(
            ray_trace_mode=RayTraceMode.RMIS,
            mis_weight_rmis=MISWeight.BALANCE,
            neighbour_selection_strategy=(
                NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR))),
        "large_romis": (large, torus_field_camera(H, W, dev),
                        Features(ray_trace_mode=RayTraceMode.ROMIS)),
    }
    theirs_ops = replace(restir.KERNELS, mis_iteration=parent_mis)
    for path, (sc, cam, f) in paths.items():
        g = torch.Generator(device=dev).manual_seed(5)

        def frame(ops):
            return lambda: render_frame(g, cam, sc, H, W, f, ops=ops)

        new, old = chip_smoke.ab_ms(torch, frame(restir.KERNELS),
                                    frame(theirs_ops), 5, 5)
        print(f"time frame[{path}]: {new:.3f} ms/frame with this tree's "
              f"kernel 17, {old:.3f} with the parent's [{card}]")
        ms[f"frame[{path}]"] = dict(change=new, parent=old)


def section_7(c: Ctx) -> None:
    """Kernel 7 on the torus soup's, the flagship's and the 2048-triangle
    soup's Z rays, in both orders; then ``vischeck_torus`` with either
    tree's kernel 7."""
    torch, dev, gen, card, ms = c.torch, c.dev, c.gen, c.card, c.ms
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.ops import _build, ris, shade, spatial, trace
    from romis_tpu_torch.ops.wrs import SHADOW_RAY_EPSILON as EPS
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.pipeline import render_frame
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
    )

    feats = Features()
    vfeats = Features(unbiased_combination=True,
                      spatial_reuse_visibility_check=True)
    k, n_nbr = feats.num_samples_in_reservoir, feats.num_neighbours_to_sample
    radius = feats.spatial_resample_radius

    def parent_z(o, t, geometry, eps=EPS, mask=None):
        """The parent's kernel 7 (its C entry: every triangle of the soup
        per pending ray), called as its wrapper called it."""
        r1, kk = o.shape[0], t.shape[0]
        h, w = o.shape[-2:]
        o, t = o.contiguous(), t.contiguous()
        m = None if mask is None else mask.contiguous()
        cols = geometry.tri_cols
        out = torch.empty((r1, kk, h, w), dtype=torch.bool, device=dev)
        c.call(c.plib.romis_zcount_occ, o.data_ptr(), t.data_ptr(),
               None if m is None else m.data_ptr(), h * w, r1, kk,
               cols.data_ptr(), cols.shape[1], float(eps), out.data_ptr())
        return out

    def in_order(order):
        """This tree's kernel 7 on blocks built once in ``order`` (True
        Morton, False the input order)."""
        built = {}

        def run(o, t, geometry, eps=EPS, mask=None):
            if id(geometry) not in built:
                built[id(geometry)] = trace.zcount_blocks(geometry, order)
            cols, boxes, nrm = built[id(geometry)]
            r1, kk = o.shape[0], t.shape[0]
            h, w = o.shape[-2:]
            out = torch.empty((r1, kk, h, w), dtype=torch.bool, device=dev)
            _build.launch("romis_zcount_occ", o.data_ptr(), t.data_ptr(),
                          None if mask is None else mask.data_ptr(), h, w,
                          r1, kk, cols.data_ptr(), boxes.data_ptr(),
                          nrm.data_ptr(), cols.shape[1], float(eps),
                          out.data_ptr())
            return out
        return run

    def z_rays(scene, cam, h, w):
        """The Z rays of one vis_check pass, as chip_smoke builds them."""
        _, ctx = restir.trace_primary(generate_rays(cam, h, w),
                                      scene.geometry, feats, restir.KERNELS)
        rp = pack_reservoir_planes(ris.gen_canonical_samples_ris(
            ctx, scene.lights, scene.num_lights, feats, generator=gen))
        cen = shade.pack_center_ctx(ctx)
        pl, blk = spatial.spatial_pass_unbiased_vis(
            rp, cen, k, n_nbr, radius, vfeats, generator=gen,
            key=spatial.philox_key(gen))
        nbr_pos = blk[2 * k:2 * k + 3 * n_nbr].reshape(n_nbr, 3, h, w)
        mf = blk[2 * k + 3 * n_nbr:].reshape(n_nbr, k, h, w)
        return (torch.cat([cen[None, 0:3], nbr_pos]).contiguous(),
                pl[:3 * k].reshape(k, 3, h, w).contiguous(),
                torch.cat([(blk[k:2 * k] > 0.0)[None], mf > 0.0]).contiguous(),
                ctx)

    torus1 = torus_field(1, dev)
    tcam = make_camera(resolution=(H, W), device=dev, **chip_smoke.TORUS_CAM)
    flag = flagship_scene(dev)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    hs, ws = H // 4, W // 4
    _, sctx = restir.trace_primary(generate_rays(flagship_camera(hs, ws, dev),
                                                 hs, ws), soup, feats,
                                   restir.PLAIN)
    so = sctx.position
    zo = torch.cat([so[None], so[None] + 0.5 * torch.randn(
        (n_nbr, 3, hs, ws), generator=gen, device=dev)]).contiguous()
    zt = ris.gen_mis_reservoir_planes_plain(
        sctx, flag.lights, flag.num_lights, feats, 1, False,
        generator=gen)[:3 * k].reshape(k, 3, hs, ws).contiguous()
    zm = (torch.rand((n_nbr + 1, k, hs, ws), generator=gen, device=dev)
          > 0.3).contiguous()
    cases = {
        "torus soup 1080p": (*z_rays(torus1, tcam, H, W)[:3],
                             torus1.geometry),
        "flagship 1080p": (*z_rays(flag, flagship_camera(H, W, dev), H,
                                   W)[:3], flag.geometry),
        "soup2048 480x270, mask": (zo, zt, zm, soup),
        "soup2048 480x270, no mask": (zo, zt, None, soup),
    }
    for label, (o, t, m, geo) in cases.items():
        ref = parent_z(o, t, geo, EPS, m)
        runs = {"Morton order": in_order(True),
                "input order": in_order(False),
                "package": trace.zcount_occ}
        for name, fn in runs.items():
            got = fn(o, t, geo, EPS, m)
            chip_smoke.require(torch.equal(got, ref), f"kernel 7 {label} "
                               f"{name}: bools differ from the parent's")
        row = {}
        new, old = chip_smoke.ab_ms(torch, lambda: trace.zcount_occ(
            o, t, geo, EPS, m), lambda: parent_z(o, t, geo, EPS, m), 10, 10)
        row.update(change=new, parent=old)
        for name, fn in runs.items():
            if name != "package":
                row[name] = chip_smoke.cuda_ms(torch, lambda: fn(
                    o, t, geo, EPS, m), 10)
        row["box build"] = chip_smoke.cuda_ms(
            torch, lambda: trace.build_zcount_blocks(geo.tri_cols), 10)
        cnt, pc = {}, {}
        if "1080p" not in label or label.startswith("torus"):
            culled = trace.zcount_occ_culled(o, t, geo, EPS, m, cnt)
            plain = trace.zcount_occ_plain(o, t, geo, EPS, m, counts=pc)
            chip_smoke.require(torch.equal(culled, ref) and torch.equal(
                plain, ref), f"kernel 7 {label}: plain or culled model "
                "differ")
            traced = (pc["tests"] > 0).sum().item()
            row.update(traced=traced, plain_tests=pc["tests"].sum().item(),
                       box_tests=cnt["box"].sum().item(),
                       guarded_blocks=cnt["guard"].sum().item(),
                       cone_products=cnt["guard_cone"].sum().item(),
                       normal_products=cnt["guard_tri"].sum().item(),
                       tri_tests=cnt["tri"].sum().item(),
                       origin_setups=cnt["origin"].sum().item())
        print(f"time zcount_occ[{label}]: {new:.4f} ms this tree, "
              f"{old:.4f} ms parent ({old / new:.2f}x); the same bool on "
              f"every ray as the parent's; {json.dumps(row)} [{card}]")
        ms[f"zcount_occ[{label}]"] = row

    g = torch.Generator(device=dev).manual_seed(5)
    mine_z = trace.zcount_occ

    def frame(z):
        def run():
            trace.zcount_occ = z
            try:
                render_frame(g, tcam, torus1, H, W, vfeats)
            finally:
                trace.zcount_occ = mine_z
        return run

    new, old = chip_smoke.ab_ms(torch, frame(mine_z), frame(parent_z), 5, 5)
    print(f"time frame[vischeck_torus]: {new:.3f} ms/frame with this tree's "
          f"kernel 7, {old:.3f} with the parent's [{card}]")
    ms["frame[vischeck_torus]"] = dict(change=new, parent=old)


class ParentPassLib:
    """The parent's library as ``_build.launch`` sees it, where this
    tree's ``romis_spatial_pass`` passes kernel 11's two record buffers
    that the parent's entry does not take."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name == "romis_spatial_pass":
            return lambda *a: fn(*a[:16], a[-1])
        return fn


def time_frames(c: Ctx, kernel: str, paths: dict, theirs_ops=None,
                swap=None) -> None:
    """Frames of ``paths`` (name → (scene, camera or a stacked camera
    path, features)) with this tree's kernels and with ``theirs_ops`` (or
    ``swap``, as ``time_steps`` takes it), in turns."""
    torch, dev, card, ms = c.torch, c.dev, c.card, c.ms
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.animation import render_animation
    from romis_tpu_torch.render.pipeline import render_frame

    for path, (sc, cam, f) in paths.items():
        g = torch.Generator(device=dev).manual_seed(5)

        n_frames = cam.look_at.shape[0] if cam.look_at.dim() > 1 else 0

        def frame(ops, theirs=False):
            def run():
                if n_frames:  # a stacked camera path: ms a frame below
                    return render_animation(g, cam, sc.geometry, sc.lights,
                                            sc.num_lights, H, W, f, ops=ops)
                return render_frame(g, cam, sc, H, W, f, ops=ops)
            return swapped(swap if theirs else None, run)

        new, old = chip_smoke.ab_ms(
            torch, frame(restir.KERNELS),
            frame(theirs_ops or restir.KERNELS, True), 5, 5)
        if n_frames:
            new, old = new / n_frames, old / n_frames
        print(f"time frame[{path}]: {new:.3f} ms/frame with this tree's "
              f"kernel {kernel}, {old:.3f} with the parent's [{card}]")
        ms[f"frame[{path}]"] = dict(change=new, parent=old)


def section_16(c: Ctx) -> None:
    """Kernel 16 in its three strategies, Philox and injected, D = 5 and 8
    at r = 10 (1080p) and D = 5 at r = 40 (past the staged window, at
    270x480); then the MIS frames with either tree's kernel 16."""
    torch, dev, gen, card, ms = c.torch, c.dev, c.gen, c.card, c.ms
    import math
    from dataclasses import replace

    from romis_tpu_torch import Features, RayTraceMode
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import nbrsel, spatial
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        flagship_camera, flagship_scene, torus_field, torus_field_camera,
    )

    feats = Features()
    sel_args = (feats.neighbour_same_geometry,
                feats.neighbour_max_depth_difference_fraction,
                math.cos(feats.neighbour_max_normal_angle_difference_radians))
    parent_sel = parent_launch(c, nbrsel.neighbour_select)
    scene = flagship_scene(dev)
    gates = {}
    for hw in ((H, W), (H // 4, W // 4)):
        _, ctx = restir.trace_primary(generate_rays(flagship_camera(
            *hw, dev), *hw), scene.geometry, feats, restir.KERNELS)
        gates[hw] = nbrsel.selection_gates(ctx).contiguous()
    for d, radius, hw in ((5, 10, (H, W)), (8, 10, (H, W)),
                          (5, 40, (H // 4, W // 4))):
        g = gates[hw]
        scores = nbrsel.selection_noise(gen, radius, *hw)
        for label, (two, prefer) in {"similar": (False, True),
                                     "dissimilar": (False, False),
                                     "two_classes": (True, True)}.items():
            key = spatial.philox_key(gen)
            for noise, kw in (("philox", dict(key=key)),
                              ("injected", dict(scores=scores))):
                args = (g, d, radius, two, prefer, *sel_args)
                mine = nbrsel.neighbour_select(*args, **kw)
                theirs = parent_sel(*args, **kw)
                chip_smoke.require(all(torch.equal(a, b) for a, b in zip(
                    mine, theirs)), f"kernel 16 {label} {noise} D={d} "
                    f"r={radius}: outputs differ from the parent's")
                new, old = chip_smoke.ab_ms(
                    torch, lambda: nbrsel.neighbour_select(*args, **kw),
                    lambda: parent_sel(*args, **kw), 10, 10)
                name = (f"neighbour_select[{label}, {noise}, D={d}, "
                        f"r={radius}, {hw[0]}x{hw[1]}]")
                print(f"time {name}: {new:.4f} ms this tree, {old:.4f} ms "
                      f"parent ({old / new:.2f}x); bit-equal to the "
                      f"parent's [{card}]")
                ms[name] = dict(change=new, parent=old)
        del scores
    del gates
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    time_frames(c, "16", {
        "romis": (scene, flagship_camera(H, W, dev),
                  Features(ray_trace_mode=RayTraceMode.ROMIS)),
        "rmis_equal": (scene, flagship_camera(H, W, dev),
                       Features(ray_trace_mode=RayTraceMode.RMIS)),
        "large_romis": (large, torus_field_camera(H, W, dev),
                        Features(ray_trace_mode=RayTraceMode.ROMIS)),
    }, replace(restir.KERNELS, neighbour_select=parent_sel))


def section_11(c: Ctx) -> None:
    """Kernel 11 at K = 1, 2 and 4, Philox and injected, plain and
    vis_check modes, and kernel 5 beside it; then the unbiased frames with
    either tree's kernel 11."""
    torch, dev, gen, card, ms = c.torch, c.dev, c.gen, c.card, c.ms
    from dataclasses import replace

    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.render.animation import interpolate_cameras
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.ops import _build, ris, shade, spatial
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        flagship_camera, flagship_scene, torus_field, torus_field_camera,
    )

    plib = ParentPassLib(c.plib)

    def parent(fn):
        def run(*a, **kw):
            saved = _build.library
            _build.library = lambda: plib
            try:
                return fn(*a, **kw)
            finally:
                _build.library = saved
        return run

    n_nbr, radius = 5, 10
    vfeats = Features(unbiased_combination=True,
                      spatial_reuse_visibility_check=True)
    scene = flagship_scene(dev)
    torus1 = torus_field(1, dev)
    tcam = make_camera(resolution=(H, W), device=dev, **chip_smoke.TORUS_CAM)
    for k in (1, 2, 4):
        f = Features(num_samples_in_reservoir=k)
        for sc_name, sc, cam in (("flagship", scene, flagship_camera(H, W,
                                                                     dev)),
                                 ("torus soup", torus1, tcam)):
            _, ctx = restir.trace_primary(generate_rays(cam, H, W),
                                          sc.geometry, f, restir.KERNELS)
            rp = pack_reservoir_planes(ris.gen_canonical_samples_ris(
                ctx, sc.lights, sc.num_lights, f, generator=gen))
            cen = shade.pack_center_ctx(ctx)
            gates = spatial.pack_gates(ctx)
            inject = spatial.spatial_noise(gen, n_nbr, k, radius, H, W)
            key = spatial.philox_key(gen)
            for noise, kw in (("philox", dict(key=key)),
                              ("injected", dict(inject=inject))):
                runs = {
                    "kernel 11": lambda fn, kw=kw: fn(
                        spatial.spatial_pass_unbiased_fused)(
                        rp, cen, k, n_nbr, radius, f, **kw),
                    "kernel 11 vis_check": lambda fn, kw=kw: fn(
                        spatial.spatial_pass_unbiased_vis)(
                        rp, cen, k, n_nbr, radius, vfeats.replace(
                            num_samples_in_reservoir=k), **kw),
                    "kernel 5": lambda fn, kw=kw: fn(
                        spatial.spatial_pass_fused)(
                        rp, gates, cen, k, n_nbr, radius, f, **kw),
                }
                for label, run in runs.items():
                    if sc_name == "torus soup" and label != (
                            "kernel 11 vis_check"):
                        continue
                    mine = run(lambda x: x)
                    theirs = run(parent)
                    mine = mine if isinstance(mine, tuple) else (mine,)
                    theirs = theirs if isinstance(theirs, tuple) else (
                        theirs,)
                    chip_smoke.require(all(torch.equal(a, b) for a, b in
                                           zip(mine, theirs)),
                                       f"{label} K={k} {noise} {sc_name}: "
                                       "outputs differ from the parent's")
                    new, old = chip_smoke.ab_ms(
                        torch, lambda: run(lambda x: x),
                        lambda: run(parent), 10, 10)
                    name = f"{label}[K={k}, {noise}, {sc_name}]"
                    print(f"time {name}: {new:.4f} ms this tree, {old:.4f} "
                          f"ms parent ({old / new:.2f}x); bit-equal to the "
                          f"parent's [{card}]")
                    ms[name] = dict(change=new, parent=old)
            del rp, cen, gates, inject
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    cam = flagship_camera(H, W, dev)
    cam_path = interpolate_cameras(cam, make_camera(
        look_at=(2.57, 1.23, -1.35), rotation_deg=(
            10.3, 30.0 + chip_smoke.PAN_DEG * 3, 0.0), distance=25.0,
        fov_deg=30.0, resolution=(H, W), device=dev), 4)
    time_frames(c, "11", {
        "animated": (scene, cam_path, Features(
            temporal_reprojection=True, unbiased_combination=True,
            initial_samples_visibility_check=True)),
        "vischeck_torus": (torus1, tcam, vfeats),
        "large_vischeck": (large, torus_field_camera(H, W, dev), vfeats),
    }, replace(restir.KERNELS, spatial_pass_unbiased=parent(
        spatial.spatial_pass_unbiased_fused)))


def section_14(c: Ctx) -> None:
    """Kernel 14, the replay RIS, on the flagship's 1080p receivers: on
    injected uniforms (this tree's records equal to the plain version's on
    every lane; the share of lanes where the parent's equal them printed)
    and on Philox, in turns with the parent's; then the gradient steps
    that run it with either tree's."""
    torch, dev, gen, card, ms = c.torch, c.dev, c.gen, c.card, c.ms
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import ris
    from romis_tpu_torch.ops.wrs import gen_canonical_replay_plain
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

    feats = Features()
    scene = flagship_scene(dev)
    _, ctx = restir.trace_primary(generate_rays(flagship_camera(H, W, dev),
                                                H, W), scene.geometry, feats,
                                  restir.KERNELS)
    args = (ctx, scene.lights, scene.num_lights, feats)
    parent_replay = parent_launch(c, ris.gen_canonical_replay)
    sk = -(-feats.initial_light_samples // feats.num_samples_in_reservoir)
    uni = torch.rand((sk, 5, feats.num_samples_in_reservoir, H, W),
                     generator=gen, device=dev)

    def same_records(a, b):
        return torch.stack([x == y for ra, rb in zip(a[1:], b[1:])
                            for x, y in zip(ra, rb)]).all(dim=0)

    plain = gen_canonical_replay_plain(*args, uniforms=uni)
    mine = ris.gen_canonical_replay(*args, uniforms=uni)
    theirs = parent_replay(*args, uniforms=uni)
    chip_smoke.require(bool(same_records(mine, plain).all()) and torch.equal(
        mine[0], plain[0]), "kernel 14: records differ from the plain "
        "version's")
    share = same_records(theirs, plain).float().mean().item()
    for noise, kw in (("uniforms", dict(uniforms=uni)),
                      ("philox", dict(generator=gen))):
        new, old = chip_smoke.ab_ms(
            torch, lambda: ris.gen_canonical_replay(*args, **kw),
            lambda: parent_replay(*args, **kw), 10, 10)
        print(f"time ris_replay[{noise}]: {new:.4f} ms this tree, {old:.4f} "
              f"ms parent; records equal to the plain version's on every "
              f"lane (the parent's on {share:.7f}) [{card}]")
        ms[f"ris_replay[{noise}]"] = dict(change=new, parent=old,
                                          parent_share=share)
    del uni, plain, mine, theirs, ctx
    from dataclasses import replace

    time_steps(c, "14", replace(restir.KERNELS, ris_replay=parent_replay))


def time_steps(c: Ctx, kernel: str, theirs_ops=None, swap=None) -> None:
    """The three gradient steps with this tree's kernels and with the
    parent's (``theirs_ops``, or ``swap`` = (module, name, the parent's
    function) set in place of the module's), in turns, from one forward
    frame's state against the light colours x 0.8 (chip_smoke's)."""
    torch, dev, card, ms = c.torch, c.dev, c.card, c.ms
    from dataclasses import replace

    from romis_tpu_torch import Features
    from romis_tpu_torch.diff.grad import (
        extract_params, make_grad_fn, render_with_params,
    )
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import (
        flagship_camera, flagship_scene, torus_field, torus_field_camera,
    )

    scene = flagship_scene(dev)
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    gf = Features(enable_tone_mapping=False, surrogate_resampling_grad=True)
    for path, (sc, cam, f) in {
            "grad_surrogate": (scene, flagship_camera(H, W, dev), gf),
            "grad_per_pixel": (scene, flagship_camera(H, W, dev),
                               gf.replace(exact_gradients=True)),
            "large_grad": (large, torus_field_camera(H, W, dev), gf)}.items():
        prm = extract_params(sc.geometry, sc.lights)
        dim = replace(prm, **{n: getattr(prm, n) * 0.8 for n in (
            "light_c0", "light_c1", "light_c2", "light_c3")})
        g = torch.Generator(device=dev).manual_seed(11)
        a = (cam, sc.geometry, sc.lights, sc.num_lights, H, W, f)
        with torch.no_grad():
            _, prev = render_with_params(
                prm, g, *a, restir.initial_temporal_state(
                    H, W, f.num_samples_in_reservoir, cam))
            target, _ = render_with_params(dim, g, *a, prev)

        def step(ops, theirs=False):
            fn = make_grad_fn(sc.geometry, sc.lights, sc.num_lights, H, W, f,
                              ops=ops)
            gs = torch.Generator(device=dev).manual_seed(5)
            return swapped(swap if theirs else None,
                           lambda: fn(prm, target, gs, cam, prev))

        new, old = chip_smoke.ab_ms(
            torch, step(restir.KERNELS),
            step(theirs_ops or restir.KERNELS, True), 5, 5)
        print(f"time step[{path}]: {new:.3f} ms with this tree's kernel "
              f"{kernel}, {old:.3f} with the parent's [{card}]")
        ms[f"step[{path}]"] = dict(change=new, parent=old)


def swapped(swap, fn):
    """``fn`` run with ``swap`` = (module, name, value) set in place of the
    module's attribute (no swap: ``fn``)."""
    if swap is None:
        return fn
    mod, name, value = swap

    def run():
        saved = getattr(mod, name)
        setattr(mod, name, value)
        try:
            return fn()
        finally:
            setattr(mod, name, saved)
    return run


def section_13(c: Ctx) -> None:
    """Kernel 13 on every table of the three gradient steps (and the
    2048-triangle soup's), each beside index_add_ and held to the plain and
    float64 sums; then the gradient steps with either tree's kernel 13."""
    torch, dev, gen, card, ms = c.torch, c.dev, c.gen, c.card, c.ms
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import rows, scatter, trace, walk
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
        torus_field_camera,
    )

    scene = flagship_scene(dev)
    rays = generate_rays(flagship_camera(H, W, dev), H, W)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    lrays = generate_rays(torus_field_camera(H, W, dev), H, W)
    k = 2
    cases = chip_smoke.scatter_tables(
        torch, gen, scene, trace.closest_hit_plain(rays, scene.geometry)[1], k)
    cases["soup2048"] = (torch.randn((9, H, W), generator=gen, device=dev),
                         trace.closest_hit_plain(rays, soup)[1].clamp_min(0),
                         chip_smoke.SOUP_TRIS)
    cases.update(chip_smoke.scatter_tables(
        torch, gen, large, walk.closest_hit_bvh(lrays, large.geometry)[1], k,
        "torus "))

    def parent_scatter(ct, idx, n_rows):
        """The parent's kernel 13, called as its wrapper called it."""
        flat_ct, flat_idx = scatter._flat(ct, idx)
        flat_ct = flat_ct.contiguous()
        flat_idx = flat_idx.to(torch.int32).contiguous()
        out = torch.zeros((n_rows, ct.shape[0]), device=dev)
        c.call(c.plib.romis_scatter_rows_add, flat_ct.data_ptr(),
               flat_ct.shape[0], flat_idx.data_ptr(), flat_idx.numel(), n_rows,
               out.data_ptr())
        return out

    for label, (ct, idx, n_rows) in cases.items():
        errs = {}
        for tree, fn in (("this tree", scatter.scatter_rows_add),
                         ("parent", parent_scatter)):
            rel, rel64 = chip_smoke.scatter_rel(torch, fn(ct, idx, n_rows), ct,
                                                idx, n_rows)
            chip_smoke.require(rel <= chip_smoke.SCATTER_REL
                               and rel64 <= chip_smoke.SCATTER_F64_REL,
                               f"kernel 13 {label} ({tree}): {rel}, {rel64}")
            errs[tree] = (rel, rel64)
        new, old = chip_smoke.ab_ms(
            torch, lambda: scatter.scatter_rows_add(ct, idx, n_rows),
            lambda: parent_scatter(ct, idx, n_rows), 20, 20)
        src, flat = ct.reshape(ct.shape[0], -1).t(), idx.reshape(-1).long()
        lib = chip_smoke.cuda_ms(torch, lambda: torch.zeros(
            (n_rows, ct.shape[0]), device=dev).index_add_(0, flat, src), 20)
        b_ms, b_by = chip_smoke.scatter_bound(ct, idx, n_rows)
        tile = scatter.scatter_tile(ct.shape[0], n_rows)
        name = f"scatter_rows_add[{label}]"
        print(f"time {name}: {new:.4f} ms this tree, {old:.4f} ms parent "
              f"({old / new:.2f}x), index_add_ {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {n_rows} rows x {ct.shape[0]}, "
              f"{idx.numel()} indices, tile {tile}; max err / sum|ct| vs "
              f"plain, vs float64: {errs} [{card}]")
        ms[name] = dict(change=new, parent=old, index_add=lib, bound=b_ms,
                        tile=tile, rows=n_rows, cols=ct.shape[0],
                        indices=idx.numel())
        del src, flat
    del cases
    time_steps(c, "13", swap=(rows, "scatter_rows_add", parent_scatter))


def section_21(c: Ctx) -> None:
    """Kernel 21 on the 5x5 torus field at K = 1, 2 and 4, shaded and
    unshaded, bit-equal to the parent's, with kernel 20 at S = 2 on the
    same rays beside it; kernels 4 and 19 (unchanged designs) bit-equal
    to the parent's and timed beside them; then the large frames and
    ``large_grad`` with either tree's kernel 21."""
    torch, dev, gen, card, ms = c.torch, c.dev, c.gen, c.card, c.ms
    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays, make_camera
    from romis_tpu_torch.ops import ris, shade, walk
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.ops.wrs import visibility
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.animation import interpolate_cameras
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, torus_field,
        torus_field_camera,
    )

    large = torus_field(5, dev)
    large.geometry = with_bvh(large.geometry)
    lgeo = large.geometry
    _, lctx = restir.trace_primary(generate_rays(torus_field_camera(
        H, W, dev), H, W), lgeo, Features(), restir.KERNELS)

    def parent_bvh_shade(ctx, res, geometry, features):
        """The parent's kernel 21 (its [10, T] columns), called as its
        wrapper called it."""
        cp, rp, cols, k_, out = shade._packed(ctx, res, geometry, features)
        nodes, _ = walk.checked_tree(geometry)
        c.call(c.plib.romis_final_shade_bvh, cp.data_ptr(), rp.data_ptr(),
               out[0].numel(), k_, nodes.data_ptr(), cols.data_ptr(),
               cols.shape[1], int(not features.enable_shading),
               out.data_ptr())
        return out

    def compare(name, mine, theirs):
        chip_smoke.require(torch.equal(mine(), theirs()),
                           f"{name}: outputs differ from the parent's")
        new, old = chip_smoke.ab_ms(torch, mine, theirs, 10, 10)
        return new, old

    for k in (1, 2, 4):
        f = Features(num_samples_in_reservoir=k)
        res = ris.gen_canonical_samples_ris(lctx, large.lights,
                                            large.num_lights, f, generator=gen)
        for mode, ff in (("shaded", f), ("unshaded",
                                         f.replace(enable_shading=False))):
            name = f"bvh_final_shade[K={k}, {mode}]"
            new, old = compare(
                name, lambda: shade.final_shade_bvh(lctx, res, lgeo, ff),
                lambda: parent_bvh_shade(lctx, res, lgeo, ff))
            row = dict(change=new, parent=old)
            line = (f"time {name}: {new:.4f} ms this tree, {old:.4f} ms "
                    f"parent ({old / new:.2f}x); bit-equal to the parent's")
            if k == 2 and mode == "shaded":
                got = {}

                def grab(o, d, tm, _g):
                    got["rays"] = (o.contiguous(),
                                   d.expand(o.shape).contiguous(),
                                   tm.contiguous())
                    return torch.zeros(tm.shape, dtype=torch.bool,
                                       device=dev)

                visibility(lctx.position, res.pos, lgeo, grab)
                k20 = chip_smoke.cuda_ms(torch, lambda: walk.any_hit_bvh_k(
                    *got["rays"], lgeo), 10)
                row.update(kernel20=k20)
                line += (f"; kernel 20 on the same S = 2 rays (every lane, "
                         f"dead ones too) {k20:.4f} ms")
                del got
            print(line + f" [{card}]")
            ms[name] = row
        del res

    # Kernels 4 and 19 keep their designs: bit-equal, timed beside the
    # parent's.
    f = Features()
    scene = flagship_scene(dev)
    soup = build_geometry([chip_smoke.random_soup(
        chip_smoke.SOUP_TRIS, (2.57, 1.23, -1.35), 3.0, seed=7)], dev)
    parent_shade = parent_launch(c, shade.final_shade_fused)
    parent_any = parent_launch(c, walk.any_hit_bvh)
    for label, sc_geo, cam in (("flagship", scene.geometry,
                                flagship_camera(H, W, dev)),
                               ("soup2048", soup, flagship_camera(H, W, dev))):
        _, ctx = restir.trace_primary(generate_rays(cam, H, W), sc_geo, f,
                                      restir.KERNELS)
        res = ris.gen_canonical_samples_ris(ctx, scene.lights,
                                            scene.num_lights, f, generator=gen)
        name = f"final_shade[{label}]"
        new, old = compare(name, lambda: shade.final_shade_fused(
            ctx, res, sc_geo, f), lambda: parent_shade(ctx, res, sc_geo, f))
        print(f"time {name} (kernel 4): {new:.4f} ms this tree, {old:.4f} ms "
              f"parent ({new / old:.3f} of it); bit-equal [{card}]")
        ms[name] = dict(change=new, parent=old)
        del ctx, res
    res = ris.gen_canonical_samples_ris(lctx, large.lights, large.num_lights,
                                        f, generator=gen)
    to = res.pos - lctx.position
    dist = torch.linalg.vector_norm(to, dim=-3).clamp_min(1e-20)
    d = to / dist[:, None]
    o = lctx.position + 1e-3 * d
    tm = torch.linalg.vector_norm(res.pos - o, dim=-3)
    name = "bvh_any_hit[1 plane]"
    new, old = compare(name, lambda: walk.any_hit_bvh(o[:1], d[:1], tm[:1],
                                                      lgeo),
                       lambda: parent_any(o[:1], d[:1], tm[:1], lgeo))
    print(f"time {name} (kernel 19): {new:.4f} ms this tree, {old:.4f} ms "
          f"parent ({new / old:.3f} of it); bit-equal [{card}]")
    ms[name] = dict(change=new, parent=old)
    del res, to, dist, d, o, tm

    # The frames and the step that run kernel 21, with either tree's.
    lcam = torus_field_camera(H, W, dev)
    lcam_path = interpolate_cameras(lcam, make_camera(
        look_at=(0, 0, 0), rotation_deg=(
            25.0, 30.0 + chip_smoke.PAN_DEG * 3, 0.0), distance=11.0,
        fov_deg=50.0, resolution=(H, W), device=dev), 4)
    vfeats = Features(unbiased_combination=True,
                      spatial_reuse_visibility_check=True)
    time_frames(c, "21", {
        "large_config5": (large, lcam, Features()),
        "large_animated": (large, lcam_path, Features(
            temporal_reprojection=True, unbiased_combination=True,
            initial_samples_visibility_check=True)),
        "large_vischeck": (large, lcam, vfeats),
    }, swap=(shade, "final_shade_bvh", parent_bvh_shade))
    time_steps(c, "21", swap=(shade, "final_shade_bvh", parent_bvh_shade))


SECTIONS = {"13": (section_13, ("scatter_rows",)),
            "21": (section_21, ("final_shade", "bvh_any_kernel")),
            "16": (section_16, ("nbrsel_kernel",)),
            "14": (section_14, ("ris_kernel",)),
            "11": (section_11, ("spatial_pass_kernel",
                                "spatial_unbiased_kernel",
                                "records_kernel")),
            "17": (section_17, ("romis_kernel", "rmis_kernel")),
            "7": (section_7, ("zcount_kernel",)),
            "10": (section_10, ("halo_scatter",)),
            "20": (section_20, ("bvh_any_k",))}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other tree (e.g. build/parent)")
    ap.add_argument("--kernels", default="13,21",
                    help="comma-separated sections: 13, 21, 16, 11, 14, "
                    "17, 7, 10, 20")
    args = ap.parse_args()
    picked = args.kernels.split(",")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    if any(p not in SECTIONS for p in picked):
        chip_smoke.fail(f"--kernels {args.kernels}: pick from {list(SECTIONS)}")
    from romis_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    print(card)
    parent = load_build(args.parent.resolve())
    with ThreadPoolExecutor(2) as pool:  # both builds at once
        jobs = [pool.submit(_build.build), pool.submit(parent.build)]
        for j in jobs:
            j.result()
    names = sum((SECTIONS[p][1] for p in picked), ())
    for label, log in (("this tree", _build.BUILD_DIR / "build.log"),
                       ("parent", parent.BUILD_DIR / "build.log")):
        for line in ptxas_lines(log, names):
            print(f"ptxas {label}: {line}")
    c = Ctx(torch, parent.library(), card)
    for p in picked:
        SECTIONS[p][0](c)
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": c.ms}))


if __name__ == "__main__":
    main()
