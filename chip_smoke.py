#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``romis_tpu_torch``) on one NVIDIA
GPU.

    python3 chip_smoke.py

1. The device: its name, power limit, and the TF32 switches (both off).
2. The build: every kernel under ``romis_tpu_torch/csrc`` compiled with
   nvcc for sm_90a (one process per source, all at once), with its seconds.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes the 1920x1080 frame gives it on the flagship scene (a ground quad
   under 512 area lights): closest hit (t, tri, u and v the plain scan's on
   every ray, the rays that differ counted), final shade and any-hit also
   on a random soup of 2048 triangles; the halo gather at every shape the
   frames give it (``halo_cases``: D = 1 through a camera shift, D = 5 at
   random and at selected neighbours' offsets, the MIS gradient steps'
   R-OMIS w_sum | chosen_w and the banded step's band rows), on a field
   beyond its
   window's margin, a ±100 field and planes holding infinities, NaNs and
   signed zeros, bit for bit as 32-bit patterns, each shape timed beside
   its bound and launches; the biased and unbiased spatial
   passes on injected noise (exact) and on their own random streams (means
   within 1 %). Then the gradient step's kernels: the row scatter-add into
   every table the steps scatter into (``scatter_tables``: the light
   table's 512 rows, the material table's one row, the triangle table's
   few rows at C = 9 and at the attribute rows' C = 24) and the soup's
   packed vertices (later also the torus field's tables: 3 light rows, its
   material rows, 24,202 triangle rows at C = 9 and 24), each within
   SCATTER_REL of the plain version and SCATTER_F64_REL of a float64 sum,
   and timed beside its bound and ``index_add_``; the MIS records path's
   light rows (the surrogate's records gathered at the selection's
   offsets: D1·K indices a pixel) through the row gather bit for bit and
   the row scatter-add, both timed there too; the halo scatter at D=5,
   C=2 on offsets within
   ±10, on the smooth field of a large camera shift (every source beyond
   the kernel's margin) and on offsets clamped at all four borders, each
   with its share of sources beyond the margin, and at every halo-gather
   shape a gradient step scatters at (``HALO_SCATTERED``); the replay RIS on
   injected uniforms (records exact) and on Philox; and one
   ``torch.autograd.grad`` through each autograd wrapper (row gather, halo
   gather, closest hit, final shade) against autograd of the plain
   version. Tolerances are the constants below.
   Then the R-MIS / R-OMIS kernels: the neighbour selection for the three
   similarity strategies on injected score planes (the same slots on every
   pixel; the two-class counts exact) and on its Philox stream (two-class
   counts exact, the share of preferred-class picks within 1 %, the
   picks' histogram over (class, box offset) as close to the plain Gumbel
   stream's as PICKS_SPREAD times the plain stream's seed-to-seed
   distance); the batched MIS RIS
   against one plain RIS per iteration on injected uniforms; and the sweep
   in its four modes (equal, balance, R-OMIS direct and progressive) per
   output plane, at 1080p on the flagship scene and at 480x270 on the soup
   (shadows; a smaller frame because the plain any-hit is a block scan).
   Then the BVH kernels on the 5x5 torus field (``scene.torus_field``,
   24,202 triangles, the monkey field's count; the SAH tree built by the
   port's own host builder), with the rays of its 1080p frame: the closest
   hit (kernel 18: t, tri, u and v the plain walk's on every ray, its
   nearer-first model ``ops.traverse.bvh_closest_ordered`` too, whose
   tests bound it), the any-hit with one walk per ray (19; the plain
   bool on every ray, its walk's model ``ops.traverse.bvh_any_wide``
   too, whose tests bound it) on the frame's shadow rays with 1 and with
   17 planes and on hard rays toward the field's triangles
   (``hard_any_rays``), the K-ray any-hit (20, a walk per
   ray with a pixel's S rays side by side) with S = 2 (the shadow rays of
   the K lanes), 4 and 16 (sky rays) and 12 (the ext_vis rays of one MIS
   iteration; also against kernel 19 on the same rays), the plain bool on
   every ray, the BVH final shade (21; at K = 1, 2 and 4), the sweep's
   ext_vis mode in its four modes; and a cross-check with no plain
   version in it: the
   2048-triangle soup with a BVH attached, kernel 18 against the soup's
   closest hit (kernel 1: the same t and hit attributes) and kernel 20
   against the soup's any-hit (kernel 6).
   Then the Z-count visibility (slice 6): kernel 11's vis_check mode per
   output plane on injected noise (reservoir planes within the pass
   tolerances, positions and m-flags exact); kernel 7 (the Z-count
   occlusion) against its plain version, the same bool on every ray, at
   1080p on the Z rays of a vis_check pass on the flagship scene and on the
   2048-triangle soup at 480x270 with and without a mask and with
   coincident pairs; kernel 20 on the Z rays of a vis_check pass on the
   5x5 torus field (the plain bool on every ray); the whole vis-check pass
   (kernel 11, kernel 7, the Z subtraction) against the plain unbiased
   pass with visibility_from (W
   within the pass tolerance on MIN_AGREE of the lanes); and the unshaded
   mode (Features(enable_shading=False)) of every kernel that evaluates
   Phong: the RIS, replay and MIS RIS, both spatial passes, the sweep in
   its four modes, the final shade and its BVH mode, at 1080p with the
   tolerances above. Kernel 4 (the final shade on a soup, its shadow rays
   walking the soup culled as kernel 7 culls it) is also held to the
   plain any-hit bool for bool on every lane it traces (its occlusion
   output): on the flagship and the 2048-soup, on the one-torus soup at
   1080p at K = 1, 2 and 4, shaded and unshaded, and on random, grazing,
   edge-on and edge-crossing shadow rays (``hard_z_rays`` made receivers
   and samples, ``hard_shade_inputs``) of the torus soup and the 2048-soup.
   Kernel 1 (its closest hit culled by the same blocks) is held to the
   plain scan on every ray of the one-torus soup's 1080p primary rays and
   of random, grazing, edge-on and edge-crossing rays (``hard_z_rays``'
   origins toward their targets) of the torus soup and the 2048-soup.
   Then kernel 6 (the soup any-hit, ``ops.trace.any_hit``) and kernel 8
   (the Plücker any-hit, ``ops.trace.any_hit_plucker``, an op-level entry
   the reference reaches on no frame path), both culled by the soup's
   blocks, each against its plain version, the same bool on every
   segment (``check_soup_any``): the K = 2 shadow rays of the flagship's
   1080p frame, of the one-torus soup's 1080p frame (970 triangles,
   TORUS_CAM) and of the 2048-triangle soup at 480x270, where kernel 8 is
   also held to kernel 6, at most PLUCKER_MT_SHARE of the hit pixels'
   segments apart (and of all but on the flagship, whose missed pixels'
   segments end on the ground); ``hard_z_rays``' four kinds made segments
   (``seg_rays``) on the torus soup and the 2048-soup, and random segments
   among small triangles moved 100 and 1000 units from the origin
   (``moved_soup``, ``box_segments``), where the Plücker sides round the
   most (kernel 8's share apart from kernel 6 printed there); kernel
   12 (the neighbour gather, ``ops.spatial.neighbour_gather``) on config
   5's pack (C = 10K + 19 = 39 planes: a coordinate plane, the reservoirs,
   the 18 context planes; R = 5, r = 10) at 1080p, bit-exact on injected
   offsets, and on its Philox stream: every offset in the clamped window,
   every plane at the offset the coordinate plane records (the plain
   version at the recovered offsets bit-exact), the offsets equal to the
   plain Philox draw's (``neighbour_offsets``), each of the 2r + 1 values
   of dy and of dx within NBR_SHARE_REL of 1/(2r + 1) over the interior
   pixels, and dx not shared down columns (as the TPU kernel shares it).
4. Twenty-eight main paths, each at 1920x1080, once through the kernels and
   once through the plain versions, with the launch counters set to 0 just
   before and read just after the kernels' run:
   - slice 1: ``Features(spatial_reuse=False)``, 2 frames;
   - config 5: ``Features()`` (the reference defaults of bench.py config 5:
     S=32, K=2, temporal reuse, 2 biased spatial passes of 5 neighbours in
     radius 10), 4 frames;
   - the animated path: a camera turning about 4 pixels per frame, with
     temporal reprojection, the unbiased combine and the initial visibility
     check, 4 frames (``render_animation``); and ``animated_torus``, the
     same features on the one-torus field as a soup of 970 triangles
     (TORUS_CAM turning), 2 frames, its initial check's shadow rays through
     kernel 6 on the culled soup, compared with the plain run at 480x270 on
     injected noise.
   - the gradient paths of ``diff.grad.make_grad_fn`` on config 5's
     features without tone mapping: ``grad_surrogate``
     (``surrogate_resampling_grad``: the replay RIS, replay records through
     the reuse phases, coherent spatial offsets) and ``grad_per_pixel``
     (the same with ``exact_gradients``: per-pixel offsets, so big_w goes
     through the halo gather and its scatter), 2 steps each (one on
     injected noise, one on the Philox streams), from the state of one
     forward frame, against a target rendered with the light colours x 0.8.
     The plain run takes the first step's injected noise.
   - R-MIS and R-OMIS at the reference defaults (D=5, r=10, K=2, S=32, 5
     iterations): ``romis`` (direct, SIMILAR), ``romis_progressive``,
     ``rmis_equal`` and ``rmis_balance`` (EQUAL_SIMILAR_DISSIMILAR), 2
     frames each, one on injected noise and one on the Philox streams; the
     plain run takes the injected frame.
   - the same on the 5x5 torus field with its BVH (bench.py config 6's
     camera): ``large_config5`` (``Features()``, bench config 6's
     features), ``large_animated``, ``large_k1`` (one sample per reservoir
     with the initial check: its shadow rays take kernel 19), 2 frames each,
     and ``large_romis`` (R-OMIS direct) and ``large_rmis_equal``, whose
     sweeps run in the ext_vis mode; the plain run of these two is at
     480x270 (on both sides, injected noise), because the plain any-hit of
     12 rays per pixel walks the tree in lockstep.
   - slice 6: ``config5_gather`` (config 5 with fused_spatial_gather=False:
     the gather-then-combine route, 2 halo gathers and no pass kernel a
     frame), ``unshaded`` (config 5 with enable_shading=False), and the
     unbiased combine with the Z-count visibility check (24 Z rays a pixel
     at config 5's R = 5, K = 2, 2 passes) on the flagship scene
     (``vischeck``), on the one-torus field as a soup of 970 triangles
     (``vischeck_torus``: the Z rays take kernel 7 and are really
     occluded) and on the 5x5 field with its BVH (``large_vischeck``: the
     Z rays take kernel 20), 2 frames each; the last two compared with the
     plain run at 480x270 on injected noise. Then ``cli``: ``python -m
     romis_tpu_torch.cli`` in-process on a TOML with the visibility check
     and an OBJ + MTL of the 5x5 field written under ``build/`` (the CLI
     attaches the BVH), 4 frames at 1920x1080 with a checkpoint, then 2 and
     a resume to 4: the two final images bit-identical, and each image's
     mean within FRAME_REL of the same frames through render_animation.
   - slice 7: ``large_grad`` (``make_grad_fn`` on the 5x5 torus field
     with its BVH, the tree as built, grad_surrogate's features, 2 steps
     from one forward frame: kernels 18, 21 and the shade backward's K-ray
     walk 20), its plain comparison at 480x270 on injected noise; and the
     op paths ``plucker_op`` (kernel 8 on the torus soup's 1080p shadow
     rays) and ``neighbour_gather_op`` (kernel 12 on config 5's pack, pass
     indices 0 and 1), 2 calls each.
   - the MIS gradient steps at the reference defaults without
     tone mapping (``mis_grad_features``), against a target rendered with
     the light colours x 0.8, 2 steps each (one on injected noise, one on
     the Philox streams): ``mis_grad_rmis`` (``make_mis_grad_fn``, R-MIS
     balance with the surrogate: the replay RIS, the replay-records
     gather, kernels 9, 10, 2, 13, 14 and 6), ``mis_grad_romis`` (R-OMIS
     direct, the same), ``mis_grad_banded`` (``diff.banded``, progressive
     R-OMIS at MIS_BANDS = 8 bands of 135 rows, the plain candidate
     loop) and ``large_mis_grad`` (R-OMIS direct on the 5x5 torus field
     with its BVH: kernels 18 and 20; its plain comparison at 480x270 on
     injected noise), each with the ms and the peak device memory of its
     Philox step and of the plain step.
   Every pixel is finite, the last images' means (the losses) agree within
   2 %, the launch counters rose by exactly the per-frame (per-step) counts
   in PATHS, and every gradient leaf is finite, reaches the image where it
   should, and agrees with the plain run's within GRAD_REL of its largest
   element. The last config-5 image goes to ``build/chip_smoke_frame.png``,
   the R-OMIS one to ``build/chip_smoke_romis.png``.
5. Timing with CUDA events: ms/frame of each path through the kernels and
   the plain versions (a gradient step beside its forward-only frame, with
   the peak device memory of a step), and each kernel beside its plain
   version, its bound (the larger of the bytes it must move over 3.35 TB/s
   and its float32 operations over 67 TFLOP/s, special functions, Philox
   and divisions at their instruction cost, from this run's shapes) and,
   where one PyTorch call computes the same function, that call; then
   ``torch.profiler`` over 3 R-OMIS frames, the 4 animated frames, the 2
   animated frames of the one-torus soup, a
   large config-5 frame, a large R-OMIS frame, the three vis-check
   paths and one step of each whole-frame MIS gradient path after a
   warm-up step, and one band of the banded step (the step at 1920x135 in
   one band, timed by events too) (device busy and idle share, kernels per
   frame, the top kernels by device time). Kernel 17 is
   timed in its four frame modes (R-OMIS, progressive, equal, balance) on
   the flagship and in its ext_vis R-OMIS on the torus field, each printed
   beside its own bound (the table's row is R-OMIS). Kernel 7 is
   timed on the Z rays of the 1080p vis-check pass on the one-torus soup
   (its blocks built beforehand, as once a soup; the build is timed
   alone), its plain version at 480x270. Its table bound counts the tests
   that the cull needs on the same rays, those of the walk with the box
   alone deciding (``ops.trace.zcount_occ_culled`` with ``guard=False``,
   the plain model of the kernel's cull): BOX_OPS a box test, MT_RAY_OPS a
   triangle test, MT_ORIGIN_OPS an origin set-up, SHADOW_OPS and three
   reciprocals a traced ray. The near-parallel guard that keeps the
   kernel's cull exact is counted apart (GUARD_OPS, GUARD_CONE_OPS and
   GUARD_TRI_OPS, from the guarded model's counts) and printed on a line
   of its own; a second bound, printed beside the first, counts the plain
   version's tests up to each ray's first hit (the yardstick of the
   unculled designs).
   Kernel 7 is also held to its plain version on random, grazing, edge-on
   and edge-crossing rays (``hard_z_rays``), where the guard decides, and
   kernel 17 at D = 4 as well as 5. Kernel 16's bound counts the work of
   its filtered race on this run's Philox stream in SIMILAR
   (``filtered_race``): each cell's Philox word and key test, the gates of
   the cells it gates (SEL_GATE_OPS, and DIV_OPS where the depth gate's
   products leave the bool to the division), the logarithms of the cells
   it scores. Kernel 11's counts its planes in and out; its records'
   traffic is printed on its sector line. The BVH kernels' bound counts the box
   and triangle tests that the plain traversal made on the same rays and
   tree (BOX_OPS and MT_OPS each, and each ray's three reciprocals).
   Kernels 6 and 8 are timed side by side on the torus soup's 1080p shadow
   rays, the 2048-soup's and the flagship's, each beside two bounds: the
   tests its cull needs (the box alone deciding, ``ops.trace``'s
   ``any_hit_culled`` and ``any_hit_plucker_culled`` with ``guard=False``:
   BOX_OPS a box test, MT_OPS or PLUCKER_OPS a triangle test, a segment's
   three reciprocals and kernel 8's set-up; the guards' operations
   printed apart) and the full scan's, the plain version's tests up to
   each segment's first occluder; the table's rows are the flagship's for
   kernel 6 and the torus soup's for kernel 8. Kernel 8's constants are
   kept with the soup (``ops.trace.plucker_blocks``): their build, at a
   soup's first call, is timed apart. ``torch.matmul`` of the [5T, 16]
   constants by the [16, N] rays is kernel 8's library column, labelled
   "product only" (it computes no sign test); kernel 12 on its Philox
   stream, with one advanced-indexing gather at the clamped coordinates as
   the library call. Kernels 3 and 14 are
   also timed on Philox, the mode of every frame and step, each beside its
   Philox bound (no uniform planes read; a Philox4x32-10 call and four
   uniforms a candidate, the replay a second call for its fifth uniform);
   the table's rows keep their injected-uniform times and bounds. Kernel
   13 is timed on every table of ``scatter_tables``, each beside its bound
   and ``index_add_`` (the table's row is the light table). Kernel 4's
   bound counts the planes it reads (16 float planes and a byte plane of
   context, 7K of reservoir) and writes (3); on the one-torus soup (the
   vischeck_torus frame's receivers, K = 2) it is timed beside the culled
   walk's bound (the box-alone walk's tests on the lanes it traces,
   ``ops.trace.any_hit_culled`` with ``guard=False``; the guard's
   operations printed apart) and the full scan's (the plain any-hit's
   tests up to each ray's first occluder). Kernel 1 is timed on the same
   soup's primary rays beside its bound, the culled walk's box, guard and
   triangle tests (``ops.trace.closest_hit_culled``, its plain model, bit
   for bit the plain scan's), and the full scan's. Kernels 18's and 19's
   bounds count the fewer tests of two walks that give the same answer:
   their own walks on the two-box records and the plain walk (both
   printed). Kernel 9's row in the table is the gather route's 39
   planes at D = 5; its bound, the planes read once, the outputs written
   once and the offsets read once. Kernel 5's bound counts what its
   Philox stream needs (``pass_work``: the offsets drawn as the kernel
   draws them, the races of the neighbours that pass the gates, a missed
   receiver's one draw) and the planes in and out; its records' bytes are
   printed apart. Both are printed beside their earlier designs' bounds.

6. The row bands of ``parallel/`` in one process (``band_phase``): config
   5, the vis-check frame (kernel 11), the animated frames (reprojection's
   16-row halo), R-MIS balance, progressive R-OMIS and ``large_romis`` (the
   torus field's BVH, ext_vis) at 1920x1080, each rendered whole and as 2
   and as 4 row bands through the kernels' band entries, each band's halo
   exchange replaced by slices of the whole frame's own tensors (recorded
   from the frame rendered as one band): the reassembled images and carry
   bit-equal to ``render_frame``'s, each kernel of the path launched by the
   bands, the sum of the bands' ms beside the whole frame's by CUDA events.
   Then each band entry of kernels 3, 15, 5, 11, 16 and 17 on an inner band
   of 4 and the bottom band of 2, against its plain version at the band's
   shape (BAND_RTOL, BAND_ATOL; kernel 16 bit-exact; kernel 17 MIS_REL)
   and on its Philox stream against the whole frame's kernel's rows, bit
   for bit, each timed beside a quarter of the whole frame's.
7. A real NCCL process group (``group_phase``): one rank in this process
   through a ``file://`` store, ``render_frame_sharded`` and
   ``render_romis_sharded`` bit-equal to ``render_frame``; with two or more
   cards two ranks, one a card (``torch.multiprocessing``), held to the
   same and the halo exchange of a pass's reservoir planes timed (and four
   ranks with four cards); with one card a line says that it was skipped.
   ``python3 chip_smoke.py --bands`` runs sections 1, 2, 6 and 7 alone,
   ``--group`` sections 1, 2 and 7.
8. The sharded training steps (``shard_grad_phase``): kernel 14's band
   entry (``romis_ris_replay_band``) on an inner band of 4 and the bottom
   band of 2 against its plain version (BAND_RTOL) and the whole frame's
   kernel's rows (bit for bit), timed beside a quarter of the whole
   frame's; through an NCCL group of one rank, at 1920x1080 on the
   flagship, ``make_sharded_train_step`` with grad_surrogate's and
   grad_per_pixel's features (2 steps each) and
   ``make_sharded_mis_train_step`` in R-MIS balance and R-OMIS direct (1
   step each), their images bit-equal to the single-device step's, loss
   and leaves within SHARD_SPREAD times the single-device step's own spread
   between two runs (at least SHARD_REL), launches asserted (PATHS), ms and
   peak memory a step; the same steps as 2 and 4 bands in one process, the
   MIS steps at SHARD_MIS_H rows, each band's exchange replayed
   differentiably from the whole step's tensors (``grad_halo_replay``):
   the bands' gradients sum to the whole step's; with two or more cards
   NCCL groups of 2 and 4 ranks, one a card (``shard_rank``), held to the
   same, with each rank's ms and peak memory a step and the share of an
   instrumented step spent in the halo exchanges and the all_reduce; with
   one card a line says that they were skipped. ``--shard-grad`` runs
   sections 1, 2 and 8 alone.

Any failed check raises, so the exit code is non-zero. The last line is
``{"ok": true, "device": {...}}``; the line before it is the kernel table.
"""

from __future__ import annotations

import json
import math
from dataclasses import replace
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H, W = 1080, 1920
SOUP_TRIS = 2048
PAN_DEG = 0.12  # camera turn per animated frame (~4 px at 1080p, fov 30°)

# Tolerances (kernel vs plain version on the same inputs).
MIN_AGREE = 0.9999  # share of pixels / lanes that must agree
RIS_W_SUM_RTOL = 1e-5
RIS_BIG_W_RTOL = 1e-4
SHADE_RTOL, SHADE_ATOL = 2e-4, 1e-5
# Spatial passes: the plain w_sum and M are PyTorch reductions over the
# R+1 streams, whose order of addition on the card may differ from the
# kernel's sequential sum.
PASS_W_SUM_RTOL = 1e-5
PASS_M_RTOL = 1e-6
PASS_BIG_W_RTOL = 1e-4
PHILOX_REL = 0.01  # Philox stream vs torch.rand stream, over the frame
FRAME_REL = 0.02  # last-frame mean, kernels vs plain versions
# Row scatter-add vs index_add_, per (row, component), relative to the sum
# of |contributions| there: both add float32 in no fixed order, and the
# plain version adds up to 2 M terms one by one into the same cell.
SCATTER_REL = 1e-3
SCATTER_F64_REL = 1e-4  # the kernel against a float64 index_add_
HALO_SCATTER_REL = 1e-5  # a few terms per cell, in another order
GRAD_REL = 1e-2  # gradient leaves, kernels vs plain, of the leaf's max |g|
# MIS sweep vs its plain version, per output plane, of the plane's largest
# |value|: the same operations in the same order (--fmad=false); what may
# differ is powf/sqrt between CUDA's libdevice and PyTorch's kernels.
MIS_REL = 1e-5
SHARE_ABS = 0.01  # preferred-class share of picks, Philox vs plain stream
# The Philox selection's histogram of picks over (class, box offset) may be
# at most this many times as far (total variation) from the plain stream's
# as two plain streams of different seeds are from each other, measured in
# the same run.
PICKS_SPREAD = 3.0

# The bound of a kernel (H100 SXM datasheet peaks at 700 W): the bytes it
# must move once over HBM3, and its operations over the float32 peak
# outside the tensor cores. That peak counts an FMA as 2 operations on the
# 128 float lanes an SM has each clock; a float add, multiply or compare
# is counted as 1. Other instructions are counted at their throughput cost
# in the same currency: the special-function unit (rcp, rsqrt, lg2, ex2,
# int-float conversion) has 16 lanes an SM, 1/8 of the FMA rate, so 16
# each; the 32-bit integer pipe 64 lanes, so 4 each. The libdevice
# sequences the kernels compile to (no fast math) are estimates from their
# instructions, not measurements:
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
SFU_OPS, INT_OPS = 16, 4
DIV_OPS = SFU_OPS + 10  # IEEE division: rcp, a Newton step, the rounding
SQRT_OPS = SFU_OPS + 8  # IEEE sqrtf: rsqrt, the product, its correction
LOG_OPS = 40  # logf: integer range reduction and a degree-8 polynomial
POW_OPS = 2 * LOG_OPS + SFU_OPS + 24  # powf: extended log2, ex2, cases
PHILOX_OPS = 10 * 8 * INT_OPS  # one Philox4x32-10 call (4 words): a round
#   is 2 wide multiplies (4 instructions), 2 three-way xors, 2 key adds
UNIFORM_OPS = SFU_OPS + 2  # 24 bits to a float in [0, 1)
DRAW_OPS = PHILOX_OPS + 4 * UNIFORM_OPS  # one call's 4 uniforms
GUMBEL_OPS = UNIFORM_OPS + 2 * LOG_OPS  # -log(-log u) of one word
MT_OPS = 40 + DIV_OPS  # one Moller-Trumbore ray-triangle test
PHONG_OPS = 70 + 3 * SQRT_OPS + 3 * DIV_OPS + POW_OPS  # Phong, p-hat norm
CANDIDATE_OPS = 60 + SFU_OPS + PHONG_OPS + LOG_OPS + DIV_OPS  # one RIS
#   candidate: light pick, point, colour, p-hat, exponential race
RACE_OPS = LOG_OPS + DIV_OPS  # the replay's second race
STREAM_OPS = DRAW_OPS + 2 * GUMBEL_OPS + DIV_OPS  # one spatial-pass
#   stream's Philox offsets and race noise (K = 2), its depth gate
GATE_OPS = 14 + DIV_OPS  # one box cell of the selection: gates, race test
SEL_GATE_OPS = 17  # one gated cell of the filtered race: the geometry
#   compare, the depth's max, two products and four compares (the depth
#   gate where they decide it; DIV_OPS more where they do not), the normal's
#   dot product and compare, the class select
KEY_OPS = 3 * INT_OPS  # the filtered race's key: shift, compare, select
VIEW_OPS = 10 + SQRT_OPS + DIV_OPS  # a unit view vector (kernel 11's record)
COLVEC_OPS = 10 + 2 * DIV_OPS  # one technique's mock weight, reciprocal
SHADOW_OPS = 20 + SQRT_OPS + 3 * DIV_OPS  # one shadow ray's set-up
BOX_OPS = 22  # one slab test: 6 subtractions, 6 multiplies, 10 min/max
# Kernel 7's division-free Moller-Trumbore, MT_OPS without its division
# split in two: the origin's terms (tvec, qvec, e2.qvec) once per (origin,
# triangle), and each ray's (pvec, det, the three scaled numerators, det^2,
# the two window products and six compares).
MT_ORIGIN_OPS = 17
MT_RAY_OPS = 37
# Kernel 7's near-parallel guard where a box test fails: the reach bound
# (3 subtractions, 3 absolutes, 4 adds, a compare), then a 3-term product
# and two compares for each cone of a pair of triangles, a 3-term product
# and a compare for each normal tried.
GUARD_OPS, GUARD_CONE_OPS, GUARD_TRI_OPS = 11, 8, 7
# Kernel 8: the non-zero terms of the five products (three 6-term edge
# sides, the 4-term plane value, the 3-term n.D: a multiply a term and an
# add between terms) and the sign test (6 compares, the straddle's add,
# multiply and compare, 2 logic) per ray-triangle test; D and M = p0 x D
# once per ray.
PLUCKER_OPS = 3 * 11 + 7 + 5 + 11
PLUCKER_RAY_OPS = 12
# Kernel 8's guard where a box test fails (ops.trace._plucker_keeps): the
# range checks, l0, the box rule's reach, the line's distance delta (a
# cross product and its norm) and the line rule's reach with its division;
# its pairs' cones and normals as kernel 7's (GUARD_CONE_OPS,
# GUARD_TRI_OPS).
PLUCKER_GUARD_OPS = 40 + SQRT_OPS + DIV_OPS
PLUCKER_MT_SHARE = 1e-3  # kernel 8 vs kernel 6, the reference's budget
MATMUL_CHUNK = 1 << 18  # rays per torch.matmul of the "product only" call
COORD = 4096  # kernel 12's coordinate plane y·4096 + x, exact in float32
NBR_SHARE_REL = 0.01  # each offset value's share, relative to 1/(2r+1)
LARGE_N, LARGE_TRIS = 5, 24202  # the torus field: n x n tori of 968
LH, LW = 270, 480  # the large MIS paths' plain comparison
SKY_PLANES = 17  # kernel 19's many-plane case (above the K-ray walk's 16)
TORUS_CAM = dict(look_at=(0.0, -0.3, 0.0), rotation_deg=(25.0, 30.0, 0.0),
                 distance=4.0, fov_deg=50.0)  # frames the one-torus field

KERNELS = ("closest_hit", "gather_rows", "ris", "final_shade",
           "spatial_pass", "spatial_pass_unbiased", "halo_gather", "any_hit",
           "scatter_rows_add", "halo_scatter", "ris_replay",
           "neighbour_select", "mis_ris", "mis_iteration", "bvh_closest_hit",
           "bvh_any_hit", "bvh_any_hit_k", "bvh_final_shade", "zcount_occ",
           "any_hit_plucker", "neighbour_gather", "ris_replay_band")
SOURCES = {
    "closest_hit": ("romis_tpu_torch/csrc/trace.cu",
                    "romis_tpu/ops/pallas_trace.py:465"),
    "gather_rows": ("romis_tpu_torch/csrc/rows.cu",
                    "romis_tpu/ops/pallas_rows.py:83"),
    "ris": ("romis_tpu_torch/csrc/ris.cu",
            "romis_tpu/ops/pallas_ris.py:473"),
    "final_shade": ("romis_tpu_torch/csrc/shade.cu",
                    "romis_tpu/ops/pallas_shade.py:236"),
    "spatial_pass": ("romis_tpu_torch/csrc/spatial.cu",
                     "romis_tpu/ops/pallas_spatial.py:1151"),
    "spatial_pass_unbiased": ("romis_tpu_torch/csrc/spatial.cu",
                              "romis_tpu/ops/pallas_spatial.py:995"),
    "halo_gather": ("romis_tpu_torch/csrc/halo.cu",
                    "romis_tpu/ops/pallas_spatial.py:283"),
    "any_hit": ("romis_tpu_torch/csrc/any.cu",
                "romis_tpu/ops/pallas_trace.py:506"),
    "scatter_rows_add": ("romis_tpu_torch/csrc/scatter.cu",
                         "romis_tpu/ops/pallas_scatter.py:77"),
    "halo_scatter": ("romis_tpu_torch/csrc/halo.cu",
                     "romis_tpu/ops/pallas_spatial.py:403"),
    "ris_replay": ("romis_tpu_torch/csrc/ris.cu",
                   "romis_tpu/ops/pallas_ris.py:625"),
    "neighbour_select": ("romis_tpu_torch/csrc/nbrsel.cu",
                         "romis_tpu/ops/pallas_nbrsel.py:184"),
    "mis_ris": ("romis_tpu_torch/csrc/ris.cu",
                "romis_tpu/ops/pallas_ris.py:553"),
    "mis_iteration": ("romis_tpu_torch/csrc/mis.cu",
                      "romis_tpu/ops/pallas_mis.py:491"),
    "bvh_closest_hit": ("romis_tpu_torch/csrc/walk.cu",
                        "romis_tpu/ops/pallas_bvh.py:304"),
    "bvh_any_hit": ("romis_tpu_torch/csrc/walk.cu",
                    "romis_tpu/ops/pallas_bvh.py:356"),
    "bvh_any_hit_k": ("romis_tpu_torch/csrc/walk.cu",
                      "romis_tpu/ops/pallas_bvh.py:427"),
    "bvh_final_shade": ("romis_tpu_torch/csrc/shade.cu",
                        "romis_tpu/ops/pallas_shade.py:275"),
    "zcount_occ": ("romis_tpu_torch/csrc/zcount.cu",
                   "romis_tpu/ops/pallas_trace.py:665"),
    "any_hit_plucker": ("romis_tpu_torch/csrc/plucker.cu",
                        "romis_tpu/ops/pallas_trace.py:371"),
    "neighbour_gather": ("romis_tpu_torch/csrc/nbrgather.cu",
                         "romis_tpu/ops/pallas_spatial.py:145"),
    # Kernel 14's band entry (romis_ris_replay_band), the sharded steps'.
    "ris_replay_band": ("romis_tpu_torch/csrc/ris.cu",
                        "romis_tpu/ops/pallas_ris.py:625"),
}
# Launches per frame (per gradient step) of each main path. A gradient
# step's row gathers: hit attributes and materials, the closest hit's
# re-evaluation, the RIS tail's two races, and two replays per spatial
# pass; a scatter for each of them whose table needs a gradient (all but
# the attributes). The any-hit runs in the final shade's backward; the
# per-pixel path adds two halo gathers per pass, one (big_w) with a
# scatter.
PATHS = {
    "slice1": {"closest_hit": 1, "gather_rows": 2, "ris": 1,
               "final_shade": 1},
    "config5": {"closest_hit": 1, "gather_rows": 2, "ris": 1,
                "spatial_pass": 2, "final_shade": 1},
    "animated": {"closest_hit": 1, "gather_rows": 2, "ris": 1, "any_hit": 1,
                 "halo_gather": 1, "spatial_pass_unbiased": 2,
                 "final_shade": 1},
    # The animated features on the one-torus soup (vischeck_torus's):
    # kernels 1, 6 and 4 on a culled soup of 970 triangles.
    "animated_torus": {"closest_hit": 1, "gather_rows": 2, "ris": 1,
                       "any_hit": 1, "halo_gather": 1,
                       "spatial_pass_unbiased": 2, "final_shade": 1},
    "grad_surrogate": {"closest_hit": 1, "gather_rows": 9, "ris_replay": 1,
                       "final_shade": 1, "any_hit": 1,
                       "scatter_rows_add": 8},
    "grad_per_pixel": {"closest_hit": 1, "gather_rows": 9, "ris_replay": 1,
                       "final_shade": 1, "any_hit": 1,
                       "scatter_rows_add": 8, "halo_gather": 4,
                       "halo_scatter": 2},
}
_MIS = {"closest_hit": 1, "gather_rows": 2, "neighbour_select": 1,
        "mis_ris": 1, "mis_iteration": 5}
PATHS.update({  # 5 iterations; the neighbours' contexts: one halo gather
    "romis": dict(_MIS, halo_gather=1),
    "romis_progressive": dict(_MIS, halo_gather=1),
    "rmis_equal": _MIS,
    "rmis_balance": dict(_MIS, halo_gather=1),
})
# The large paths: the BVH closest hit and final shade instead of the soup
# kernels 1 and 4 (which no large path launches); the initial check's K = 2
# shadow rays per pixel take the shared walk (kernel 20), K = 1 the per-ray
# walk (kernel 19); the MIS sweeps' ext_vis planes take a halo gather of the
# iteration's sample positions and a 12-ray shared walk each.
_LARGE = {"bvh_closest_hit": 1, "gather_rows": 2, "bvh_final_shade": 1}
_LARGE_MIS = {"bvh_closest_hit": 1, "gather_rows": 2, "neighbour_select": 1,
              "mis_ris": 1, "mis_iteration": 5, "bvh_any_hit_k": 5}
PATHS.update({
    "large_config5": dict(_LARGE, ris=1, spatial_pass=2),
    "large_animated": dict(_LARGE, ris=1, bvh_any_hit_k=1, halo_gather=1,
                           spatial_pass_unbiased=2),
    "large_k1": dict(_LARGE, ris=1, bvh_any_hit=1, spatial_pass=2),
    "large_romis": dict(_LARGE_MIS, halo_gather=6),
    "large_rmis_equal": dict(_LARGE_MIS, halo_gather=5),
})
# Slice 6: the gather route (a halo gather per pass, no pass kernel), the
# unshaded frame, and the vis-check frames, whose 2 unbiased passes each
# trace their Z rays: kernel 7 on a soup, the K-ray walk (12 rays a pixel)
# on the BVH; the CLI renders the large vis-check frame from its OBJ.
_VIS = dict(ris=1, spatial_pass_unbiased=2)
PATHS.update({
    "config5_gather": {"closest_hit": 1, "gather_rows": 2, "ris": 1,
                       "halo_gather": 2, "final_shade": 1},
    "unshaded": PATHS["config5"],
    "vischeck": {"closest_hit": 1, "gather_rows": 2, "final_shade": 1,
                 "zcount_occ": 2, **_VIS},
    "vischeck_torus": {"closest_hit": 1, "gather_rows": 2, "final_shade": 1,
                       "zcount_occ": 2, **_VIS},
    "large_vischeck": dict(_LARGE, bvh_any_hit_k=2, **_VIS),
    "cli": dict(_LARGE, bvh_any_hit_k=2, **_VIS),
})
# Slice 7: the gradient step on the BVH field (kernels 18 and 21 forward,
# the shade backward's shadow rays through the K-ray walk 20), and the op
# paths of kernels 8 and 12, one launch a call.
PATHS.update({
    "large_grad": {"bvh_closest_hit": 1, "gather_rows": 9, "ris_replay": 1,
                   "bvh_final_shade": 1, "bvh_any_hit_k": 1,
                   "scatter_rows_add": 8},
    "plucker_op": {"any_hit_plucker": 1},
    "neighbour_gather_op": {"neighbour_gather": 1},
})
# The MIS gradient steps (``mis_grad_fn``). Each iteration runs
# under a checkpoint whose backward recomputes it, so a kernel in an
# iteration launches twice an iteration a step: the replay RIS, its two
# light-row gathers and the records' one, the records' and the stats' halo
# gathers, the D1·K shadow rays; the backward kernels once: the three
# light-row scatters, the stats' halo scatter. Once a step: the closest hit
# and its re-evaluation's row gather, the attribute and material rows, the
# scatters of the triangle and material rows, the selection, the
# neighbours' contexts' halo gather and scatter. The banded step checkpoints
# each of its MIS_BANDS bands, and each iteration of a band again inside
# it: a band's contexts' gather runs twice (forward, the band's recompute),
# an iteration's stats gather and shadow rays three times (forward, the
# band's recompute, its own), but for the last iteration, which the band's
# recompute stops short of (its last saved tensor is the α solve before
# it: torch.utils.checkpoint's early stop); their scatters once. Its RIS is
# the plain candidate loop.
MIS_BANDS = 8
_MIS_IT = 5  # the reference's max_iterations_mis
_BAND_IT = 3 * _MIS_IT - 1  # an iteration body's runs a band, a step
_MIS_GRAD = {"closest_hit": 1, "gather_rows": 3 + 3 * 2 * _MIS_IT,
             "scatter_rows_add": 2 + 3 * _MIS_IT, "neighbour_select": 1,
             "ris_replay": 2 * _MIS_IT, "halo_gather": 1 + 2 * 2 * _MIS_IT,
             "halo_scatter": 1 + _MIS_IT, "any_hit": 2 * _MIS_IT}
PATHS.update({
    "mis_grad_rmis": _MIS_GRAD,
    "mis_grad_romis": _MIS_GRAD,
    "mis_grad_banded": {
        "closest_hit": 1, "gather_rows": 3, "scatter_rows_add": 2,
        "neighbour_select": 1,
        "halo_gather": MIS_BANDS * (2 + _BAND_IT),
        "halo_scatter": MIS_BANDS * (1 + _MIS_IT),
        "any_hit": MIS_BANDS * _BAND_IT},
    # The BVH walks instead of kernels 1 and 6: 12 shadow rays a pixel take
    # the K-ray walk (kernel 20).
    "large_mis_grad": {**{n: c for n, c in _MIS_GRAD.items()
                          if n not in ("closest_hit", "any_hit")},
                       "bvh_closest_hit": 1, "bvh_any_hit_k": 2 * _MIS_IT},
})
# The sharded training steps (section 8) on a group of one rank: the
# whole-frame steps' kernels, kernel 14 through its band entry.
def _on_band(counts: dict) -> dict:
    out = dict(counts)
    out["ris_replay_band"] = out.pop("ris_replay")
    return out


PATHS.update({
    "shard_grad_surrogate": _on_band(PATHS["grad_surrogate"]),
    "shard_grad_per_pixel": _on_band(PATHS["grad_per_pixel"]),
    "shard_mis_rmis": _on_band(_MIS_GRAD),
    "shard_mis_romis": _on_band(_MIS_GRAD),
})
FRAMES = {"slice1": 2, "config5": 4, "animated": 4, "animated_torus": 2,
          "grad_surrogate": 2,
          "grad_per_pixel": 2, "romis": 2, "romis_progressive": 2,
          "rmis_equal": 2, "rmis_balance": 2, "large_config5": 2,
          "large_animated": 2, "large_k1": 2, "large_romis": 2,
          "large_rmis_equal": 2, "config5_gather": 2, "unshaded": 2,
          "vischeck": 2, "vischeck_torus": 2, "large_vischeck": 2, "cli": 4,
          "large_grad": 2, "plucker_op": 2, "neighbour_gather_op": 2,
          "mis_grad_rmis": 2, "mis_grad_romis": 2, "mis_grad_banded": 2,
          "large_mis_grad": 2, "shard_grad_surrogate": 2,
          "shard_grad_per_pixel": 2, "shard_mis_rmis": 1,
          "shard_mis_romis": 1}
GRAD_PATHS = ("grad_surrogate", "grad_per_pixel", "large_grad")
MIS_GRAD_PATHS = ("mis_grad_rmis", "mis_grad_romis", "mis_grad_banded",
                  "large_mis_grad")
OP_PATHS = ("plucker_op", "neighbour_gather_op")
MIS_PATHS = ("romis", "romis_progressive", "rmis_equal", "rmis_balance",
             "large_romis", "large_rmis_equal")
# ReSTIR paths whose plain run is at LH x LW on injected noise.
SMALL_PLAIN = ("vischeck_torus", "large_vischeck", "animated_torus")


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


def bound(n_bytes: float, n_ops: float):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scatter_tables(torch, gen, scene, tri, k: int, prefix: str = ""):
    """Kernel 13's tables in a gradient step on ``scene`` at the shape of
    ``tri``, the closest-hit triangles [H, W] (-1 on a miss), each (ct,
    idx, n_rows): the light table (the re-evaluations' K lanes of uniform
    picks, C = 24), the material table at the hit pixels' materials
    (C = 8), the packed v0|e1|e2 triangle table at the hit triangles
    (C = 9), and a table of the attribute rows' width (C = 24) at the same
    indices, which the step gathers without a gradient."""
    geo = scene.geometry
    dev = tri.device
    h, w = tri.shape
    hit = tri.clamp_min(0)
    mat = torch.where(tri >= 0, geo.attr_rows[hit.long(), 15].int(), 0)
    n_tris = geo.v0.shape[0]

    def ct(c, *lead):
        return torch.randn((c, *lead, h, w), generator=gen, device=dev)

    return {
        f"{prefix}lights": (ct(24, k), torch.randint(
            0, scene.num_lights, (k, h, w), generator=gen, device=dev,
            dtype=torch.int32), scene.lights.rows.shape[0]),
        f"{prefix}material": (ct(8), mat, geo.mat_rows.shape[0]),
        f"{prefix}triangles": (ct(9), hit, n_tris),
        f"{prefix}attributes": (ct(24), hit, n_tris),
    }


def scatter_rel(torch, out, ct, idx, n_rows):
    """(max error over the summed |ct| against the plain version, and
    against a float64 index_add_), per (row, component)."""
    from romis_tpu_torch.ops.scatter import scatter_rows_add_plain

    o_p = scatter_rows_add_plain(ct, idx, n_rows)
    o_64 = torch.zeros((n_rows, ct.shape[0]), dtype=torch.float64,
                       device=ct.device).index_add_(
        0, idx.reshape(-1).long().clamp(0, n_rows - 1),
        ct.reshape(ct.shape[0], -1).t().double())
    mag = scatter_rows_add_plain(ct.abs(), idx,
                                 n_rows).double().clamp_min(1e-30)
    return (((out - o_p).abs() / mag).max().item(),
            ((out.double() - o_64).abs() / mag).max().item())


def scatter_bound(ct, idx, n_rows):
    """Kernel 13's bound: the cotangents and indices read once, the table
    written once, an add a cotangent."""
    return bound(ct.numel() * 4 + idx.numel() * 4 + n_rows * ct.shape[0] * 4,
                 ct.numel())


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


HARD_RAY_KINDS = ("random", "grazing", "edge_on", "edge")


def hard_z_rays(rng, kind, cols, r1=3, k=2, h=6, w=16):
    """Z rays where kernel 7's cull is hardest, from a soup's columns
    [10, T] (numpy) → float32 origins [R+1, 3, H, W] and targets
    [K, 3, H, W]: ``random`` in the scene's box; ``grazing`` and
    ``edge_on`` through a point P of a random triangle's plane near it,
    along an in-plane direction, the ends ±delta off the plane (delta from
    1e-7 to 1e-3, or 0); ``edge`` through a point on a random triangle's
    edge or vertex."""
    import numpy as np

    act = np.flatnonzero(cols[9] > 0.0)
    if kind == "random":
        lo = cols[0:3, act].min(axis=1) - 0.3
        hi = cols[0:3, act].max(axis=1) + 0.3
        o = rng.uniform(lo[None, :, None, None], hi[None, :, None, None],
                        (r1, 3, h, w))
        t = rng.uniform(lo[None, :, None, None], hi[None, :, None, None],
                        (k, 3, h, w))
        return o.astype(np.float32), t.astype(np.float32)
    j = rng.choice(act, (h, w))
    v0, e1, e2 = (cols[3 * i:3 * i + 3, j] for i in range(3))  # [3, h, w]
    if kind == "edge":
        a = rng.choice([0.0, 1.0, rng.uniform()], (h, w))
        on_e2 = rng.uniform(size=(h, w)) < 0.5
        p = v0 + np.where(on_e2, a * e2, a * e1)
        d = rng.normal(size=(3, h, w))
        u = d / np.linalg.norm(d, axis=0)
        nrm = np.zeros_like(u)
        delta = np.zeros((h, w))
    else:
        a, b = rng.uniform(-0.5, 1.5, (2, h, w))
        p = v0 + a * e1 + b * e2
        nrm = np.cross(e1, e2, axis=0)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=0), 1e-12)
        u = rng.normal(size=(3, h, w))
        u -= (u * nrm).sum(axis=0) * nrm  # in the plane
        u /= np.maximum(np.linalg.norm(u, axis=0), 1e-12)
        delta = (np.zeros((h, w)) if kind == "edge_on" else
                 10.0 ** rng.uniform(-7, -3, (h, w)))
    s_o = rng.uniform(0.2, 2.0, (r1, 1, h, w))
    s_t = rng.uniform(0.2, 2.0, (k, 1, h, w))
    o = p[None] - s_o * u[None] + delta * nrm[None]
    t = p[None] + s_t * u[None] - delta * nrm[None]
    return o.astype(np.float32), t.astype(np.float32)


def seg_rays(torch, origins, targets):
    """``hard_z_rays``' origins [1, 3, H, W] and targets [K, 3, H, W] →
    the K segments between them: (origins, unit directions, t_max), [K,
    ...] contiguous."""
    to = targets - origins[0]
    dist = torch.linalg.vector_norm(to, dim=1)
    return (origins[0].expand(to.shape).contiguous(),
            (to / dist.clamp_min(1e-20)[:, None]).contiguous(),
            dist.contiguous())


# Offsets of moved_soup: where kernel 8's Plucker sides round the most.
MOVED_OFFSETS = (100.0, 1000.0)


def moved_soup(offset: float):
    """A SubMesh of 300 small random triangles (~0.04 across, in a box of
    0.12) moved ``offset`` units from the origin along (1, 0.5, -1): its
    Plucker sides carry rounding far beyond the blocks' growth, which
    kernel 8's guard must cover (``ops.trace.any_hit_plucker_culled``)."""
    import numpy as np

    mesh = random_soup(300, (0.0, 0.0, 0.0), 0.6, seed=5)
    mesh.positions[:] = mesh.positions * 0.1 + np.float32(offset) * np.asarray(
        [1.0, 0.5, -1.0], np.float32)
    return mesh


def box_segments(torch, geometry, rng, planes, h, w, pad):
    """Segments between random points of the soup's box grown by ``pad``:
    (origins [planes, 3, h, w], unit directions, t_max [planes, h, w]) on
    the geometry's device."""
    cols = geometry.tri_cols.cpu().numpy()
    act = cols[9] > 0.0
    lo = cols[0:3, act].min(axis=1) - pad
    hi = cols[0:3, act].max(axis=1) + pad
    a, b = (torch.from_numpy(rng.uniform(
        lo[None, :, None, None], hi[None, :, None, None],
        (planes, 3, h, w)).astype("float32")).to(geometry.tri_cols.device)
        for _ in range(2))
    to = b - a
    dist = torch.linalg.vector_norm(to, dim=1)
    return (a.contiguous(), (to / dist.clamp_min(1e-20)[:, None]).contiguous(),
            dist.contiguous())


def hard_shade_inputs(torch, position, targets):
    """Receivers at ``position`` [3, H, W] and K samples at ``targets``
    [K, 3, H, W] (``hard_z_rays``' origin and targets) → (ShadeCtx,
    Reservoirs) for the final shade: every receiver valid and facing its
    first sample, unit colours and W, its shadow rays the segments' own."""
    from romis_tpu_torch.core.types import Reservoirs, ShadeCtx

    h, w = position.shape[-2:]
    k = targets.shape[0]
    to = targets[0] - position
    nrm = to / torch.linalg.vector_norm(to, dim=0).clamp_min(1e-20)
    one = torch.ones((h, w), device=position.device)
    ctx = ShadeCtx(valid=one > 0, position=position.contiguous(), normal=nrm,
                   view_origin=position + nrm, kd=one.expand(3, h, w) * 0.5,
                   ks=one.expand(3, h, w) * 0.2, shininess=one * 10.0,
                   geom_id=torch.zeros((h, w), dtype=torch.int32,
                                       device=position.device),
                   depth_t=one)
    lane = torch.ones((k, h, w), device=position.device)
    res = Reservoirs(pos=targets.contiguous(),
                     color=torch.ones((k, 3, h, w), device=position.device),
                     w_sum=lane, m=lane, big_w=lane, chosen_w=lane)
    return ctx, res


# Kernel 9's frame shapes (PERF.md row 9): label → launches over the
# frame and step paths (PATHS x FRAMES). The MIS gradient steps' gathers
# count with the shapes they share: their records' (5 x 6) with
# mis_ext_vis's, R-MIS's big_w (5 x 2) with grad_per_pixel's, their
# contexts' with resolve_neighbour_ctx's; the banded step's at any band
# with the band it is checked on.
HALO_FRAME_LAUNCHES = {
    "reprojection 1x25, camera shift": 8,
    "config5_gather 5x39, random +-10": 4,
    "grad_per_pixel 5x45, random +-10": 4,
    "grad_per_pixel big_w 5x2, random +-10": 24,
    "resolve_neighbour_ctx 5x14, selected": 14,
    "mis_ext_vis 5x6, selected": 80,
    "R-OMIS w_sum | chosen 5x4, selected": 40,
    "banded contexts 5x14, band 0 rows": 32,
    "banded reservoirs 5x16, band 3 rows": 224,
}
# The shapes at which a gradient step also scatters (kernel 10 is held
# against its plain version on each, with the same offsets).
HALO_SCATTERED = ("grad_per_pixel big_w 5x2, random +-10",
                  "resolve_neighbour_ctx 5x14, selected",
                  "R-OMIS w_sum | chosen 5x4, selected",
                  "banded contexts 5x14, band 0 rows",
                  "banded reservoirs 5x16, band 3 rows")


def halo_cases(torch, gen, ctx, res, feats, pan_cam):
    """Kernel 9's inputs at the frames' shapes, on a 1080p frame's context
    ``ctx`` and reservoirs ``res`` (K = 2) → label (``HALO_FRAME_LAUNCHES``)
    → (planes [C, H, W], dy, dx [D, H, W] int32): temporal reprojection's
    25 planes through the camera-shift field of ``pan_cam`` (clamped to
    the reprojection radius); the gather route's 39 pixel planes, the
    per-pixel gradient path's 39 + 3K and its K big_w planes at the spatial
    pass's random offsets within the radius, clamped into the image; the
    sweep's 14 neighbour-context planes and 3K sample positions, and the
    MIS gradient step's 2K R-OMIS w_sum | chosen_w planes, at the neighbour
    selection's offsets; and the banded step's (``diff.banded``, MIS_BANDS
    bands) gathers of the contexts and the 8K-plane R-OMIS pack on a
    band's rows and halo, as it slices them: the top band, whose halo
    above is zero rows, and a middle band."""
    from romis_tpu_torch.core.camera import project_to_pixel
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.diff.banded import pad_rows
    from romis_tpu_torch.ops import nbrsel, shade, spatial
    from romis_tpu_torch.ops.mis import pack_mis_reservoirs
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.restir import pack_pixel_planes
    from romis_tpu_torch.render.rmis import mis_offsets

    h, w = ctx.depth_t.shape
    dev = ctx.depth_t.device
    k = res.k
    rr = feats.reprojection_radius
    rows_f, cols_f, _ = project_to_pixel(pan_cam, ctx.position, h, w)
    cam_dy = (torch.round(rows_f).clamp(0, h - 1).int() - torch.arange(
        h, dtype=torch.int32, device=dev)[:, None]).clamp(-rr, rr)[None]
    cam_dx = (torch.round(cols_f).clamp(0, w - 1).int() - torch.arange(
        w, dtype=torch.int32, device=dev)[None, :]).clamp(-rr, rr)[None]
    offs, _ = spatial.spatial_noise(gen, feats.num_neighbours_to_sample, k,
                                    feats.spatial_resample_radius, h, w)
    rdy, rdx = spatial.clamped_offsets(offs, h, w)
    ny, nx = select_neighbour_indices(gen, ctx, h, w, feats,
                                      select=nbrsel.neighbour_select)
    sel = mis_offsets(ny, nx)
    d = sel.shape[0] // 2
    sdy, sdx = sel[:d].contiguous(), sel[d:].contiguous()
    pix = pack_pixel_planes(res, ctx)
    cen = shade.pack_center_ctx(ctx)
    nbr_planes = torch.cat([cen[0:6], cen[9:16], cen[17:18]])
    pos = res.pos.reshape(3 * k, h, w)
    rad, h_b = feats.spatial_resample_radius, h // MIS_BANDS

    def band(planes, b):
        """Band b's planes (its rows and halo of the zero-padded frame)
        and offsets (the halo rows' 0), as ``diff.banded`` slices them."""
        z = torch.zeros((2 * d, rad, w), dtype=sel.dtype, device=dev)
        offs_b = torch.cat([z, sel[:, b * h_b:(b + 1) * h_b], z], dim=1)
        return (pad_rows(planes, rad)[:, b * h_b:b * h_b + h_b + 2 * rad]
                .contiguous(), offs_b[:d].contiguous(),
                offs_b[d:].contiguous())
    return {
        "reprojection 1x25, camera shift": (
            torch.cat([pack_reservoir_planes(res), spatial.pack_gates(ctx)]),
            cam_dy, cam_dx),
        "config5_gather 5x39, random +-10": (pix, rdy, rdx),
        "grad_per_pixel 5x45, random +-10": (torch.cat([pix, pos]), rdy,
                                             rdx),
        "grad_per_pixel big_w 5x2, random +-10": (res.big_w.contiguous(),
                                                  rdy, rdx),
        "resolve_neighbour_ctx 5x14, selected": (nbr_planes, sdy, sdx),
        "mis_ext_vis 5x6, selected": (pos.contiguous(), sdy, sdx),
        "R-OMIS w_sum | chosen 5x4, selected": (torch.cat(
            [res.w_sum, res.chosen_w]), sdy, sdx),
        "banded contexts 5x14, band 0 rows": band(nbr_planes, 0),
        "banded reservoirs 5x16, band 3 rows": band(
            pack_mis_reservoirs(res, True), 3),
    }


def halo_bound(planes, dy):
    """Kernel 9's bound: each plane read once, each output written once,
    the offsets read once → (ms, "bytes")."""
    c, h, w = planes.shape
    d = dy.shape[0]
    return bound(4 * h * w * (c + d * c + 2 * d), 0)


def same_bits(torch, a, b) -> bool:
    """The same 32-bit patterns (NaN payloads and signed zeros count)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def hard_any_rays(torch, rng, kind, geometry, s=4, h=16, w=32):
    """Shadow rays of ``hard_z_rays``' kinds toward a BVH geometry's
    triangles, and ``at_hit``: random rays whose t_max is their closest
    hit's t (the triangle at t_max itself does not occlude) → (origins,
    dirs, t_max) [S, 3, H, W], [S, H, W] on the geometry's device."""
    from romis_tpu_torch.core.types import Rays
    from romis_tpu_torch.ops.traverse import bvh_closest

    cols = geometry.tri_cols.cpu().numpy()
    o_, t_ = hard_z_rays(rng, "random" if kind == "at_hit" else kind, cols,
                         r1=1, k=s, h=h, w=w)
    dev = geometry.tri_cols.device
    o = torch.from_numpy(o_).to(dev).expand(s, 3, h, w).contiguous()
    to = torch.from_numpy(t_).to(dev) - o
    tm = torch.linalg.vector_norm(to, dim=1)
    d = (to / tm.clamp_min(1e-20)[:, None]).contiguous()
    if kind == "at_hit":
        for i in range(s):
            t, tri, _, _ = bvh_closest(Rays(o[i], d[i]), geometry,
                                       geometry.bvh)
            tm[i] = torch.where(tri >= 0, t, tm[i])
    return o, d, tm.contiguous()


def walk_ops(cnt, mask=None) -> float:
    """The operations of a BVH walk's tests, from its ``counts`` (on the
    rays of ``mask``): BOX_OPS a box test, MT_OPS a triangle test, a ray's
    three reciprocals."""
    box, tri = cnt["box"], cnt["tri"]
    if mask is not None:
        box, tri = box[mask], tri[mask]
    return (box.sum().item() * BOX_OPS + tri.sum().item() * MT_OPS
            + box.numel() * 3 * DIV_OPS)


def sector_bytes(torch, mask, elem: int = 4) -> int:
    """Bytes of the 32-byte sectors that a read or write of ``mask``'s True
    elements touches: mask [..., H, W] over planes of ``elem``-byte values,
    each leading index a plane of its own (planes 32-byte aligned, as at
    1080p)."""
    per = 32 // elem
    m = mask.reshape(-1, mask.shape[-2] * mask.shape[-1])
    pad = (-m.shape[1]) % per
    if pad:
        m = torch.cat([m, m.new_zeros((m.shape[0], pad))], dim=1)
    return int(m.reshape(m.shape[0], -1, per).any(-1).sum().item()) * 32


def shade_bytes(torch, ctx, res, occluded, shaded: bool) -> int:
    """The bytes the final shade (kernels 4 and 21) needs on these inputs,
    in 32-byte sectors: valid (a byte plane), W and the colour out at every
    pixel; position and sample position where a lane may be live (W != 0,
    and, shaded, a valid receiver), the normal there too when shaded (the
    Phong gate); the colour of each lit lane (live, facing the light when
    shaded, not ``occluded`` [K, H, W]) and the receiver's material where
    one is (shaded: view, kd, ks, shininess; unshaded: kd alone)."""
    every = torch.ones_like(ctx.valid)
    to = res.pos - ctx.position[None]
    dist = torch.sqrt(torch.clamp_min((to * to).sum(dim=-3), 1e-24))
    dot_nl = (ctx.normal[None] * to).sum(dim=-3) / dist.clamp_min(1e-20)
    live = res.big_w != 0
    if shaded:
        live = live & ctx.valid[None]
    lit = live & ~occluded & ((dot_nl >= 0) if shaded else True)
    any_live, any_lit = live.any(0), lit.any(0)
    n = (sector_bytes(torch, every, 1) + res.k * sector_bytes(torch, every)
         + 3 * sector_bytes(torch, every)
         + 3 * sector_bytes(torch, any_live) + 3 * sector_bytes(torch, live))
    if shaded:
        return (n + 3 * sector_bytes(torch, any_live)
                + 3 * sector_bytes(torch, lit)
                + 10 * sector_bytes(torch, any_lit))
    return n + 3 * sector_bytes(torch, any_lit)


def pass_work(torch, spatial, ctx, gates, key, n_nbr: int, radius: int,
              k: int, shaded: bool):
    """Kernel 5's operations on its Philox stream ``key`` (pass 0) → (ops,
    the (stream, lane) races it runs). Its offsets drawn as the kernel
    draws them (Philox4x32-10 at counter (2s, pixel, pixel >> 32, tag),
    its first two words), the gates of the neighbours they reach: a
    receiver races stream 0, each neighbour that passes the gates and
    itself, each race a Gumbel score, a p-hat and a logarithm a lane, and
    divides W a lane; every stream draws a Philox call (two at K > 2) and
    two uniforms. A missed receiver, shaded, draws stream 0 alone. Also
    the bytes the pass needs on this stream, in 32-byte sectors
    (``sector_bytes``): its 10K planes out; of the receiver, valid
    everywhere, normal and depth where valid (the gates), kd where it races
    (valid, or unshaded), position, view, ks and shininess where valid
    (shaded); the neighbours' gates wherever a valid receiver's
    neighbours fall; a lane's sample and colour, m and W at stream 0's
    neighbour (a race's fallback), at each neighbour that passes the gates
    and at a racing receiver, m and W also at a missed one (shaded) →
    (ops, races, bytes)."""
    h, w = ctx.depth_t.shape
    dev = ctx.depth_t.device
    p = torch.arange(h * w, dtype=torch.int64, device=dev)
    kk = key.to(torch.int64)
    k0, k1 = kk & 0xFFFFFFFF, (kk >> 32) & 0xFFFFFFFF
    tag = torch.full_like(p, spatial._TAG_BIASED << 16)
    offs = []
    for s_ in range(n_nbr):
        x, y, _, _ = spatial.philox4x32_10(
            (torch.full_like(p, 2 * s_), p & 0xFFFFFFFF, p >> 32, tag), k0, k1)
        offs.append(torch.stack([spatial._offset_from(x, radius),
                                 spatial._offset_from(y, radius)]))
    dy, dx = spatial.clamped_offsets(
        torch.stack(offs, 1).reshape(2, n_nbr, h, w), h, w)
    g = spatial.halo_offset_gather_plain(gates, dy, dx)  # [R, 5, H, W]
    depth_ok = (1.0 - g[:, 3] / ctx.depth_t.clamp_min(1e-20)).abs() <= 0.1
    normal_ok = (g[:, 0] * ctx.normal[0] + g[:, 1] * ctx.normal[1]
                 + g[:, 2] * ctx.normal[2]) >= 0.90630778703
    passed = depth_ok & normal_ok & (g[:, 4] > 0.5) & ctx.valid
    full = ctx.valid if shaded else torch.ones_like(ctx.valid)
    n_full = int(full.sum().item())
    raced = int(full.sum().item()) * 2 + int(passed[1:].sum().item())
    draw = PHILOX_OPS * (1 if k <= 2 else 2) + 2 * UNIFORM_OPS
    ops = (n_full * (n_nbr + 1) * draw + (h * w - n_full) * draw
           + raced * k * (GUMBEL_OPS + PHONG_OPS + LOG_OPS)
           + n_full * k * DIV_OPS)
    q = ((torch.arange(h, device=dev)[:, None] + dy) * w
         + torch.arange(w, device=dev)[None, :] + dx).reshape(n_nbr, -1)

    def at(sel):  # the pixels q[sel] as a [H, W] mask
        m = torch.zeros(h * w, dtype=torch.bool, device=dev)
        m[q[sel.reshape(n_nbr, -1)]] = True
        return m.reshape(h, w)

    every, valid = torch.ones_like(ctx.valid), ctx.valid
    nbr_of_valid = at(valid[None].expand(n_nbr, h, w))
    first = torch.zeros_like(passed)
    if n_nbr:
        first[0] = True
    res_at = at(passed | first) | full
    mw_at = res_at | (~full if shaded else torch.zeros_like(full))
    n_bytes = (10 * k * sector_bytes(torch, every)
               + sector_bytes(torch, every) + 4 * sector_bytes(torch, valid)
               + 3 * sector_bytes(torch, full)
               + (10 * sector_bytes(torch, valid) if shaded else 0)
               + 5 * sector_bytes(torch, nbr_of_valid)
               + 6 * k * sector_bytes(torch, res_at)
               + 2 * k * sector_bytes(torch, mw_at))
    return ops, raced, n_bytes


def filtered_race(gates, d: int, radius: int, two_classes: bool,
                  prefer_similar: bool, same_geom: bool, depth_frac: float,
                  normal_cos: float, keys, scores, counts: dict):
    """Kernel 16's filtered race (Philox mode) in PyTorch, cell by cell in
    the walk's order and vectorised over the pixels, for the work it needs:
    keys [(2r+1)^2-1, H, W] (24-bit, ``nbrsel.selection_keys``) and scores
    non-decreasing in the key → the plain version's outputs on those
    scores. A key race per class keeps the D largest composite keys
    (class << 24 | key, the class 1 for the preferred one; the key alone
    with two classes); a cell whose composite key is not above the D-th
    largest is not scored, and in one class not gated while even its
    preferred composite key could not pass. ``counts`` receives per pixel
    [H, W] int64 the cells "scored" (their logarithms), "gated" (their
    similarity gates) and "divided" (gated cells of the same geometry whose
    depth gate the kernel's two products leave to the division)."""
    import numpy as np
    import torch

    from romis_tpu_torch.ops import nbrsel

    _, h, w = gates.shape
    dev = gates.device
    offs = nbrsel.box_offsets(radius)
    side = 2 * radius + 1
    pref = 1 << nbrsel.KEY_BITS
    f32 = np.float32
    dfrac = torch.tensor(depth_frac, dtype=torch.float32, device=dev)
    ncos = torch.tensor(normal_cos, dtype=torch.float32, device=dev)
    # csrc/nbrsel.cu's depth_factors: (1 -+ f)(1 +- 2^-20) in double, then
    # rounded to float; outside 0 <= f < 0.5 every cell divides.
    m = 1.0 / (1 << 20)
    f = float(f32(depth_frac))
    fac = ([float(f32(v)) for v in ((1 - f) * (1 + m), (1 + f) * (1 - m),
                                    (1 - f) * (1 - m), (1 + f) * (1 + m))]
           if 0.0 <= f < 0.5 else None)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    gpad = torch.nn.functional.pad(gates, (radius, radius, radius, radius))
    n_cls = 2 if two_classes else 1
    s = torch.full((n_cls, d, h, w), -torch.inf, device=dev)
    p = torch.full((n_cls, d, h, w), -1, dtype=torch.int32, device=dev)
    kr = torch.full((n_cls, d, h, w), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros((2, h, w), dtype=torch.int32, device=dev)
    scored, gated, divided = (torch.zeros((h, w), dtype=torch.int64,
                                          device=dev) for _ in range(3))

    for o in range(len(offs)):
        dy, dx = int(offs[o, 0]), int(offs[o, 1])
        in_b = ((rows + dy >= 0) & (rows + dy < h) & (cols + dx >= 0)
                & (cols + dx < w))
        nb = gpad[:, radius + dy:radius + dy + h, radius + dx:radius + dx + w]
        sim = nbrsel._similar(gates, nb, same_geom, dfrac, ncos)
        key = keys[o].to(torch.int64)
        g = scores[o]
        if two_classes:
            cnt[0] += (in_b & sim).int()
            cnt[1] += (in_b & ~sim).int()
            c = (~sim).long()  # the race the cell is in
            last = torch.where(sim, kr[0, d - 1], kr[1, d - 1])
            ck, score = key, g
        else:
            in_b = in_b & ((pref | key) > kr[0, d - 1])
            cls = sim if prefer_similar else ~sim
            c = torch.zeros_like(key)
            last = kr[0, d - 1]
            ck = torch.where(cls, pref | key, key)
            score = g + cls.float() * nbrsel.CLASS_OFFSET
        gated += in_b
        dd = torch.clamp_min(nb[1], 1e-20)
        decided = torch.zeros_like(in_b)
        if fac is not None:
            cd = gates[1]
            decided = (dd < 1e30) & (
                ((cd >= dd * fac[0]) & (cd <= dd * fac[1]))
                | (cd < dd * fac[2]) | (cd > dd * fac[3]))
        geo = (nb[0] == gates[0]) if same_geom else torch.ones_like(in_b)
        divided += in_b & geo & ~decided
        enter = in_b & (ck > last)
        scored += enter
        pack = torch.full((h, w), (dy + radius) * side + (dx + radius),
                          dtype=torch.int32, device=dev)
        for ci in range(n_cls):
            mine = enter & (c == ci)
            kc = ck  # the key race: the D largest composite keys, descending
            for i in range(d):
                take = mine & (kc > kr[ci, i])
                t = kr[ci, i].clone()
                kr[ci, i] = torch.where(take, kc, t)
                kc = torch.where(take, t, kc)
            mine = mine & (score > s[ci, d - 1])
            cs, cp = score, pack  # the race: ties to the earlier offset
            for i in range(d):
                take = mine & ((cs > s[ci, i])
                               | ((cs == s[ci, i]) & (cp < p[ci, i])))
                ts, tp = s[ci, i].clone(), p[ci, i].clone()
                s[ci, i] = torch.where(take, cs, ts)
                p[ci, i] = torch.where(take, cp, tp)
                cs = torch.where(take, ts, cs)
                cp = torch.where(take, tp, cp)
    counts.update(scored=scored, gated=gated, divided=divided)
    if two_classes:
        return s[0], p[0], s[1], p[1], cnt
    return s[0], p[0]


def profile_run(torch, label: str, run, n: int, card: str, unit="frame",
                cuda_only=False, warm=True) -> None:
    """Device busy and idle share over n calls of ``run`` (after one
    warm-up unless ``warm`` is False), and the top kernels, from
    ``torch.profiler`` (the device's activity alone with ``cuda_only``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run()
    torch.cuda.synchronize()
    ev_a = torch.cuda.Event(enable_timing=True)
    ev_b = torch.cuda.Event(enable_timing=True)
    activities = [ProfilerActivity.CUDA] if cuda_only else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        ev_a.record()
        for _ in range(n):
            run()
        ev_b.record()
        torch.cuda.synchronize()
    span = ev_a.elapsed_time(ev_b) / n
    dev_rows = sorted(((e.key, e.self_device_time_total / 1e3 / n,
                        e.count / n) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
    busy = sum(r[1] for r in dev_rows)
    print(f"profile {unit}[{label}]: span {span:.3f} ms/{unit}, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / span:.3f}, "
          f"{sum(r[2] for r in dev_rows):.0f} device kernels/{unit} [{card}]"
          if busy else f"profile {unit}[{label}]: no device time recorded")
    for key_, ms_, n_ in dev_rows[:8]:
        print(f"profile {unit}[{label}]: {ms_:.3f} ms in {n_:.0f} x "
              f"{key_[:70]}")


def kernel_entries() -> dict:
    """Each kernel's C entry points, the keys it launches under in
    ``utils.stats.launches``, by KERNELS name."""
    return {"closest_hit": ("romis_closest_hit",),
            "gather_rows": ("romis_gather_rows",),
            "ris": ("romis_ris", "romis_ris_band"),
            "final_shade": ("romis_final_shade",),
            "spatial_pass": ("romis_spatial_pass", "romis_spatial_pass_band"),
            "spatial_pass_unbiased": ("romis_spatial_pass:unbiased",
                                      "romis_spatial_pass_band:unbiased"),
            "halo_gather": ("romis_halo_gather",),
            "any_hit": ("romis_any_hit",),
            "scatter_rows_add": ("romis_scatter_rows_add",),
            "halo_scatter": ("romis_halo_scatter",),
            "ris_replay": ("romis_ris_replay",),
            "neighbour_select": ("romis_neighbour_select",
                                 "romis_neighbour_select_band"),
            "mis_ris": ("romis_ris_mis", "romis_ris_mis_band"),
            "mis_iteration": ("romis_mis_iteration",
                              "romis_mis_iteration_band"),
            "bvh_closest_hit": ("romis_bvh_closest",),
            "bvh_any_hit": ("romis_bvh_any",),
            "bvh_any_hit_k": ("romis_bvh_any_k",),
            "bvh_final_shade": ("romis_final_shade_bvh",),
            "zcount_occ": ("romis_zcount_occ",),
            "any_hit_plucker": ("romis_any_hit_plucker",),
            "neighbour_gather": ("romis_neighbour_gather",),
            "ris_replay_band": ("romis_ris_replay_band",)}


def launch_counts(entries: dict) -> dict:
    """Launches since ``stats.launches`` was cleared, by KERNELS name."""
    from romis_tpu_torch.utils import stats

    return {n: sum(stats.launches.get(e, 0) for e in es)
            for n, es in entries.items()}


def mis_grad_features(path: str):
    """The Features of an MIS gradient path: the reference defaults (D = 5,
    r = 10, K = 2, S = 32, 5 iterations) without tone mapping; R-MIS
    balance (EQUAL_SIMILAR_DISSIMILAR) and R-OMIS direct with the
    surrogate (the replay-records path), progressive R-OMIS banded on the
    plain candidate loop."""
    from romis_tpu_torch import (
        Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
    )

    if path == "mis_grad_banded":
        return Features(enable_tone_mapping=False,
                        ray_trace_mode=RayTraceMode.ROMIS,
                        use_progressive_romis=True)
    if path == "mis_grad_rmis":
        return Features(
            enable_tone_mapping=False, surrogate_resampling_grad=True,
            ray_trace_mode=RayTraceMode.RMIS,
            mis_weight_rmis=MISWeight.BALANCE,
            neighbour_selection_strategy=(
                NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR))
    return Features(enable_tone_mapping=False, surrogate_resampling_grad=True,
                    ray_trace_mode=RayTraceMode.ROMIS)


def mis_grad_fn(path: str, scene, hw, ops, bands: int = MIS_BANDS):
    """An MIS gradient path's step: ``make_mis_grad_fn``, or for
    ``mis_grad_banded`` ``make_mis_banded_grad_fn`` in ``bands`` bands."""
    from romis_tpu_torch.diff.banded import make_mis_banded_grad_fn
    from romis_tpu_torch.diff.grad import make_mis_grad_fn

    args = (scene.geometry, scene.lights, scene.num_lights, *hw,
            mis_grad_features(path))
    if path == "mis_grad_banded":
        return make_mis_banded_grad_fn(*args, bands, ops=ops)
    return make_mis_grad_fn(*args, ops=ops)


def mis_grad_setup(torch, path: str, scene, cam, hw, dev):
    """(params, target, one step's injected noise) of an MIS gradient path
    at hw: the target rendered with the light colours x 0.8, the noise the
    selection's score planes and, but for the banded step (whose RIS draws
    from the generator), every iteration's replay uniforms."""
    from romis_tpu_torch.diff.grad import (
        extract_params, render_mis_with_params,
    )
    from romis_tpu_torch.ops.nbrsel import selection_noise
    from romis_tpu_torch.ops.wrs import replay_uniforms

    f = mis_grad_features(path)
    p = extract_params(scene.geometry, scene.lights)
    dim = replace(p, **{n: getattr(p, n) * 0.8 for n in (
        "light_c0", "light_c1", "light_c2", "light_c3")})
    g = torch.Generator(device=dev).manual_seed(11)
    with torch.no_grad():
        target = render_mis_with_params(dim, g, cam, scene.geometry,
                                        scene.lights, scene.num_lights, *hw,
                                        f)
    sel = selection_noise(g, f.spatial_resample_radius, *hw)
    if path == "mis_grad_banded":
        return p, target, sel
    return p, target, (sel, torch.stack([
        replay_uniforms(g, f.initial_light_samples,
                        f.num_samples_in_reservoir, *hw)
        for _ in range(f.max_iterations_mis)]))


# ---- 6 and 7: the row bands of parallel/ ----
# The band phase renders each of these paths at 1920x1080 whole and as
# BAND_SPLITS row bands in one process (each band through the kernels'
# band entries), and holds the bands' images and carry to the whole frame's
# bit for bit: (frames, the kernels its bands must launch).
BAND_SPLITS = (2, 4)
BAND_PATHS = {
    "config5": (2, ("ris", "spatial_pass")),
    "vischeck": (2, ("ris", "spatial_pass_unbiased", "zcount_occ")),
    "animated": (3, ("ris", "spatial_pass_unbiased", "halo_gather",
                     "any_hit")),
    "rmis_balance": (1, ("neighbour_select", "halo_gather", "mis_ris",
                         "mis_iteration")),
    "romis_progressive": (1, ("neighbour_select", "halo_gather", "mis_ris",
                              "mis_iteration")),
    "large_romis": (1, ("bvh_closest_hit", "neighbour_select", "halo_gather",
                        "mis_ris", "mis_iteration", "bvh_any_hit_k")),
}
# A band entry against its plain version at the band's shape, on the same
# injected numbers: every output plane of MIN_AGREE of the pixels within
# BAND_RTOL (relative) and BAND_ATOL, as the whole frame's checks above
# hold the RIS and the passes (powf and logf of CUDA and of PyTorch may
# part by an ulp, and the plain sums over streams run in another order).
BAND_RTOL, BAND_ATOL = 1e-4, 1e-6
NCCL_TIMEOUT_S = 300


class HaloRecorder:
    """The halo exchange of a frame rendered as one band: records every
    whole-frame tensor it is asked to extend, with its radius, and pads it
    with zero rows, as a world of one does."""

    def __init__(self):
        self.seen = []

    def __call__(self, x, radius, bands):
        import torch

        self.seen.append((x, radius))
        return torch.nn.functional.pad(x, (0, 0, radius, radius))


def halo_replay(torch, seen, bands, check: bool):
    """A band's halo exchange in one process: its k-th call returns the
    rows of the k-th recorded whole-frame tensor that the band and its halo
    cover (zeros beyond the frame), cut beforehand; with ``check`` it
    requires the rows the band passes in to be the whole frame's."""
    prepared = []
    for x, r in seen:
        pad = torch.nn.functional.pad(x, (0, 0, r, r))
        prepared.append(pad[..., bands.row_base:bands.row_base + bands.h_loc
                            + 2 * r, :].contiguous())
    calls = iter(prepared)

    def exchange(x, radius, b):
        out = next(calls, None)
        require(out is not None and out.shape[-2] == x.shape[-2] + 2 * radius,
                f"band {b.rank} of {b.world}: halo exchange out of step")
        if check:
            require(torch.equal(out[..., radius:radius + x.shape[-2], :], x),
                    f"band {b.rank} of {b.world}: its rows before a halo "
                    f"exchange differ from the whole frame's")
        return out
    return exchange


def band_frames(torch, sc, cams, feats, bands, seed: int, dev):
    """A path's frames at H x W, whole (``bands`` None, ``render_frame``)
    or one row band (the frames' band entries) → (images, the last state's
    reservoir planes or None)."""
    from romis_tpu_torch import RayTraceMode
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.parallel.halo import render_frame_band
    from romis_tpu_torch.render.pipeline import render_frame
    from romis_tpu_torch.render.rmis import render_rmis
    from romis_tpu_torch.render.romis import render_romis

    gen = torch.Generator(device=dev).manual_seed(seed)
    g, li, nl = sc.geometry, sc.lights, sc.num_lights
    images, state = [], None
    for c in cams:
        if bands is None:
            img, state = render_frame(gen, c, sc, H, W, feats, state)
        elif feats.ray_trace_mode == RayTraceMode.RMIS:
            img = render_rmis(gen, c, g, li, nl, H, W, feats, band=bands)
        elif feats.ray_trace_mode == RayTraceMode.ROMIS:
            img = render_romis(gen, c, g, li, nl, H, W, feats, band=bands)
        else:
            img, state = render_frame_band(gen, c, g, li, nl, H, W, feats,
                                           state, bands)
        images.append(img)
    return images, None if state is None else pack_reservoir_planes(
        state.reservoirs)


def band_phase(torch, dev, card: str, entries: dict, large=None) -> None:
    """Section 6: the frames as row bands in one process (see BAND_PATHS),
    each band's halo exchange replaced by slices of the whole frame's own
    tensors (recorded from the frame rendered as one band, which must be
    render_frame's bit for bit): nothing but the package's band entries
    computes a band. Per path and split the bands' launches and the sum of
    their ms against the whole frame's, by CUDA events (the cost of the 2r
    extra rows a band computes in its halo). Then each band entry of kernels
    3, 15, 5, 11, 16 and 17 against its plain version at the band's shape
    and against the whole frame's kernel's rows."""
    from romis_tpu_torch import (
        Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
    )
    from romis_tpu_torch.core.camera import make_camera
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.parallel.mesh import Bands
    from romis_tpu_torch.scene.scene import (
        flagship_camera, flagship_scene, torus_field, torus_field_camera,
    )
    from romis_tpu_torch.utils import stats

    scene, cam = flagship_scene(dev), flagship_camera(H, W, dev)
    if large is None:
        large = torus_field(LARGE_N, dev)
        large.geometry = with_bvh(large.geometry)
    pan = [make_camera(look_at=(2.57, 1.23, -1.35), rotation_deg=(
        10.3 + PAN_DEG * f, 30.0 + PAN_DEG * f, 0.0), distance=25.0,
        fov_deg=30.0, resolution=(H, W), device=dev) for f in range(3)]
    romis = RayTraceMode.ROMIS
    cases = {
        "config5": (scene, [cam] * 2, Features()),
        "vischeck": (scene, [cam] * 2, Features(
            unbiased_combination=True, spatial_reuse_visibility_check=True)),
        "animated": (scene, pan, Features(
            temporal_reprojection=True, unbiased_combination=True,
            initial_samples_visibility_check=True)),
        "rmis_balance": (scene, [cam], Features(
            ray_trace_mode=RayTraceMode.RMIS,
            mis_weight_rmis=MISWeight.BALANCE,
            neighbour_selection_strategy=(
                NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR))),
        "romis_progressive": (scene, [cam], Features(
            ray_trace_mode=romis, use_progressive_romis=True)),
        "large_romis": (large, [torus_field_camera(H, W, dev)],
                        Features(ray_trace_mode=romis)),
    }

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    for path, (n_frames, must) in BAND_PATHS.items():
        sc, cams, feats = cases[path]
        require(len(cams) == n_frames, f"band[{path}]: frames")
        whole, whole_ms = timed(lambda: band_frames(torch, sc, cams, feats,
                                                    None, 17, dev))
        rec = HaloRecorder()
        one = band_frames(torch, sc, cams, feats, Bands(H, exchange=rec), 17,
                          dev)
        same = all(torch.equal(a, b) for a, b in zip(one[0], whole[0])) \
            and (whole[1] is None or torch.equal(one[1], whole[1]))
        require(same, f"band[{path}]: the one-band frame differs from "
                      f"render_frame's")
        r_list = sorted({r for _, r in rec.seen})
        mb = sum(x.numel() * x.element_size() * 2 * r / x.shape[-2]
                 for x, r in rec.seen) / 1e6
        _, whole_ms = timed(lambda: band_frames(torch, sc, cams, feats, None,
                                                17, dev))
        for n in BAND_SPLITS:
            stats.launches.clear()
            parts = [band_frames(torch, sc, cams, feats, Bands(
                H, n, b, exchange=halo_replay(torch, rec.seen, Bands(H, n, b),
                                              True)), 17, dev)
                     for b in range(n)]
            got = {k_: c for k_, c in launch_counts(entries).items()
                   if c}
            imgs = [torch.cat([p[0][f] for p in parts]) for f in
                    range(n_frames)]
            same = all(torch.equal(a, b) for a, b in zip(imgs, whole[0]))
            if whole[1] is not None:
                same &= torch.equal(torch.cat([p[1] for p in parts], dim=-2),
                                    whole[1])
            require(same, f"band[{path}]: {n} bands differ from the whole "
                          f"frame")
            missing = [k_ for k_ in must if not got.get(k_)]
            require(not missing, f"band[{path}]: {n} bands launched no "
                                 f"{missing}")
            band_ms = 0.0
            for b in range(n):
                bands = Bands(H, n, b, exchange=halo_replay(
                    torch, rec.seen, Bands(H, n, b), False))
                band_ms += timed(lambda: band_frames(
                    torch, sc, cams, feats, bands, 17, dev))[1]
            print(f"band[{path}]: {n} bands bit-equal to render_frame over "
                  f"{n_frames} frame(s) (images"
                  f"{' and carry' if whole[1] is not None else ''}); "
                  f"launches of the {n} bands {got}; {len(rec.seen)} halo "
                  f"exchanges a band of radius {r_list} rows, "
                  f"{mb / n_frames:.2f} MB a frame, both sides; sum of the "
                  f"bands {band_ms / n_frames:.3f} ms/frame vs whole "
                  f"{whole_ms / n_frames:.3f} ms/frame "
                  f"({100 * (band_ms / whole_ms - 1):+.1f} %) [{card}]")
        del whole, one, rec, parts, imgs
    band_entry_checks(torch, dev, card, scene, cam)


def band_entry_checks(torch, dev, card: str, scene, cam) -> None:
    """Each band entry of kernels 3, 15, 5, 11, 16 and 17 at 1080p on the
    flagship: on an inner band of 4 and the bottom band of 2, against its
    plain version with the same band arguments on the same injected
    numbers, and on its Philox stream against the whole frame's kernel's
    rows (bit for bit); the inner band's kernel ms beside a quarter of the
    whole frame's."""
    from dataclasses import fields, replace as dc_replace

    from romis_tpu_torch import Features, MISWeight
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.core.types import pack_reservoir_planes
    from romis_tpu_torch.ops import mis, nbrsel, ris, spatial
    from romis_tpu_torch.ops.shade import pack_center_ctx
    from romis_tpu_torch.ops.wrs import gen_canonical_samples_plain
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.rmis import mis_offsets

    feats = Features(mis_weight_rmis=MISWeight.BALANCE)
    k, s = feats.num_samples_in_reservoir, feats.initial_light_samples
    n_nbr, radius = feats.num_neighbours_to_sample, \
        feats.spatial_resample_radius
    it_n, sk = feats.max_iterations_mis, -(-s // k)
    li, nl = scene.lights, scene.num_lights
    _, ctx = restir.trace_primary(generate_rays(cam, H, W), scene.geometry,
                                  feats)
    gen = torch.Generator(device=dev).manual_seed(4321)
    res = ris.gen_canonical_samples_ris(ctx, li, nl, feats, generator=gen)
    res_planes = pack_reservoir_planes(res)
    gates, cen = spatial.pack_gates(ctx), pack_center_ctx(ctx)
    sel_gates = nbrsel.selection_gates(ctx)
    sel_args = (n_nbr, radius, False, True, True,
                feats.neighbour_max_depth_difference_fraction,
                float(math.cos(
                    feats.neighbour_max_normal_angle_difference_radians)))
    ny, nx = select_neighbour_indices(gen, ctx, H, W, feats)
    offs = mis_offsets(ny, nx)
    nbr_ctx = mis.resolve_neighbour_ctx(cen, offs)

    def close(a, b):
        """Share of pixels whose every plane is within the band
        tolerance."""
        ok = (a - b).abs() <= BAND_ATOL + BAND_RTOL * b.abs()
        return ok.reshape(-1, *a.shape[-2:]).all(dim=0).float().mean().item()

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    for n, b in ((4, 1), (2, 1)):
        h, base = H // n, (H // n) * b
        band = dict(row_base=base, h_global=H)

        def rows(t):
            return t[..., base:base + h, :].contiguous()

        def ext(t):
            pad = torch.nn.functional.pad(t, (0, 0, radius, radius))
            return pad[..., base:base + h + 2 * radius, :].contiguous()

        bctx = dc_replace(ctx, **{f.name: rows(getattr(ctx, f.name))
                                  for f in fields(ctx)})
        label = f"{b} of {n}"
        out = {}
        # Kernel 3.
        uni = torch.rand((sk, 4, k, h, W), generator=gen, device=dev)
        out["ris"] = (
            close(pack_reservoir_planes(ris.gen_canonical_samples_ris(
                bctx, li, nl, feats, uniforms=uni, **band)),
                pack_reservoir_planes(gen_canonical_samples_plain(
                    bctx, li, nl, feats, uniforms=uni, **band))),
            torch.equal(pack_reservoir_planes(ris.gen_canonical_samples_ris(
                bctx, li, nl, feats, generator=seeded(1), **band)),
                rows(pack_reservoir_planes(ris.gen_canonical_samples_ris(
                    ctx, li, nl, feats, generator=seeded(1))))))
        # Kernel 15.
        uni = torch.rand((it_n, sk, 4, k, h, W), generator=gen, device=dev)
        out["mis_ris"] = (
            close(ris.gen_mis_reservoir_planes(
                bctx, li, nl, feats, it_n, True, uniforms=uni, **band),
                ris.gen_mis_reservoir_planes_plain(
                    bctx, li, nl, feats, it_n, True, uniforms=uni, **band)),
            torch.equal(ris.gen_mis_reservoir_planes(
                bctx, li, nl, feats, it_n, True, generator=seeded(2),
                **band), rows(ris.gen_mis_reservoir_planes(
                    ctx, li, nl, feats, it_n, True, generator=seeded(2)))))
        # Kernels 5 and 11.
        inject = tuple(rows(t) for t in spatial.spatial_noise(
            gen, n_nbr, k, radius, H, W))
        key = spatial.philox_key(gen)
        ub = feats.replace(unbiased_combination=True)
        for name, kern, plain, ins, f in (
                ("spatial_pass", spatial.spatial_pass_fused,
                 spatial.spatial_pass_plain, (res_planes, gates, cen), feats),
                ("spatial_pass_unbiased", spatial.spatial_pass_unbiased_fused,
                 spatial.spatial_pass_unbiased_plain, (res_planes, cen), ub)):
            args = (k, n_nbr, radius, f)
            out[name] = (
                close(kern(*(ext(t) for t in ins), *args, inject=inject,
                           **band),
                      plain(*(ext(t) for t in ins), *args, inject=inject,
                            **band)),
                torch.equal(kern(*(ext(t) for t in ins), *args, key=key,
                                 generator=seeded(7), pass_index=1, **band),
                            rows(kern(*ins, *args, key=key,
                                      generator=seeded(7), pass_index=1))))
        # Kernel 16, on the kernel's own Philox keys given as scores too.
        sel_key = spatial.philox_key(gen)
        scores = rows(nbrsel.gumbel_of_keys(nbrsel.selection_keys(
            sel_key, radius, H, W)))
        band_k = nbrsel.neighbour_select(ext(sel_gates), *sel_args,
                                         scores=scores, **band)
        band_p = nbrsel.neighbour_select_plain(ext(sel_gates), *sel_args,
                                               scores=scores, **band)
        band_x = nbrsel.neighbour_select(ext(sel_gates), *sel_args,
                                         key=sel_key, generator=seeded(8),
                                         **band)
        whole_x = nbrsel.neighbour_select(sel_gates, *sel_args, key=sel_key,
                                          generator=seeded(8))
        out["neighbour_select"] = (
            float(all(torch.equal(a, c) for a, c in zip(band_k, band_p))),
            all(torch.equal(a, rows(c)) for a, c in zip(band_x, whole_x)))
        # Kernel 17, R-OMIS and balance, on the pack of kernel 15.
        pack = ris.gen_mis_reservoir_planes(ctx, li, nl, feats, 2, True,
                                            generator=seeded(3))
        pack_b = ris.gen_mis_reservoir_planes(ctx, li, nl, feats, 2, False,
                                              generator=seeded(3))
        sweep_rel = 0.0
        sweep_same = True
        for mode, pk in (("romis", pack), ("rmis_balance", pack_b)):
            a_ = (scene.geometry, k, mode, nl, feats)
            kw = dict(nbr_ctx=rows(nbr_ctx), it_block=1)
            got_k = mis.mis_iteration(rows(cen), ext(pk), rows(offs), *a_,
                                      **kw, **band)
            got_p = mis.mis_iteration_plain(rows(cen), ext(pk), rows(offs),
                                            *a_, **kw, **band)
            whole_k = mis.mis_iteration(cen, pk, offs, *a_, nbr_ctx=nbr_ctx,
                                        it_block=1)
            if mode != "romis":
                got_k, got_p, whole_k = (got_k,), (got_p,), (whole_k,)
            for gk, gp, wk in zip(got_k, got_p, whole_k):
                sweep_rel = max(sweep_rel, ((gk - gp).abs().amax(dim=(1, 2))
                                            / gp.abs().amax(dim=(1, 2))
                                            .clamp_min(1e-30)).max().item())
                sweep_same &= torch.equal(gk, rows(wk))
        torch.cuda.synchronize()
        for name, (share, exact) in out.items():
            print(f"check band entry {name}[{label}]: pixels within "
                  f"rtol {BAND_RTOL} of the plain version at the band's "
                  f"shape {share:.6f}; Philox band bit-equal to the whole "
                  f"frame's rows {exact}")
            require(share >= MIN_AGREE if name != "neighbour_select"
                    else share == 1.0, f"band entry {name} [{label}]: "
                    f"{share} of the pixels agree with the plain version")
            require(exact, f"band entry {name} [{label}]: the band's rows "
                           f"differ from the whole frame's")
        print(f"check band entry mis_iteration[{label}]: max plane error "
              f"{sweep_rel:.2e} of the plane's largest value against the "
              f"plain version; bit-equal to the whole frame's rows "
              f"{sweep_same}")
        require(sweep_rel <= MIS_REL, f"band entry mis_iteration [{label}]: "
                                      f"{sweep_rel}")
        require(sweep_same, f"band entry mis_iteration [{label}]: the band's "
                            f"rows differ from the whole frame's")
        if (n, b) != (4, 1):
            continue
        # The inner band's kernels beside a quarter of the whole frame's,
        # their inputs cut beforehand.
        e_res, e_gates, e_cen, e_sel, e_pack = (ext(t) for t in (
            res_planes, gates, cen, sel_gates, pack))
        r_cen, r_offs, r_nbr = rows(cen), rows(offs), rows(nbr_ctx)
        kw = dict(key=key, generator=gen)
        timings = {
            "ris": (lambda: ris.gen_canonical_samples_ris(
                bctx, li, nl, feats, generator=gen, **band),
                lambda: ris.gen_canonical_samples_ris(
                    ctx, li, nl, feats, generator=gen)),
            "mis_ris": (lambda: ris.gen_mis_reservoir_planes(
                bctx, li, nl, feats, it_n, True, generator=gen, **band),
                lambda: ris.gen_mis_reservoir_planes(
                    ctx, li, nl, feats, it_n, True, generator=gen)),
            "spatial_pass": (lambda: spatial.spatial_pass_fused(
                e_res, e_gates, e_cen, k, n_nbr, radius, feats, **kw,
                **band), lambda: spatial.spatial_pass_fused(
                    res_planes, gates, cen, k, n_nbr, radius, feats, **kw)),
            "spatial_pass_unbiased": (
                lambda: spatial.spatial_pass_unbiased_fused(
                    e_res, e_cen, k, n_nbr, radius, ub, **kw, **band),
                lambda: spatial.spatial_pass_unbiased_fused(
                    res_planes, cen, k, n_nbr, radius, ub, **kw)),
            "neighbour_select": (lambda: nbrsel.neighbour_select(
                e_sel, *sel_args, key=sel_key, generator=gen, **band),
                lambda: nbrsel.neighbour_select(
                    sel_gates, *sel_args, key=sel_key, generator=gen)),
            "mis_iteration": (lambda: mis.mis_iteration(
                r_cen, e_pack, r_offs, scene.geometry, k, "romis", nl, feats,
                nbr_ctx=r_nbr, it_block=1, **band),
                lambda: mis.mis_iteration(
                    cen, pack, offs, scene.geometry, k, "romis", nl, feats,
                    nbr_ctx=nbr_ctx, it_block=1)),
        }
        for name, (band_fn, whole_fn) in timings.items():
            b_ms = cuda_ms(torch, band_fn, 5)
            w_ms = cuda_ms(torch, whole_fn, 5)
            print(f"time band entry {name}[{label}]: {b_ms:.4f} ms for "
                  f"{h} + 2x{radius} rows vs {w_ms / n:.4f} ms, a quarter of "
                  f"the whole frame's {w_ms:.4f} ms [{card}]")


def nccl_rank(rank: int, world: int, store: str, out: str) -> None:
    """A rank of the NCCL phase on card ``rank``: the config-5 frame and
    R-OMIS through the sharded entry points, rank 0 holding them to the
    single-device frames bit for bit, and the halo exchange of the
    spatial passes' reservoir planes timed → a JSON line in ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=NCCL_TIMEOUT_S))
    result = group_frames(torch, dev, world)
    if rank == 0:
        Path(out).write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def group_frames(torch, dev, world: int) -> dict:
    """The sharded frames on the default process group against the
    single-device frames (compared where the rank is 0), and the
    exchange's time."""
    import torch.distributed as dist

    from romis_tpu_torch import Features, RayTraceMode
    from romis_tpu_torch.parallel.halo import halo_extend
    from romis_tpu_torch.parallel.launch import global_bands
    from romis_tpu_torch.parallel.mis import render_romis_sharded
    from romis_tpu_torch.parallel.shard import render_frame_sharded
    from romis_tpu_torch.render.pipeline import render_frame
    from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

    scene, cam = flagship_scene(dev), flagship_camera(H, W, dev)
    g, li, nl = scene.geometry, scene.lights, scene.num_lights
    bands = global_bands(H)
    require(bands.world == world, f"group of {bands.world}, not {world}")
    feats = Features()
    gen = torch.Generator(device=dev).manual_seed(23)
    state, imgs = None, []
    for _ in range(2):
        img, state = render_frame_sharded(gen, cam, g, li, nl, H, W, feats,
                                          state, bands)
        imgs.append(img)
    rfeats = Features(ray_trace_mode=RayTraceMode.ROMIS)
    rimg = render_romis_sharded(torch.Generator(device=dev).manual_seed(29),
                                cam, g, li, nl, H, W, rfeats, bands)
    same = None
    if bands.rank == 0:
        gen = torch.Generator(device=dev).manual_seed(23)
        ref, st = None, None
        same = True
        for img in imgs:
            ref, st = render_frame(gen, cam, scene, H, W, feats, st)
            same &= torch.equal(img, ref)
        ref, _ = render_frame(torch.Generator(device=dev).manual_seed(29),
                              cam, scene, H, W, rfeats)
        same &= torch.equal(rimg, ref)
    # The exchange of one pass's reservoir planes [10K, h_loc, W].
    k, radius = feats.num_samples_in_reservoir, feats.spatial_resample_radius
    planes = torch.rand((10 * k, bands.h_loc, W), device=dev)
    halo_extend(planes, radius, bands)
    dist.barrier()
    ms = cuda_ms(torch, lambda: halo_extend(planes, radius, bands), 20)
    return {"world": world, "same": same, "exchange_ms": ms,
            "radius": radius, "planes": 10 * k,
            "exchange_mb": 2 * 10 * k * radius * W * 4 / 1e6}


def group_phase(torch, card: str) -> None:
    """Section 7: the sharded frames through a real NCCL process group:
    of one rank in this process (a file:// store), bit-equal to the
    single-device frames; and, on a machine with two or more cards, of two
    ranks (and of four, with four cards), one a card, with the halo
    exchange timed."""
    import tempfile

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        x = torch.ones(4, device=dev)
        dist.all_reduce(x)
        r = group_frames(torch, dev, 1)
        dist.destroy_process_group()
    print(f"group[nccl, 1 rank]: all_reduce {x.tolist()}; sharded config-5 "
          f"frames and R-OMIS bit-equal to render_frame {r['same']}")
    require(r["same"] and x.tolist() == [1.0] * 4,
            "group[nccl, 1 rank]: the sharded frames differ")
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"group[nccl, 2 ranks]: skipped: this machine has {n_cards} "
              f"CUDA device; NCCL puts each rank on a card of its own")
        return
    import torch.multiprocessing as mp

    for world in (2, 4):
        if world > n_cards:
            continue
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            out = Path(tmp) / "rank0.json"
            t0 = time.perf_counter()
            mp.spawn(nccl_rank, args=(world, f"{tmp}/store", str(out)),
                     nprocs=world, join=True)
            r = json.loads(out.read_text())
        print(f"group[nccl, {world} ranks]: sharded config-5 frames and "
              f"R-OMIS bit-equal to render_frame {r['same']}; halo exchange "
              f"of {r['planes']} reservoir planes x {r['radius']} rows a side"
              f" ({r['exchange_mb']:.2f} MB both sides of an inner band) "
              f"{r['exchange_ms']:.4f} ms; {time.perf_counter() - t0:.1f} s "
              f"with the ranks' start [{card}]")
        require(r["same"], f"group[nccl, {world} ranks]: the sharded frames "
                           f"differ")


# ---- 8: the sharded training steps ----
# Section 8 drives parallel.shard.make_sharded_train_step (grad_surrogate's
# and grad_per_pixel's features, 2 steps each) and parallel.mis.
# make_sharded_mis_train_step (R-MIS balance and R-OMIS direct with the
# surrogate, 1 step each) at 1920x1080 on the flagship; the MIS steps' bands
# in one process at SHARD_MIS_H rows, where the whole step's retained graph
# and one band's fit the card. The steps' leaves are held to the
# single-device step's within SHARD_SPREAD times its own spread between two
# runs (kernel 13 adds with atomics), and never tighter than SHARD_REL
# (float32 sums in another order, as the CPU tests hold them).
SHARD_GRAD = ("shard_grad_surrogate", "shard_grad_per_pixel")
SHARD_MIS = ("shard_mis_rmis", "shard_mis_romis")
SHARD_MIS_H = 540
SHARD_SPREAD, SHARD_REL = 4.0, 1e-5
SHARD_LR = 1e-2


def shard_features(path: str):
    """The Features of a section-8 path: the whole-frame gradient path's it
    stands beside."""
    from romis_tpu_torch import Features

    if path in SHARD_MIS:
        return mis_grad_features(path.replace("shard_mis_", "mis_grad_"))
    return Features(enable_tone_mapping=False, surrogate_resampling_grad=True,
                    exact_gradients=path == "shard_grad_per_pixel")


def shard_setup(torch, dev, scene, path: str, h: int):
    """(features, camera, params, target) of a section-8 path at h rows:
    the target rendered with the light colours x 0.8."""
    from romis_tpu_torch.diff.grad import (
        extract_params, render_mis_with_params, render_with_params,
    )
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.scene.scene import flagship_camera

    f, cam = shard_features(path), flagship_camera(h, W, dev)
    p = extract_params(scene.geometry, scene.lights)
    dim = replace(p, **{n: getattr(p, n) * 0.8 for n in (
        "light_c0", "light_c1", "light_c2", "light_c3")})
    g = torch.Generator(device=dev).manual_seed(11)
    args = (cam, scene.geometry, scene.lights, scene.num_lights, h, W, f)
    with torch.no_grad():
        if path in SHARD_MIS:
            target = render_mis_with_params(dim, g, *args)
        else:
            target, _ = render_with_params(dim, g, *args,
                                           restir.initial_temporal_state(
                                               h, W, 2, cam))
    return f, cam, p, target


def shard_reference(torch, dev, scene, path: str, setup):
    """The single-device step of a section-8 path at 1080p
    (``shard_run`` without bands), run twice on the same draws → the
    first run's {"images", "loss", "grads"} and "spread": per leaf the
    largest difference of the two runs over the leaf's largest |g|."""
    a, b = (shard_run(torch, dev, scene, path, setup) for _ in range(2))
    for ia, ib in zip(a["images"], b["images"]):
        require(torch.equal(ia, ib), f"{path}: two single-device runs "
                                     f"render different images")
    a["spread"] = {leaf: max(
        (getattr(ga, leaf) - getattr(gb, leaf)).abs().max().item()
        / max(getattr(gb, leaf).abs().max().item(), 1e-30)
        for ga, gb in zip(a["grads"], b["grads"]))
        for leaf in a["grads"][0].__dataclass_fields__}
    return a


def shard_tolerance(spread: dict) -> dict:
    """Each leaf's tolerance (of its largest |g|) from the single-device
    step's spread."""
    return {n: max(SHARD_SPREAD * s, SHARD_REL) for n, s in spread.items()}


def shard_close(label: str, got, want, tol: dict) -> float:
    """Every leaf of ``got`` finite and within its tolerance of ``want``'s
    largest |g| → the worst leaf's error over its tolerance."""
    import torch

    worst = 0.0
    for leaf in want.__dataclass_fields__:
        a, b = getattr(got, leaf), getattr(want, leaf)
        require(bool(torch.isfinite(a).all()), f"{label}: non-finite {leaf}")
        scale = b.abs().max().item()
        rel = (a - b).abs().max().item() / max(scale, 1e-30)
        require(rel <= tol[leaf] or scale == a.abs().max().item() == 0,
                f"{label}: gradient {leaf} {rel:.3e} over its tolerance "
                f"{tol[leaf]:.3e}")
        worst = max(worst, rel / tol[leaf])
    return worst


def shard_run(torch, dev, scene, path: str, setup, bands=None):
    """A section-8 path's step at 1080p on ``bands`` (without: the
    single-device step) → {"images" (this rank's rows), "loss", "grads"}:
    the ReSTIR path's value and gradient over 2 frames at fixed parameters,
    the state carried (``make_sharded_grad_fn``, ``make_grad_fn``); the MIS
    path's one step (``make_sharded_mis_train_step``, ``make_mis_grad_fn``).
    Each frame's image is rendered again from the draws the step took (its
    backward draws nothing)."""
    from romis_tpu_torch.diff.grad import (
        make_grad_fn, make_mis_grad_fn, render_mis_with_params,
        render_with_params,
    )
    from romis_tpu_torch.parallel.mis import make_sharded_mis_train_step
    from romis_tpu_torch.parallel.shard import make_sharded_grad_fn
    from romis_tpu_torch.render import restir

    f, cam, p, target = setup
    args = (scene.geometry, scene.lights, scene.num_lights, H, W, f)
    out = {"images": [], "loss": [], "grads": []}
    gen = torch.Generator(device=dev).manual_seed(31)
    if path in SHARD_MIS:
        if bands is None:
            loss, grads = make_mis_grad_fn(*args)(p, target, gen, cam)
        else:
            _, loss, grads = make_sharded_mis_train_step(
                *args, bands, lr=SHARD_LR)(p, target, gen, cam)
        with torch.no_grad():
            out["images"].append(render_mis_with_params(
                p, torch.Generator(device=dev).manual_seed(31), cam, *args,
                band=bands))
        out["loss"].append(loss)
        out["grads"].append(grads)
        return out
    fn = make_grad_fn(*args) if bands is None else \
        make_sharded_grad_fn(*args, bands)
    prev = restir.initial_temporal_state(H if bands is None else bands.h_loc,
                                         W, 2, cam)
    for _ in range(2):
        drawn = gen.get_state()
        loss, grads, *state = fn(p, target, gen, cam, prev)
        with torch.no_grad():
            img, prev = render_with_params(
                p, torch.Generator(device=dev).set_state(drawn), cam, *args,
                prev, band=bands)
        require(not state or torch.equal(state[0].reservoirs.w_sum,
                                          prev.reservoirs.w_sum),
                f"{path}: the step's state differs from its frame's")
        out["images"].append(img)
        out["loss"].append(loss)
        out["grads"].append(grads)
    return out


def shard_compare(label: str, got, ref, world: int) -> str:
    """A sharded run's frame images (gathered, on rank 0), loss and
    gradients against the single-device step's → a summary."""
    import torch

    for i, (img, want) in enumerate(zip(got["images"], ref["images"])):
        require(torch.equal(img, want), f"{label}: frame {i + 1}'s image "
                                        f"differs from the single device's")
    tol = shard_tolerance(ref["spread"])
    worst, loss_rel = 0.0, 0.0
    for la, lb, ga, gb in zip(got["loss"], ref["loss"], got["grads"],
                              ref["grads"]):
        loss_rel = max(loss_rel, abs(la.item() - lb.item()) / abs(lb.item()))
        worst = max(worst, shard_close(label, ga, gb, tol))
    require(loss_rel <= SHARD_REL, f"{label}: loss {loss_rel:.3e} apart")
    return (f"images bit-equal over {len(ref['images'])} frame(s), loss "
            f"{loss_rel:.2e} apart, the worst leaf at {worst:.3f} of its "
            f"tolerance (world {world})")


def timed_steps(torch, step, n: int):
    """(ms per step by CUDA events over ``n`` calls of ``step``, peak device
    memory above what was held, what was held)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        step()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, torch.cuda.max_memory_allocated() - held, \
        held


def exchange_share(torch, step):
    """One call of ``step`` with every halo exchange (``parallel.halo.
    _swap_rows``, forward and backward) and the gradients' all_reduce
    (``Bands.all_reduce``) bracketed by synchronisations → (step ms, halo
    ms, exchanges, all_reduce ms), host clock."""
    from romis_tpu_torch.parallel import halo, mesh

    acc = {"halo": 0.0, "n": 0, "reduce": 0.0}
    swap, reduce_ = halo._swap_rows, mesh.Bands.all_reduce

    def bracket(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            acc["n"] += key == "halo"
            return out
        return run
    halo._swap_rows = bracket(swap, "halo")
    mesh.Bands.all_reduce = bracket(reduce_, "reduce")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        halo._swap_rows, mesh.Bands.all_reduce = swap, reduce_
    return 1e3 * total, 1e3 * acc["halo"], acc["n"], 1e3 * acc["reduce"]


def shard_step_fn(torch, dev, scene, path: str, setup, bands):
    """A closure taking one step of the section-8 path through the entry a
    user calls (``make_sharded_train_step`` from the state it carries,
    ``make_sharded_mis_train_step``)."""
    from romis_tpu_torch.parallel.mis import make_sharded_mis_train_step
    from romis_tpu_torch.parallel.shard import make_sharded_train_step

    f, cam, p, target = setup
    args = (scene.geometry, scene.lights, scene.num_lights, H, W, f, bands)
    gen = torch.Generator(device=dev).manual_seed(37)
    if path in SHARD_MIS:
        step = make_sharded_mis_train_step(*args, lr=SHARD_LR)
        return lambda: step(p, target, gen, cam)
    step = make_sharded_train_step(*args, lr=SHARD_LR)
    carry = {"p": p, "state": None}

    def one():
        carry["p"], loss, carry["state"] = step(carry["p"], target, gen, cam,
                                                carry["state"])
        return loss
    return one


def grad_halo_replay(torch, seen, bands):
    """A band's differentiable halo exchange in one process: its k-th call
    returns the band's own rows (their graph kept) between the rows above
    and below the band cut from the k-th recorded whole-frame tensor (zeros
    beyond the frame; the whole step's graph kept), and requires the band's
    rows to be the whole frame's. The sum over the bands of the gradients
    into their own and the whole step's leaves is then the whole step's
    gradient: every band's halo rows reach the parameters through the
    whole step's graph, as they reach them through their neighbour's band
    with a group."""
    calls = iter(seen)

    def exchange(x, radius, b):
        rec = next(calls, None)
        require(rec is not None and rec[1] == radius and rec[0].shape[:-2]
                == x.shape[:-2], f"band {b.rank} of {b.world}: halo exchange "
                                 f"out of step")
        lo, h = b.row_base, b.h_loc
        require(torch.equal(x, rec[0][..., lo:lo + h, :]),
                f"band {b.rank} of {b.world}: its rows before a halo "
                f"exchange differ from the whole frame's")
        pad = torch.nn.functional.pad(rec[0], (0, 0, radius, radius))
        return torch.cat([pad[..., lo:lo + radius, :], x,
                          pad[..., lo + radius + h:lo + 2 * radius + h, :]],
                         dim=-2)
    return exchange


def shard_bands_in_process(torch, dev, scene, path: str, h: int,
                           spread: dict, card: str):
    """A section-8 path's step at h rows as 2 and 4 bands in one process
    (``grad_halo_replay``), each band's term of the loss differentiated
    into its own leaves and the whole step's: the sum over the bands equals
    the whole step's (one band, ``HaloRecorder``) gradient within the
    tolerance of the single-device step's ``spread`` (``shard_reference``'s
    at 1080p), and the sum of the terms its loss."""
    from romis_tpu_torch.diff.grad import SceneParams
    from romis_tpu_torch.parallel.mesh import Bands
    from romis_tpu_torch.parallel.mis import mis_band_loss
    from romis_tpu_torch.parallel.shard import band_loss

    f, cam, p, target = shard_setup(torch, dev, scene, path, h)
    args = (scene.geometry, scene.lights, scene.num_lights, h, W, f)

    def term(params, bands):
        gen = torch.Generator(device=dev).manual_seed(41)
        if path in SHARD_MIS:
            return mis_band_loss(params, target, gen, cam, *args, bands)
        return band_loss(params, target, gen, cam, *args, None, bands)[0]

    tol = shard_tolerance(spread)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = HaloRecorder()
    leaves_w = [x.detach().requires_grad_() for x in p.leaves()]
    t_w = term(SceneParams(*leaves_w), Bands(h, exchange=rec))
    g_w = SceneParams(*(torch.zeros_like(x) if g is None else g for x, g in
                        zip(leaves_w, torch.autograd.grad(
                            t_w, leaves_w, retain_graph=True,
                            allow_unused=True))))
    seen = list(rec.seen)
    lines = []
    for n in BAND_SPLITS:
        total = [torch.zeros_like(x) for x in leaves_w]
        t_sum = 0.0
        for b in range(n):
            leaves_b = [x.detach().requires_grad_() for x in p.leaves()]
            t_b = term(SceneParams(*leaves_b), Bands(
                h, n, b, exchange=grad_halo_replay(torch, seen,
                                                   Bands(h, n, b))))
            grads = torch.autograd.grad(t_b, leaves_b + leaves_w,
                                        retain_graph=True, allow_unused=True)
            for i, g in enumerate(grads):
                if g is not None:
                    total[i % len(leaves_w)] += g
            t_sum += t_b.item()
            del t_b, grads
        loss_rel = abs(t_sum - t_w.item()) / abs(t_w.item())
        require(loss_rel <= SHARD_REL, f"{path} in {n} bands: the terms sum "
                                       f"to {t_sum}, not {t_w.item()}")
        worst = shard_close(f"{path} in {n} bands", SceneParams(*total), g_w,
                            tol)
        lines.append(f"{n} bands: terms {loss_rel:.2e} from the loss, the "
                     f"worst leaf at {worst:.3f} of its tolerance")
    peak = torch.cuda.max_memory_allocated()
    print(f"shard[{path}] in one process at {W}x{h}: the bands' gradients "
          f"sum to the whole step's over {len(seen)} halo exchanges a band "
          f"({'; '.join(lines)}); tolerance {SHARD_SPREAD} x the single "
          f"device's spread, at least {SHARD_REL}; peak {peak / 2**30:.3f} "
          f"GiB with the whole step's graph retained [{card}]")
    del t_w, g_w, seen, rec, leaves_w


def replay_band_checks(torch, dev, card: str, scene, cam) -> dict:
    """Kernel 14's band entry (``romis_ris_replay_band``) at 1080p on the
    flagship: on an inner band of 4 and the bottom band of 2, against its
    plain version at the band's shape on the same uniforms (every plane
    within BAND_RTOL on MIN_AGREE of the pixels) and on its Philox stream
    against the whole frame's kernel's rows (bit for bit); the inner band
    timed beside a quarter of the whole frame's → its kernel-table row."""
    from dataclasses import fields

    from romis_tpu_torch import Features
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops import ris
    from romis_tpu_torch.ops.wrs import gen_canonical_replay_plain
    from romis_tpu_torch.render import restir

    feats = Features(surrogate_resampling_grad=True)
    k, s = feats.num_samples_in_reservoir, feats.initial_light_samples
    sk = -(-s // k)
    li, nl = scene.lights, scene.num_lights
    _, ctx = restir.trace_primary(generate_rays(cam, H, W), scene.geometry,
                                  feats)
    gen = torch.Generator(device=dev).manual_seed(4327)

    def flat(out):
        return torch.stack([out[0], *out[1], *out[2]])

    row = {}
    for n, b in ((4, 1), (2, 1)):
        h, base = H // n, (H // n) * b
        band = dict(row_base=base, h_global=H)
        bctx = replace(ctx, **{f.name: getattr(ctx, f.name)[
            ..., base:base + h, :].contiguous() for f in fields(ctx)})
        uni = torch.rand((sk, 5, k, h, W), generator=gen, device=dev)
        got = flat(ris.gen_canonical_replay(bctx, li, nl, feats, uniforms=uni,
                                            **band))
        plain = flat(gen_canonical_replay_plain(bctx, li, nl, feats,
                                                uniforms=uni, **band))
        ok = (got - plain).abs() <= BAND_ATOL + BAND_RTOL * plain.abs()
        share = ok.reshape(-1, h, W).all(dim=0).float().mean().item()
        err = (got - plain).abs().max().item()
        seeded = [torch.Generator(device=dev).manual_seed(5) for _ in
                  range(2)]
        band_x = flat(ris.gen_canonical_replay(bctx, li, nl, feats,
                                               generator=seeded[0], **band))
        whole_x = flat(ris.gen_canonical_replay(ctx, li, nl, feats,
                                                generator=seeded[1]))
        exact = torch.equal(band_x, whole_x[..., base:base + h, :])
        print(f"check band entry ris_replay[{b} of {n}]: pixels within rtol "
              f"{BAND_RTOL} of the plain version at the band's shape "
              f"{share:.6f} (max abs err {err:.3e}); Philox band bit-equal "
              f"to the whole frame's rows {exact}")
        require(share >= MIN_AGREE, f"band entry ris_replay [{b} of {n}]: "
                                    f"{share} of the pixels agree")
        require(exact, f"band entry ris_replay [{b} of {n}]: the band's rows "
                       f"differ from the whole frame's")
        if (n, b) != (4, 1):
            continue
        b_ms = cuda_ms(torch, lambda: ris.gen_canonical_replay(
            bctx, li, nl, feats, generator=gen, **band), 10)
        w_ms = cuda_ms(torch, lambda: ris.gen_canonical_replay(
            ctx, li, nl, feats, generator=gen), 10)
        p_ms = cuda_ms(torch, lambda: gen_canonical_replay_plain(
            bctx, li, nl, feats, generator=gen, **band), 2)
        hw = h * W
        bnd = bound(hw * 4 * (17 + 7 * k), hw * s * (
            CANDIDATE_OPS + RACE_OPS + DRAW_OPS + PHILOX_OPS + UNIFORM_OPS))
        print(f"time band entry ris_replay[{b} of {n}]: {b_ms:.4f} ms (Philox)"
              f" for {h} rows vs {w_ms / n:.4f} ms, a quarter of the whole "
              f"frame's {w_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"{bnd[0] / b_ms:.2f} of it reached; plain {p_ms:.4f} ms "
              f"[{card}]")
        row = dict(max_abs_err=err, ms=b_ms, plain_ms=p_ms, bound=bnd)
    return row


def shard_rank(rank: int, world: int, store: str, ref_file: str,
               out: str) -> None:
    """A rank of section 8's NCCL groups of 2 and 4 on card ``rank``: each
    path's sharded step on the group (rank 0 holding its images, loss and
    gradients to the single-device step's, read from ``ref_file``), its ms
    and peak memory per step, and the share of an instrumented step spent
    in the halo exchanges and the all_reduce → a JSON line per rank in
    ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from romis_tpu_torch.parallel.halo import gather_image
    from romis_tpu_torch.parallel.launch import global_bands
    from romis_tpu_torch.scene.scene import flagship_scene

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=NCCL_TIMEOUT_S))
    refs = torch.load(ref_file, map_location=dev, weights_only=False) \
        if rank == 0 else None
    scene = flagship_scene(dev)
    bands = global_bands(H)
    result = {}
    for path in SHARD_GRAD + SHARD_MIS:
        setup = shard_setup(torch, dev, scene, path, H)
        got = shard_run(torch, dev, scene, path, setup, bands)
        got["images"] = [gather_image(i, bands) for i in got["images"]]
        summary = None
        if rank == 0:
            summary = shard_compare(f"{path} on {world} ranks", got,
                                    refs[path], world)
        del got
        step = shard_step_fn(torch, dev, scene, path, setup, bands)
        ms, peak, held = timed_steps(torch, step, FRAMES[path])
        dist.barrier()
        total, halo_ms, n_ex, red_ms = exchange_share(torch, step)
        result[path] = dict(summary=summary, ms=ms, peak=peak, held=held,
                            instrumented=total, halo=halo_ms, exchanges=n_ex,
                            reduce=red_ms)
        del step, setup
        torch.cuda.empty_cache()
    with open(out, "a") as fh:
        fh.write(json.dumps({"rank": rank, **result}) + "\n")
    dist.barrier()
    dist.destroy_process_group()


def shard_grad_phase(torch, dev, card: str, entries: dict) -> dict:
    """Section 8: the sharded training steps. Kernel 14's band entry
    (``replay_band_checks``); then through an NCCL group of one rank each
    path of SHARD_GRAD and SHARD_MIS at 1920x1080, its images bit-equal to
    the single-device step's, its loss and leaves within the tolerance of
    the single-device step's spread, its launches asserted (PATHS), its
    ms and peak memory per step; the bands in one process
    (``shard_bands_in_process``: the ReSTIR paths at 1080p, the MIS paths
    at SHARD_MIS_H rows); and with two or more cards NCCL groups of 2 and
    4 ranks, one a card (``shard_rank``). → {kernel-table row of the band
    entry, the paths' launches}."""
    import tempfile

    import torch.distributed as dist

    from romis_tpu_torch.parallel.launch import global_bands
    from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene
    from romis_tpu_torch.utils import stats

    scene, cam = flagship_scene(dev), flagship_camera(H, W, dev)
    row = replay_band_checks(torch, dev, card, scene, cam)
    refs, launched = {}, {n: 0 for n in entries}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        bands = global_bands(H)
        require(bands.world == 1, "group[nccl, 1 rank]: world")
        for path in SHARD_GRAD + SHARD_MIS:
            setup = shard_setup(torch, dev, scene, path, H)
            refs[path] = shard_reference(torch, dev, scene, path, setup)
            got = shard_run(torch, dev, scene, path, setup, bands)
            summary = shard_compare(f"{path} on 1 rank", got, refs[path], 1)
            del got
            # The main path's run: the training step a user calls, with
            # the counts set to 0 just before it and read just after, and
            # timed.
            step = shard_step_fn(torch, dev, scene, path, setup, bands)
            stats.launches.clear()
            ms, peak, held = timed_steps(torch, step, FRAMES[path])
            counts = launch_counts(entries)
            expect = {n: PATHS[path].get(n, 0) * FRAMES[path]
                      for n in entries}
            print(f"path {path}: launches over {FRAMES[path]} step(s) "
                  f"{ {n: c for n, c in counts.items() if c} }")
            require(counts == expect, f"{path}: launch counts {counts} != "
                                      f"{expect}")
            for n, c in counts.items():
                launched[n] += c
            tol = shard_tolerance(refs[path]["spread"])
            spread = max(refs[path]["spread"].values())
            print(f"shard[{path}] nccl, 1 rank at {W}x{H}: {summary}; "
                  f"single-device spread {spread:.2e} at most, tolerances "
                  f"{min(tol.values()):.1e}..{max(tol.values()):.1e}; "
                  f"{ms:.3f} ms/step, peak {peak / 2**30:.3f} GiB above the "
                  f"{held / 2**30:.3f} held; no halo exchange at one rank "
                  f"[{card}]")
            del step, setup
            torch.cuda.empty_cache()
        x = torch.ones(4, device=dev)
        dist.all_reduce(x)
        require(x.tolist() == [1.0] * 4, "group[nccl, 1 rank]: all_reduce")
        dist.destroy_process_group()
    for path in SHARD_GRAD:
        shard_bands_in_process(torch, dev, scene, path, H,
                               refs[path]["spread"], card)
        torch.cuda.empty_cache()
    print(f"shard: the MIS steps' bands in one process at {W}x{SHARD_MIS_H} "
          f"(the whole step's graph retained beside one band's)")
    for path in SHARD_MIS:
        shard_bands_in_process(torch, dev, scene, path, SHARD_MIS_H,
                               refs[path]["spread"], card)
        torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"shard[nccl, 2 ranks]: skipped: this machine has {n_cards} "
              f"CUDA device; NCCL puts each rank on a card of its own")
    else:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            ref_file = f"{tmp}/refs.pt"
            torch.save({p: {k_: v for k_, v in r.items()}
                        for p, r in refs.items()}, ref_file)
            del refs
            torch.cuda.empty_cache()
            for world in (2, 4):
                if world > n_cards:
                    continue
                out = Path(tmp) / f"ranks{world}.jsonl"
                t0 = time.perf_counter()
                mp.spawn(shard_rank, args=(world, f"{tmp}/store{world}",
                                           ref_file, str(out)),
                         nprocs=world, join=True)
                res = sorted((json.loads(line) for line in
                              out.read_text().splitlines()),
                             key=lambda r: r["rank"])
                for path in SHARD_GRAD + SHARD_MIS:
                    r0 = res[0][path]
                    print(f"shard[{path}] nccl, {world} ranks: "
                          f"{r0['summary']}; ms/step per rank "
                          + ", ".join(f"{r[path]['ms']:.3f}" for r in res)
                          + "; peak GiB per rank "
                          + ", ".join(f"{r[path]['peak'] / 2**30:.3f}"
                                      for r in res)
                          + f" above {r0['held'] / 2**30:.3f} held; an "
                          f"instrumented step (synchronised around each "
                          f"exchange) per rank: "
                          + ", ".join(
                              f"{r[path]['instrumented']:.1f} ms, halo "
                              f"{r[path]['halo']:.1f} ms in "
                              f"{r[path]['exchanges']} exchanges "
                              f"({100 * r[path]['halo'] / r[path]['instrumented']:.1f} %), "
                              f"all_reduce {r[path]['reduce']:.2f} ms"
                              for r in res)
                          + f" [{card}]")
                print(f"shard[nccl, {world} ranks]: "
                      f"{time.perf_counter() - t0:.1f} s with the ranks' "
                      f"start")
    return dict(row=row, launches=launched)


def main() -> None:
    import numpy as np
    import torch

    # ---- 1. the device ----
    sys.stdout.reconfigure(line_buffering=True)
    t_run = time.perf_counter()

    def section(label):
        print(f"section {label}: {time.perf_counter() - t_run:.1f} s into "
              f"the run")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    from romis_tpu_torch import (
        Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
    )
    from romis_tpu_torch.core.camera import (
        generate_rays, make_camera,
    )
    from romis_tpu_torch.core.types import (
        Rays, pack_reservoir_planes, unpack_reservoir_planes,
    )
    from romis_tpu_torch.diff.grad import (
        extract_params, make_grad_fn, render_with_params,
    )
    from romis_tpu_torch.ops import (
        _build, mis, nbrsel, rows, ris, scatter, shade, spatial, trace, walk,
    )
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.ops.traverse import (
        bvh_any, bvh_any_wide, bvh_closest, bvh_closest_ordered,
    )
    from romis_tpu_torch.ops.wrs import (
        gen_canonical_replay_plain, gen_canonical_samples_plain,
        gen_canonical_surrogate, gumbel_noise, replay_uniforms, visibility,
        visibility_from,
    )
    from romis_tpu_torch.render import restir
    from romis_tpu_torch.render.animation import (
        camera_at, interpolate_cameras, render_animation, stack_cameras,
    )
    from romis_tpu_torch.render.neighbours import select_neighbour_indices
    from romis_tpu_torch.render.pipeline import render_frame, save_image
    from romis_tpu_torch.render.rmis import mis_ext_vis, mis_offsets
    from romis_tpu_torch.scene.scene import (
        build_geometry, flagship_camera, flagship_scene, repack_rows,
        torus_field, torus_field_camera,
    )
    from romis_tpu_torch.ops.wrs import SHADOW_RAY_EPSILON
    from romis_tpu_torch.utils import stats

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. the build ----
    section("2")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    # The compiler's report, one line per kernel: registers, spill bytes.
    entry, regs, spill = "", [], 0
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line:
            regs.append(f"{entry.replace('_ZN5romis', '')[:32]} "
                        f"{line.split('Used')[1].split()[0]}r"
                        + (f"+{spill}B" if spill else ""))
    print(f"ptxas ({len(regs)} kernels; registers, spill stores): "
          + ", ".join(regs))
    nvcc_s = [line.split()[2:] for line in (_build.BUILD_DIR / "build.log")
              .read_text().splitlines() if line.startswith("nvcc seconds")]
    print("build: seconds of each nvcc from the common start: "
          + ", ".join(f"{a} {b}" for a, b in nvcc_s))
    t0 = time.perf_counter()
    host = _build.build_host()
    _build.host_library()
    print(f"build: host BVH builder {time.perf_counter() - t0:.1f} s -> "
          f"{host.name}")

    entries = kernel_entries()

    # ---- 3. each kernel against its plain version ----
    section("3")
    feats = Features()
    k, s = feats.num_samples_in_reservoir, feats.initial_light_samples
    n_nbr, radius = feats.num_neighbours_to_sample, \
        feats.spatial_resample_radius
    sk = -(-s // k)
    scene = flagship_scene(dev)
    cam = flagship_camera(H, W, dev)
    rays = generate_rays(cam, H, W)
    soup = build_geometry([random_soup(SOUP_TRIS, (2.57, 1.23, -1.35), 3.0,
                                       seed=7)], dev)
    require(soup.tri_cols.shape[1] == SOUP_TRIS, "soup size")
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {}

    def check_trace(geometry, label, r=rays):
        """Kernel 1 (or 18 on BVH geometry) against the plain version: the
        same t, tri, u and v on every ray; the rays that differ are
        counted → the largest |t| difference."""
        out_k = trace.closest_hit(r, geometry)
        out_p = trace.closest_hit_plain(r, geometry)
        torch.cuda.synchronize()
        differ = torch.zeros(out_p[1].shape, dtype=torch.bool, device=dev)
        for a_k, a_p in zip(out_k, out_p):
            differ |= (a_k != a_p) & ~(torch.isnan(a_k.float())
                                       & torch.isnan(a_p.float()))
        n_diff = int(differ.sum().item())
        both = torch.isfinite(out_k[0]) & torch.isfinite(out_p[0])
        err = (out_k[0][both] - out_p[0][both]).abs()
        print(f"check closest_hit[{label}]: {n_diff} of {differ.numel()} "
              f"rays differ from the plain version in t, tri, u or v (hits "
              f"{torch.isfinite(out_p[0]).float().mean().item():.4f})")
        require(n_diff == 0, f"closest hit {label}: {n_diff} rays differ")
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

    def check_ris(c, label, f=feats):
        uni = torch.rand((sk, 4, k, H, W), generator=gen, device=dev)
        r_k = ris.gen_canonical_samples_ris(c, scene.lights, scene.num_lights,
                                            f, uniforms=uni)
        r_p = gen_canonical_samples_plain(c, scene.lights, scene.num_lights,
                                          f, uniforms=uni)
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

    def check_shade(c, res, geometry, label, f=feats):
        o_k = shade.final_shade_fused(c, res, geometry, f)
        o_p = shade.final_shade_plain(c, res, geometry, f)
        torch.cuda.synchronize()
        err = (o_k - o_p).abs()
        ok = (err <= SHADE_ATOL + SHADE_RTOL * o_p.abs()).all(dim=0)
        agree = ok.float().mean().item()
        print(f"check final_shade[{label}]: pixels within tolerance "
              f"{agree:.6f}, max abs err {err.max().item():.2e}")
        require(agree >= MIN_AGREE, f"final shade {label}: agree {agree}")
        return err[:, ok].max().item()

    def check_soup_shade(c, res, geometry, label, f=feats):
        """Kernel 4 against its plain version: the colour as
        ``check_shade`` holds it, and each lane's occlusion bool equal to
        the plain any-hit's on every lane it traces (False elsewhere)."""
        o_k, occ_k = shade.final_shade_soup(c, res, geometry, f,
                                            occlusion=True)
        occ_p = shade.shadow_occlusion_plain(c, res, geometry, f)
        torch.cuda.synchronize()
        same = torch.equal(occ_k, occ_p)
        print(f"check final_shade[{label}] occlusion: lanes {occ_p.numel()},"
              f" occluded {occ_p.float().mean().item():.4f}, the plain "
              f"any-hit's bool on every lane {same}")
        require(same, f"final shade {label}: kernel 4's occlusion differs "
                "from the plain any-hit's")
        del o_k, occ_k, occ_p
        return check_shade(c, res, geometry, label, f)

    # An empty soup (no triangle: every lane visible) takes the direct
    # loop over nothing.
    empty = replace(
        scene.geometry, tri_cols=scene.geometry.tri_cols[:, :0].contiguous(),
        zcount=None)
    errs["final_shade"] = max(
        check_soup_shade(ctx, res_main, scene.geometry, "flagship"),
        check_soup_shade(soup_ctx, res_soup, soup, "soup2048"),
        check_soup_shade(ctx, res_main, empty, "empty soup"))
    del empty

    # Any-hit: the shadow rays of the initial visibility check (origins
    # pushed toward the RIS winners, t_max the remaining distance).
    def shadow_rays(c, res):
        to = res.pos - c.position
        dist = torch.linalg.vector_norm(to, dim=-3).clamp_min(1e-20)
        d = to / dist[:, None]
        o = c.position + 1e-3 * d
        return o, d, torch.linalg.vector_norm(res.pos - o, dim=-3)

    def check_any(c, res, geometry, label):
        o, d, tm = shadow_rays(c, res)
        occ_k = trace.any_hit(o, d, tm, geometry)
        occ_p = trace.any_hit_plain(o, d, tm, geometry)
        torch.cuda.synchronize()
        same = (occ_k == occ_p).float().mean().item()
        print(f"check any_hit[{label}]: rays {occ_k.numel()}, occluded "
              f"{occ_p.float().mean().item():.4f}, agree {same:.6f}, "
              f"bit-exact {bool(torch.equal(occ_k, occ_p))}")
        require(torch.equal(occ_k, occ_p), f"any-hit {label}: agree {same}")
        return 1.0 - same

    errs["any_hit"] = max(check_any(ctx, res_main, scene.geometry, "flagship"),
                          check_any(soup_ctx, res_soup, soup, "soup2048"))

    # Halo gather (kernel 9) at every shape the frames give it
    # (halo_cases), bit for bit as 32-bit patterns, and on a field beyond
    # the window's margin, a +-100 field clamped at the borders and planes
    # holding infinities, NaNs and signed zeros.
    cam_pan = make_camera(look_at=(2.57, 1.23, -1.35),
                          rotation_deg=(10.3 + PAN_DEG, 30.0 + PAN_DEG, 0.0),
                          distance=25.0, fov_deg=30.0, resolution=(H, W),
                          device=dev)
    halo = halo_cases(torch, gen, ctx, res_main, feats, cam_pan)
    rand40 = spatial.clamped_offsets(torch.randint(
        -40, 41, (2, n_nbr, H, W), generator=gen, device=dev,
        dtype=torch.int32), H, W)
    raw100 = torch.randint(-100, 101, (2, n_nbr, H, W), generator=gen,
                           device=dev, dtype=torch.int32)
    h39 = halo["config5_gather 5x39, random +-10"]
    special = h39[0].clone()
    bits = special.view(torch.int32).reshape(-1)
    picks = torch.randint(0, bits.numel(), (4, bits.numel() // 50),
                          generator=gen, device=dev)
    bits[picks[0]] = 0x7F800000  # +inf
    bits[picks[1]] = -0x800000  # -inf
    bits[picks[2]] = 0x7FC00000 | (picks[2] % (1 << 20)).int()  # NaNs
    bits[picks[3]] = -0x80000000  # -0.0
    halo_extra = {
        "beyond the margin 5x14, random +-40": (
            halo["resolve_neighbour_ctx 5x14, selected"][0], *rand40),
        "+-100 5x39, clamped at the borders": (h39[0], *raw100),
        "specials 5x39 (inf, NaN, -0.0), random +-40": (special, *rand40),
        # Two groups of offset fields (csrc/halo.cu kGatherDGroup).
        "8 fields 8x6, random +-10": (h39[0][:6].contiguous(),
                                      *spatial.clamped_offsets(torch.randint(
                                          -radius, radius + 1, (2, 8, H, W),
                                          generator=gen, device=dev,
                                          dtype=torch.int32), H, W)),
    }
    for label, (pl, dy, dx) in {**halo, **halo_extra}.items():
        g_k = spatial.halo_offset_gather(pl, dy, dx)
        g_p = spatial.halo_offset_gather_plain(pl, dy, dx)
        torch.cuda.synchronize()
        exact = same_bits(torch, g_k, g_p)
        far = spatial.beyond_window(dy, dx).float().mean().item()
        print(f"check halo_gather[{label}]: D={dy.shape[0]}, C={pl.shape[0]}, "
              f"mean |dy| {dy.abs().float().mean().item():.3f}, beyond the "
              f"window {far:.4f}, bit-exact (32-bit patterns) {exact}")
        require(exact, f"halo gather {label} is not bit-exact")
        del g_k, g_p
    errs["halo_gather"] = 0.0
    del special, bits, picks

    # Spatial passes on the RIS reservoirs of the flagship frame.
    cen = shade.pack_center_ctx(ctx)
    gates = spatial.pack_gates(ctx)
    res_planes = pack_reservoir_planes(res_main)

    def pass_pair(f):
        """label → (kernel, plain) of the two passes with features f."""
        return {
            "spatial_pass": (
                lambda **kw: spatial.spatial_pass_fused(
                    res_planes, gates, cen, k, n_nbr, radius, f, **kw),
                lambda **kw: spatial.spatial_pass_plain(
                    res_planes, gates, cen, k, n_nbr, radius, f, **kw)),
            "spatial_pass_unbiased": (
                lambda **kw: spatial.spatial_pass_unbiased_fused(
                    res_planes, cen, k, n_nbr, radius, f, **kw),
                lambda **kw: spatial.spatial_pass_unbiased_plain(
                    res_planes, cen, k, n_nbr, radius, f, **kw)),
        }

    pass_fns = pass_pair(feats)

    def check_pass(label, kernel_fn, plain_fn, offsets=None, philox=True):
        """The pass on injected noise (``offsets`` replacing the drawn
        ones, where given) against its plain version, then on Philox
        against the plain version's own stream."""
        inject = spatial.spatial_noise(gen, n_nbr, k, radius, H, W)
        if offsets is not None:
            inject = (offsets, inject[1])
        o_k = unpack_reservoir_planes(kernel_fn(inject=inject), k)
        o_p = unpack_reservoir_planes(plain_fn(inject=inject), k)
        torch.cuda.synchronize()
        win = ((o_k.pos - o_p.pos).abs()
               <= 1e-6 + 1e-5 * o_p.pos.abs()).all(dim=1)
        agree = win.float().mean().item()

        def rel(a, b, mask=None):
            r = (a - b).abs() / b.abs().clamp_min(1e-30)
            return (r if mask is None else r[mask]).max().item()

        ws_rel = rel(o_k.w_sum, o_p.w_sum)
        m_rel = rel(o_k.m, o_p.m)
        bw_rel = rel(o_k.big_w, o_p.big_w, win)
        live = (o_p.w_sum > 0).float().mean().item()
        print(f"check {label}[injected]: winners agree {agree:.6f}, live "
              f"lanes {live:.4f}, w_sum max rel err {ws_rel:.2e}, M max rel "
              f"err {m_rel:.2e}, big_w max rel err {bw_rel:.2e}")
        require(agree >= MIN_AGREE, f"{label}: winners agree {agree}")
        require(ws_rel <= PASS_W_SUM_RTOL, f"{label}: w_sum {ws_rel}")
        require(m_rel <= PASS_M_RTOL, f"{label}: M {m_rel}")
        require(bw_rel <= PASS_BIG_W_RTOL, f"{label}: big_w {bw_rel}")
        err = max((o_k.w_sum - o_p.w_sum).abs().max().item(),
                  (o_k.big_w - o_p.big_w).abs()[win].max().item())
        if not philox:
            return err
        # Philox mode against the plain version's own draws.
        key = spatial.philox_key(gen)
        p_k = unpack_reservoir_planes(kernel_fn(generator=gen, key=key), k)
        p_p = unpack_reservoir_planes(plain_fn(generator=gen), k)
        for lane in range(k):
            mk = p_k.w_sum[lane].mean().item()
            mp = p_p.w_sum[lane].mean().item()
            print(f"check {label}[philox]: lane {lane} mean w_sum {mk:.6g} "
                  f"vs plain {mp:.6g}")
            require(abs(mk - mp) <= PHILOX_REL * abs(mp),
                    f"{label}: Philox w_sum mean")
        ik = shade.final_shade_plain(ctx, p_k, scene.geometry,
                                     feats).mean().item()
        ip = shade.final_shade_plain(ctx, p_p, scene.geometry,
                                     feats).mean().item()
        print(f"check {label}[philox]: shaded mean {ik:.6g} vs plain {ip:.6g}")
        require(abs(ik - ip) <= PHILOX_REL * abs(ip),
                f"{label}: Philox shaded mean")
        return err

    for label, (kernel_fn, plain_fn) in pass_fns.items():
        errs[label] = check_pass(label, kernel_fn, plain_fn)
    # Kernel 11 reads its neighbours from records: on zero offsets (every
    # neighbour the pixel itself), then at a radius of 40 (injected offsets
    # within +-40, then its Philox stream at that radius), held as above.
    zero = torch.zeros((2, n_nbr, H, W), dtype=torch.int32, device=dev)
    p40 = (lambda **kw: spatial.spatial_pass_unbiased_fused(
        res_planes, cen, k, n_nbr, 40, feats, **kw),
        lambda **kw: spatial.spatial_pass_unbiased_plain(
            res_planes, cen, k, n_nbr, 40, feats, **kw))
    errs["spatial_pass_unbiased"] = max(
        errs["spatial_pass_unbiased"],
        check_pass("spatial_pass_unbiased[zero offsets]",
                   *pass_fns["spatial_pass_unbiased"], zero, False),
        check_pass("spatial_pass_unbiased[radius 40]", *p40,
                   spatial.spatial_noise(gen, n_nbr, k, 40, H, W)[0]))
    del zero

    # The gradient step's kernels. Row scatter-add: the step's tables on
    # the flagship (the light table's 4 M lane indices over 512 rows, the
    # material table's one row, the hit triangles' few rows at C = 9 and
    # C = 24), and the packed v0|e1|e2 of the 2048-triangle soup at its
    # closest-hit triangles; the torus field's below, with its BVH.
    def check_scatter(label, ct, idx, n_rows):
        o_k = scatter.scatter_rows_add(ct, idx, n_rows)
        torch.cuda.synchronize()
        rel, rel64 = scatter_rel(torch, o_k, ct, idx, n_rows)
        rel_p64 = scatter_rel(torch, scatter.scatter_rows_add_plain(
            ct, idx, n_rows), ct, idx, n_rows)[1]
        print(f"check scatter_rows_add[{label}]: rows {n_rows}, columns "
              f"{ct.shape[0]}, indices {idx.numel()}, max err / sum|ct| vs "
              f"plain {rel:.2e}, vs float64 {rel64:.2e} (plain vs float64 "
              f"{rel_p64:.2e}); kernel 13's tile "
              f"{scatter.scatter_tile(ct.shape[0], n_rows)} (0: device "
              f"atomics)")
        require(rel <= SCATTER_REL, f"scatter {label}: vs plain {rel}")
        require(rel64 <= SCATTER_F64_REL, f"scatter {label}: vs f64 {rel64}")
        return (o_k - scatter.scatter_rows_add_plain(ct, idx, n_rows)
                ).abs().max().item()

    scatter_cases = scatter_tables(
        torch, gen, scene, trace.closest_hit_plain(rays, scene.geometry)[1],
        k)
    scatter_cases["soup2048"] = (
        torch.randn((9, H, W), generator=gen, device=dev),
        torch.clamp_min(trace.closest_hit_plain(rays, soup)[1], 0),
        SOUP_TRIS)
    light_idx = scatter_cases["lights"][1]
    errs["scatter_rows_add"] = max(check_scatter(label, *case)
                                   for label, case in scatter_cases.items())

    # Halo scatter (kernel 10): the per-pixel path's big_w cotangents
    # (D = R = 5, C = K = 2) at clamped offsets within ±radius; the smooth
    # field of a large camera shift (every source beyond the kernel's
    # margin: its device-memory branch); raw offsets of up to ±5000, which
    # the scatter clamps onto all four borders.
    halo_ct = torch.randn((n_nbr, k, H, W), generator=gen, device=dev)
    sdy, sdx = spatial.clamped_offsets(torch.randint(
        -radius, radius + 1, (2, n_nbr, H, W), generator=gen, device=dev,
        dtype=torch.int32), H, W)
    ys_i = torch.arange(H, device=dev)[:, None]
    xs_i = torch.arange(W, device=dev)[None, :]
    shift_dy = torch.full((n_nbr, H, W), 37, dtype=torch.int32, device=dev)
    shift_dx = (-53 + 3 * torch.sin(xs_i / 50.0 + ys_i / 70.0)).int() \
        .expand(n_nbr, H, W).contiguous()
    border_dy, border_dx = torch.randint(
        -5000, 5001, (2, n_nbr, H, W), generator=gen, device=dev,
        dtype=torch.int32)
    errs["halo_scatter"] = 0.0

    def check_halo_scatter(label, ct, hdy, hdx):
        hs_k = spatial.halo_offset_scatter(ct, hdy, hdx)
        hs_p = spatial.halo_offset_scatter_plain(ct, hdy, hdx)
        hs_mag = spatial.halo_offset_scatter_plain(ct.abs(), hdy,
                                                   hdx).clamp_min(1e-30)
        torch.cuda.synchronize()
        hs_rel = ((hs_k - hs_p).abs() / hs_mag).max().item()
        far = spatial.beyond_margin(hdy, hdx).float().mean().item()
        print(f"check halo_scatter[{label}]: D={ct.shape[0]}, C="
              f"{ct.shape[1]}, {ct.shape[2]}x{ct.shape[3]}, max err / "
              f"sum|ct| {hs_rel:.2e}, sources beyond the margin "
              f"{far:.4f}")
        require(hs_rel <= HALO_SCATTER_REL, f"halo scatter {label}: "
                f"{hs_rel}")
        errs["halo_scatter"] = max(errs["halo_scatter"],
                                   (hs_k - hs_p).abs().max().item())

    for label, (hdy, hdx) in {
            f"±{radius}": (sdy, sdx), "camera shift (37, -53)": (shift_dy,
                                                                 shift_dx),
            "±5000, clamped at the borders": (border_dy, border_dx)}.items():
        check_halo_scatter(label, halo_ct, hdy, hdx)
    del shift_dy, shift_dx, border_dy, border_dx
    # The gradient steps' own shapes (HALO_SCATTERED): cotangents
    # [D, C, h, w] of each gather, at the offsets kernel 9 gathered with.
    for label in HALO_SCATTERED:
        pl, hdy, hdx = halo[label]
        check_halo_scatter(label, torch.randn(
            (hdy.shape[0], *pl.shape), generator=gen, device=dev), hdy, hdx)

    # The MIS gradient step's records path (render.rmis.gather_nb_records):
    # the surrogate's winner records of the flagship frame, gathered at
    # the neighbour selection's offsets, self first, give D1·K light
    # indices a pixel into the light table, through kernel 2 and back
    # through kernel 13.
    _, rec = gen_canonical_surrogate(
        ctx, scene.lights, scene.num_lights, scene.geometry,
        feats.replace(surrogate_resampling_grad=True), generator=gen)
    rec_pl = rec[:, 0].contiguous()  # [K, H, W] light index (-1: none)
    rec_idx = torch.clamp_min(torch.cat([
        rec_pl[None], spatial.halo_offset_gather(
            rec_pl, *halo["mis_ext_vis 5x6, selected"][1:])]), 0.0).int()
    del rec, rec_pl
    l_tab = scene.lights.rows
    exact = torch.equal(rows.gather_rows(l_tab, rec_idx),
                        rows.gather_rows_plain(l_tab, rec_idx))
    torch.cuda.synchronize()
    print(f"check gather_rows[records]: {tuple(rec_idx.shape)} = "
          f"{rec_idx.numel()} light indices, bit-exact {exact}")
    require(exact, "gather_rows at the records' indices is not bit-exact")

    def records_ct():
        """Kernel 13's cotangents at the records' indices [24, D1, K, H,
        W]."""
        return torch.randn((l_tab.shape[1], *rec_idx.shape), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               17))

    errs["scatter_rows_add"] = max(errs["scatter_rows_add"], check_scatter(
        "records lights", records_ct(), rec_idx, l_tab.shape[0]))

    # Replay RIS: injected uniforms (records exact), then Philox.
    def check_replay(c, label, f=feats):
        uni5 = torch.rand((sk, 5, k, H, W), generator=gen, device=dev)
        w_k, *recs_k = ris.gen_canonical_replay(c, scene.lights,
                                                scene.num_lights, f,
                                                uniforms=uni5)
        w_p, *recs_p = gen_canonical_replay_plain(c, scene.lights,
                                                  scene.num_lights, f,
                                                  uniforms=uni5)
        torch.cuda.synchronize()
        same = torch.stack([a == b for rk, rp in zip(recs_k, recs_p)
                            for a, b in zip(rk, rp)]).all(dim=0)
        share = same.float().mean().item()
        ws_rel = ((w_k - w_p).abs() / w_p.abs().clamp_min(1e-30)).max().item()
        print(f"check ris_replay[{label}, uniforms]: records of both races "
              f"exact on {share:.7f} of the lanes ({(~same).sum().item()} "
              f"apart), w_sum max rel err {ws_rel:.2e}, live lanes "
              f"{(w_p > 0).float().mean().item():.4f}")
        # Unshaded, every candidate of a pixel has the same weight and the
        # noise alone decides a race: the kernel's exponential race and the
        # plain Gumbel-max may then round apart on nearly equal uniforms.
        require(share == 1.0 if f.enable_shading else share >= MIN_AGREE,
                f"replay {label}: records differ")
        require(ws_rel <= RIS_W_SUM_RTOL, f"replay {label}: w_sum {ws_rel}")
        return (w_k - w_p).abs().max().item()

    errs["ris_replay"] = max(check_replay(ctx, "flagship"),
                             check_replay(soup_ctx, "soup2048"))
    w_k = ris.gen_canonical_replay(ctx, scene.lights, scene.num_lights, feats,
                                   generator=gen)[0]
    w_p = gen_canonical_replay_plain(ctx, scene.lights, scene.num_lights,
                                     feats, generator=gen)[0]
    for lane in range(k):
        mk, mp = w_k[lane].mean().item(), w_p[lane].mean().item()
        print(f"check ris_replay[philox]: lane {lane} mean w_sum {mk:.6g} vs "
              f"plain {mp:.6g}")
        require(abs(mk - mp) <= PHILOX_REL * abs(mp), "replay Philox w_sum")

    # One torch.autograd.grad through each autograd wrapper, against
    # autograd of the plain version.
    def check_grad(label, kernel_fn, plain_fn, leaves):
        outs_k, outs_p = kernel_fn(), plain_fn()
        cts = [torch.randn(o.shape, generator=gen, device=dev)
               for o in outs_k]
        g_k = torch.autograd.grad(outs_k, leaves, cts)
        g_p = torch.autograd.grad(outs_p, leaves, cts)
        torch.cuda.synchronize()
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  .item() for a, b in zip(g_k, g_p))
        nz = all(bool(b.abs().max() > 0) for b in g_p)
        print(f"check grad[{label}]: max err / max |g| {rel:.2e}, all leaves "
              f"reached {nz}")
        require(rel <= GRAD_REL and nz, f"grad {label}: {rel}")

    table_g = scene.lights.rows.clone().requires_grad_()
    check_grad("gather_rows", lambda: [rows.gather_rows(table_g, light_idx)],
               lambda: [rows.gather_rows_plain(table_g, light_idx)],
               [table_g])
    planes_g = torch.rand((k, H, W), generator=gen,
                          device=dev).requires_grad_()
    check_grad("halo_gather",
               lambda: [spatial.halo_offset_gather(planes_g, sdy, sdx)],
               lambda: [spatial.halo_offset_gather_plain(planes_g, sdy, sdx)],
               [planes_g])
    verts = [getattr(scene.geometry, f).clone().requires_grad_()
             for f in ("v0", "e1", "e2")]
    geo_g = repack_rows(replace(scene.geometry, v0=verts[0], e1=verts[1],
                                e2=verts[2]))
    hit_mask = torch.isfinite(trace.closest_hit_plain(rays, geo_g)[0])

    def tuv(fn):
        t_, _, u_, v_ = fn(rays, geo_g)
        return [torch.where(hit_mask, t_, 0.0), u_, v_]

    check_grad("closest_hit", lambda: tuv(trace.closest_hit),
               lambda: tuv(trace.closest_hit_plain), verts)
    shade_leaves = [ctx.kd.clone().requires_grad_(),
                    res_main.pos.clone().requires_grad_(),
                    res_main.color.clone().requires_grad_(),
                    res_main.big_w.clone().requires_grad_()]
    ctx_g = replace(ctx, kd=shade_leaves[0])
    res_g = replace(res_main, pos=shade_leaves[1], color=shade_leaves[2],
                    big_w=shade_leaves[3])
    check_grad("final_shade",
               lambda: [shade.final_shade_fused(ctx_g, res_g, scene.geometry,
                                                feats)],
               lambda: [shade.final_shade_plain(ctx_g, res_g, scene.geometry,
                                                feats)], shade_leaves)

    # The R-MIS / R-OMIS kernels. Neighbour selection over the +-10 box
    # (440 cells) for the three similarity strategies: injected score
    # planes (3.6 GB at 1080p), then the Philox stream.
    it_n = feats.max_iterations_mis
    sel_gates = nbrsel.selection_gates(ctx)
    sel_args = (feats.neighbour_same_geometry,
                feats.neighbour_max_depth_difference_fraction,
                math.cos(feats.neighbour_max_normal_angle_difference_radians))
    strategies = {"similar": (False, True), "dissimilar": (False, False),
                  "equal_similar_dissimilar": (True, True)}

    def preferred_share(o, two):
        """Share of the real picks that fall in the preferred class."""
        if two:
            n_sim = torch.isfinite(o[0]).sum()
            return (n_sim / (n_sim + torch.isfinite(o[2]).sum())).item()
        real = torch.isfinite(o[0])
        return ((o[0] >= nbrsel.CLASS_OFFSET / 2) & real).sum().item() / max(
            real.sum().item(), 1)

    side = 2 * radius + 1
    box_dy = (torch.arange(side * side, device=dev) // side - radius).double()
    box_dx = (torch.arange(side * side, device=dev) % side - radius).double()

    def pick_hist(o, two):
        """Shares of the real picks over (class, box offset) [2, side²];
        class 0 is the preferred one (similar with two classes)."""
        if two:
            parts = [(o[0], o[1], 0), (o[2], o[3], 1)]
        else:
            parts = [(o[0], o[1], (o[0] < nbrsel.CLASS_OFFSET / 2).long())]
        idx = torch.cat([torch.where(torch.isfinite(sc), pk.long() + c
                                     * side * side, -1).flatten()
                         for sc, pk, c in parts])
        idx = idx[idx >= 0]
        return (torch.bincount(idx, minlength=2 * side * side).double()
                / max(idx.numel(), 1)).reshape(2, side * side)

    def pick_moments(hist):
        """Mean and spread of the picked dy and dx."""
        box = hist.sum(dim=0)
        out = []
        for v in (box_dy, box_dx):
            mean = (box * v).sum().item()
            out += [mean, math.sqrt(max((box * v * v).sum().item()
                                        - mean * mean, 0.0))]
        return out

    def top_score(o):
        """Mean best score of the preferred class, its offset removed."""
        top = o[0][0][torch.isfinite(o[0][0])].double()
        return torch.where(top >= nbrsel.CLASS_OFFSET / 2,
                           top - nbrsel.CLASS_OFFSET, top).mean().item()

    # The filtered race skips a cell by its key, which is exact only if the
    # kernel's compiled Gumbel score is non-decreasing in the key: its own
    # function on all 2^24 keys.
    table = nbrsel.gumbel_table()
    down = int((table[1:] < table[:-1]).sum().item())
    print(f"check neighbour_select[gumbel table]: the kernel's score of all "
          f"{table.numel()} keys: {torch.unique(table).numel()} levels, "
          f"from {table[0].item():.6f} to {table[-1].item():.6f}, "
          f"{down} keys scored below the key before them")
    require(bool(torch.all(table[1:] >= table[:-1])),
            f"selection: the compiled score decreases at {down} keys")
    del table
    sel_scores = nbrsel.selection_noise(gen, radius, H, W)
    errs["neighbour_select"] = 0.0
    sel_work = {}  # the filtered race's cells on the main path's stream
    for label, (two, prefer) in strategies.items():
        o_k = nbrsel.neighbour_select(sel_gates, n_nbr, radius, two, prefer,
                                      *sel_args, scores=sel_scores)
        o_p = nbrsel.neighbour_select_plain(sel_gates, n_nbr, radius, two,
                                            prefer, *sel_args,
                                            scores=sel_scores)
        torch.cuda.synchronize()
        slots = (lambda o: torch.cat([o[1], o[3]]) if two else o[1])
        same = (slots(o_k).sort(dim=0).values == slots(o_p).sort(
            dim=0).values).all(dim=0).float().mean().item()
        exact = all(torch.equal(a, b) for a, b in zip(o_k, o_p))
        fin = torch.isfinite(o_p[0])
        err = (o_k[0][fin] - o_p[0][fin]).abs().max().item()
        print(f"check neighbour_select[{label}, injected]: pixels with the "
              f"same slots {same:.6f}, all outputs bit-exact {exact}, score "
              f"max abs err {err:.2e}")
        require(same >= MIN_AGREE, f"selection {label}: same slots {same}")
        if two:
            require(torch.equal(o_k[4], o_p[4]), f"selection {label}: counts")
        errs["neighbour_select"] = max(errs["neighbour_select"], err)
        key = spatial.philox_key(gen)
        p_k = nbrsel.neighbour_select(sel_gates, n_nbr, radius, two, prefer,
                                      *sel_args, generator=gen, key=key)
        # Slot for slot against the plain version fed the kernel's own
        # uniforms: its keys rebuilt with the plain Philox, through
        # torch.log (which may differ from the kernel's logf by an ulp).
        keys = nbrsel.selection_keys(key, radius, H, W)
        own = nbrsel.gumbel_of_keys(keys)
        p_own = nbrsel.neighbour_select_plain(sel_gates, n_nbr, radius, two,
                                              prefer, *sel_args, scores=own)
        same = (slots(p_k).sort(dim=0).values == slots(p_own).sort(
            dim=0).values).all(dim=0).float().mean().item()
        exact = all(torch.equal(a, b) for a, b in zip(p_k, p_own))
        cnt_w = {}
        model = filtered_race(sel_gates, n_nbr, radius, two, prefer,
                              *sel_args, keys, own, cnt_w)
        model_exact = all(torch.equal(a, b) for a, b in zip(model, p_own))
        print(f"check neighbour_select[{label}, philox]: pixels with the "
              f"same slots as the plain version on the kernel's own "
              f"uniforms {same:.6f}, all outputs bit-exact {exact}; the "
              f"filtered race's model bit-exact {model_exact}, per pixel "
              f"{cnt_w['scored'].float().mean().item():.3f} cells scored, "
              f"{cnt_w['gated'].float().mean().item():.3f} gated, "
              f"{cnt_w['divided'].float().mean().item():.4f} divided")
        require(same >= MIN_AGREE, f"selection {label}: Philox slots {same}")
        if two:
            require(torch.equal(p_k[4], p_own[4]),
                    f"selection {label}: Philox counts")
        sel_work[label] = {n_: v.sum().item() for n_, v in cnt_w.items()}
        del keys, own, p_own, model
        p_p = nbrsel.neighbour_select_plain(sel_gates, n_nbr, radius, two,
                                            prefer, *sel_args, generator=gen)
        p_p2 = nbrsel.neighbour_select_plain(sel_gates, n_nbr, radius, two,
                                             prefer, *sel_args, generator=gen)
        sk_, sp_ = preferred_share(p_k, two), preferred_share(p_p, two)
        print(f"check neighbour_select[{label}, philox]: preferred-class "
              f"share of picks {sk_:.6f} vs plain {sp_:.6f}"
              + (f", counts exact {torch.equal(p_k[4], p_p[4])}" if two
                 else ""))
        require(abs(sk_ - sp_) <= SHARE_ABS, f"selection {label}: share")
        # The picks' distribution over the box, against the plain Gumbel
        # stream on the same gates; the tolerance is the plain stream's
        # own seed-to-seed distance.
        h_k, h_p, h_p2 = (pick_hist(o, two) for o in (p_k, p_p, p_p2))
        tv_kp = 0.5 * (h_k - h_p).abs().sum().item()
        tv_pp = 0.5 * (h_p2 - h_p).abs().sum().item()
        top_k, top_p = (top_score(o) for o in (p_k, p_p))
        mk_, mp_ = pick_moments(h_k), pick_moments(h_p)
        print(f"check neighbour_select[{label}, philox]: pick histogram "
              f"distance {tv_kp:.3e} vs plain seed-to-seed {tv_pp:.3e}; dy "
              f"mean/sd {mk_[0]:.4f}/{mk_[1]:.4f} vs {mp_[0]:.4f}/"
              f"{mp_[1]:.4f}, dx {mk_[2]:.4f}/{mk_[3]:.4f} vs {mp_[2]:.4f}/"
              f"{mp_[3]:.4f}; mean top score {top_k:.5f} vs {top_p:.5f}")
        require(tv_kp <= PICKS_SPREAD * tv_pp,
                f"selection {label}: pick distribution {tv_kp} vs {tv_pp}")
        if two:
            require(torch.equal(p_k[4], p_p[4]), f"selection {label}: counts")
    del sel_scores

    # Batched MIS RIS: the 5 iterations' packs against 5 plain RIS calls.
    mis_uni = torch.rand((it_n, sk, 4, k, H, W), generator=gen, device=dev)
    packs = {}
    errs["mis_ris"] = 0.0

    def check_mis_ris(romis_pack, f=feats):
        """→ (the plain pack, max abs error of its statistics planes)."""
        c_blk = (8 if romis_pack else 7) * k
        pk_k = ris.gen_mis_reservoir_planes(ctx, scene.lights,
                                            scene.num_lights, f, it_n,
                                            romis_pack, uniforms=mis_uni)
        pk_p = ris.gen_mis_reservoir_planes_plain(
            ctx, scene.lights, scene.num_lights, f, it_n, romis_pack,
            uniforms=mis_uni)
        torch.cuda.synchronize()
        b_k, b_p = (x.reshape(it_n, c_blk, H, W) for x in (pk_k, pk_p))
        pos_k, pos_p = b_k[:, :3 * k], b_p[:, :3 * k]
        win = ((pos_k - pos_p).abs() <= 1e-6 + 1e-5 * pos_p.abs()).reshape(
            it_n, k, 3, H, W).all(dim=2)
        agree = win.float().mean().item()
        st_k, st_p = b_k[:, 6 * k:7 * k], b_p[:, 6 * k:7 * k]
        st_rel = ((st_k - st_p).abs() / st_p.abs().clamp_min(1e-30))[
            win].max().item()
        print(f"check mis_ris[{'romis' if romis_pack else 'rmis'}"
              f"{'' if f.enable_shading else ' unshaded'}, "
              f"uniforms]: {it_n} iterations, winners agree {agree:.6f}, "
              f"{'w_sum' if romis_pack else 'big_w'} max rel err "
              f"{st_rel:.2e}, bit-exact {torch.equal(pk_k, pk_p)}")
        require(agree >= MIN_AGREE, f"MIS RIS: winners agree {agree}")
        require(st_rel <= RIS_BIG_W_RTOL, f"MIS RIS: stats {st_rel}")
        return pk_p, (st_k - st_p).abs()[win].max().item()

    for romis_pack in (False, True):
        packs[romis_pack], err = check_mis_ris(romis_pack)
        errs["mis_ris"] = max(errs["mis_ris"], err)
    ph_k = ris.gen_mis_reservoir_planes(ctx, scene.lights, scene.num_lights,
                                        feats, it_n, True, generator=gen)
    ph_p = gen_canonical_samples_plain(ctx, scene.lights, scene.num_lights,
                                       feats, generator=gen).w_sum.mean()
    for i in range(it_n):
        mk = ph_k[i * 8 * k + 6 * k:i * 8 * k + 7 * k].mean().item()
        print(f"check mis_ris[philox]: iteration {i} mean w_sum {mk:.6g} vs "
              f"plain {ph_p.item():.6g}")
        require(abs(mk - ph_p.item()) <= PHILOX_REL * ph_p.item(),
                "MIS RIS Philox w_sum mean")

    # The sweep in its four modes, on the neighbourhoods of the plain
    # selection and iteration 0 of the packs above.
    def check_sweep(label, c, geometry, pack_r, pack_o, hw,
                    num_lights=scene.num_lights, f=feats):
        """The sweep in its four modes; on geometry with a BVH in its
        ext_vis mode, the visibility planes of each pack traced by the
        kernels (mis_ext_vis: halo gather, kernel 20) and fed to both."""
        h_, w_ = hw
        ny_, nx_ = select_neighbour_indices(
            gen, c, h_, w_, f, select=nbrsel.neighbour_select_plain)
        offs_ = mis_offsets(ny_, nx_)
        cen_ = shade.pack_center_ctx(c)
        nbr_ = mis.resolve_neighbour_ctx(cen_, offs_,
                                         spatial.halo_offset_gather_plain)
        d1 = f.num_neighbours_to_sample + 1
        al = torch.rand((3 * d1, h_, w_), generator=gen, device=dev) - 0.5
        ext = {}
        if geometry.bvh is not None:
            ext = {id(pk): mis_ext_vis(c, pk[:3 * k], offs_, geometry, k)
                   for pk in (pack_r, pack_o)}
        worst = 0.0
        for mode in ("rmis_equal", "rmis_balance", "romis", "romis_prog"):
            m = "romis" if mode == "romis_prog" else mode
            pack = pack_o if m == "romis" else pack_r
            kw = dict(nbr_ctx=None if m == "rmis_equal" else nbr_,
                      alphas=al if mode == "romis_prog" else None,
                      ext_vis=ext.get(id(pack)))
            o_k = mis.mis_iteration(cen_, pack, offs_, geometry, k, m,
                                    num_lights, f, **kw)
            o_p = mis.mis_iteration_plain(cen_, pack, offs_, geometry, k, m,
                                          num_lights, f, **kw)
            torch.cuda.synchronize()
            o_k = o_k if isinstance(o_k, tuple) else (o_k,)
            o_p = o_p if isinstance(o_p, tuple) else (o_p,)
            rel = 0.0
            for a, b in zip(o_k, o_p):
                require(bool(torch.isfinite(a).all()),
                        f"sweep {label} {mode}: non-finite")
                top = b.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
                rel = max(rel, ((a - b).abs() / top).max().item())
                worst = max(worst, (a - b).abs().max().item())
            exact = all(torch.equal(a, b) for a, b in zip(o_k, o_p))
            print(f"check mis_iteration[{label}, {mode}]: outputs "
                  f"{[tuple(a.shape)[0] for a in o_k]} planes, max err / "
                  f"plane max {rel:.2e}, bit-exact {exact}")
            require(rel <= MIS_REL, f"sweep {label} {mode}: {rel}")
        return worst

    errs["mis_iteration"] = check_sweep("flagship", ctx, scene.geometry,
                                        packs[False], packs[True], (H, W))
    # D = 4 (D1 = 5): the last chunk of the kernel's stage is partial in
    # every mode (3 members a chunk for R-OMIS, 2 for balance).
    errs["mis_iteration"] = max(errs["mis_iteration"], check_sweep(
        "flagship, D = 4", ctx, scene.geometry, packs[False], packs[True],
        (H, W), f=Features(num_neighbours_to_sample=4)))
    hs, ws = H // 4, W // 4
    soup_cam = flagship_camera(hs, ws, dev)
    _, soup_ctx_s = restir.trace_primary(generate_rays(soup_cam, hs, ws),
                                         soup, feats, restir.PLAIN)
    soup_packs = [ris.gen_mis_reservoir_planes_plain(
        soup_ctx_s, scene.lights, scene.num_lights, feats, 1, romis_pack,
        generator=gen) for romis_pack in (False, True)]
    check_sweep("soup2048 480x270", soup_ctx_s, soup, *soup_packs, (hs, ws))
    del mis_uni, ph_k

    # The BVH kernels on the 5x5 torus field at 1080p, against the plain
    # traversal on the same rays and tree; the plain traversal's box and
    # triangle tests feed the bounds.
    large = torus_field(LARGE_N, dev)
    t0 = time.perf_counter()
    large.geometry = with_bvh(large.geometry)
    lgeo = large.geometry
    n_large = int(lgeo.active.sum())
    print(f"large scene: torus field {LARGE_N}x{LARGE_N}, {n_large} "
          f"triangles, SAH BVH of {lgeo.bvh.n_nodes} nodes (largest leaf "
          f"{lgeo.bvh.max_leaf_count}) in {time.perf_counter() - t0:.2f} s")
    require(n_large == LARGE_TRIS, f"torus field: {n_large} triangles")
    lcam = torus_field_camera(H, W, dev)
    lrays = generate_rays(lcam, H, W)
    walk_counts = {}
    errs["bvh_closest_hit"] = check_trace(lgeo, "torus5x5", lrays)
    # Kernel 18's bound counts the fewer tests of its own walk (the
    # nearer-first model, bit-equal to the plain walk here too) and the
    # plain walk.
    walk_counts["bvh_closest_hit"], walk_counts["bvh_closest_plain"] = {}, {}
    ordered = bvh_closest_ordered(lrays, lgeo, lgeo.bvh,
                                  counts=walk_counts["bvh_closest_hit"])
    plain18 = bvh_closest(lrays, lgeo, lgeo.bvh,
                          counts=walk_counts["bvh_closest_plain"])
    require(all(torch.equal(a, b) for a, b in zip(ordered, plain18)),
            "kernel 18's nearer-first model and the plain walk differ")
    del ordered, plain18
    _, lctx = restir.trace_primary(lrays, lgeo, feats, restir.KERNELS)
    lres = ris.gen_canonical_samples_ris(lctx, large.lights,
                                         large.num_lights, feats,
                                         generator=gen)

    def vis_rays(position, targets, own_origins=False):
        """The shadow rays ops.wrs.visibility traces from ``position`` to
        ``targets`` [..., 3, H, W] (``visibility_from``'s with
        ``own_origins``: an origin per sample) → (origins, directions,
        t_max)."""
        got = {}

        def grab(o, d, tm, _g):
            got["rays"] = (o.contiguous(), d.expand(o.shape).contiguous(),
                           tm.contiguous())
            return torch.zeros(tm.shape, dtype=torch.bool, device=dev)

        (visibility_from if own_origins else visibility)(position, targets,
                                                         lgeo, grab)
        return got["rays"]

    def check_walk_any(label, fn, rays_, exact=False):
        """Kernel 19 or 20 against the plain traversal on the same rays
        (kernel 20 with ``exact``: the same bool on every ray)."""
        cnt = {}
        occ_k = fn(*rays_, lgeo)
        occ_p = bvh_any(*rays_, lgeo, lgeo.bvh, counts=cnt)
        torch.cuda.synchronize()
        same = (occ_k == occ_p).float().mean().item()
        bit = bool(torch.equal(occ_k, occ_p))
        print(f"check {label}: rays {occ_k.numel()}, occluded "
              f"{occ_p.float().mean().item():.4f}, agree {same:.6f}, "
              f"bit-exact {bit}, box / triangle "
              f"tests per ray {cnt['box'].float().mean().item():.2f} / "
              f"{cnt['tri'].float().mean().item():.2f}")
        require(same >= MIN_AGREE, f"{label}: agree {same}")
        require(bit or not exact, f"{label}: not the plain bool on every "
                f"ray")
        cnt["occluded"] = occ_p
        return 1.0 - same, cnt

    lshadow = vis_rays(lctx.position, lres.pos)  # the K = 2 lanes
    # Kernel 19 (its bool the plain traversal's on every ray): the K = 1
    # initial check's plane, 17 planes to the sky light, and hard rays
    # toward the field's triangles (hard_any_rays: random, grazing,
    # edge-on, edge-crossing, t_max at the closest hit). Its bound counts
    # the fewer tests of its own walk on the two-box records (bvh_any_wide,
    # the same bool) and the plain walk.
    one = tuple(a[:1] for a in lshadow)
    errs["bvh_any_hit"], walk_counts["bvh_any_plain"] = check_walk_any(
        "bvh_any_hit[torus5x5, 1 plane]", walk.any_hit_bvh, one, True)
    c19 = {}
    same19 = torch.equal(bvh_any_wide(*one, lgeo, lgeo.bvh, counts=c19),
                         walk_counts["bvh_any_plain"]["occluded"])
    walk_counts["bvh_any_hit"] = c19
    print(f"check bvh_any_wide[torus5x5, 1 plane] (kernel 19's walk): "
          f"the plain bool on every ray {same19}, per ray "
          f"{c19['box'].float().mean().item():.2f} box and "
          f"{c19['tri'].float().mean().item():.2f} triangle tests, "
          f"{int(c19['again'].sum().item())} rays walked again")
    require(same19, "kernel 19's walk model differs from the plain walk")
    # 17 planes: the frame's receivers to 17 points of the sky light.
    sky = large.lights.rows[0]
    uv = torch.rand((2, SKY_PLANES, 1, H, W), generator=gen, device=dev)
    sky_pts = (sky[0:3, None, None] + uv[0] * sky[3:6, None, None]
               + uv[1] * sky[6:9, None, None])
    sky_rays = vis_rays(lctx.position, sky_pts)
    err17, _ = check_walk_any(f"bvh_any_hit[torus5x5, {SKY_PLANES} planes]",
                              walk.any_hit_bvh, sky_rays, True)
    errs["bvh_any_hit"] = max(errs["bvh_any_hit"], err17)
    rng19 = np.random.default_rng(19)
    for kind in HARD_RAY_KINDS + ("at_hit",):
        err_h, _ = check_walk_any(
            f"bvh_any_hit[torus5x5, hard rays: {kind}]", walk.any_hit_bvh,
            hard_any_rays(torch, rng19, kind, lgeo, s=4, h=128, w=256), True)
        errs["bvh_any_hit"] = max(errs["bvh_any_hit"], err_h)
    errs["bvh_any_hit_k"], walk_counts["bvh_any_hit_k2"] = check_walk_any(
        "bvh_any_hit_k[torus5x5, S=2]", walk.any_hit_bvh_k, lshadow, True)
    for s_ in (4, 16):  # the first S planes of the sky rays
        err_s, _ = check_walk_any(
            f"bvh_any_hit_k[torus5x5, S={s_} sky rays]", walk.any_hit_bvh_k,
            tuple(a[:s_] for a in sky_rays), True)
        errs["bvh_any_hit_k"] = max(errs["bvh_any_hit_k"], err_s)
    del sky_rays
    # S = 12: one MIS iteration's ext_vis rays (D1 = 6 members x K = 2).
    lny, lnx = select_neighbour_indices(gen, lctx, H, W, feats,
                                        select=nbrsel.neighbour_select)
    loffs = mis_offsets(lny, lnx)
    lpack = ris.gen_mis_reservoir_planes(lctx, large.lights,
                                         large.num_lights, feats, 1, True,
                                         generator=gen)
    lpos = lpack[:3 * k]
    ext_targets = torch.cat([lpos[None], spatial.halo_offset_gather(
        lpos, loffs[:n_nbr], loffs[n_nbr:])]).reshape(n_nbr + 1, k, 3, H, W)
    ext_rays = vis_rays(lctx.position, ext_targets)
    err12, walk_counts["bvh_any_hit_k"] = check_walk_any(
        "bvh_any_hit_k[torus5x5, S=12 ext_vis rays]", walk.any_hit_bvh_k,
        ext_rays, True)
    errs["bvh_any_hit_k"] = max(errs["bvh_any_hit_k"], err12)
    occ19 = walk.any_hit_bvh(*ext_rays, lgeo)
    same19 = torch.equal(occ19, walk.any_hit_bvh_k(*ext_rays, lgeo))
    print(f"check bvh_any_hit_k vs bvh_any_hit (kernel 20 vs kernel 19, the "
          f"12 ext_vis planes): the same bool on every ray {same19}")
    require(same19, "kernel 20 and kernel 19 differ on the ext_vis rays")
    del occ19
    errs["bvh_final_shade"] = check_shade(lctx, lres, lgeo, "torus5x5 BVH")
    for k_ in (1, 4):  # kernel 21's K = 1 and 4 (a warp of 32 and 8 pixels)
        f_ = Features(num_samples_in_reservoir=k_)
        errs["bvh_final_shade"] = max(errs["bvh_final_shade"], check_shade(
            lctx, ris.gen_canonical_samples_ris(
                lctx, large.lights, large.num_lights, f_, generator=gen),
            lgeo, f"torus5x5 BVH, K={k_}", f_))
    # Kernel 13 on the torus field's tables: its 3 light rows and 26
    # material rows in shared memory, its 24,208 triangle rows (C = 9, and
    # the attribute rows' C = 24) in device memory.
    torus_tables = scatter_tables(
        torch, gen, large, walk.closest_hit_bvh(lrays, lgeo)[1], k, "torus ")
    errs["scatter_rows_add"] = max(
        [errs["scatter_rows_add"]] + [check_scatter(label, *case) for
                                      label, case in torus_tables.items()])
    scatter_cases.update(torus_tables)
    lpack_r = ris.gen_mis_reservoir_planes(lctx, large.lights,
                                           large.num_lights, feats, 1, False,
                                           generator=gen)
    errs["mis_iteration"] = max(errs["mis_iteration"], check_sweep(
        "torus5x5 ext_vis", lctx, lgeo, lpack_r, lpack, (H, W),
        large.num_lights))

    # The cross-check with no plain version in it: the 2048-triangle soup
    # with a BVH attached, the walk against the soup kernels.
    soup_bvh = with_bvh(soup)
    t_s, tri_s, _, _ = trace.closest_hit(rays, soup)  # kernel 1
    t_b, tri_b, _, _ = walk.closest_hit_bvh(rays, soup_bvh)  # kernel 18
    o_s, d_s, tm_s = shadow_rays(soup_ctx, res_soup)
    occ6 = trace.any_hit(o_s, d_s, tm_s, soup)  # kernel 6
    occ20 = walk.any_hit_bvh_k(o_s, d_s, tm_s, soup_bvh)  # kernel 20
    torch.cuda.synchronize()
    hit_s = torch.isfinite(t_s)
    same_t = torch.where(hit_s, t_b == t_s, torch.isinf(t_b))
    attr_s = soup.attr_rows[tri_s.clamp_min(0)]
    attr_b = soup_bvh.attr_rows[tri_b.clamp_min(0)]
    same_attr = ((attr_s == attr_b).all(dim=-1) & hit_s)[hit_s]
    agree_t = same_t.float().mean().item()
    agree_attr = same_attr.float().mean().item()
    agree_occ = (occ6 == occ20).float().mean().item()
    print(f"check soup2048 with a BVH: kernel 18 vs kernel 1 same t "
          f"{agree_t:.6f}, same hit attributes {agree_attr:.6f} (hits "
          f"{hit_s.float().mean().item():.4f}); kernel 20 vs kernel 6 "
          f"occlusion agree {agree_occ:.6f} (occluded "
          f"{occ6.float().mean().item():.4f})")
    require(min(agree_t, agree_attr, agree_occ) >= MIN_AGREE,
            "soup with a BVH: the walk and the soup kernels disagree")
    del ext_rays, soup_bvh

    # ---- slice 6: the Z-count visibility and the unshaded modes ----
    vfeats = Features(unbiased_combination=True,
                      spatial_reuse_visibility_check=True)

    def rel_err(a, b, mask=None):
        r = (a - b).abs() / b.abs().clamp_min(1e-30)
        return (r if mask is None else r[mask]).max().item()

    def z_rays(planes, blk, cen_):
        """The Z rays of a vis_check pass, as z_visibility builds them →
        (origins [R+1, 3, H, W], targets [K, 3, H, W], mask)."""
        h_, w_ = planes.shape[-2:]
        nbr_pos = blk[2 * k:2 * k + 3 * n_nbr].reshape(n_nbr, 3, h_, w_)
        mf = blk[2 * k + 3 * n_nbr:].reshape(n_nbr, k, h_, w_)
        return (torch.cat([cen_[None, 0:3], nbr_pos]).contiguous(),
                planes[:3 * k].reshape(k, 3, h_, w_).contiguous(),
                torch.cat([(blk[k:2 * k] > 0.0)[None], mf > 0.0]))

    def check_vis_mode(rp, cen_, label):
        """Kernel 11's vis_check mode against its plain form, plane by
        plane, on injected noise → (the kernel's planes and block, max
        abs error)."""
        h_, w_ = rp.shape[-2:]
        inject = spatial.spatial_noise(gen, n_nbr, k, radius, h_, w_)
        pl_k, blk_k = spatial.spatial_pass_unbiased_vis(
            rp, cen_, k, n_nbr, radius, vfeats, inject=inject)
        pl_p, blk_p = spatial.spatial_pass_unbiased_vis_plain(
            rp, cen_, k, n_nbr, radius, vfeats, inject=inject)
        torch.cuda.synchronize()
        o_k, o_p = (unpack_reservoir_planes(x, k) for x in (pl_k, pl_p))
        win = ((o_k.pos - o_p.pos).abs()
               <= 1e-6 + 1e-5 * o_p.pos.abs()).all(dim=1)
        agree = win.float().mean().item()
        z_rel = rel_err(blk_k[:k], blk_p[:k], win)
        ps_rel = rel_err(blk_k[k:2 * k], blk_p[k:2 * k], win)
        pos_exact = torch.equal(blk_k[2 * k:2 * k + 3 * n_nbr],
                                blk_p[2 * k:2 * k + 3 * n_nbr])
        mf_same = (blk_k[2 * k + 3 * n_nbr:] == blk_p[2 * k + 3 * n_nbr:]
                   ).reshape(n_nbr, k, h_, w_).all(dim=0)
        mf_exact = bool(mf_same[win].all())
        ws_rel, m_rel = rel_err(o_k.w_sum, o_p.w_sum), rel_err(o_k.m, o_p.m)
        bw_rel = rel_err(o_k.big_w, o_p.big_w, win)
        print(f"check spatial_pass_unbiased vis_check[{label}, injected]: "
              f"winners agree {agree:.6f}, w_sum {ws_rel:.2e}, M {m_rel:.2e}, "
              f"big_w {bw_rel:.2e}, Z before visibility {z_rel:.2e}, p-hat* "
              f"{ps_rel:.2e} (max rel err), positions exact {pos_exact}, "
              f"m-flags exact where the winners agree {mf_exact}")
        require(agree >= MIN_AGREE, f"vis_check {label}: winners {agree}")
        require(ws_rel <= PASS_W_SUM_RTOL and m_rel <= PASS_M_RTOL
                and bw_rel <= PASS_BIG_W_RTOL,
                f"vis_check {label}: reservoir planes")
        require(z_rel <= PASS_M_RTOL and ps_rel <= RIS_W_SUM_RTOL,
                f"vis_check {label}: Z {z_rel} or p-hat* {ps_rel}")
        require(pos_exact and mf_exact,
                f"vis_check {label}: positions or m-flags differ")
        return pl_k, blk_k, max((o_k.w_sum - o_p.w_sum).abs().max().item(),
                                (o_k.big_w - o_p.big_w).abs()[win].max()
                                .item())

    def check_zcount(o, t, m, geometry, label):
        """Kernel 7 against its plain version: the same bool on every
        ray."""
        occ_k = trace.zcount_occ(o, t, geometry, SHADOW_RAY_EPSILON, m)
        occ_p = trace.zcount_occ_plain(o, t, geometry, SHADOW_RAY_EPSILON, m)
        torch.cuda.synchronize()
        exact = torch.equal(occ_k, occ_p)
        alive = "all" if m is None else f"{m.float().mean().item():.4f}"
        print(f"check zcount_occ[{label}]: rays {occ_k.numel()} ({o.shape[0]} "
              f"origins x {t.shape[0]} targets a pixel), alive {alive}, "
              f"occluded {occ_p.float().mean().item():.4f}, the same bool on "
              f"every ray {exact}")
        require(exact, f"zcount_occ {label}: kernel 7 and its plain version "
                f"differ on {(occ_k != occ_p).sum().item()} rays")

    def check_vis_pass(rp, cen_, geometry, label):
        """The whole vis-check pass (kernel 11, kernel 7, the Z
        subtraction) against the plain unbiased pass with visibility_from:
        W within the pass tolerance on MIN_AGREE of the lanes (kernel 7's
        division-free test and visibility_from's shifted origin may round
        apart on grazing rays)."""
        h_, w_ = rp.shape[-2:]
        inject = spatial.spatial_noise(gen, n_nbr, k, radius, h_, w_)
        o_k = unpack_reservoir_planes(spatial.spatial_pass_unbiased_fused(
            rp, cen_, k, n_nbr, radius, vfeats, inject=inject,
            geometry=geometry), k)
        o_p = unpack_reservoir_planes(spatial.spatial_pass_unbiased_plain(
            rp, cen_, k, n_nbr, radius, vfeats, inject=inject,
            geometry=geometry), k)
        torch.cuda.synchronize()
        win = ((o_k.pos - o_p.pos).abs()
               <= 1e-6 + 1e-5 * o_p.pos.abs()).all(dim=1)
        agree = win.float().mean().item()
        ws_rel, m_rel = rel_err(o_k.w_sum, o_p.w_sum), rel_err(o_k.m, o_p.m)
        bw_ok = ((o_k.big_w - o_p.big_w).abs()
                 <= PASS_BIG_W_RTOL * o_p.big_w.abs())
        share = bw_ok.float().mean().item()
        print(f"check vis-check pass[{label}, injected]: winners agree "
              f"{agree:.6f}, w_sum {ws_rel:.2e}, M {m_rel:.2e} (max rel err); "
              f"W within {PASS_BIG_W_RTOL:g} on {share:.6f} of the lanes, "
              f"{(~bw_ok).sum().item()} lanes apart; W zeroed by the check "
              f"on {((o_k.big_w == 0) & (o_k.w_sum > 0)).float().mean().item():.4f}")
        require(agree >= MIN_AGREE and share >= MIN_AGREE,
                f"vis-check pass {label}: winners {agree}, W {share}")
        require(ws_rel <= PASS_W_SUM_RTOL and m_rel <= PASS_M_RTOL,
                f"vis-check pass {label}: w_sum or M")

    # Kernel 11's mode and kernel 7 (a) at 1080p on the flagship frame.
    vis_planes, vis_blk, err = check_vis_mode(res_planes, cen, "flagship")
    errs["spatial_pass_unbiased"] = max(errs["spatial_pass_unbiased"], err)
    check_zcount(*z_rays(vis_planes, vis_blk, cen), scene.geometry,
                 "flagship 1080p, a vis_check pass's rays")
    check_vis_pass(res_planes, cen, scene.geometry, "flagship 1080p")
    # (b) The 2048-triangle soup at 480x270: its receivers and five
    # jittered copies to the MIS packs' light samples, with coincident
    # pairs (target = origin, and within eps of it) on a band of rows.
    so = soup_ctx_s.position
    zo = torch.cat([so[None], so[None] + 0.5 * torch.randn(
        (n_nbr, 3, hs, ws), generator=gen, device=dev)]).contiguous()
    zt = soup_packs[0][:3 * k].reshape(k, 3, hs, ws).clone()
    zt[0, :, :8] = zo[0, :, :8]
    zt[1, :, 8:16] = zo[2, :, 8:16] + 2e-4
    zm = torch.rand((n_nbr + 1, k, hs, ws), generator=gen, device=dev) > 0.3
    for m_, lab in ((None, "no mask"), (zm, "mask")):
        check_zcount(zo, zt, m_, soup, f"soup2048 480x270, {lab}")
    res_s = pack_reservoir_planes(gen_canonical_samples_plain(
        soup_ctx_s, scene.lights, scene.num_lights, feats, generator=gen))
    cen_s = shade.pack_center_ctx(soup_ctx_s)
    check_vis_mode(res_s, cen_s, "soup2048 480x270")
    check_vis_pass(res_s, cen_s, soup, "soup2048 480x270")
    errs["zcount_occ"] = 0.0  # the checks above require the same bools
    # (c) Kernel 20 on the Z rays of a vis_check pass on the 5x5 torus field
    # (large_vischeck's: (R+1)·K = 12 rays a pixel from R+1 origins), the
    # plain traversal's bool on every ray.
    lcen_v = shade.pack_center_ctx(lctx)
    lpl, lblk = spatial.spatial_pass_unbiased_vis(
        pack_reservoir_planes(lres), lcen_v, k, n_nbr, radius, vfeats,
        generator=gen, key=spatial.philox_key(gen))
    lzo, lzt, _ = z_rays(lpl, lblk, lcen_v)
    err_z, _ = check_walk_any(
        "bvh_any_hit_k[torus5x5, large_vischeck's Z rays, S=12]",
        walk.any_hit_bvh_k, vis_rays(lzo[:, None], lzt[None], True), True)
    errs["bvh_any_hit_k"] = max(errs["bvh_any_hit_k"], err_z)
    del lpl, lblk, lzo, lzt

    # The unshaded mode of every kernel that evaluates Phong.
    ufeats = feats.replace(enable_shading=False)
    res_u, err = check_ris(ctx, "flagship unshaded", ufeats)
    errs["ris"] = max(errs["ris"], err)
    errs["ris_replay"] = max(errs["ris_replay"], check_replay(
        ctx, "flagship unshaded", ufeats))
    mis_uni = torch.rand((it_n, sk, 4, k, H, W), generator=gen, device=dev)
    packs_u = {}
    for romis_pack in (False, True):
        packs_u[romis_pack], err = check_mis_ris(romis_pack, ufeats)
        errs["mis_ris"] = max(errs["mis_ris"], err)
    del mis_uni
    for label, (kernel_fn, plain_fn) in pass_pair(ufeats).items():
        errs[label] = max(errs[label], check_pass(f"{label} unshaded",
                                                  kernel_fn, plain_fn))
    errs["final_shade"] = max(errs["final_shade"], check_soup_shade(
        ctx, res_u, scene.geometry, "flagship unshaded", ufeats))
    errs["bvh_final_shade"] = max(errs["bvh_final_shade"], check_shade(
        lctx, lres, lgeo, "torus5x5 BVH unshaded", ufeats))
    errs["mis_iteration"] = max(errs["mis_iteration"], check_sweep(
        "flagship unshaded", ctx, scene.geometry, packs_u[False],
        packs_u[True], (H, W), f=ufeats))
    del packs_u, res_u

    # ---- slice 7: kernels 8 and 12 through their op-level entries ----
    # Kernel 8 on the K = 2 shadow rays of three frames: the flagship's,
    # the one-torus soup's (970 triangles) and the 2048-triangle soup's.
    torus1 = torus_field(1, dev)
    require(torus1.geometry.tri_cols.shape[1] <= trace.MAX_SOUP_TRIS
            and torus1.geometry.bvh is None, "one-torus soup")
    # Kernel 7 where its cull's near-parallel guard decides: random,
    # grazing, edge-on and edge-crossing rays (hard_z_rays) on the one-torus
    # soup and the 2048-triangle soup, masked and not, against the plain
    # version; the box-only walk (ops.trace.zcount_occ_culled with
    # guard=False) shows on how many of them the box alone would be wrong.
    for g_label, g_ in (("torus soup", torus1.geometry),
                        ("soup2048", soup)):
        cols_np = g_.tri_cols.cpu().numpy()
        for i, kind in enumerate(HARD_RAY_KINDS):
            rng = np.random.default_rng(90 + i)
            o_, t_ = (torch.from_numpy(a).to(dev) for a in hard_z_rays(
                rng, kind, cols_np, n_nbr + 1, k, 64, 128))
            m_ = torch.from_numpy(rng.uniform(
                size=(n_nbr + 1, k, 64, 128)) > 0.3).to(dev)
            for mm, lab in ((None, "no mask"), (m_, "mask")):
                check_zcount(o_, t_, mm, g_, f"{g_label}, {kind} rays, {lab}")
                wrong = (trace.zcount_occ_culled(
                    o_, t_, g_, SHADOW_RAY_EPSILON, mm, guard=False)
                    != trace.zcount_occ_plain(o_, t_, g_, SHADOW_RAY_EPSILON,
                                              mm)).sum().item()
                print(f"check zcount_occ[{g_label}, {kind} rays, {lab}]: "
                      f"the box alone would be wrong on {wrong} rays")
    tcam = make_camera(resolution=(H, W), device=dev, **TORUS_CAM)
    # Kernel 1's culled walk on the one-torus soup's 61 blocks: on
    # vischeck_torus's 1080p primary rays, and on hard closest-hit rays
    # (hard_z_rays' origins toward their targets: random, grazing, edge-on
    # and edge-crossing) of the torus soup and the 2048-triangle soup.
    errs["closest_hit"] = max(errs["closest_hit"], check_trace(
        torus1.geometry, "torus soup 1080p", generate_rays(tcam, H, W)))
    for g_label, g_ in (("torus soup", torus1.geometry),
                        ("soup2048", soup)):
        cols_np = g_.tri_cols.cpu().numpy()
        for i, kind in enumerate(HARD_RAY_KINDS):
            o_, t_ = (torch.from_numpy(a).to(dev)[0] for a in hard_z_rays(
                np.random.default_rng(110 + i), kind, cols_np, 1, 1, 64, 128))
            d_ = t_ - o_
            d_ = d_ / torch.linalg.vector_norm(d_, dim=0).clamp_min(1e-20)
            errs["closest_hit"] = max(errs["closest_hit"], check_trace(
                g_, f"{g_label}, {kind} rays", Rays(o_, d_)))
    _, tctx = restir.trace_primary(generate_rays(tcam, H, W),
                                   torus1.geometry, feats, restir.KERNELS)
    # Kernel 4 on the one-torus soup (vischeck_torus's receivers, its
    # culled walk over 61 blocks) at K = 1, 2 and 4, shaded and unshaded,
    # and on shadow rays where its cull's guard decides: hard_z_rays'
    # origins made receivers and their targets samples (unshaded: every
    # lane with W != 0 traces), on the torus soup and the 2048-soup.
    for k_ in (1, 2, 4):
        f_ = Features(num_samples_in_reservoir=k_)
        res_t = ris.gen_canonical_samples_ris(
            tctx, torus1.lights, torus1.num_lights, f_, generator=gen)
        for ff in (f_, f_.replace(enable_shading=False)):
            errs["final_shade"] = max(errs["final_shade"], check_soup_shade(
                tctx, res_t, torus1.geometry, f"torus soup, K={k_}, "
                + ("shaded" if ff.enable_shading else "unshaded"), ff))
        del res_t
    hard_f = feats.replace(enable_shading=False)
    for g_label, g_ in (("torus soup", torus1.geometry),
                        ("soup2048", soup)):
        cols_np = g_.tri_cols.cpu().numpy()
        for i, kind in enumerate(HARD_RAY_KINDS):
            o_, t_ = (torch.from_numpy(a).to(dev) for a in hard_z_rays(
                np.random.default_rng(70 + i), kind, cols_np, 1, k, 64, 128))
            c_, r_ = hard_shade_inputs(torch, o_[0], t_)
            errs["final_shade"] = max(errs["final_shade"], check_soup_shade(
                c_, r_, g_, f"{g_label}, {kind} shadow rays", hard_f))
    tshadow = shadow_rays(tctx, ris.gen_canonical_samples_ris(
        tctx, torus1.lights, torus1.num_lights, feats, generator=gen))
    sshadow = shadow_rays(soup_ctx_s, gen_canonical_samples_plain(
        soup_ctx_s, scene.lights, scene.num_lights, feats, generator=gen))

    def check_soup_any(label, geometry, rays_, valid=None, share=None):
        """Kernels 6 and 8 against their plain versions: the same bool on
        every segment. Kernel 8 also against kernel 6: within
        PLUCKER_MT_SHARE of the hit pixels' segments (``valid``) with
        ``share``, and of all segments with ``share="all"`` (on the
        flagship a missed pixel's segment runs from the camera to the light
        sample's default, a point on the ground plane: it ends on a
        triangle, where the two tests round either way); elsewhere (hard
        segments at the tests' boundaries, a soup far from the origin) the
        share is printed → kernel 8's plain counts."""
        cnt = {}
        occ_6 = trace.any_hit(*rays_, geometry)
        occ_k = trace.any_hit_plucker(*rays_, geometry)
        plain6 = trace.any_hit_plain(*rays_, geometry)
        occ_p = trace.any_hit_plucker_plain(*rays_, geometry, counts=cnt)
        torch.cuda.synchronize()
        exact6, exact = torch.equal(occ_6, plain6), torch.equal(occ_k, occ_p)
        hit = (valid.expand(occ_k.shape) if valid is not None
               else torch.ones_like(occ_k))
        apart = (occ_k != occ_6)[hit].float().mean().item()
        apart_all = (occ_k != occ_6).float().mean().item()
        print(f"check any_hit, any_hit_plucker[{label}]: segments "
              f"{occ_k.numel()}, triangles {geometry.tri_cols.shape[1]}, "
              f"occluded {plain6.float().mean().item():.4f} (Moller-Trumbore)"
              f" {occ_p.float().mean().item():.4f} (Plucker); kernel 6 the "
              f"plain bool on every segment {exact6}, kernel 8 {exact}; "
              f"kernel 8 vs kernel 6 {apart:.2e} of the hit pixels' "
              f"{int(hit.sum().item())} segments apart, {apart_all:.2e} of "
              f"all; plain Plucker tests per segment "
              f"{cnt['tests'].float().mean().item():.1f}")
        require(exact6, f"any_hit {label}: kernel 6 and its plain version "
                f"differ on {(occ_6 != plain6).sum().item()} segments")
        require(exact, f"any_hit_plucker {label}: kernel 8 and its plain "
                f"version differ on {(occ_k != occ_p).sum().item()} segments")
        require(share is None or apart <= PLUCKER_MT_SHARE,
                f"any_hit_plucker {label}: {apart} of the hit pixels' "
                "segments apart from kernel 6")
        require(share != "all" or apart_all <= PLUCKER_MT_SHARE,
                f"any_hit_plucker {label}: {apart_all} of all segments apart "
                "from kernel 6")
        return cnt

    check_soup_any("flagship 1080p", scene.geometry,
                   shadow_rays(ctx, res_main), ctx.valid, "hit")
    check_soup_any("torus soup 1080p", torus1.geometry, tshadow, tctx.valid,
                   "all")
    check_soup_any("soup2048 480x270", soup, sshadow, soup_ctx_s.valid,
                   "all")
    # Where the culls' guards decide: hard_z_rays' segments (one origin, two
    # targets) on the torus soup and the 2048-soup, and small triangles far
    # from the origin (moved_soup), where the Plucker sides round the most.
    for g_label, g_ in (("torus soup", torus1.geometry), ("soup2048", soup)):
        cols_np = g_.tri_cols.cpu().numpy()
        for i, kind in enumerate(HARD_RAY_KINDS):
            check_soup_any(f"{g_label}, {kind} segments", g_, seg_rays(
                torch, *(torch.from_numpy(a).to(dev) for a in hard_z_rays(
                    np.random.default_rng(130 + i), kind, cols_np, 1, 2, 64,
                    128))))
    for off in MOVED_OFFSETS:
        g_ = build_geometry([moved_soup(off)], dev)
        check_soup_any(f"soup moved {off:g} from the origin", g_, box_segments(
            torch, g_, np.random.default_rng(140), 2, 270, 480, 0.05))
        del g_
    errs["any_hit_plucker"] = 0.0  # the checks above require the same bools

    # Kernel 12 on config 5's pack: plane 0 holds each pixel's coordinate
    # y·COORD + x, then the K reservoirs and the 18 context planes.
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    gpack = torch.cat([(ys * COORD + xs).float()[None], res_planes,
                       cen]).contiguous()
    require(gpack.shape[0] == 10 * k + 19, f"pack of {gpack.shape[0]}")
    inj = spatial.spatial_noise(gen, n_nbr, 1, radius, H, W)[0]
    g_k = spatial.neighbour_gather(gpack, n_nbr, radius, offsets=inj)
    g_p = spatial.neighbour_gather_plain(gpack, inj)
    torch.cuda.synchronize()
    exact = torch.equal(g_k, g_p)
    print(f"check neighbour_gather[injected]: planes {gpack.shape[0]}, R="
          f"{n_nbr}, r={radius}, bit-exact {exact}")
    require(exact, "neighbour_gather on injected offsets is not bit-exact")
    gkey = spatial.philox_key(gen)
    g_k = spatial.neighbour_gather(gpack, n_nbr, radius, key=gkey,
                                   pass_index=1)
    src = g_k[:, 0].long()  # [R, H, W]
    sy, sx = src // COORD, src % COORD
    rec = torch.stack([sy - ys, sx - xs]).int()
    in_win = bool(((sy >= (ys - radius).clamp_min(0))
                   & (sy <= (ys + radius).clamp_max(H - 1))
                   & (sx >= (xs - radius).clamp_min(0))
                   & (sx <= (xs + radius).clamp_max(W - 1))).all())
    at_rec = torch.equal(g_k, spatial.neighbour_gather_plain(gpack, rec))
    drawn = spatial.neighbour_offsets(gkey, 1, n_nbr, radius, H, W)
    stream = torch.equal(g_k, spatial.neighbour_gather_plain(gpack, drawn))
    inner = rec[:, :, radius:H - radius, radius:W - radius]
    side = 2 * radius + 1
    share_err = max(
        (torch.bincount((inner[a] + radius).reshape(-1), minlength=side)
         .double() * side / inner[a].numel() - 1.0).abs().max().item()
        for a in range(2))
    col_same = (inner[1, :, 1:] == inner[1, :, :-1]).float().mean().item()
    print(f"check neighbour_gather[philox]: every offset in the clamped "
          f"window {in_win}, every plane at the recovered offsets (bit-exact) "
          f"{at_rec}, offsets equal to the plain Philox draw {stream}; over "
          f"the interior each of the {side} values of dy and dx within "
          f"{share_err:.2e} of 1/{side} (relative), dx equal to the pixel "
          f"above's on {col_same:.4f} of the pixels")
    require(in_win and at_rec and stream,
            "neighbour_gather Philox: offsets or planes")
    require(share_err <= NBR_SHARE_REL, f"neighbour_gather: shares "
            f"{share_err}")
    require(col_same <= 2.0 / side, f"neighbour_gather: dx shared down "
            f"columns ({col_same})")
    errs["neighbour_gather"] = 0.0  # bit-exact above
    del g_k, g_p, src, sy, sx, rec, drawn, inner

    # ---- 4. the main paths through the entry points ----
    section("4")
    path_feats = {
        "slice1": Features(spatial_reuse=False),
        "config5": Features(),
        "animated": Features(temporal_reprojection=True,
                             unbiased_combination=True,
                             initial_samples_visibility_check=True),
        "romis": Features(ray_trace_mode=RayTraceMode.ROMIS),
        "romis_progressive": Features(ray_trace_mode=RayTraceMode.ROMIS,
                                      use_progressive_romis=True),
        "rmis_equal": Features(ray_trace_mode=RayTraceMode.RMIS),
        "rmis_balance": Features(
            ray_trace_mode=RayTraceMode.RMIS,
            mis_weight_rmis=MISWeight.BALANCE,
            neighbour_selection_strategy=(
                NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR)),
    }
    path_feats.update({
        "large_config5": path_feats["config5"],
        "large_animated": path_feats["animated"],
        "large_k1": Features(num_samples_in_reservoir=1,
                             initial_samples_visibility_check=True),
        "large_romis": path_feats["romis"],
        "large_rmis_equal": path_feats["rmis_equal"],
        "config5_gather": Features(fused_spatial_gather=False),
        "unshaded": Features(enable_shading=False),
        "vischeck": vfeats,
        "vischeck_torus": vfeats,
        "large_vischeck": vfeats,
        "animated_torus": path_feats["animated"],
    })
    cam_path = interpolate_cameras(
        cam, make_camera(look_at=(2.57, 1.23, -1.35),
                         rotation_deg=(10.3, 30.0 + PAN_DEG
                                       * (FRAMES["animated"] - 1), 0.0),
                         distance=25.0, fov_deg=30.0, resolution=(H, W),
                         device=dev), FRAMES["animated"])
    tcam_path = interpolate_cameras(
        tcam, make_camera(resolution=(H, W), device=dev, **dict(
            TORUS_CAM, rotation_deg=(25.0, 30.0 + PAN_DEG
                                     * (FRAMES["animated_torus"] - 1), 0.0))),
        FRAMES["animated_torus"])
    lcam_path = interpolate_cameras(
        lcam, make_camera(look_at=(0, 0, 0), rotation_deg=(
            25.0, 30.0 + PAN_DEG * (FRAMES["large_animated"] - 1), 0.0),
            distance=11.0, fov_deg=50.0, resolution=(H, W), device=dev),
        FRAMES["large_animated"])

    def path_scene(path):
        """(scene, camera, animated camera path) of a main path."""
        if path.startswith("large_"):
            return large, lcam, lcam_path
        if path == "vischeck_torus":
            return torus1, tcam, None
        if path == "animated_torus":
            return torus1, tcam, tcam_path
        return scene, cam, cam_path

    def small_cam(path, h_, w_):
        """A path's camera at h_ x w_ (the plain comparison's size)."""
        if path in ("vischeck_torus", "animated_torus"):
            return make_camera(resolution=(h_, w_), device=dev, **TORUS_CAM)
        return torus_field_camera(h_, w_, dev)

    def restir_noise(g, f, h_, w_):
        """One ReSTIR frame's draws, render_restir_frame's noise hook."""
        k_ = f.num_samples_in_reservoir
        return (torch.rand((sk, 4, k_, h_, w_), generator=g, device=dev),
                gumbel_noise(g, (2, k_, h_, w_)),
                [spatial.spatial_noise(g, n_nbr, k_, radius, h_, w_)
                 for _ in range(f.spatial_resampling_passes)])

    def run_small(path, ops, noises):
        """The path's frames at LH x LW on injected noise → last image."""
        sc = path_scene(path)[0]
        c = small_cam(path, LH, LW)
        state, img = None, None
        for nz in noises:
            img, state = render_frame(None, c, sc, LH, LW, path_feats[path],
                                      state, noise=nz, ops=ops)
        torch.cuda.synchronize()
        return img

    def run_path(path, ops, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        f = path_feats[path]
        sc, c, c_path = path_scene(path)
        if "animated" in path:
            imgs, state = render_animation(g, c_path, sc.geometry, sc.lights,
                                           sc.num_lights, H, W, f, ops=ops)
            img = imgs[-1]
        else:
            state, img = None, None
            for _ in range(FRAMES[path]):
                img, state = render_frame(g, c, sc, H, W, f, state, ops=ops)
        torch.cuda.synchronize()
        return img, state

    launches = {n: 0 for n in KERNELS}
    # The op paths of kernels 8 and 12: their entries, as a caller calls
    # them (the reference reaches neither on a frame path).
    op_calls = {
        "plucker_op": lambda i: trace.any_hit_plucker(*tshadow,
                                                      torus1.geometry),
        "neighbour_gather_op": lambda i: spatial.neighbour_gather(
            gpack, n_nbr, radius, key=gkey, pass_index=i),
    }
    for path in OP_PATHS:
        stats.launches.clear()
        outs = [op_calls[path](i) for i in range(FRAMES[path])]
        torch.cuda.synchronize()
        got = launch_counts(entries)
        expect = {n: PATHS[path].get(n, 0) * FRAMES[path] for n in KERNELS}
        print(f"path {path}: launches over {FRAMES[path]} calls "
              f"{ {n: c for n, c in got.items() if c} }")
        require(got == expect, f"{path}: launch counts {got} != {expect}")
        for n in KERNELS:
            launches[n] += got[n]
        require(all(torch.equal(o_, outs[0]) for o_ in outs)
                if path == "plucker_op" else not torch.equal(*outs),
                f"{path}: calls {'differ' if path == 'plucker_op' else 'equal'}")
        del outs
    for path, per_frame in PATHS.items():
        if (path in GRAD_PATHS or path in MIS_GRAD_PATHS or path in MIS_PATHS
                or path in OP_PATHS or path in SHARD_GRAD + SHARD_MIS
                or path == "cli"):
            continue
        stats.launches.clear()
        img_k, state_k = run_path(path, restir.KERNELS, 0)
        got = launch_counts(entries)
        ref = img_k  # the kernels' frame the plain run is held to
        if path in SMALL_PLAIN:
            g = torch.Generator(device=dev).manual_seed(3)
            noises = [restir_noise(g, path_feats[path], LH, LW)
                      for _ in range(FRAMES[path])]
            ref = run_small(path, restir.KERNELS, noises)
            img_p = run_small(path, restir.PLAIN, noises)
            same = (ref == img_p).all(dim=-1).float().mean().item()
            print(f"path {path}: kernels vs plain at {LH}x{LW} on injected "
                  f"noise, pixels bit-equal {same:.6f}, max abs diff "
                  f"{(ref - img_p).abs().max().item():.2e}; 1080p mean "
                  f"{img_k.mean().item():.6f}")
            require(bool(torch.isfinite(ref).all()),
                    f"{path}: non-finite pixels (kernels at {LH}x{LW})")
        else:
            img_p, _ = run_path(path, restir.PLAIN, 0)
        expect = {n: per_frame.get(n, 0) * FRAMES[path] for n in KERNELS}
        print(f"path {path}: launches over {FRAMES[path]} frames "
              f"{ {n: c for n, c in got.items() if c} }")
        require(got == expect, f"{path}: launch counts {got} != {expect}")
        for n in KERNELS:
            launches[n] += got[n]
        require(tuple(img_k.shape) == (H, W, 3), f"image shape {img_k.shape}")
        require(bool(torch.isfinite(img_k).all()),
                f"{path}: non-finite pixels (kernels)")
        require(bool(torch.isfinite(img_p).all()),
                f"{path}: non-finite pixels (plain)")
        mk, mp = ref.mean().item(), img_p.mean().item()
        print(f"path {path}: last-frame mean {mk:.6f} (kernels) vs "
              f"{mp:.6f} (plain)")
        require(abs(mk - mp) <= FRAME_REL * abs(mp), f"{path}: means differ")
        require(state_k.has_prev and float(state_k.reservoirs.m.max())
                > s / k, f"{path}: temporal state did not accumulate")
        if path == "vischeck_torus":
            png = ROOT / "build" / "chip_smoke_vischeck_torus.png"
            save_image(str(png), img_k)
            print(f"path {path}: wrote {png.relative_to(ROOT)}")
        if path in ("config5", "large_config5"):
            png = ROOT / "build" / f"chip_smoke_{path}.png".replace(
                "_config5", "_frame")
            png.parent.mkdir(parents=True, exist_ok=True)
            save_image(str(png), img_k)
            print(f"path {path}: wrote {png.relative_to(ROOT)}")

    section("frame paths")
    # The app: python -m romis_tpu_torch.cli in-process, on a TOML with the
    # visibility check and the 5x5 torus field's lights, and an OBJ + MTL of
    # the field (24,202 triangles: the CLI attaches the BVH). 4 frames with a
    # checkpoint, then 2 and a resume to 4.
    from romis_tpu_torch import cli
    from romis_tpu_torch.io.config import read_config_file
    from romis_tpu_torch.scene.lights import (
        PARALLELOGRAM, POINT, LightListBuilder,
    )
    from romis_tpu_torch.scene.objloader import write_obj
    from romis_tpu_torch.scene.scene import (
        load_scene_from_file, torus_field_lights, torus_field_submeshes,
    )
    import numpy as np

    cdir = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(cdir, ignore_errors=True)
    cdir.mkdir(parents=True)
    obj = cdir / "torus_field.obj"
    write_obj(str(obj), torus_field_submeshes(LARGE_N))

    def vec(v):
        return "[" + ", ".join(repr(float(x)) for x in v) + "]"

    toml = ['output_dir = "."', "[features]", "unbiased_combination = true",
            "spatial_reuse_visibility_check = true"]
    for v0, e01, e02, c0, c1, c2, c3, kind in torus_field_lights(
            LightListBuilder(), LARGE_N).rows:
        toml.append("[[lights]]")
        if kind == POINT:
            toml += ['type = "point"', f"position = {vec(v0)}",
                     f"color = {vec(c0)}"]
        else:
            require(kind == PARALLELOGRAM, "torus field lights")
            toml += ['type = "parallelogram"', f"corner = {vec(v0)}",
                     f"edges = [{vec(e01)}, {vec(e02)}]",
                     f"colors = [{', '.join(vec(c) for c in (c0, c1, c2, c3))}]"]
    toml += ["[[cameras]]", "look_at = [0.0, 0.0, 0.0]",
             "rotation = [25.0, 30.0, 0.0]", "distance_from_look_at = 11.0",
             "field_of_view = 50.0"]
    cfg_path = cdir / "vischeck.toml"
    cfg_path.write_text("\n".join(toml) + "\n")

    def run_cli(out, frames, ck):
        """→ (the image the CLI wrote, seconds on the host clock)."""
        t0 = time.perf_counter()
        rc = cli.main(["--config", str(cfg_path), "--scene", str(obj),
                       "--size", str(W), str(H), "--frames", str(frames),
                       "--checkpoint", str(ck), "--out", str(out),
                       "--format", "npy"])
        torch.cuda.synchronize()
        require(rc == 0, f"cli: exit code {rc}")
        files = list(out.glob("torus_field_*_cam_0.npy"))
        require(len(files) == 1, f"cli: images {files}")
        return np.load(files[0]), time.perf_counter() - t0

    stats.launches.clear()
    img_a, t_a = run_cli(cdir / "a", FRAMES["cli"], cdir / "ck_a")
    got = launch_counts(entries)
    expect = {n: PATHS["cli"].get(n, 0) * FRAMES["cli"] for n in KERNELS}
    print(f"path cli: launches over {FRAMES['cli']} frames "
          f"{ {n: c for n, c in got.items() if c} }")
    require(got == expect, f"cli: launch counts {got} != {expect}")
    for n in KERNELS:
        launches[n] += got[n]
    img_b, t_b = run_cli(cdir / "b", 2, cdir / "ck_b")
    img_c, t_c = run_cli(cdir / "c", FRAMES["cli"], cdir / "ck_b")
    resumed = bool(np.array_equal(img_a, img_c))
    print(f"path cli: {H}x{W}, {FRAMES['cli']} frames in {t_a:.2f} s, 2 in "
          f"{t_b:.2f} s, resumed to {FRAMES['cli']} in {t_c:.2f} s (host "
          f"clock, scene load and BVH build included); the resumed image "
          f"bit-identical {resumed} [{card}]")
    require(resumed, "cli: the resumed run's image differs")
    # The same frames through render_animation directly.
    cfg = read_config_file(str(cfg_path))
    csc = load_scene_from_file(str(obj), cfg.lights, device=dev)
    csc.geometry = with_bvh(csc.geometry)
    cc = cfg.cameras[0]
    ccam = make_camera(look_at=cc.look_at, rotation_deg=cc.rotation,
                       distance=cc.distance_from_look_at,
                       fov_deg=cc.field_of_view, resolution=(H, W),
                       device=dev)
    imgs_r, _ = render_animation(
        torch.Generator(device=dev).manual_seed(cli._camera_seed(0, 0)),
        stack_cameras([ccam] * FRAMES["cli"]), csc.geometry, csc.lights,
        csc.num_lights, H, W, cfg.features)
    torch.cuda.synchronize()
    for label, img, ref_ in (("4 frames", img_a, imgs_r[-1]),
                             ("2 frames", img_b, imgs_r[1]),
                             ("2 + resume to 4", img_c, imgs_r[-1])):
        mc, mr = float(img.mean()), ref_.mean().item()
        print(f"path cli: {label}: image mean {mc:.6f} vs {mr:.6f} through "
              f"render_animation")
        require(img.shape == (H, W, 3) and np.isfinite(img).all(),
                f"cli {label}: image")
        require(abs(mc - mr) <= FRAME_REL * abs(mr), f"cli {label}: mean")
    png = ROOT / "build" / "chip_smoke_cli.png"
    save_image(str(png), torch.from_numpy(img_a))
    print(f"path cli: wrote {png.relative_to(ROOT)}")
    del imgs_r, csc

    section("cli")
    # The gradient paths: make_grad_fn from one forward frame's state,
    # against a target rendered with the light colours x 0.8; large_grad
    # on the 5x5 torus field with its BVH (the tree as built).
    grad_feats = {
        "grad_surrogate": Features(enable_tone_mapping=False,
                                   surrogate_resampling_grad=True),
        "grad_per_pixel": Features(enable_tone_mapping=False,
                                   surrogate_resampling_grad=True,
                                   exact_gradients=True),
    }
    grad_feats["large_grad"] = grad_feats["grad_surrogate"]

    def grad_setup(path, hw=(H, W)):
        """(features, scene, camera, params, prev state, target image, one
        step's injected noise) of a gradient path at hw."""
        f = grad_feats[path]
        h_, w_ = hw
        sc, c = (large, torus_field_camera(h_, w_, dev)) \
            if path == "large_grad" else (scene, flagship_camera(h_, w_, dev))
        p = extract_params(sc.geometry, sc.lights)
        dim = replace(p, **{n: getattr(p, n) * 0.8 for n in (
            "light_c0", "light_c1", "light_c2", "light_c3")})
        g = torch.Generator(device=dev).manual_seed(11)
        args = (c, sc.geometry, sc.lights, sc.num_lights, h_, w_, f)
        with torch.no_grad():
            _, prev = render_with_params(
                p, g, *args, restir.initial_temporal_state(h_, w_, k, c))
            target, _ = render_with_params(dim, g, *args, prev)
        shape = (2, n_nbr, h_, w_) if f.exact_gradients else (2, n_nbr)
        noise = (replay_uniforms(g, s, k, h_, w_),
                 gumbel_noise(g, (2, k, h_, w_)),
                 [(torch.randint(-radius, radius + 1, shape, generator=g,
                                 device=dev, dtype=torch.int32),
                   gumbel_noise(g, (n_nbr + 1, k, h_, w_)),
                   gumbel_noise(g, (n_nbr + 1, k, h_, w_)))
                  for _ in range(f.spatial_resampling_passes)])
        return f, sc, c, p, prev, target, noise

    def grad_fn(path, sc, hw, ops=restir.KERNELS):
        return make_grad_fn(sc.geometry, sc.lights, sc.num_lights, *hw,
                            grad_feats[path], ops=ops)

    grad_reach = ("light_c0", "light_v0", "mat_kd", "tri_v0")

    def check_steps(path, got, hw, steps):
        """The launch counts of a gradient path's kernel steps, and the
        steps (loss, gradients) of the kernels and the plain versions at
        hw (on the same noise) and of the kernels on the Philox streams at
        W x H: finite, the losses within FRAME_REL, each leaf within
        GRAD_REL of its largest element and reaching the image where it
        should."""
        (loss_k, g_k), (loss_p, g_p), (loss_k2, g_k2) = steps
        expect = {n: PATHS[path].get(n, 0) * FRAMES[path] for n in KERNELS}
        print(f"path {path}: launches over {FRAMES[path]} steps "
              f"{ {n: c for n, c in got.items() if c} }")
        require(got == expect, f"{path}: launch counts {got} != {expect}")
        for n in KERNELS:
            launches[n] += got[n]
        lk, lp, lk2 = loss_k.item(), loss_p.item(), loss_k2.item()
        print(f"path {path}: loss {lk:.8g} (kernels) vs {lp:.8g} (plain) at "
              f"{hw[1]}x{hw[0]}, Philox step {lk2:.8g} at {W}x{H}")
        require(all(map(math.isfinite, (lk, lp, lk2))) and lk > 0,
                f"{path}: loss")
        require(abs(lk - lp) <= FRAME_REL * abs(lp), f"{path}: losses differ")
        worst = 0.0
        for leaf in g_k.__dataclass_fields__:
            a, b, a2 = (getattr(x, leaf) for x in (g_k, g_p, g_k2))
            require(bool(torch.isfinite(a).all() & torch.isfinite(b).all()
                         & torch.isfinite(a2).all()),
                    f"{path}: non-finite gradient {leaf}")
            scale = b.abs().max().item()
            rel = (a - b).abs().max().item() / max(scale, 1e-30)
            worst = max(worst, rel if scale > 0 else 0.0)
            print(f"path {path}: grad {leaf} max |g| {scale:.4e}, max err / "
                  f"max |g| {rel:.2e}")
            require(rel <= GRAD_REL or scale == a.abs().max().item() == 0,
                    f"{path}: gradient {leaf} differs ({rel})")
            if leaf in grad_reach:
                require(scale > 0 and a2.abs().max().item() > 0,
                        f"{path}: no gradient reaches {leaf}")
        print(f"path {path}: worst gradient leaf err / max |g| {worst:.2e}")

    for path in GRAD_PATHS:
        f, sc, c, p, prev, target, noise = grad_setup(path)
        fn_k = grad_fn(path, sc, (H, W))
        stats.launches.clear()
        step_k = fn_k(p, target, None, c, prev, noise)
        step_k2 = fn_k(p, target, torch.Generator(device=dev).manual_seed(12),
                       c, prev)
        torch.cuda.synchronize()
        got = launch_counts(entries)
        hw = (H, W)
        if path == "large_grad":
            # The plain step at 480x270 (the plain traversal walks the
            # tree in lockstep), against the kernels' on the same noise.
            hw = (LH, LW)
            f, sc, c, p, prev, target, noise = grad_setup(path, hw)
            step_k = grad_fn(path, sc, hw)(p, target, None, c, prev, noise)
        step_p = grad_fn(path, sc, hw, restir.PLAIN)(
            p, target, None, c, prev, noise)
        torch.cuda.synchronize()
        check_steps(path, got, hw, (step_k, step_p, step_k2))
        del step_k, step_k2, step_p, prev, target, noise

    section("gradient paths")
    # The MIS gradient steps: step 1 on injected noise (the selection's
    # score planes and every iteration's replay uniforms; the banded
    # step's RIS on a generator seeded alike), step 2 on the Philox
    # streams, against a target rendered with the light colours x 0.8;
    # the plain step takes step 1's noise (large_mis_grad's at LH x LW on
    # both sides: the plain 12-ray walk is a lockstep loop).
    def timed(step):
        """(the step's result, its ms by CUDA events, its peak device
        memory, and what was held before it)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev_a = torch.cuda.Event(enable_timing=True)
        ev_b = torch.cuda.Event(enable_timing=True)
        ev_a.record()
        out = step()
        ev_b.record()
        torch.cuda.synchronize()
        return (out, ev_a.elapsed_time(ev_b),
                torch.cuda.max_memory_allocated(), base)

    mis_setups = {}
    for path in MIS_GRAD_PATHS:
        sc, c, _ = path_scene(path)
        p, target, noise = mis_grad_setup(torch, path, sc, c, (H, W), dev)
        mis_setups[path] = (sc, c, p, target)
        fn_k = mis_grad_fn(path, sc, (H, W), restir.KERNELS)
        stats.launches.clear()
        step_k = fn_k(p, target, torch.Generator(device=dev).manual_seed(13),
                      c, noise=noise)
        step_k2, ms_k, pk, bk = timed(lambda: fn_k(
            p, target, torch.Generator(device=dev).manual_seed(12), c))
        got = launch_counts(entries)
        hw = (H, W)
        if path.startswith("large_"):
            hw = (LH, LW)
            c = torus_field_camera(LH, LW, dev)
            p, target, noise = mis_grad_setup(torch, path, sc, c, hw, dev)
            step_k = mis_grad_fn(path, sc, hw, restir.KERNELS)(
                p, target, torch.Generator(device=dev).manual_seed(13), c,
                noise=noise)
        step_p, ms_p, pp, bp = timed(lambda: mis_grad_fn(
            path, sc, hw, restir.PLAIN)(
                p, target, torch.Generator(device=dev).manual_seed(13), c,
                noise=noise))
        at_p = "" if hw == (H, W) else f" at {LW}x{LH}"
        nbr_ctx = mis.NBR_CTX_PLANES * n_nbr * H * W * 4
        print(f"time grad[{path}]: {ms_k:.3f} ms/step kernels (the Philox "
              f"step, the second), {ms_p:.3f} ms/step plain{at_p} (injected "
              f"noise) [{card}]")
        print(f"memory grad[{path}]: peak {pk / 2**30:.3f} GiB kernels, "
              f"Philox step ({(pk - bk) / 2**30:.3f} above the "
              f"{bk / 2**30:.3f} GiB held before it), {pp / 2**30:.3f} GiB "
              f"plain{at_p}, injected noise ({(pp - bp) / 2**30:.3f} above); "
              f"the neighbours' contexts gathered once a step "
              f"{nbr_ctx / 2**30:.3f} GiB, their cotangent as much [{card}]")
        check_steps(path, got, hw, (step_k, step_p, step_k2))
        del step_k, step_k2, step_p, target, noise
        section(f"path {path}")

    section("MIS gradient paths")
    # R-MIS / R-OMIS: frame 1 on injected noise (the selection's score
    # planes, every iteration's RIS uniforms), frame 2 on the Philox
    # streams; the plain run takes frame 1's noise.
    mis_noise = (nbrsel.selection_noise(gen, radius, H, W),
                 torch.rand((it_n, sk, 4, k, H, W), generator=gen,
                            device=dev))
    small_noise = (nbrsel.selection_noise(gen, radius, LH, LW),
                   torch.rand((it_n, sk, 4, k, LH, LW), generator=gen,
                              device=dev))
    for path in MIS_PATHS:
        f = path_feats[path]
        sc, c, _ = path_scene(path)
        stats.launches.clear()
        img_k, st = render_frame(None, c, sc, H, W, f, noise=mis_noise)
        img_k2, _ = render_frame(torch.Generator(device=dev).manual_seed(0),
                                 c, sc, H, W, f)
        torch.cuda.synchronize()
        got = launch_counts(entries)
        ref = img_k  # the kernels' frame the plain run is held to
        if path.startswith("large_"):
            # The plain run at 480x270 (its 12 rays per pixel walk the
            # tree in lockstep), against the kernels on the same noise.
            cs = torus_field_camera(LH, LW, dev)
            ref, _ = render_frame(None, cs, sc, LH, LW, f, noise=small_noise)
            img_p, _ = render_frame(None, cs, sc, LH, LW, f,
                                    noise=small_noise, ops=restir.PLAIN)
        else:
            img_p, _ = render_frame(None, c, sc, H, W, f, noise=mis_noise,
                                    ops=restir.PLAIN)
        torch.cuda.synchronize()
        expect = {n: PATHS[path].get(n, 0) * FRAMES[path] for n in KERNELS}
        print(f"path {path}: launches over {FRAMES[path]} frames "
              f"{ {n: c for n, c in got.items() if c} }")
        require(got == expect, f"{path}: launch counts {got} != {expect}")
        for n in KERNELS:
            launches[n] += got[n]
        require(st is None and tuple(img_k.shape) == (H, W, 3),
                f"{path}: image {tuple(img_k.shape)}")
        for label, img in (("kernels", img_k), ("Philox", img_k2),
                           ("plain", img_p), ("kernels vs plain", ref)):
            require(bool(torch.isfinite(img).all()),
                    f"{path}: non-finite pixels ({label})")
        mk, mk2, mr, mp = (x.mean().item() for x in (img_k, img_k2, ref,
                                                     img_p))
        same = (ref == img_p).all(dim=-1).float().mean().item()
        print(f"path {path}: injected-noise frame mean {mr:.6f} (kernels) vs "
              f"{mp:.6f} (plain) at {tuple(ref.shape[:2])}, pixels bit-equal "
              f"{same:.6f}, max abs diff {(ref - img_p).abs().max().item():.2e}"
              f"; Philox frame mean {mk2:.6f} vs injected {mk:.6f} at 1080p")
        require(abs(mr - mp) <= FRAME_REL * abs(mp), f"{path}: means differ")
        require(abs(mk2 - mk) <= FRAME_REL * abs(mk),
                f"{path}: Philox frame mean differs")
        if path in ("romis", "large_romis"):
            png = ROOT / "build" / f"chip_smoke_{path}.png"
            save_image(str(png), img_k2)
            print(f"path {path}: wrote {png.relative_to(ROOT)}")
    del mis_noise, small_noise

    # ---- 5. timing ----
    section("5")
    def one_frame(path, ops, hw=(H, W)):
        g = torch.Generator(device=dev).manual_seed(5)
        f = path_feats[path]
        sc, c0, c_path = path_scene(path)
        if hw != (H, W):
            c0 = small_cam(path, *hw)
        st = restir.initial_temporal_state(
            *hw, f.num_samples_in_reservoir, c0)
        i = 0

        def run():
            nonlocal st, i
            c = camera_at(c_path, i % FRAMES[path]) \
                if "animated" in path else c0
            _, st = render_frame(g, c, sc, *hw, f, st, ops=ops)
            i += 1
        return run

    for path in PATHS:
        if (path in GRAD_PATHS or path in MIS_GRAD_PATHS or path in OP_PATHS
                or path in SHARD_GRAD + SHARD_MIS or path == "cli"):
            continue
        if path.startswith("large_") and path in MIS_PATHS \
                or path in SMALL_PLAIN:
            # The plain frame at 480x270 (lockstep 12-ray walks).
            f_k = cuda_ms(torch, one_frame(path, restir.KERNELS), 5)
            f_p = cuda_ms(torch, one_frame(path, restir.PLAIN, (LH, LW)), 1)
            print(f"time frame[{path}]: {f_k:.3f} ms/frame kernels, "
                  f"{f_p:.3f} ms/frame plain at {LH}x{LW} [{card}]")
            continue
        if path in MIS_PATHS:
            f_k, f_p = ab_ms(torch, one_frame(path, restir.KERNELS),
                             one_frame(path, restir.PLAIN), 5, 2)
            print(f"time frame[{path}]: {f_k:.3f} ms/frame kernels, "
                  f"{f_p:.3f} ms/frame plain [{card}]")
            continue
        f_k, f_p = ab_ms(torch, one_frame(path, restir.KERNELS),
                         one_frame(path, restir.PLAIN), 10,
                         1 if path.startswith("large_") else 3)
        print(f"time frame[{path}]: {f_k:.3f} ms/frame kernels, {f_p:.3f} "
              f"ms/frame plain ({H * W * (1 + k) / f_k / 1e3:.1f} Mrays/s) "
              f"[{card}]")

    section("frame timings")
    # Where a frame's time goes: torch.profiler over a few frames.
    def profile_frames(path, n):
        profile_run(torch, path, one_frame(path, restir.KERNELS), n, card)

    profile_frames("romis", 3)
    profile_frames("animated", FRAMES["animated"])
    profile_frames("animated_torus", FRAMES["animated_torus"])
    profile_frames("large_config5", 5)
    profile_frames("large_romis", 2)
    for path in ("vischeck", "vischeck_torus", "large_vischeck"):
        profile_frames(path, 3)

    for path in GRAD_PATHS:
        # The plain large step at 480x270 (lockstep traversal), like its
        # comparison above.
        hw_p = (LH, LW) if path == "large_grad" else (H, W)
        setups = {hw: grad_setup(path, hw) for hw in {(H, W), hw_p}}

        def grad_step(ops, hw):
            f, sc, c, p, prev, target, _ = setups[hw]
            fn = grad_fn(path, sc, hw, ops)
            g = torch.Generator(device=dev).manual_seed(5)
            return lambda: fn(p, target, g, c, prev)

        def forward_frame(ops, hw):
            f, sc, c, p, prev, _, _ = setups[hw]
            g = torch.Generator(device=dev).manual_seed(5)

            def run():
                with torch.no_grad():
                    render_with_params(p, g, c, sc.geometry, sc.lights,
                                       sc.num_lights, *hw, f, prev, ops=ops)
            return run

        s_k, s_p = ab_ms(torch, grad_step(restir.KERNELS, (H, W)),
                         grad_step(restir.PLAIN, hw_p), 3, 1)
        f_k, f_p = ab_ms(torch, forward_frame(restir.KERNELS, (H, W)),
                         forward_frame(restir.PLAIN, hw_p), 5, 2)
        peaks = []
        for ops, hw in ((restir.KERNELS, (H, W)), (restir.PLAIN, hw_p)):
            step = grad_step(ops, hw)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated(), base))
        (pk, bk), (pp, bp) = peaks
        at_p = "" if hw_p == (H, W) else f" at {LW}x{LH}"
        print(f"time grad[{path}]: {s_k:.3f} ms/step kernels, {s_p:.3f} "
              f"ms/step plain{at_p}; forward frame {f_k:.3f} ms kernels, "
              f"{f_p:.3f} ms plain{at_p} [{card}]")
        print(f"memory grad[{path}]: peak {pk / 2**30:.3f} GiB kernels "
              f"({(pk - bk) / 2**30:.3f} above the {bk / 2**30:.3f} GiB "
              f"held before the step), {pp / 2**30:.3f} GiB plain{at_p} "
              f"({(pp - bp) / 2**30:.3f} above) [{card}]")
        del setups

    # One whole-frame MIS gradient step of each path on the Philox
    # streams, profiled on the device's activity alone after a warm-up
    # step. Its ms by events and the plain step's are in section 4's lines.
    # The banded step's ~10^6 launches would keep the profiler busy for
    # minutes: one band's work is profiled instead, the step at
    # W x (H / MIS_BANDS) in one band (the same band shapes, the flagship
    # camera at that size), timed by events and profiled alike.
    for path, (sc, c, p, target) in mis_setups.items():
        bands, hw = MIS_BANDS, (H, W)
        if path == "mis_grad_banded":
            bands, hw = 1, (H // MIS_BANDS, W)
            c = flagship_camera(*hw, dev)
            p, target, _ = mis_grad_setup(torch, path, sc, c, hw, dev)
        fn = mis_grad_fn(path, sc, hw, restir.KERNELS, bands)
        g = torch.Generator(device=dev).manual_seed(5)
        label = path
        if bands == 1:  # warmed up by its timing
            label = f"{path}, one band {W}x{hw[0]}"
            ms = cuda_ms(torch, lambda: fn(p, target, g, c), 2)
            print(f"time grad[{label}]: {ms:.3f} ms/step [{card}]")
        profile_run(torch, label, lambda: fn(p, target, g, c), 1, card,
                    "step", cuda_only=True, warm=bands != 1)
    del mis_setups

    section("step timings and profiles")
    uni = torch.rand((sk, 4, k, H, W), generator=gen, device=dev)
    o, d, tm = shadow_rays(ctx, res_main)
    key = spatial.philox_key(gen)
    _, fctx = restir.trace_primary(rays, scene.geometry, feats,
                                   restir.KERNELS)
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
        # On the receivers as a frame gives them (the kernels' trace: each
        # field its own contiguous planes; the plain trace's are strided
        # views, which the wrapper would copy).
        "final_shade": ab_ms(
            torch, lambda: shade.final_shade_fused(fctx, res_main,
                                                   scene.geometry, feats),
            lambda: shade.final_shade_plain(fctx, res_main, scene.geometry,
                                            feats), 20, 5),
        "any_hit": ab_ms(
            torch, lambda: trace.any_hit(o, d, tm, scene.geometry),
            lambda: trace.any_hit_plain(o, d, tm, scene.geometry), 20, 5),
        # Kernel 9 at the gather route's 39 planes, D = 5 (every frame
        # shape is timed apart below).
        "halo_gather": ab_ms(
            torch, lambda: spatial.halo_offset_gather(*h39),
            lambda: spatial.halo_offset_gather_plain(*h39).contiguous(), 20,
            3),
    }
    for label, (kernel_fn, plain_fn) in pass_fns.items():
        timings[label] = ab_ms(torch, lambda: kernel_fn(generator=gen,
                                                        key=key),
                               lambda: plain_fn(generator=gen), 10, 3)
    # Kernel 2 at the MIS records path's light indices, and kernel 13 back
    # (the last of the cases below).
    ms = ab_ms(torch, lambda: rows.gather_rows(l_tab, rec_idx),
               lambda: rows.gather_rows_plain(l_tab, rec_idx).contiguous(),
               20, 5)
    flat = rec_idx.reshape(-1).long()
    lib = cuda_ms(torch, lambda: torch.index_select(l_tab, 0, flat), 20)
    b_ms, b_by = bound(rec_idx.numel() * 4 * (1 + l_tab.shape[1])
                       + l_tab.numel() * 4, 0)
    print(f"time gather_rows[records]: {ms[0]:.4f} ms kernel, {ms[1]:.4f} "
          f"ms plain, index_select {lib:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {ms[0] / b_ms:.2f}x the bound; {rec_idx.numel()} "
          f"indices [{card}]")
    del flat
    scatter_cases["records lights"] = (records_ct(), rec_idx, l_tab.shape[0])
    for label, (ct, idx_s, n_rows) in scatter_cases.items():
        ms = ab_ms(torch, lambda: scatter.scatter_rows_add(ct, idx_s, n_rows),
                   lambda: scatter.scatter_rows_add_plain(ct, idx_s, n_rows),
                   20, 5)
        src, flat = ct.reshape(ct.shape[0], -1).t(), idx_s.reshape(-1).long()
        lib = cuda_ms(torch, lambda: torch.zeros(
            (n_rows, ct.shape[0]), device=dev).index_add_(0, flat, src), 20)
        b_ms, b_by = scatter_bound(ct, idx_s, n_rows)
        print(f"time scatter_rows_add[{label}]: {ms[0]:.4f} ms kernel, "
              f"{ms[1]:.4f} ms plain, index_add_ {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {ms[0] / b_ms:.2f}x the bound; "
              f"{n_rows} rows x {ct.shape[0]}, {idx_s.numel()} indices "
              f"[{card}]")
        if label == "lights":
            timings["scatter_rows_add"] = ms
    del src, flat, ct, scatter_cases["records lights"]
    timings["halo_scatter"] = ab_ms(
        torch, lambda: spatial.halo_offset_scatter(halo_ct, sdy, sdx),
        lambda: spatial.halo_offset_scatter_plain(halo_ct, sdy, sdx), 20, 5)
    uni5 = torch.rand((sk, 5, k, H, W), generator=gen, device=dev)
    timings["ris_replay"] = ab_ms(
        torch, lambda: ris.gen_canonical_replay(
            ctx, scene.lights, scene.num_lights, feats, uniforms=uni5),
        lambda: gen_canonical_replay_plain(
            ctx, scene.lights, scene.num_lights, feats, uniforms=uni5), 10, 3)
    # The R-MIS / R-OMIS kernels on the main path's streams: the SIMILAR
    # selection (Philox), the 5-iteration R-OMIS pack (Philox) and one
    # R-OMIS direct sweep iteration.
    sel_key = spatial.philox_key(gen)
    timings["neighbour_select"] = ab_ms(
        torch, lambda: nbrsel.neighbour_select(
            sel_gates, n_nbr, radius, False, True, *sel_args, generator=gen,
            key=sel_key),
        lambda: nbrsel.neighbour_select_plain(
            sel_gates, n_nbr, radius, False, True, *sel_args,
            generator=gen), 10, 2)
    timings["mis_ris"] = ab_ms(
        torch, lambda: ris.gen_mis_reservoir_planes(
            ctx, scene.lights, scene.num_lights, feats, it_n, True,
            generator=gen),
        lambda: ris.gen_mis_reservoir_planes_plain(
            ctx, scene.lights, scene.num_lights, feats, it_n, True,
            generator=gen), 10, 2)
    ny_t, nx_t = select_neighbour_indices(
        gen, ctx, H, W, feats, select=nbrsel.neighbour_select_plain)
    offs_t = mis_offsets(ny_t, nx_t)
    nbr_t = mis.resolve_neighbour_ctx(cen, offs_t)
    d1 = n_nbr + 1
    al_t = torch.rand((3 * d1, H, W), generator=gen, device=dev) - 0.5
    sweep_args = dict(romis=("romis", packs[True], nbr_t, None),
                      romis_prog=("romis", packs[True], nbr_t, al_t),
                      rmis_equal=("rmis_equal", packs[False], None, None),
                      rmis_balance=("rmis_balance", packs[False], nbr_t,
                                    None))
    sweep_ms = {}  # each mode's times, printed beside its bound below
    for label, (m, pack, nbr_, al_) in sweep_args.items():
        sweep_ms[label] = ab_ms(
            torch, lambda: mis.mis_iteration(
                cen, pack, offs_t, scene.geometry, k, m, scene.num_lights,
                feats, nbr_ctx=nbr_, alphas=al_),
            lambda: mis.mis_iteration_plain(
                cen, pack, offs_t, scene.geometry, k, m, scene.num_lights,
                feats, nbr_ctx=nbr_, alphas=al_), 20, 3)
    timings["mis_iteration"] = sweep_ms["romis"]
    # The BVH kernels at the 1080p torus-field frame's shapes: primary rays,
    # one plane of shadow rays (19), the 12 ext_vis rays per pixel (20), the
    # final shade (21); the ext_vis sweep (R-OMIS) beside them.
    timings["bvh_closest_hit"] = ab_ms(
        torch, lambda: walk.closest_hit_bvh(lrays, lgeo),
        lambda: bvh_closest(lrays, lgeo, lgeo.bvh), 20, 1)
    timings["bvh_any_hit"] = ab_ms(
        torch, lambda: walk.any_hit_bvh(*one, lgeo),
        lambda: bvh_any(*one, lgeo, lgeo.bvh), 20, 1)
    ext_rays = vis_rays(lctx.position, ext_targets)
    timings["bvh_any_hit_k"] = ab_ms(
        torch, lambda: walk.any_hit_bvh_k(*ext_rays, lgeo),
        lambda: bvh_any(*ext_rays, lgeo, lgeo.bvh), 20, 1)
    # Kernel 20 beside kernel 19 on the same rays, in turns (19, 20, 20,
    # 19): the 12 ext_vis planes and the S = 2 shadow rays.
    for label, rays_ in (("12 planes, the S=12 ext_vis rays", ext_rays),
                         ("2 planes, the S=2 rays", lshadow)):
        m20, m19 = ab_ms(torch, lambda: walk.any_hit_bvh_k(*rays_, lgeo),
                         lambda: walk.any_hit_bvh(*rays_, lgeo), 20, 20)
        print(f"time bvh_any_hit_k vs bvh_any_hit[{label}]: kernel 20 "
              f"{m20:.4f} ms, kernel 19 {m19:.4f} ms, ratio "
              f"{m20 / m19:.3f} [{card}]")
    ms = ab_ms(torch, lambda: walk.any_hit_bvh_k(*lshadow, lgeo),
               lambda: bvh_any(*lshadow, lgeo, lgeo.bvh), 20, 1)
    print(f"time bvh_any_hit_k[S=2]: {ms[0]:.4f} ms kernel, {ms[1]:.4f} ms "
          f"plain [{card}]")
    del ext_rays
    timings["bvh_final_shade"] = ab_ms(
        torch, lambda: shade.final_shade_bvh(lctx, lres, lgeo, feats),
        lambda: shade.final_shade_plain(lctx, lres, lgeo, feats), 20, 1)
    lcen = shade.pack_center_ctx(lctx)
    lnbr = mis.resolve_neighbour_ctx(lcen, loffs)
    lext = mis_ext_vis(lctx, lpos, loffs, lgeo, k)
    sweep_ms["ext_vis romis, torus5x5"] = ab_ms(
        torch, lambda: mis.mis_iteration(
            lcen, lpack, loffs, lgeo, k, "romis", large.num_lights, feats,
            nbr_ctx=lnbr, ext_vis=lext),
        lambda: mis.mis_iteration_plain(
            lcen, lpack, loffs, lgeo, k, "romis", large.num_lights, feats,
            nbr_ctx=lnbr, ext_vis=lext), 20, 3)
    ms = cuda_ms(torch, lambda: mis_ext_vis(lctx, lpos, loffs, lgeo, k), 20)
    print(f"time mis_ext_vis (halo gather + kernel 20, 12 rays/pixel): "
          f"{ms:.4f} ms [{card}]")
    # Kernel 7 on the Z rays of the 1080p vis-check pass on the one-torus
    # soup (the vischeck_torus path's), its plain version at 480x270; the
    # plain version at 1080p counts the tests of the bound once and is held
    # to kernel 7 there too. Kernel 11's vis_check mode and the whole pass
    # beside it.
    def torus_z_rays(h_, w_):
        c_ = tcam if (h_, w_) == (H, W) else small_cam("vischeck_torus",
                                                        h_, w_)
        _, tc = restir.trace_primary(generate_rays(c_, h_, w_),
                                     torus1.geometry, feats, restir.KERNELS)
        tr = pack_reservoir_planes(ris.gen_canonical_samples_ris(
            tc, torus1.lights, torus1.num_lights, feats, generator=gen))
        tcn = shade.pack_center_ctx(tc)
        pl, blk = spatial.spatial_pass_unbiased_vis(
            tr, tcn, k, n_nbr, radius, vfeats, generator=gen,
            key=spatial.philox_key(gen))
        return tr, tcn, z_rays(pl, blk, tcn)

    t_res, t_cen, (zo_t, zt_t, zm_t) = torus_z_rays(H, W)
    _, _, (zo_s, zt_s, zm_s) = torus_z_rays(LH, LW)
    zc = {}
    occ_t = trace.zcount_occ_plain(zo_t, zt_t, torus1.geometry,
                                   SHADOW_RAY_EPSILON, zm_t, counts=zc)
    same_t = torch.equal(occ_t, trace.zcount_occ(
        zo_t, zt_t, torus1.geometry, SHADOW_RAY_EPSILON, zm_t))
    print(f"check zcount_occ[torus soup 1080p, a vis_check pass's rays]: "
          f"alive {zm_t.float().mean().item():.4f}, occluded "
          f"{occ_t.float().mean().item():.4f}, the same bool on every ray "
          f"{same_t}; triangle tests per traced ray "
          f"{zc['tests'][zc['tests'] > 0].float().mean().item():.1f} of "
          f"{int(torus1.geometry.active.sum())}")
    require(same_t, "zcount_occ torus 1080p: kernel 7 and plain differ")
    # The culled walk's tests on the same rays (the plain model of kernel
    # 7's cull, which gives the same bool): with the near-parallel guard,
    # which the design adds, and with the box alone deciding, the walk
    # the cull needs (its tests give kernel 7's table bound).
    zcc, zcb = {}, {}
    require(torch.equal(occ_t, trace.zcount_occ_culled(
        zo_t, zt_t, torus1.geometry, SHADOW_RAY_EPSILON, zm_t, zcc)),
        "zcount_occ torus 1080p: the culled model and plain differ")
    box_alone = trace.zcount_occ_culled(
        zo_t, zt_t, torus1.geometry, SHADOW_RAY_EPSILON, zm_t, zcb,
        guard=False)
    traced_t = zc["tests"] > 0
    print(f"check zcount_occ culled walk [torus soup 1080p]: the plain "
          f"bool on every ray; per traced ray "
          f"{zcc['box'][traced_t].float().mean().item():.1f} box tests, "
          f"{zcc['guard'][traced_t].float().mean().item():.1f} blocks "
          f"guarded ({zcc['guard_cone'][traced_t].float().mean().item():.1f}"
          f" cone and {zcc['guard_tri'][traced_t].float().mean().item():.1f}"
          f" normal products), "
          f"{zcc['tri'][traced_t].float().mean().item():.1f} "
          f"triangle tests (plain "
          f"{zc['tests'][traced_t].float().mean().item():.1f}); the box "
          f"alone: {zcb['box'][traced_t].float().mean().item():.1f} box and "
          f"{zcb['tri'][traced_t].float().mean().item():.1f} triangle "
          f"tests, wrong on {(box_alone != occ_t).sum().item()} rays")
    ms = cuda_ms(torch, lambda: trace.build_zcount_blocks(
        torus1.geometry.tri_cols), 10)
    print(f"time zcount_blocks (kernel 7's blocks, built once a soup; "
          f"torus soup): {ms:.4f} ms [{card}]")
    timings["zcount_occ"] = (
        cuda_ms(torch, lambda: trace.zcount_occ(
            zo_t, zt_t, torus1.geometry, SHADOW_RAY_EPSILON, zm_t), 10),
        cuda_ms(torch, lambda: trace.zcount_occ_plain(
            zo_s, zt_s, torus1.geometry, SHADOW_RAY_EPSILON, zm_s), 2))
    print(f"time zcount_occ: {timings['zcount_occ'][0]:.4f} ms kernel at "
          f"{H}x{W}, {timings['zcount_occ'][1]:.4f} ms plain at {LH}x{LW} "
          f"(the torus soup's Z rays) [{card}]")
    vkey = spatial.philox_key(gen)
    ms = cuda_ms(torch, lambda: spatial.spatial_pass_unbiased_vis(
        t_res, t_cen, k, n_nbr, radius, vfeats, generator=gen, key=vkey), 10)
    print(f"time spatial_pass_unbiased vis_check mode (torus soup 1080p): "
          f"{ms:.4f} ms [{card}]")
    ms = cuda_ms(torch, lambda: spatial.spatial_pass_unbiased_fused(
        t_res, t_cen, k, n_nbr, radius, vfeats, generator=gen, key=vkey,
        geometry=torus1.geometry), 10)
    print(f"time vis-check pass (kernel 11 + kernel 7 + Z subtraction, torus "
          f"soup 1080p): {ms:.4f} ms [{card}]")
    # Kernels 6 and 8 on the torus soup's 1080p shadow rays, the 2048-soup's
    # (480x270) and the flagship's, side by side, each beside two bounds:
    # the tests its cull needs (the box alone deciding: ops.trace's
    # any_hit_culled and any_hit_plucker_culled with guard=False; BOX_OPS a
    # box test, MT_OPS or PLUCKER_OPS a triangle test, a segment's three
    # reciprocals and kernel 8's set-up; the guards' operations printed
    # apart) and the full scan's, each plain version's tests up to each
    # segment's first occluder. Kernel 8's constants are kept with the
    # soup: their build, at a soup's first call, is timed apart.
    tgeo = torus1.geometry
    for label, geo_ in (("torus soup", tgeo), ("soup2048", soup),
                        ("flagship", scene.geometry)):
        ms = cuda_ms(torch, lambda: (setattr(geo_, "plucker", None),
                                     trace.plucker_blocks(geo_)), 5)
        first = cuda_ms(torch, lambda: (setattr(geo_, "plucker", None),
                                        trace.any_hit_plucker(
                                            *tshadow if geo_ is tgeo else
                                            (o, d, tm), geo_)), 3)
        print(f"time plucker_blocks[{label}] (kernel 8's kept constants, "
              f"slots and guard, built at a soup's first call): {ms:.4f} ms; "
              f"a first call with its build {first:.4f} ms [{card}]")
    timings["any_hit_plucker"] = ab_ms(
        torch, lambda: trace.any_hit_plucker(*tshadow, tgeo),
        lambda: trace.any_hit_plucker_plain(*tshadow, tgeo), 10, 1)
    soup_any_rows = {}
    for label, rays_, geo_ in (
            ("torus soup 1080p, 970 triangles", tshadow, tgeo),
            ("soup2048 480x270, 2048 triangles", sshadow, soup),
            ("flagship 1080p, 2 triangles", (o, d, tm), scene.geometry)):
        m8, m6 = ab_ms(torch, lambda: trace.any_hit_plucker(*rays_, geo_),
                       lambda: trace.any_hit(*rays_, geo_), 10, 10)
        n_seg = rays_[2].numel()
        n_traced = int((rays_[2] > 0).sum().item())
        seg_bytes = n_seg * 29 + geo_.tri_cols.numel() * 4
        c6, c6b, c6p, c8, c8b, c8p = {}, {}, {}, {}, {}, {}
        require(torch.equal(trace.any_hit_culled(*rays_, geo_, c6,
                                                 lazy=False),
                            trace.any_hit_plain(*rays_, geo_, c6p))
                and torch.equal(trace.any_hit_plucker_culled(*rays_, geo_, c8),
                                trace.any_hit_plucker_plain(*rays_, geo_,
                                                            c8p)),
                f"{label}: a culled model differs from its plain version")
        trace.any_hit_culled(*rays_, geo_, c6b, guard=False)
        trace.any_hit_plucker_culled(*rays_, geo_, c8b, guard=False)
        recip = 3 * (SFU_OPS + 1)
        b6 = bound(seg_bytes, c6b["box"].sum().item() * BOX_OPS
                   + c6b["tri"].sum().item() * MT_OPS + n_traced * recip)
        b6f = bound(seg_bytes, c6p["tests"].sum().item() * MT_OPS)
        b8 = bound(seg_bytes, c8b["box"].sum().item() * BOX_OPS
                   + c8b["tri"].sum().item() * PLUCKER_OPS
                   + n_traced * (PLUCKER_RAY_OPS + recip))
        b8f = bound(seg_bytes, c8p["tests"].sum().item() * PLUCKER_OPS
                    + n_seg * PLUCKER_RAY_OPS)
        g6 = (c6["guard"].sum().item() * GUARD_OPS
              + c6["guard_cone"].sum().item() * GUARD_CONE_OPS
              + c6["guard_tri"].sum().item() * GUARD_TRI_OPS)
        g8 = (c8["guard"].sum().item() * PLUCKER_GUARD_OPS
              + c8["guard_cone"].sum().item() * GUARD_CONE_OPS
              + c8["guard_tri"].sum().item() * GUARD_TRI_OPS)
        for name_, ms_, bc, bf, cb, cg, gops in (
                ("any_hit", m6, b6, b6f, c6b, c6, g6),
                ("any_hit_plucker", m8, b8, b8f, c8b, c8, g8)):
            print(f"time {name_}[{label}]: {ms_:.4f} ms; bound of the culled "
                  f"walk {bc[0]:.4f} ms ({bc[1]}; per segment "
                  f"{cb['box'].float().mean().item():.2f} box and "
                  f"{cb['tri'].float().mean().item():.2f} triangle tests, "
                  f"{n_traced} traced), {ms_ / bc[0]:.2f}x it; bound of the "
                  f"full scan {bf[0]:.4f} ms ({bf[1]}); with the guard "
                  f"{cg['tri'].float().mean().item():.2f} triangle tests and "
                  f"{cg['guard'].float().mean().item():.2f} blocks guarded a "
                  f"segment, its operations alone (not in the bound) "
                  f"{gops:.4e}, {1e3 * gops / FP32_OPS_S:.4f} ms at the float "
                  f"peak [{card}]")
        print(f"time any_hit_plucker vs any_hit (kernel 8 vs kernel 6, the "
              f"same segments; {label}): {m8:.4f} ms vs {m6:.4f} ms, ratio "
              f"{m8 / m6:.2f} [{card}]")
        soup_any_rows[label] = dict(b6=b6, b8=b8)
        del c6, c6b, c6p, c8, c8b, c8p
    plucker_bound = soup_any_rows["torus soup 1080p, 970 triangles"]["b8"]
    del sshadow
    # Kernel 4 on the one-torus soup (vischeck_torus's receivers, K = 2),
    # beside two bounds: the culled walk's tests on the lanes it traces
    # (the box alone deciding, as kernel 7's row counts; the guard's
    # operations printed apart) and the full scan's, the plain any-hit's
    # tests up to each ray's first occluder; the culled model's bool held
    # to the plain any-hit's on every traced ray.
    tres4 = ris.gen_canonical_samples_ris(tctx, torus1.lights,
                                          torus1.num_lights, feats,
                                          generator=gen)
    ms4 = ab_ms(torch, lambda: shade.final_shade_soup(tctx, tres4, tgeo,
                                                      feats),
                lambda: shade.final_shade_plain(tctx, tres4, tgeo, feats),
                10, 1)
    rays4 = {}

    def grab4(o_, d_, tm_, _g):
        rays4["r"] = (o_, d_.expand(o_.shape), tm_)
        return torch.ones(tm_.shape, dtype=torch.bool, device=dev)

    live4 = shade.shadow_occlusion_plain(tctx, tres4, tgeo, feats, grab4)
    o4, d4, tm4 = (a.movedim(-3, 0)[:, live4][:, None] if a.dim() > 3
                   else a[live4][None] for a in rays4["r"])
    cb4, cg4, cp4 = {}, {}, {}
    occ4 = trace.any_hit_plain(o4, d4, tm4, tgeo, cp4)
    require(torch.equal(trace.any_hit_culled(o4, d4, tm4, tgeo, cg4), occ4),
            "kernel 4's culled model and the plain any-hit differ on the "
            "torus soup")
    trace.any_hit_culled(o4, d4, tm4, tgeo, cb4, guard=False)
    n4 = int(live4.sum().item())
    lit4 = n4 - int(occ4.sum().item())
    occ4_all = torch.zeros_like(live4)
    occ4_all[live4] = occ4[0]
    bytes4 = shade_bytes(torch, tctx, tres4, occ4_all, feats.enable_shading)
    rest4 = n4 * (SHADOW_OPS + 3 * (SFU_OPS + 1)) + lit4 * PHONG_OPS
    b4c = bound(bytes4, cb4["box"].sum().item() * BOX_OPS
                + cb4["tri"].sum().item() * MT_OPS + rest4)
    b4f = bound(bytes4, cp4["tests"].sum().item() * MT_OPS + rest4)
    guard4 = (cg4["guard"].sum().item() * GUARD_OPS
              + cg4["guard_cone"].sum().item() * GUARD_CONE_OPS
              + cg4["guard_tri"].sum().item() * GUARD_TRI_OPS)
    print(f"time final_shade[torus soup 1080p, K=2, 970 triangles]: "
          f"{ms4[0]:.4f} ms kernel, {ms4[1]:.4f} ms plain; bound of the "
          f"culled walk {b4c[0]:.4f} ms ({b4c[1]}; per traced ray "
          f"{cb4['box'].float().mean().item():.1f} box and "
          f"{cb4['tri'].float().mean().item():.1f} triangle tests, "
          f"{n4} rays traced), {ms4[0] / b4c[0]:.2f}x it; bound of the "
          f"full scan {b4f[0]:.4f} ms ({b4f[1]}; "
          f"{cp4['tests'].float().mean().item():.1f} tests a ray up to its "
          f"first occluder); the guard alone (not in the bound) "
          f"{guard4:.4e} operations, {1e3 * guard4 / FP32_OPS_S:.4f} ms at "
          f"the float peak [{card}]")
    del tres4, live4, rays4, o4, d4, tm4, occ4, occ4_all, cb4, cg4, cp4
    # Kernel 1 on the same soup's primary rays (vischeck_torus's), beside
    # its bound: the tests its cull needs, the box-alone walk's
    # (ops.trace.closest_hit_culled with guard=False; the culled model with
    # its guard is bit-equal to the plain scan here too, and its guard's
    # products, a lane's own, are printed apart); the full scan's, every
    # ray against every triangle, beside it.
    trays = generate_rays(tcam, H, W)
    ms1 = ab_ms(torch, lambda: trace.closest_hit(trays, tgeo),
                lambda: trace.closest_hit_plain(trays, tgeo), 20, 1)
    c1, c1b = {}, {}
    require(all(torch.equal(a, b) for a, b in zip(
        trace.closest_hit_culled(trays, tgeo, counts=c1),
        trace.closest_hit_plain(trays, tgeo))),
        "kernel 1's culled model and the plain scan differ on the torus soup")
    trace.closest_hit_culled(trays, tgeo, counts=c1b, guard=False)
    n_t1 = tgeo.tri_cols.shape[1]
    b1 = bound(H * W * 40, c1b["box"].sum().item() * BOX_OPS
               + c1b["tri"].sum().item() * MT_OPS + H * W * 3 * SFU_OPS)
    b1f = bound(H * W * 10 * 4 + n_t1 * 40, H * W * n_t1 * MT_OPS)
    guard1 = (c1["guard"].sum().item() * GUARD_OPS
              + c1["guard_cone"].sum().item() * GUARD_CONE_OPS
              + c1["guard_tri"].sum().item() * GUARD_TRI_OPS)
    print(f"time closest_hit[torus soup 1080p, {n_t1} triangle slots, "
          f"vischeck_torus's primary rays]: {ms1[0]:.4f} ms kernel, "
          f"{ms1[1]:.4f} ms plain; bound of the culled walk {b1[0]:.4f} ms "
          f"({b1[1]}; per ray {c1b['box'].float().mean().item():.1f} box "
          f"and {c1b['tri'].float().mean().item():.1f} triangle tests; with "
          f"the guard {c1['tri'].float().mean().item():.1f} triangle tests "
          f"and {c1['guard'].float().mean().item():.1f} blocks guarded), "
          f"{ms1[0] / b1[0]:.2f}x it; bound of the full scan {b1f[0]:.4f} ms "
          f"({b1f[1]}); each lane's guard alone (not in the bound; the "
          f"kernel tries the pair cones once a warp) {guard1:.4e} "
          f"operations, {1e3 * guard1 / FP32_OPS_S:.4f} ms at the float "
          f"peak [{card}]")
    del trays, c1, c1b
    # Kernel 12 on config 5's pack: its Philox stream (the plain version
    # draws the same offsets with neighbour_offsets), and injected offsets.
    timings["neighbour_gather"] = ab_ms(
        torch, lambda: spatial.neighbour_gather(gpack, n_nbr, radius,
                                                key=gkey, pass_index=1),
        lambda: spatial.neighbour_gather_plain(gpack, spatial.neighbour_offsets(
            gkey, 1, n_nbr, radius, H, W)), 20, 5)
    ms = cuda_ms(torch, lambda: spatial.neighbour_gather(
        gpack, n_nbr, radius, offsets=inj), 20)
    print(f"time neighbour_gather (injected offsets): {ms:.4f} ms [{card}]")
    for n, (km, pm) in timings.items():
        print(f"time {n}: {km:.4f} ms kernel, {pm:.4f} ms plain [{card}]")

    # One PyTorch call computing the same function, where there is one
    # (the yardstick; the port never calls it this way).
    attr = scene.geometry.attr_rows
    idx_l = idx.reshape(-1).long()
    rows_i = torch.arange(H, device=dev)[:, None]
    cols_i = torch.arange(W, device=dev)[None, :]
    ny_l = torch.clamp(rows_i + h39[1].long(), 0, H - 1)
    nx_l = torch.clamp(cols_i + h39[2].long(), 0, W - 1)
    l_ct, l_idx, l_rows = scatter_cases["lights"]
    l_src = l_ct.reshape(l_ct.shape[0], -1).t()
    l_flat = l_idx.reshape(-1).long()
    q_flat = (torch.clamp(rows_i + sdy.long(), 0, H - 1) * W
              + torch.clamp(cols_i + sdx.long(), 0, W - 1)).reshape(-1)
    hs_src = halo_ct.movedim(1, 0).reshape(k, -1).contiguous()
    # Kernel 12's: the pack at the clamped coordinates of the same draws.
    g_dy, g_dx = spatial.clamped_offsets(spatial.neighbour_offsets(
        gkey, 1, n_nbr, radius, H, W), H, W)
    g_ny = (rows_i + g_dy.long()).contiguous()
    g_nx = (cols_i + g_dx.long()).contiguous()
    # Kernel 8's product alone: the [5T, 16] constants by the [16, N] ray
    # vectors R = [D, M, p0, 1, 0...] (no sign test), in chunks of rays.
    t_o, t_d, t_tm = tshadow
    tcmat = trace.plucker_matrix(tgeo)
    t_big_d = t_tm[:, None] * t_d
    rvec = torch.cat([t_big_d, torch.linalg.cross(t_o, t_big_d, dim=1), t_o,
                      torch.ones_like(t_tm)[:, None],
                      torch.zeros((t_o.shape[0], 6, H, W), device=dev)],
                     dim=1).transpose(0, 1).reshape(16, -1).contiguous()

    def plucker_product():
        for a in range(0, rvec.shape[1], MATMUL_CHUNK):
            torch.matmul(tcmat, rvec[:, a:a + MATMUL_CHUNK])

    library = {
        "gather_rows": cuda_ms(
            torch, lambda: torch.index_select(attr, 0, idx_l), 20),
        "halo_gather": cuda_ms(torch, lambda: h39[0][:, ny_l, nx_l], 20),
        "scatter_rows_add": cuda_ms(
            torch, lambda: torch.zeros((l_rows, l_ct.shape[0]), device=dev)
            .index_add_(0, l_flat, l_src), 20),
        "halo_scatter": cuda_ms(
            torch, lambda: torch.zeros((k, H * W), device=dev).index_add_(
                1, q_flat, hs_src), 20),
        "neighbour_gather": cuda_ms(
            torch, lambda: gpack[:, g_ny, g_nx], 20),
    }
    for n, ms in library.items():
        print(f"time {n} (one PyTorch call): {ms:.4f} ms [{card}]")
    # No PyTorch call computes kernel 8's function (its library column
    # stays null); the product alone is timed beside it.
    ms = cuda_ms(torch, plucker_product, 3)
    print(f"time any_hit_plucker product only (torch.matmul [5T, 16] x "
          f"[16, N], T={tgeo.tri_cols.shape[1]}, N={rvec.shape[1]}, in "
          f"chunks of {MATMUL_CHUNK} rays, no sign test): {ms:.4f} ms "
          f"[{card}]")
    del rvec, g_ny, g_nx

    # Bounds of the timed calls, from this run's shapes: bytes read once
    # and written once (4 B a plane element), float32 operations.
    hw, n_t = H * W, scene.geometry.tri_cols.shape[1]
    n_off = (2 * radius + 1) ** 2 - 1
    n_up = d1 * (d1 + 1) // 2
    live_lanes = ((res_main.big_w != 0) & ctx.valid[None]).sum().item()
    live_rays = ctx.valid.sum().item() * d1 * k  # at most: every sample
    cnt_f = {}
    trace.any_hit_plain(o, d, tm, scene.geometry, cnt_f)
    shade_live = shade.shadow_occlusion_plain(
        ctx, res_main, scene.geometry, feats,
        lambda o_, d_, tm_, g_: torch.ones(tm_.shape, dtype=torch.bool,
                                           device=dev))
    shade_ops = (cnt_f["tests"][shade_live].sum().item() * MT_OPS
                 + live_lanes * (SHADOW_OPS + PHONG_OPS))
    bytes_f = shade_bytes(torch, fctx, res_main, shade.shadow_occlusion_plain(
        fctx, res_main, scene.geometry, feats), feats.enable_shading)
    pass_ops, pass_raced, pass_bytes = pass_work(
        torch, spatial, ctx, spatial.pack_gates(ctx), key, n_nbr, radius, k,
        feats.enable_shading)
    del cnt_f, shade_live
    bounds = {
        # Kernel 1 on the flagship: rays in, hits out; each ray tests the
        # soup's active triangles (its direct loop skips the padding).
        "closest_hit": bound(hw * 10 * 4 + n_t * 40, hw * int(
            scene.geometry.active.sum().item()) * MT_OPS),
        "gather_rows": bound(hw * 4 * (1 + attr.shape[1]) + attr.numel() * 4,
                             0),
        "ris": bound(hw * 4 * (17 + sk * 4 * k + 10 * k), hw * s
                     * CANDIDATE_OPS),  # on injected uniforms
        # Kernel 4: the bytes this frame's data needs (shade_bytes); the
        # flagship's rays test its 2 triangles up to the first hit.
        "final_shade": bound(bytes_f, shade_ops),
        "any_hit": bound(o.shape[0] * hw * 29, o.shape[0] * hw * n_t
                         * MT_OPS),
        "halo_gather": halo_bound(h39[0], h39[1]),
        # Kernel 5 on this run's Philox stream: the operations and the
        # bytes its data needs (pass_work); the records' traffic is
        # printed apart.
        "spatial_pass": bound(pass_bytes, pass_ops),
        # The race's (R+1)·K and the Z sweep's R·K target PDFs and a unit
        # view a pixel; the planes in and out (the records' traffic is on
        # the sector line below).
        "spatial_pass_unbiased": bound(
            hw * 4 * (20 * k + 18),
            hw * (n_nbr + 1) * (STREAM_OPS + k * LOG_OPS)
            + hw * k * (2 * n_nbr + 1) * PHONG_OPS + hw * VIEW_OPS),
        "scatter_rows_add": scatter_bound(l_ct, l_idx, l_rows),
        "halo_scatter": bound(halo_ct.numel() * 4 + sdy.numel() * 8
                              + k * hw * 4, halo_ct.numel()),
        "ris_replay": bound(hw * 4 * (17 + sk * 5 * k + 7 * k),
                            hw * s * (CANDIDATE_OPS + RACE_OPS)),
        # SIMILAR on Philox: a Philox call for every 4 cells and the key
        # test for every cell; the gates for each cell the filtered race
        # gates, the division for those the products leave to it, a Gumbel
        # score for each cell it scores (counted on this run's stream).
        "neighbour_select": bound(
            hw * 4 * (5 + 2 * n_nbr + 2),
            hw * n_off * (PHILOX_OPS / 4 + KEY_OPS)
            + sel_work["similar"]["gated"] * SEL_GATE_OPS
            + sel_work["similar"]["divided"] * DIV_OPS
            + sel_work["similar"]["scored"] * GUMBEL_OPS),
        "mis_ris": bound(hw * 4 * (17 + it_n * 8 * k),
                         hw * it_n * s * (CANDIDATE_OPS + DRAW_OPS)),
        # One R-OMIS direct iteration: per sample, p-hat and colvec under
        # the D1 techniques, the A and b updates and the scale; the shadow
        # rays of the live samples.
        "mis_iteration": bound(
            hw * 4 * (18 + 8 * k + 2 * n_nbr + 14 * n_nbr + n_up + 3 * d1),
            hw * d1 * k * (d1 * (PHONG_OPS + COLVEC_OPS) + 2 * n_up
                           + 6 * d1 + DIV_OPS)
            + live_rays * (n_t * MT_OPS + SHADOW_OPS)),
    }
    # The BVH kernels: the box and triangle tests of the walk on the same
    # rays and tree (walk_ops); rays in and results out (40 B a primary
    # ray: 6 floats in, t, tri, u, v out; 29 B a shadow ray). The final
    # shade: the walk's tests of its live lanes (those it traces) and each
    # live lane's set-up and Phong; the fields' planes it reads, as kernel
    # 4.
    to_l = lres.pos - lctx.position[None]
    dist_l = torch.linalg.vector_norm(to_l, dim=-3)
    dot_l = (to_l * lctx.normal[None]).sum(dim=-3)
    live_l = ((lres.big_w != 0) & lctx.valid[None] & (dot_l >= 0)
              & (dist_l > 1e-3))
    n_live_l = live_l.sum().item()
    ops21 = (walk_ops(walk_counts["bvh_any_hit_k2"], live_l)
             + n_live_l * (SHADOW_OPS + PHONG_OPS))
    bytes21 = shade_bytes(torch, lctx, lres,
                          walk_counts["bvh_any_hit_k2"]["occluded"],
                          feats.enable_shading)
    bounds.update({
        # Kernels 18 and 19: the fewer of two walks' tests on the same rays
        # and tree, the kernel's own (its model's; the rays it walks again
        # count both walks) or the plain preorder walk's: both give the
        # same answer, and the bound is the least work that gives it.
        "bvh_closest_hit": bound(hw * 40, min(
            walk_ops(walk_counts["bvh_closest_hit"]),
            walk_ops(walk_counts["bvh_closest_plain"]))),
        "bvh_any_hit": bound(hw * 29, min(
            walk_ops(walk_counts["bvh_any_hit"]),
            walk_ops(walk_counts["bvh_any_plain"]))),
        "bvh_any_hit_k": bound((n_nbr + 1) * k * hw * 29, walk_ops(
            walk_counts["bvh_any_hit_k"])),
        "bvh_final_shade": bound(bytes21, ops21),
    })
    # Kernel 7: the tests this run's rays make up to their first hit, an
    # origin set-up for each triangle an origin tests (while any of its K
    # rays is pending), a ray set-up for every ray; origins, targets, mask
    # and output once.
    tests = zc["tests"]
    r1 = n_nbr + 1
    z_bytes = hw * (4 * 3 * (r1 + k) + 2 * r1 * k)
    plain_tests_bound = bound(
        z_bytes, tests.amax(dim=1).sum().item() * MT_ORIGIN_OPS
        + tests.sum().item() * MT_RAY_OPS + tests.numel() * SHADOW_OPS)
    # Kernel 7 culls: its table bound counts the tests the cull needs on
    # the same rays, those of the walk with the box alone deciding (box
    # tests, triangle tests, origin set-ups), each traced ray's set-up and
    # reciprocals, and the soup's columns and boxes read once. The
    # near-parallel guard, which keeps the cull exact, is work of this
    # design and is printed apart.
    z_cols = trace.zcount_blocks(torus1.geometry)[0].shape[1]
    bounds["zcount_occ"] = bound(
        z_bytes + 4 * (10 * z_cols + 6 * z_cols // trace.ZCOUNT_BLOCK),
        zcb["box"].sum().item() * BOX_OPS
        + zcb["tri"].sum().item() * MT_RAY_OPS
        + zcb["origin"].sum().item() * MT_ORIGIN_OPS
        + tests.numel() * SHADOW_OPS
        + traced_t.sum().item() * 3 * (SFU_OPS + 1))  # fast reciprocals
    guard_ops = (zcc["guard"].sum().item() * GUARD_OPS
                 + zcc["guard_cone"].sum().item() * GUARD_CONE_OPS
                 + zcc["guard_tri"].sum().item() * GUARD_TRI_OPS)
    print(f"bound zcount_occ, the plain version's tests (unculled): "
          f"{plain_tests_bound[0]:.4f} ms ({plain_tests_bound[1]}); the "
          f"culled walk's: {bounds['zcount_occ'][0]:.4f} ms "
          f"({bounds['zcount_occ'][1]})")
    print(f"bound zcount_occ, the near-parallel guard alone (not in the "
          f"bound): {guard_ops:.4e} operations, "
          f"{1e3 * guard_ops / FP32_OPS_S:.4f} ms at the float peak")
    # Kernel 17 in each mode at the flagship's shapes (the R-OMIS bound is
    # the table's), and the ext_vis R-OMIS on the torus field (no rays
    # traced; its visibility planes read).
    trace_ops = live_rays * (n_t * MT_OPS + SHADOW_OPS)
    sweep_in = hw * 4 * (18 + 2 * n_nbr)
    sweep_bounds = {
        "romis": bounds["mis_iteration"],
        "romis_prog": bound(
            sweep_in + hw * 4 * (8 * k + 14 * n_nbr + 3 * d1 + n_up + 3 * d1
                                 + 3),
            hw * d1 * k * (d1 * (PHONG_OPS + COLVEC_OPS) + 2 * n_up
                           + 6 * d1 + DIV_OPS + 6 * d1 + DIV_OPS + 12)
            + trace_ops),
        "rmis_equal": bound(sweep_in + hw * 4 * (7 * k + 3),
                            hw * d1 * k * (PHONG_OPS + 8) + trace_ops),
        "rmis_balance": bound(
            sweep_in + hw * 4 * (7 * k + 14 * n_nbr + 3),
            hw * d1 * k * (d1 * PHONG_OPS + d1 + DIV_OPS + 8) + trace_ops),
        "ext_vis romis, torus5x5": bound(
            sweep_in + hw * 4 * (8 * k + 14 * n_nbr + d1 * k + n_up
                                 + 3 * d1),
            hw * d1 * k * (d1 * (PHONG_OPS + COLVEC_OPS) + 2 * n_up
                           + 6 * d1 + DIV_OPS)),
    }
    for label, (k_ms, p_ms) in sweep_ms.items():
        b_ms, b_by = sweep_bounds[label]
        print(f"time mis_iteration[{label}]: {k_ms:.4f} ms kernel, "
              f"{p_ms:.4f} ms plain, bound {b_ms:.4f} ms ({b_by}), "
              f"{k_ms / b_ms:.2f}x the bound [{card}]")
    # Kernel 8: the torus soup's shadow rays' culled bound (above). Kernel
    # 12 on Philox: the C planes read once, R·C written, a Philox call and
    # two uniforms per neighbour.
    bounds["any_hit_plucker"] = plucker_bound
    bounds["neighbour_gather"] = bound(
        hw * 4 * gpack.shape[0] * (1 + n_nbr),
        hw * n_nbr * (PHILOX_OPS + 2 * UNIFORM_OPS))
    for n in ("bvh_closest_hit", "bvh_any_hit", "bvh_any_hit_k",
              "bvh_final_shade", "zcount_occ", "any_hit_plucker",
              "neighbour_gather"):
        print(f"bound {n}: {bounds[n][0]:.4f} ms ({bounds[n][1]})")
    for walk_name, ray_bytes, own_walk in (
            ("bvh_closest_hit", 40, "nearer-first walk"),
            ("bvh_any_hit", 29, "walk on the two-box records")):
        plain = "bvh_closest_plain" if walk_name == "bvh_closest_hit" else \
            "bvh_any_plain"
        cown, cplain = walk_counts[walk_name], walk_counts[plain]
        b_own = bound(hw * ray_bytes, walk_ops(cown))
        b_plain = bound(hw * ray_bytes, walk_ops(cplain))
        print(f"bound {walk_name}: {bounds[walk_name][0]:.4f} ms, the fewer "
              f"tests of two walks: its {own_walk}'s {b_own[0]:.4f} ms (per ray "
              f"{cown['box'].float().mean().item():.2f} box and "
              f"{cown['tri'].float().mean().item():.2f} triangle tests, "
              f"{int(cown['again'].sum().item())} rays walked again in "
              f"preorder), the plain walk's {b_plain[0]:.4f} ms (per ray "
              f"{cplain['box'].float().mean().item():.2f} box and "
              f"{cplain['tri'].float().mean().item():.2f} triangle tests)")
    inject = spatial.spatial_noise(gen, n_nbr, k, radius, H, W)
    for label, (kernel_fn, _) in pass_fns.items():
        ms = cuda_ms(torch, lambda: kernel_fn(inject=inject), 10)
        print(f"time {label} (injected noise): {ms:.4f} ms [{card}]")
    # Kernels 16 and 11 as their earlier designs were bounded: a
    # Gumbel score for every cell; 3R+1 target PDFs a lane, no records.
    old_bounds = {
        "neighbour_select": bound(hw * 4 * (5 + 2 * n_nbr + 2), hw * n_off
                                  * (PHILOX_OPS / 4 + GUMBEL_OPS
                                     + GATE_OPS)),
        "spatial_pass_unbiased": bound(
            hw * 4 * (20 * k + 18), hw * (n_nbr + 1) * (STREAM_OPS + k
                                                         * LOG_OPS)
            + hw * k * (3 * n_nbr + 1) * PHONG_OPS)}
    sw = sel_work["similar"]
    print(f"bound neighbour_select: {bounds['neighbour_select'][0]:.4f} ms "
          f"({bounds['neighbour_select'][1]}; per pixel {n_off} cells' "
          f"Philox and key test, {sw['gated'] / hw:.3f} cells gated, "
          f"{sw['divided'] / hw:.4f} of them divided, {sw['scored'] / hw:.3f} "
          f"scored); before the filter {old_bounds['neighbour_select'][0]:.4f}"
          f" ms")
    # Kernels 4 and 5 as their earlier designs were bounded: kernel 4's
    # 18 + 10K packed planes in and every live lane against every
    # triangle; kernel 5's 10K + 5 + 18 planes in and 10K out, every
    # stream's draw, Gumbel scores, p-hat and logarithm on every pixel.
    old45 = {"final_shade": bound(hw * 4 * (18 + 10 * k + 3), live_lanes
                                  * (n_t * MT_OPS + SHADOW_OPS + PHONG_OPS)),
             "spatial_pass": bound(hw * 4 * (20 * k + 5 + 18), hw * (n_nbr + 1)
                                   * (STREAM_OPS + k * (PHONG_OPS + LOG_OPS)))}
    for n_ in ("final_shade", "spatial_pass"):
        print(f"bound {n_}: {bounds[n_][0]:.4f} ms ({bounds[n_][1]}); as the "
              f"earlier design was counted {old45[n_][0]:.4f} ms "
              f"({old45[n_][1]})")
    # Kernels 4, 21 and 5 with every plane they read counted whole at
    # every pixel (as this design was first bounded), beside the bytes
    # their data needs.
    shade_whole = hw * (4 * (16 + 7 * k + 3) + 1)
    for n_, need, whole, ops_ in (
            ("final_shade", bytes_f, shade_whole, shade_ops),
            ("bvh_final_shade", bytes21, shade_whole, ops21),
            ("spatial_pass", pass_bytes, hw * 4 * (8 * k + 5 + 18 + 10 * k),
             pass_ops)):
        w_ms, w_by = bound(whole, ops_)
        print(f"bound {n_}: the bytes its data needs {need / 1e9:.4f} GB "
              f"({need / hw:.1f} B a pixel, {1e3 * need / HBM_BYTES_S:.4f} "
              f"ms); every plane it reads counted whole {whole / hw:.1f} B "
              f"a pixel, a bound of {w_ms:.4f} ms ({w_by}); the bound used "
              f"{bounds[n_][0]:.4f} ms ({bounds[n_][1]}) [{card}]")
    rec5 = hw * 4 * 2 * (8 * k + spatial.GATE_RECORD)
    print(f"bound spatial_pass: {pass_raced / hw:.3f} (stream, pixel) races "
          f"a pixel of {n_nbr + 1} ({ctx.valid.float().mean().item():.4f} of "
          f"the pixels hit); its records (reservoir {8 * k * 4} B, gate "
          f"{spatial.GATE_RECORD * 4} B a pixel) written and read back once "
          f"{rec5 / 1e9:.3f} GB ({1e3 * rec5 / HBM_BYTES_S:.4f} ms at the "
          f"memory rate); neighbour sectors a pixel {n_nbr * (8 * k + 5)} "
          f"in planes, {n_nbr * (-(-8 * k * 4 // 32) + 1)} in records")
    # Sectors a pixel's neighbour reads touch (32 B each; the offsets are
    # random, so no two lanes of a warp share one): the planes, one a float
    # (8K reservoir floats, the 17 context and K m floats of a neighbour),
    # against the two records (the m it sweeps kept from the race).
    sec_planes = n_nbr * (8 * k + 17 + k)
    sec_records = n_nbr * (-(-8 * k * 4 // 32) + -(-spatial.CTX_RECORD
                                                   * 4 // 32))
    b11, old11 = bounds["spatial_pass_unbiased"], old_bounds[
        "spatial_pass_unbiased"]
    rec_bytes = hw * 4 * 2 * (8 * k + spatial.CTX_RECORD)
    print(f"bound spatial_pass_unbiased: {b11[0]:.4f} ms ({b11[1]}); as "
          f"first counted {old11[0]:.4f} ms; neighbour sectors a pixel "
          f"{sec_planes} in planes ({sec_planes * 32 * hw / 1e9:.2f} GB a "
          f"call), {sec_records} in records ({sec_records * 32 * hw / 1e9:.2f}"
          f" GB); the records written and read back once "
          f"{rec_bytes / 1e9:.3f} GB ({1e3 * rec_bytes / HBM_BYTES_S:.4f} ms "
          f"at the memory rate)")
    # Kernel 9 at every frame shape, beside its bound and launches.
    for label, (pl, dy, dx) in {**halo, **halo_extra}.items():
        if label.startswith(("+-100", "specials", "8 fields")):
            continue
        k_ms, p_ms = ab_ms(torch, lambda: spatial.halo_offset_gather(
            pl, dy, dx), lambda: spatial.halo_offset_gather_plain(
                pl, dy, dx).contiguous(), 20, 2)
        b_ms, b_by = halo_bound(pl, dy)
        print(f"time halo_gather[{label}]: {k_ms:.4f} ms kernel, {p_ms:.4f} "
              f"ms plain, bound {b_ms:.4f} ms ({b_by}), {b_ms / k_ms:.2f} of "
              f"the bound reached, frame launches "
              f"{HALO_FRAME_LAUNCHES.get(label, 0)} [{card}]")
    # Kernels 3 and 14 on Philox, the mode of every frame and step: no
    # uniform planes read, and a Philox4x32-10 call and four uniforms a
    # candidate (the replay a second call for its fifth uniform).
    philox_bounds = {
        "ris": bound(hw * 4 * (17 + 10 * k),
                     hw * s * (CANDIDATE_OPS + DRAW_OPS)),
        "ris_replay": bound(hw * 4 * (17 + 7 * k), hw * s * (
            CANDIDATE_OPS + RACE_OPS + DRAW_OPS + PHILOX_OPS + UNIFORM_OPS)),
    }
    for n_, fn_ in (("ris", ris.gen_canonical_samples_ris),
                    ("ris_replay", ris.gen_canonical_replay)):
        ms = cuda_ms(torch, lambda: fn_(ctx, scene.lights, scene.num_lights,
                                        feats, generator=gen), 10)
        (b_ms, b_by), (u_ms, u_by) = philox_bounds[n_], bounds[n_]
        print(f"time {n_} (philox): {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / ms:.2f} of the bound reached; on injected "
              f"uniforms {timings[n_][0]:.4f} ms, bound {u_ms:.4f} ms "
              f"({u_by}) [{card}]")

    ms = cuda_ms(torch, lambda: nbrsel.neighbour_select(
        sel_gates, n_nbr, radius, True, True, *sel_args, generator=gen,
            key=sel_key), 10)
    print(f"time neighbour_select (two classes, philox): {ms:.4f} ms "
          f"[{card}]")

    section("6: row bands")
    band_phase(torch, dev, card, entries, large)
    section("7: process group")
    group_phase(torch, card)
    section("8: sharded training steps")
    shard = shard_grad_phase(torch, dev, card, entries)
    for n in KERNELS:
        launches[n] += shard["launches"][n]
    band = shard["row"]
    errs["ris_replay_band"] = band["max_abs_err"]
    timings["ris_replay_band"] = (band["ms"], band["plain_ms"])
    bounds["ris_replay_band"] = band["bound"]

    section("kernel table")
    table_rows = [{"name": n, "route": "cuda", "source": SOURCES[n][0],
                   "replaces": SOURCES[n][1], "launches": launches[n],
                   "max_abs_err": errs[n], "ms": timings[n][0],
                   "plain_ms": timings[n][1], "bound_ms": bounds[n][0],
                   "bound_by": bounds[n][1],
                   "library_ms": library.get(n)}
                  for n in KERNELS]
    for r in table_rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']}, launches {r['launches']} [{card}]")
    print(json.dumps({"kernels": table_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def bands_main(mode: str) -> None:
    """``--bands``: the device and the build (sections 1 and 2), then the
    row bands and the process group (sections 6 and 7) alone; ``--group``:
    section 7 alone after them; ``--shard-grad``: section 8 alone after
    them."""
    import torch

    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    from romis_tpu_torch.ops import _build

    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()})")
    print(card)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    _build.build_host()
    _build.host_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    t0 = time.perf_counter()
    if mode == "--shard-grad":
        shard_grad_phase(torch, torch.device("cuda", 0), card,
                         kernel_entries())
        print(f"section 8: {time.perf_counter() - t0:.1f} s")
    else:
        if mode == "--bands":
            band_phase(torch, torch.device("cuda", 0), card,
                       kernel_entries())
        group_phase(torch, card)
        print(f"{'sections 6 and' if mode == '--bands' else 'section'} 7: "
              f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] in (["--bands"], ["--group"], ["--shard-grad"]):
        bands_main(sys.argv[1])
    else:
        main()
