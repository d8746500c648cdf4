#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``romis_tpu_torch``) on one NVIDIA
GPU.

    python3 chip_smoke.py

1. The device: its name, power limit, and the TF32 switches (both off).
2. The build: every kernel under ``romis_tpu_torch/csrc`` compiled with
   nvcc for sm_90a (one process per source, all at once), with its seconds.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes the 1920x1080 frame gives it on the flagship scene (a ground quad
   under 512 area lights): closest hit, final shade and any-hit also on a
   random soup of 2048 triangles; the halo gather on random offsets and on
   the smooth field of a camera shift; the biased and unbiased spatial
   passes on injected noise (exact) and on their own random streams (means
   within 1 %). Then the gradient step's kernels: the row scatter-add into
   the light table, the material table (every index the same row) and the
   soup's packed vertices; the halo scatter at D=5, C=2 on offsets within
   ±10, on the smooth field of a large camera shift (every source beyond
   the kernel's margin) and on offsets clamped at all four borders, each
   with its share of sources beyond the margin; the replay RIS on
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
   hit (kernel 18), the any-hit with one walk per ray (19) on the frame's
   shadow rays with 1 and with 17 planes, the K-ray any-hit (20, a walk per
   ray with a pixel's S rays side by side) with S = 2 (the shadow rays of
   the K lanes), 4 and 16 (sky rays) and 12 (the ext_vis rays of one MIS
   iteration; also against kernel 19 on the same rays), the plain bool on
   every ray, the BVH final shade (21), the sweep's ext_vis mode in
   its four modes; and a cross-check with no plain version in it: the
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
   tolerances above.
   Then slice 7's two kernels, which the reference reaches on no frame
   path, through their op-level entries: kernel 8 (the Plücker any-hit,
   ``ops.trace.any_hit_plucker``) against its plain version, the same bool
   on every ray, and against kernel 6 (Möller–Trumbore) on the same rays,
   at most PLUCKER_MT_SHARE of the hit pixels' rays apart (and of all
   rays but on the flagship, whose missed pixels' rays end on the ground):
   the K = 2 shadow rays of the
   flagship's 1080p frame, of the one-torus soup's 1080p frame (970
   triangles, TORUS_CAM) and of the 2048-triangle soup at 480x270; kernel
   12 (the neighbour gather, ``ops.spatial.neighbour_gather``) on config
   5's pack (C = 10K + 19 = 39 planes: a coordinate plane, the reservoirs,
   the 18 context planes; R = 5, r = 10) at 1080p, bit-exact on injected
   offsets, and on its Philox stream: every offset in the clamped window,
   every plane at the offset the coordinate plane records (the plain
   version at the recovered offsets bit-exact), the offsets equal to the
   plain Philox draw's (``neighbour_offsets``), each of the 2r + 1 values
   of dy and of dx within NBR_SHARE_REL of 1/(2r + 1) over the interior
   pixels, and dx not shared down columns (as the TPU kernel shares it).
4. Twenty-three main paths, each at 1920x1080, once through the kernels and
   once through the plain versions, with the launch counters set to 0 just
   before and read just after the kernels' run:
   - slice 1: ``Features(spatial_reuse=False)``, 2 frames;
   - config 5: ``Features()`` (the reference defaults of bench.py config 5:
     S=32, K=2, temporal reuse, 2 biased spatial passes of 5 neighbours in
     radius 10), 4 frames;
   - the animated path: a camera turning about 4 pixels per frame, with
     temporal reprojection, the unbiased combine and the initial visibility
     check, 4 frames (``render_animation``).
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
   ``torch.profiler`` over 3 R-OMIS frames, the 4 animated frames, a
   large config-5 frame, a large R-OMIS frame and the three vis-check
   paths (device busy and idle
   share, kernels per frame, the top kernels by device time). Kernel 17 is
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
   Kernel 8 is timed beside kernel 6 on the torus soup's 1080p shadow rays
   (its bound: the triangle tests this run's rays make up to their first
   occluder, PLUCKER_OPS each, the table built inside the timed call as
   the entry builds it), with ``torch.matmul`` of the [5T, 16]
   constants by the [16, N] rays as the library column, labelled "product
   only" (it computes no sign test); kernel 12 on its Philox stream, with
   one advanced-indexing gather at the clamped coordinates as the library
   call.

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
TRACE_T_RTOL = 1e-5  # multiply-add order may differ
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
           "any_hit_plucker", "neighbour_gather")
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
FRAMES = {"slice1": 2, "config5": 4, "animated": 4, "grad_surrogate": 2,
          "grad_per_pixel": 2, "romis": 2, "romis_progressive": 2,
          "rmis_equal": 2, "rmis_balance": 2, "large_config5": 2,
          "large_animated": 2, "large_k1": 2, "large_romis": 2,
          "large_rmis_equal": 2, "config5_gather": 2, "unshaded": 2,
          "vischeck": 2, "vischeck_torus": 2, "large_vischeck": 2, "cli": 4,
          "large_grad": 2, "plucker_op": 2, "neighbour_gather_op": 2}
GRAD_PATHS = ("grad_surrogate", "grad_per_pixel", "large_grad")
OP_PATHS = ("plucker_op", "neighbour_gather_op")
MIS_PATHS = ("romis", "romis_progressive", "rmis_equal", "rmis_balance",
             "large_romis", "large_rmis_equal")
# ReSTIR paths whose plain run is at LH x LW on injected noise.
SMALL_PLAIN = ("vischeck_torus", "large_vischeck")


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


def main() -> None:
    import numpy as np
    import torch

    # ---- 1. the device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    from romis_tpu_torch import (
        Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
    )
    from romis_tpu_torch.core.camera import (
        generate_rays, make_camera, project_to_pixel,
    )
    from romis_tpu_torch.core.types import (
        pack_reservoir_planes, unpack_reservoir_planes,
    )
    from romis_tpu_torch.diff.grad import (
        extract_params, make_grad_fn, render_with_params,
    )
    from romis_tpu_torch.ops import (
        _build, mis, nbrsel, rows, ris, scatter, shade, spatial, trace, walk,
    )
    from romis_tpu_torch.ops.bvh import with_bvh
    from romis_tpu_torch.ops.traverse import bvh_any, bvh_closest
    from romis_tpu_torch.ops.wrs import (
        gen_canonical_replay_plain, gen_canonical_samples_plain, gumbel_noise,
        replay_uniforms, visibility, visibility_from,
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

    wrappers = {"closest_hit": trace.closest_hit,
                "gather_rows": rows.gather_rows,
                "ris": ris.gen_canonical_samples_ris,
                "final_shade": shade.final_shade_fused,
                "spatial_pass": spatial.spatial_pass_fused,
                "spatial_pass_unbiased": spatial.spatial_pass_unbiased_fused,
                "halo_gather": spatial.halo_offset_gather,
                "any_hit": trace.any_hit,
                "scatter_rows_add": scatter.scatter_rows_add,
                "halo_scatter": spatial.halo_offset_scatter,
                "ris_replay": ris.gen_canonical_replay,
                "neighbour_select": nbrsel.neighbour_select,
                "mis_ris": ris.gen_mis_reservoir_planes,
                "mis_iteration": mis.mis_iteration,
                "bvh_closest_hit": walk.closest_hit_bvh,
                "bvh_any_hit": walk.any_hit_bvh,
                "bvh_any_hit_k": walk.any_hit_bvh_k,
                "bvh_final_shade": shade.final_shade_bvh,
                "zcount_occ": trace.zcount_occ,
                "any_hit_plucker": trace.any_hit_plucker,
                "neighbour_gather": spatial.neighbour_gather}

    # ---- 3. each kernel against its plain version ----
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
        t_k, tri_k, u_k, v_k = trace.closest_hit(r, geometry)
        t_p, tri_p, u_p, v_p = trace.closest_hit_plain(r, geometry)
        torch.cuda.synchronize()
        same = tri_k == tri_p
        agree = same.float().mean().item()
        both = same & torch.isfinite(t_p)
        require(torch.equal(torch.isinf(t_k[same]), torch.isinf(t_p[same])),
                f"closest hit {label}: miss flags differ")
        err = (t_k[both] - t_p[both]).abs()
        rel = (err / t_p[both].abs()).max().item() if both.any() else 0.0
        print(f"check closest_hit[{label}]: tri agree {agree:.6f}, "
              f"hits {both.float().mean().item():.4f}, t max rel err {rel:.2e}")
        require(agree >= MIN_AGREE, f"closest hit {label}: tri agree {agree}")
        require(rel <= TRACE_T_RTOL, f"closest hit {label}: t rel err {rel}")
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

    errs["final_shade"] = max(
        check_shade(ctx, res_main, scene.geometry, "flagship"),
        check_shade(soup_ctx, res_soup, soup, "soup2048"))

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
        require(same >= MIN_AGREE, f"any-hit {label}: agree {same}")
        return 1.0 - same

    errs["any_hit"] = max(check_any(ctx, res_main, scene.geometry, "flagship"),
                          check_any(soup_ctx, res_soup, soup, "soup2048"))

    # Halo gather: the reprojection planes [10K+5, H, W] at D=1.
    rr = feats.reprojection_radius
    halo_planes = torch.cat([pack_reservoir_planes(res_main),
                             spatial.pack_gates(ctx)])
    rand_dy = torch.randint(-rr, rr + 1, (1, H, W), generator=gen, device=dev,
                            dtype=torch.int32)
    rand_dx = torch.randint(-rr, rr + 1, (1, H, W), generator=gen, device=dev,
                            dtype=torch.int32)
    cam_pan = make_camera(look_at=(2.57, 1.23, -1.35),
                          rotation_deg=(10.3 + PAN_DEG, 30.0 + PAN_DEG, 0.0),
                          distance=25.0, fov_deg=30.0, resolution=(H, W),
                          device=dev)
    rows_f, cols_f, _ = project_to_pixel(cam_pan, ctx.position, H, W)
    smooth_dy = (torch.round(rows_f).clamp(0, H - 1).int() - torch.arange(
        H, dtype=torch.int32, device=dev)[:, None]).clamp(-rr, rr)[None]
    smooth_dx = (torch.round(cols_f).clamp(0, W - 1).int() - torch.arange(
        W, dtype=torch.int32, device=dev)[None, :]).clamp(-rr, rr)[None]
    for label, dy, dx in (("random", rand_dy, rand_dx),
                          ("camera-shift", smooth_dy, smooth_dx)):
        g_k = spatial.halo_offset_gather(halo_planes, dy, dx)
        g_p = spatial.halo_offset_gather_plain(halo_planes, dy, dx)
        torch.cuda.synchronize()
        exact = torch.equal(g_k, g_p)
        print(f"check halo_gather[{label}]: planes {halo_planes.shape[0]}, "
              f"mean |dy| {dy.abs().float().mean().item():.3f}, bit-exact "
              f"{exact}")
        require(exact, f"halo gather {label} is not bit-exact")
    errs["halo_gather"] = 0.0

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

    # The gradient step's kernels. Row scatter-add: the light table
    # (4 M lane indices over 512 rows), the material table (every pixel on
    # its one row: the contention case) and the packed v0|e1|e2 of the
    # 2048-triangle soup at its closest-hit triangles.
    def check_scatter(label, ct, idx, n_rows):
        o_k = scatter.scatter_rows_add(ct, idx, n_rows)
        o_p = scatter.scatter_rows_add_plain(ct, idx, n_rows)
        o_64 = torch.zeros((n_rows, ct.shape[0]), dtype=torch.float64,
                           device=dev).index_add_(
            0, idx.reshape(-1).long().clamp(0, n_rows - 1),
            ct.reshape(ct.shape[0], -1).t().double())
        mag = scatter.scatter_rows_add_plain(ct.abs(), idx,
                                             n_rows).double().clamp_min(1e-30)
        torch.cuda.synchronize()
        rel = ((o_k - o_p).abs() / mag).max().item()
        rel64 = ((o_k.double() - o_64).abs() / mag).max().item()
        rel_p64 = ((o_p.double() - o_64).abs() / mag).max().item()
        print(f"check scatter_rows_add[{label}]: rows {n_rows}, indices "
              f"{idx.numel()}, max err / sum|ct| vs plain {rel:.2e}, vs "
              f"float64 {rel64:.2e} (plain vs float64 {rel_p64:.2e})")
        require(rel <= SCATTER_REL, f"scatter {label}: vs plain {rel}")
        require(rel64 <= SCATTER_F64_REL, f"scatter {label}: vs f64 {rel64}")
        return (o_k - o_p).abs().max().item()

    light_idx = torch.randint(0, scene.num_lights, (k, H, W), generator=gen,
                              device=dev, dtype=torch.int32)
    light_ct = torch.randn((24, k, H, W), generator=gen, device=dev)
    soup_tri = torch.clamp_min(trace.closest_hit_plain(rays, soup)[1], 0)
    scatter_cases = {
        "lights": (light_ct, light_idx, scene.num_lights),
        "material": (torch.randn((8, H, W), generator=gen, device=dev),
                     torch.zeros((H, W), dtype=torch.int32, device=dev), 1),
        "soup2048": (torch.randn((9, H, W), generator=gen, device=dev),
                     soup_tri, SOUP_TRIS),
    }
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
    for label, (hdy, hdx) in {
            f"±{radius}": (sdy, sdx), "camera shift (37, -53)": (shift_dy,
                                                                 shift_dx),
            "±5000, clamped at the borders": (border_dy, border_dx)}.items():
        hs_k = spatial.halo_offset_scatter(halo_ct, hdy, hdx)
        hs_p = spatial.halo_offset_scatter_plain(halo_ct, hdy, hdx)
        hs_mag = spatial.halo_offset_scatter_plain(halo_ct.abs(), hdy,
                                                   hdx).clamp_min(1e-30)
        torch.cuda.synchronize()
        hs_rel = ((hs_k - hs_p).abs() / hs_mag).max().item()
        far = spatial.beyond_margin(hdy, hdx).float().mean().item()
        print(f"check halo_scatter[{label}]: D={n_nbr}, C={k}, max err / "
              f"sum|ct| {hs_rel:.2e}, sources beyond the margin "
              f"{far:.4f}")
        require(hs_rel <= HALO_SCATTER_REL, f"halo scatter {label}: "
                f"{hs_rel}")
        errs["halo_scatter"] = max(errs["halo_scatter"],
                                   (hs_k - hs_p).abs().max().item())
    del hs_k, hs_p, hs_mag, shift_dy, shift_dx, border_dy, border_dx

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
    walk_counts["bvh_closest_hit"] = {}
    bvh_closest(lrays, lgeo, lgeo.bvh, counts=walk_counts["bvh_closest_hit"])
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
        return 1.0 - same, cnt

    lshadow = vis_rays(lctx.position, lres.pos)  # the K = 2 lanes
    one = tuple(a[:1] for a in lshadow)
    errs["bvh_any_hit"], walk_counts["bvh_any_hit"] = check_walk_any(
        "bvh_any_hit[torus5x5, 1 plane]", walk.any_hit_bvh, one)
    # 17 planes: the frame's receivers to 17 points of the sky light.
    sky = large.lights.rows[0]
    uv = torch.rand((2, SKY_PLANES, 1, H, W), generator=gen, device=dev)
    sky_pts = (sky[0:3, None, None] + uv[0] * sky[3:6, None, None]
               + uv[1] * sky[6:9, None, None])
    sky_rays = vis_rays(lctx.position, sky_pts)
    err17, _ = check_walk_any(f"bvh_any_hit[torus5x5, {SKY_PLANES} planes]",
                              walk.any_hit_bvh, sky_rays)
    errs["bvh_any_hit"] = max(errs["bvh_any_hit"], err17)
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
    errs["final_shade"] = max(errs["final_shade"], check_shade(
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
    _, tctx = restir.trace_primary(generate_rays(tcam, H, W),
                                   torus1.geometry, feats, restir.KERNELS)
    tshadow = shadow_rays(tctx, ris.gen_canonical_samples_ris(
        tctx, torus1.lights, torus1.num_lights, feats, generator=gen))
    sshadow = shadow_rays(soup_ctx_s, gen_canonical_samples_plain(
        soup_ctx_s, scene.lights, scene.num_lights, feats, generator=gen))

    def check_plucker(label, c, rays_, geometry, all_rays):
        """Kernel 8 against its plain version (the same bool on every ray)
        and against kernel 6 on the rays of the pixels that hit and, with
        ``all_rays``, on every ray (on the flagship a missed pixel's ray
        runs from the camera to the light sample's default, a point on the
        ground plane: it ends on a triangle, where the two tests round
        either way) → the plain version's triangle tests."""
        cnt = {}
        occ_k = trace.any_hit_plucker(*rays_, geometry)
        occ_p = trace.any_hit_plucker_plain(*rays_, geometry, counts=cnt)
        occ_6 = trace.any_hit(*rays_, geometry)
        torch.cuda.synchronize()
        exact = torch.equal(occ_k, occ_p)
        valid = c.valid.expand(occ_k.shape)
        apart = (occ_k != occ_6)[valid].float().mean().item()
        apart_all = (occ_k != occ_6).float().mean().item()
        print(f"check any_hit_plucker[{label}]: rays {occ_k.numel()}, "
              f"triangles {geometry.tri_cols.shape[1]}, occluded "
              f"{occ_p.float().mean().item():.4f}, the same bool on every "
              f"ray {exact}; vs kernel 6 (Moller-Trumbore) {apart:.2e} of "
              f"the hit pixels' {valid.sum().item()} rays apart "
              f"({(occ_k != occ_6)[valid].sum().item()}; "
              f"{(occ_k != occ_6).sum().item()} of all rays); triangle "
              f"tests per ray {cnt['tests'].float().mean().item():.1f}")
        require(exact, f"any_hit_plucker {label}: kernel 8 and its plain "
                f"version differ on {(occ_k != occ_p).sum().item()} rays")
        require(apart <= PLUCKER_MT_SHARE,
                f"any_hit_plucker {label}: {apart} of the hit pixels' rays "
                f"apart from kernel 6")
        require(not all_rays or apart_all <= PLUCKER_MT_SHARE,
                f"any_hit_plucker {label}: {apart_all} of all rays apart "
                f"from kernel 6")
        return cnt

    check_plucker("flagship 1080p", ctx, shadow_rays(ctx, res_main),
                  scene.geometry, False)
    plucker_counts = check_plucker("torus soup 1080p", tctx, tshadow,
                                   torus1.geometry, True)
    check_plucker("soup2048 480x270", soup_ctx_s, sshadow, soup, True)
    errs["any_hit_plucker"] = 0.0  # the checks above require the same bools
    del sshadow

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
    })
    cam_path = interpolate_cameras(
        cam, make_camera(look_at=(2.57, 1.23, -1.35),
                         rotation_deg=(10.3, 30.0 + PAN_DEG
                                       * (FRAMES["animated"] - 1), 0.0),
                         distance=25.0, fov_deg=30.0, resolution=(H, W),
                         device=dev), FRAMES["animated"])
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
        return scene, cam, cam_path

    def small_cam(path, h_, w_):
        """A path's camera at h_ x w_ (the plain comparison's size)."""
        if path == "vischeck_torus":
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
        if path.endswith("animated"):
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
        for fn in wrappers.values():
            fn.launches = 0
        outs = [op_calls[path](i) for i in range(FRAMES[path])]
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in wrappers.items()}
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
        if (path in GRAD_PATHS or path in MIS_PATHS or path in OP_PATHS
                or path == "cli"):
            continue
        for fn in wrappers.values():
            fn.launches = 0
        img_k, state_k = run_path(path, restir.KERNELS, 0)
        got = {n: fn.launches for n, fn in wrappers.items()}
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

    for fn in wrappers.values():
        fn.launches = 0
    img_a, t_a = run_cli(cdir / "a", FRAMES["cli"], cdir / "ck_a")
    got = {n: fn.launches for n, fn in wrappers.items()}
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
    for path in GRAD_PATHS:
        f, sc, c, p, prev, target, noise = grad_setup(path)
        fn_k = grad_fn(path, sc, (H, W))
        for fn in wrappers.values():
            fn.launches = 0
        loss_k, g_k = fn_k(p, target, None, c, prev, noise)
        loss_k2, g_k2 = fn_k(p, target,
                             torch.Generator(device=dev).manual_seed(12),
                             c, prev)
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in wrappers.items()}
        hw = (H, W)
        if path == "large_grad":
            # The plain step at 480x270 (the plain traversal walks the
            # tree in lockstep), against the kernels' on the same noise.
            hw = (LH, LW)
            f, sc, c, p, prev, target, noise = grad_setup(path, hw)
            loss_k, g_k = grad_fn(path, sc, hw)(p, target, None, c, prev,
                                                noise)
        loss_p, g_p = grad_fn(path, sc, hw, restir.PLAIN)(
            p, target, None, c, prev, noise)
        torch.cuda.synchronize()
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
        del g_k, g_k2, g_p, prev, target, noise

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
        for fn in wrappers.values():
            fn.launches = 0
        img_k, st = render_frame(None, c, sc, H, W, f, noise=mis_noise)
        img_k2, _ = render_frame(torch.Generator(device=dev).manual_seed(0),
                                 c, sc, H, W, f)
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in wrappers.items()}
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
                if path.endswith("animated") else c0
            _, st = render_frame(g, c, sc, *hw, f, st, ops=ops)
            i += 1
        return run

    for path in PATHS:
        if path in GRAD_PATHS or path in OP_PATHS or path == "cli":
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

    # Where a frame's time goes: torch.profiler over a few frames.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_frames(path, n):
        run = one_frame(path, restir.KERNELS)
        run()
        torch.cuda.synchronize()
        ev_a = torch.cuda.Event(enable_timing=True)
        ev_b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
        print(f"profile frame[{path}]: span {span:.3f} ms/frame, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / span:.3f}, "
              f"{sum(r[2] for r in dev_rows):.0f} device kernels/frame "
              f"[{card}]" if busy
              else f"profile frame[{path}]: no device time recorded")
        for key_, ms_, n_ in dev_rows[:8]:
            print(f"profile frame[{path}]: {ms_:.3f} ms in {n_:.0f} x "
                  f"{key_[:70]}")

    profile_frames("romis", 3)
    profile_frames("animated", FRAMES["animated"])
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

    uni = torch.rand((sk, 4, k, H, W), generator=gen, device=dev)
    o, d, tm = shadow_rays(ctx, res_main)
    key = spatial.philox_key(gen)
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
        "final_shade": ab_ms(
            torch, lambda: shade.final_shade_fused(ctx, res_main,
                                                   scene.geometry, feats),
            lambda: shade.final_shade_plain(ctx, res_main, scene.geometry,
                                            feats), 20, 5),
        "any_hit": ab_ms(
            torch, lambda: trace.any_hit(o, d, tm, scene.geometry),
            lambda: trace.any_hit_plain(o, d, tm, scene.geometry), 20, 5),
        "halo_gather": ab_ms(
            torch, lambda: spatial.halo_offset_gather(halo_planes, smooth_dy,
                                                      smooth_dx),
            lambda: spatial.halo_offset_gather_plain(
                halo_planes, smooth_dy, smooth_dx).contiguous(), 20, 5),
    }
    for label, (kernel_fn, plain_fn) in pass_fns.items():
        timings[label] = ab_ms(torch, lambda: kernel_fn(generator=gen,
                                                        key=key),
                               lambda: plain_fn(generator=gen), 10, 3)
    for label, (ct, idx_s, n_rows) in scatter_cases.items():
        ms = ab_ms(torch, lambda: scatter.scatter_rows_add(ct, idx_s, n_rows),
                   lambda: scatter.scatter_rows_add_plain(ct, idx_s, n_rows),
                   20, 5)
        print(f"time scatter_rows_add[{label}]: {ms[0]:.4f} ms kernel, "
              f"{ms[1]:.4f} ms plain [{card}]")
        if label == "lights":
            timings["scatter_rows_add"] = ms
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
    # Kernel 8 on the torus soup's 1080p shadow rays, beside its plain
    # version and beside kernel 6 on the same rays (and on the flagship's).
    tgeo = torus1.geometry
    timings["any_hit_plucker"] = ab_ms(
        torch, lambda: trace.any_hit_plucker(*tshadow, tgeo),
        lambda: trace.any_hit_plucker_plain(*tshadow, tgeo), 10, 1)
    for label, rays_, geo_ in (
            ("torus soup 1080p, 970 triangles", tshadow, tgeo),
            ("flagship 1080p, 2 triangles", (o, d, tm), scene.geometry)):
        m8, m6 = ab_ms(torch, lambda: trace.any_hit_plucker(*rays_, geo_),
                       lambda: trace.any_hit(*rays_, geo_), 10, 10)
        print(f"time any_hit_plucker vs any_hit (kernel 8 vs kernel 6, the "
              f"same rays; {label}): {m8:.4f} ms vs {m6:.4f} ms, ratio "
              f"{m8 / m6:.2f} [{card}]")
        ms = cuda_ms(torch, lambda: trace.plucker_matrix(geo_), 10)
        print(f"time plucker_matrix (the table any_hit_plucker builds in "
              f"each call; {label}): {ms:.4f} ms [{card}]")
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
    ny_l = torch.clamp(rows_i + smooth_dy.long(), 0, H - 1)
    nx_l = torch.clamp(cols_i + smooth_dx.long(), 0, W - 1)
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
        "halo_gather": cuda_ms(
            torch, lambda: halo_planes[:, ny_l, nx_l], 20),
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
    bounds = {
        "closest_hit": bound(hw * 10 * 4 + n_t * 40, hw * n_t * MT_OPS),
        "gather_rows": bound(hw * 4 * (1 + attr.shape[1]) + attr.numel() * 4,
                             0),
        "ris": bound(hw * 4 * (17 + sk * 4 * k + 10 * k), hw * s
                     * CANDIDATE_OPS),  # on injected uniforms
        "final_shade": bound(hw * 4 * (18 + 10 * k + 3),
                             live_lanes * (n_t * MT_OPS + SHADOW_OPS
                                           + PHONG_OPS)),
        "any_hit": bound(o.shape[0] * hw * 29, o.shape[0] * hw * n_t
                         * MT_OPS),
        "halo_gather": bound(hw * 4 * (2 * halo_planes.shape[0] + 2), 0),
        "spatial_pass": bound(hw * 4 * (20 * k + 5 + 18), hw * (n_nbr + 1)
                              * (STREAM_OPS + k * (PHONG_OPS + LOG_OPS))),
        # The race's (R+1)·K and the Z sweep's R·K target PDFs and a unit
        # view a pixel; the planes in and out (the records' traffic is on
        # the sector line below).
        "spatial_pass_unbiased": bound(
            hw * 4 * (20 * k + 18),
            hw * (n_nbr + 1) * (STREAM_OPS + k * LOG_OPS)
            + hw * k * (2 * n_nbr + 1) * PHONG_OPS + hw * VIEW_OPS),
        "scatter_rows_add": bound(l_ct.numel() * 4 + l_idx.numel() * 4
                                  + l_rows * l_ct.shape[0] * 4, l_ct.numel()),
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
    # The BVH kernels: the box and triangle tests the plain traversal made
    # on the same rays and tree, BOX_OPS and MT_OPS each, and each ray's
    # three reciprocals; rays in and results out (40 B a primary ray:
    # 6 floats in, t, tri, u, v out; 29 B a shadow ray). The final shade:
    # the walk's tests of its live lanes (those it traces) and each live
    # lane's set-up and Phong.
    def walk_ops(cnt, mask=None):
        box, tri = cnt["box"], cnt["tri"]
        if mask is not None:
            box, tri = box[mask], tri[mask]
        return (box.sum().item() * BOX_OPS + tri.sum().item() * MT_OPS
                + box.numel() * 3 * DIV_OPS)

    to_l = lres.pos - lctx.position[None]
    dist_l = torch.linalg.vector_norm(to_l, dim=-3)
    dot_l = (to_l * lctx.normal[None]).sum(dim=-3)
    live_l = ((lres.big_w != 0) & lctx.valid[None] & (dot_l >= 0)
              & (dist_l > 1e-3))
    n_live_l = live_l.sum().item()
    bounds.update({
        "bvh_closest_hit": bound(hw * 40, walk_ops(
            walk_counts["bvh_closest_hit"])),
        "bvh_any_hit": bound(hw * 29, walk_ops(walk_counts["bvh_any_hit"])),
        "bvh_any_hit_k": bound((n_nbr + 1) * k * hw * 29, walk_ops(
            walk_counts["bvh_any_hit_k"])),
        "bvh_final_shade": bound(
            hw * 4 * (18 + 10 * k + 3),
            walk_ops(walk_counts["bvh_any_hit_k2"], live_l)
            + n_live_l * (SHADOW_OPS + PHONG_OPS)),
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
    # Kernel 8: the tests the torus soup's shadow rays make up to their
    # first occluder (its plain version counts them), a set-up per ray;
    # 7 floats in and a byte out per ray, the triangles' v0, e1, e2 and
    # active flag once. Kernel 12 on
    # Philox: the C planes read once, R·C written, a Philox call and two
    # uniforms per neighbour.
    tests8 = plucker_counts["tests"]
    bounds["any_hit_plucker"] = bound(
        tests8.numel() * 29 + tgeo.v0.shape[0] * (3 * 3 * 4 + 1),
        tests8.sum().item() * PLUCKER_OPS + tests8.numel() * PLUCKER_RAY_OPS)
    bounds["neighbour_gather"] = bound(
        hw * 4 * gpack.shape[0] * (1 + n_nbr),
        hw * n_nbr * (PHILOX_OPS + 2 * UNIFORM_OPS))
    for n in ("bvh_closest_hit", "bvh_any_hit", "bvh_any_hit_k",
              "bvh_final_shade", "zcount_occ", "any_hit_plucker",
              "neighbour_gather"):
        print(f"bound {n}: {bounds[n][0]:.4f} ms ({bounds[n][1]})")
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
    ms = cuda_ms(torch, lambda: spatial.halo_offset_gather(
        halo_planes, rand_dy, rand_dx), 20)
    print(f"time halo_gather (random offsets): {ms:.4f} ms [{card}]")
    ms = cuda_ms(torch, lambda: ris.gen_canonical_samples_ris(
        ctx, scene.lights, scene.num_lights, feats, generator=gen), 10)
    print(f"time ris (philox): {ms:.4f} ms [{card}]")
    ms = cuda_ms(torch, lambda: ris.gen_canonical_replay(
        ctx, scene.lights, scene.num_lights, feats, generator=gen), 10)
    print(f"time ris_replay (philox): {ms:.4f} ms [{card}]")

    ms = cuda_ms(torch, lambda: nbrsel.neighbour_select(
        sel_gates, n_nbr, radius, True, True, *sel_args, generator=gen,
            key=sel_key), 10)
    print(f"time neighbour_select (two classes, philox): {ms:.4f} ms "
          f"[{card}]")

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
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
