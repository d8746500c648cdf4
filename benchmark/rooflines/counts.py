"""Operations and bytes of the port's kernels, counted from their shapes.

A frozen copy of the arithmetic the port's chip check (``chip_smoke.py``)
holds its kernels to, so a later change to a kernel cannot move its own
yardstick. A bound is the larger of the bytes the kernel must move once
over HBM3 and its operations over the float32 peak outside the tensor
cores (NVIDIA H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s at 700 W). That
peak counts an FMA as 2 operations on the 128 float lanes of an SM each
clock and a float add, multiply or compare as 1. Other instructions are
counted at their throughput in the same currency: the special-function
unit (rcp, rsqrt, lg2, ex2, int-float conversion) has 16 lanes an SM, 1/8
of the FMA rate, so 16 each; the 32-bit integer pipe 64 lanes, so 4 each.
The libdevice sequences (no fast math) are estimates from their
instructions.
"""

from __future__ import annotations

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
MT_OPS = 40 + DIV_OPS  # one Moller-Trumbore ray-triangle test
PHONG_OPS = 70 + 3 * SQRT_OPS + 3 * DIV_OPS + POW_OPS  # Phong, p-hat norm
CANDIDATE_OPS = 60 + SFU_OPS + PHONG_OPS + LOG_OPS + DIV_OPS  # one RIS
#   candidate: light pick, point, colour, p-hat, exponential race
COLVEC_OPS = 10 + 2 * DIV_OPS  # one technique's mock weight, reciprocal
SHADOW_OPS = 20 + SQRT_OPS + 3 * DIV_OPS  # one shadow ray's set-up


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take."""
    return max(n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S)


def ris_philox(hw: int, s: int, k: int):
    """Kernel 3 (``csrc/ris.cu``, canonical RIS) on its Philox stream →
    (bytes, operations): 17 context planes in, 10K reservoir planes out; a
    candidate's work and one Philox call with its four uniforms."""
    return hw * 4 * (17 + 10 * k), hw * s * (CANDIDATE_OPS + DRAW_OPS)


def _romis_sample_ops(d1: int, n_up: int) -> int:
    """One sample of an R-OMIS iteration: p-hat and colvec under the D+1
    techniques, the A and b updates and the scale."""
    return d1 * (PHONG_OPS + COLVEC_OPS) + 2 * n_up + 6 * d1 + DIV_OPS


def sweep_romis(hw: int, d: int, k: int, tri_slots: int = 0,
                hit_pixels: int = 0, ext_vis: bool = False):
    """Kernel 17 (``csrc/mis.cu``) in one R-OMIS direct iteration →
    (bytes, operations). On a soup (``ext_vis`` False) it traces the
    shadow rays of the hit pixels' samples against the soup's
    ``tri_slots``; with ``ext_vis`` it reads their visibility planes."""
    d1 = d + 1
    n_up = d1 * (d1 + 1) // 2
    ops = hw * d1 * k * _romis_sample_ops(d1, n_up)
    if ext_vis:
        n_bytes = hw * 4 * (18 + 2 * d) + hw * 4 * (
            8 * k + 14 * d + d1 * k + n_up + 3 * d1)
        return n_bytes, ops
    live_rays = hit_pixels * d1 * k  # at most: every sample of a hit pixel
    n_bytes = hw * 4 * (18 + 8 * k + 2 * d + 14 * d + n_up + 3 * d1)
    return n_bytes, ops + live_rays * (tri_slots * MT_OPS + SHADOW_OPS)
