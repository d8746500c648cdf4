"""Kernel 17 (``csrc/mis.cu``, the MIS sweep) in R-OMIS direct mode on a
triangle soup against its roofline: the least time for the cell's shapes
(``rooflines.counts.sweep_romis``: every hit pixel's D+1 by K shadow rays
tested against every triangle) over the kernel's mean device time a
launch, from the profiler's trace, in %."""

from rooflines import counts

NAME, UNIT, LAYER = "sweep_roofline", "%", "kernels"
SOURCE, MOVES = "device_trace", "frame_ms"


def _sweep(name: str) -> bool:
    return "romis::romis_kernel" in name


def read(trace):
    n = trace.kernel_count(_sweep)
    if not n:
        return None
    c = trace.context
    least = counts.bound_s(*counts.sweep_romis(
        c["pixels"], c["neighbours"], c["lanes"], c["triangles"],
        c["hit_pixels"]))
    return 100.0 * least / (trace.kernel_s(_sweep) / n)
