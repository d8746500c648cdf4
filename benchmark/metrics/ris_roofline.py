"""Kernel 3 (``csrc/ris.cu``, the canonical RIS) against its roofline: the
least time for the cell's shapes on its Philox stream
(``rooflines.counts.ris_philox``) over the kernel's mean device time a
launch, from the profiler's trace, in %."""

from rooflines import counts

NAME, UNIT, LAYER = "ris_roofline", "%", "kernels"
SOURCE, MOVES = "device_trace", "frame_ms"


def _ris(name: str) -> bool:
    return "romis::ris_kernel" in name


def read(trace):
    n = trace.kernel_count(_ris)
    if not n:
        return None
    c = trace.context
    least = counts.bound_s(*counts.ris_philox(c["pixels"], c["candidates"],
                                              c["lanes"]))
    return 100.0 * least / (trace.kernel_s(_ris) / n)
