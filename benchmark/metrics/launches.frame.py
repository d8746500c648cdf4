"""Device kernels launched a frame (copies and sets not counted): the
profiler's kernel count over the traced frames. The render layer issues
them; each costs the host a launch."""

from harness.trace import is_kernel

NAME, UNIT, LAYER = "launches.frame", "launches/frame", "render"
SOURCE, MOVES = "device_trace", "frame_ms"


def read(trace):
    n = trace.kernel_count(is_kernel)
    return n / trace.units if n else None
