"""Milliseconds a frame that R-OMIS's α solves span on the device's
timeline: the extents of the spans ``romis.alpha_solve`` by their CUDA
event pairs, over the traced frames. An extent holds the solve's kernels
and any idle between them (the device waiting for the host's enqueue);
it is not the kernels' busy time."""

from harness import spans

NAME, UNIT, LAYER = "alpha_solve_ms.frame", "ms/frame", "render"
SOURCE, MOVES = "program_span", "frame_ms"


def read(trace):
    got = spans.frames(trace)
    if got is None:
        return None
    recs, n = got
    ms = spans.device_ms(recs, "romis.alpha_solve")
    return None if ms is None else ms / n
