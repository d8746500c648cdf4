"""Milliseconds a frame that the ReSTIR temporal combine spans on the
device's timeline: the extent of the span ``romis.temporal`` (the Gumbel
draw and ``temporal_reuse``) by its CUDA event pair, over the traced
frames. The extent holds the combine's kernels and every idle between
them: on a host-paced frame mostly the device waiting for the host to
enqueue the combine, so it moves with the host's speed as much as with the
kernels'. It is not the kernels' busy time."""

from harness import spans

NAME, UNIT, LAYER = "temporal_ms.frame", "ms/frame", "render"
SOURCE, MOVES = "program_span", "frame_ms"


def read(trace):
    got = spans.frames(trace)
    if got is None:
        return None
    recs, n = got
    ms = spans.device_ms(recs, "romis.temporal")
    return None if ms is None else ms / n
