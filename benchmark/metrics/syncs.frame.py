"""Reads of the device back to the host a frame (``romis.sync.*`` spans),
from the program's spans over the traced frames."""

from harness import spans

NAME, UNIT, LAYER = "syncs.frame", "syncs/frame", "ops"
SOURCE, MOVES = "program_span", "frame_ms"


def read(trace):
    got = spans.frames(trace)
    if got is None:
        return None
    recs, n = got
    return len(spans.syncs(recs)) / n
