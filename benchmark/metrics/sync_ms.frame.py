"""Host milliseconds a frame spent waiting on reads of the device
(``romis.sync.*`` spans: each drains the device's queue), from the
program's spans over the traced frames."""

from harness import spans

NAME, UNIT, LAYER = "sync_ms.frame", "ms/frame", "ops"
SOURCE, MOVES = "program_span", "frame_ms"


def read(trace):
    got = spans.frames(trace)
    if got is None:
        return None
    recs, n = got
    return sum(r.host_ms for r in spans.syncs(recs)) / n
