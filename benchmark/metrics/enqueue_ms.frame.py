"""The host's enqueue milliseconds a frame: each ``romis.frame`` span's
host time less the host time of the device reads inside it
(``romis.sync.*``), from the program's spans over the traced frames. On a
host-paced frame this is the frame's pace."""

from harness import spans

NAME, UNIT, LAYER = "enqueue_ms.frame", "ms/frame", "render"
SOURCE, MOVES = "program_span", "frame_ms"


def read(trace):
    got = spans.frames(trace)
    if got is None:
        return None
    recs, n = got
    frame_ms = sum(r.host_ms for r in recs if r.name == spans.FRAME)
    return (frame_ms - sum(r.host_ms for r in spans.syncs(recs))) / n
