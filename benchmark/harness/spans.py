"""The program's own spans over a traced window, for the per-layer readers
whose source is ``program_span``.

The program (``romis_tpu_torch.utils.stats``) records a span only while
the profiler runs, so its records hold the traced window alone. A frame is
the span ``romis.frame``; a span named ``romis.sync.*`` is a read of the
device back to the host. A program without spans (an older checkout) has
no ``records``: every reader then finds nothing and reports nothing.
"""

from __future__ import annotations

FRAME = "romis.frame"
SYNC = "romis.sync."


def frames(trace):
    """(the window's spans, its frames) → ([Span], n), or None where there
    is nothing to read: no device activity, no spans, or a count of
    ``romis.frame`` spans other than the trace's units."""
    if trace.busy_s <= 0 or not trace.units:
        return None
    try:
        from romis_tpu_torch.utils import stats

        recs = stats.records()
    except (ImportError, AttributeError):
        return None
    n = sum(r.name == FRAME for r in recs)
    return (recs, n) if n == trace.units else None


def _inside(recs, i: int, prefix: str) -> bool:
    """Whether a span above record ``i`` is named with ``prefix``."""
    p = recs[i].parent
    while p is not None:
        if recs[p].name.startswith(prefix):
            return True
        p = recs[p].parent
    return False


def syncs(recs) -> list:
    """The outermost ``romis.sync.*`` spans inside a frame."""
    return [r for i, r in enumerate(recs) if r.name.startswith(SYNC)
            and _inside(recs, i, FRAME) and not _inside(recs, i, SYNC)]


def device_ms(recs, name: str):
    """The summed device milliseconds of the spans ``name`` (None without
    any such span timed on the device)."""
    ms = [r.device_ms for r in recs if r.name == name
          and r.device_ms is not None]
    return sum(ms) if ms else None
