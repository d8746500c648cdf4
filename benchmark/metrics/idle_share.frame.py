"""The device's idle share over the traced frames: 1 - (the union of its
busy intervals) / the traced window. Read from the profiler's trace."""

NAME, UNIT, LAYER = "idle_share.frame", "share", "device"
SOURCE, MOVES = "device_trace", "frame_ms"


def read(trace):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
