"""Device milliseconds a frame: the union of the device's busy intervals
over the traced frames, from the profiler's trace. Steadier than
``frame_ms`` on a host-paced frame, whose time follows the host's speed;
a kernel's gain shows here first."""

NAME, UNIT, LAYER = "device_ms.frame", "ms/frame", "device"
SOURCE, MOVES = "device_trace", "frame_ms"


def read(trace):
    if trace.busy_s <= 0 or not trace.units:
        return None
    return 1e3 * trace.busy_s / trace.units
