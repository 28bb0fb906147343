"""Share of the profiled frames' wall time in which no activity ran on
the device."""

NAME = "device.idle_pct"
UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return r.idle_pct()
