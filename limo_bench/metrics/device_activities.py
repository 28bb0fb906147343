"""Device activities (kernels, copies, fills) per profiled frame, the
benchmark's markers left out."""

NAME = "device.activities"
UNIT = "activities/frame"
LAYER = "device"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return r.activities_per_frame()
