"""Host time of `tracks/pipeline.process_frame` per frame: the depth
association (ground plane, rasterization, track matching, the depth
pair, the table update)."""

NAME = "assoc.host_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "program_span"
SPANS = [("mono_lidar_depth_tpu_torch", "process_frame", "assoc", None)]


def read(r):
    return r.host_ms("assoc")
