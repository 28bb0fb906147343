"""Host ms per frame of the port's span `vo.branch_sync`: the one host sync
of `odometry_step` (the `.tolist()` of its two branch predicates), so
the host's wait for the card to finish the association and the first
Gauss-Newton.  The median over the window's frames, from the port's own
record."""

from ..program_spans import host_ms

NAME = "vo.branch_sync.host_ms"
UNIT = "ms"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("vo.branch_sync")
