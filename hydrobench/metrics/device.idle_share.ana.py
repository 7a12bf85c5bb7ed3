"""device.idle_share.ana: the share of the analysis cycle's traced
stretch in which the device ran nothing (no kernel, memcpy or memset),
from the profiler's device trace: 1 - (union of those intervals) / (the
stretch's wall time), in percent."""

from hydrobench.measure import idle_share_pct

SOURCE = "device_trace"
MOVES = "hour_p95_ms"


def read(view):
    return idle_share_pct(view.trace)
