"""nudge.host_ms.ana: the host's time in one step's gage nudging (the
gather of the gage rows' flows, ``simple_da`` on every gage lane, the
scatter of the nudged flows), in ms: the median duration of the program's
``engine.nudge`` spans over both traced stretches.  The gage lanes nudged
a step (the program's counter ``engine.nudge_lanes`` over its spans) go
to standard error."""

import sys

from hydrobench import spans

SOURCE = "program_span"
MOVES = "hour_p95_ms"


def read(view):
    got = spans.program()
    if got is None:
        return None
    recs, counts = got
    v = spans.median_ms(recs, "engine.nudge")
    n = len(spans.closed(recs, "engine.nudge"))
    if v is not None and "engine.nudge_lanes" in counts:
        print(f"nudge.host_ms: {counts['engine.nudge_lanes'] / n!r} gage "
              f"lanes a step over {n} steps", file=sys.stderr)
    return v
