"""reservoir_da.host_ms.ana: the host's time in one step's typed
reservoir DA (``typed_reservoir_dispatch``: hybrid persistence, RFC and
Great Lakes DA, each computed masked over every reservoir lane), in ms:
the median duration of the program's ``engine.reservoir_da`` spans, which
lie inside ``engine.reservoirs``, over both traced stretches.  The lanes
the dispatch computes a step (the counter ``engine.reservoir_da_lanes``
over the spans) go to standard error."""

import sys

from hydrobench import spans

SOURCE = "program_span"
MOVES = "hour_p95_ms"


def read(view):
    got = spans.program()
    if got is None:
        return None
    recs, counts = got
    v = spans.median_ms(recs, "engine.reservoir_da")
    n = len(spans.closed(recs, "engine.reservoir_da"))
    if v is not None and "engine.reservoir_da_lanes" in counts:
        print(f"reservoir_da.host_ms: "
              f"{counts['engine.reservoir_da_lanes'] / n!r} lanes a step "
              f"over {n} steps; engine.reservoirs "
              f"{spans.median_ms(recs, 'engine.reservoirs')!r} ms",
              file=sys.stderr)
    return v
