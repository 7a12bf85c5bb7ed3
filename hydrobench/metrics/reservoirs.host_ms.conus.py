"""reservoirs.host_ms.conus: the host's time in one step's reservoirs
(the gather of the lakes' inflows, the level pool on every lake, the
scatter of their outflows and levels), in ms: the median duration of the
program's ``engine.reservoirs`` spans over both traced stretches."""

from hydrobench import spans

SOURCE = "program_span"
MOVES = "hour_p95_ms"


def read(view):
    got = spans.program()
    return None if got is None else spans.median_ms(got[0],
                                                    "engine.reservoirs")
