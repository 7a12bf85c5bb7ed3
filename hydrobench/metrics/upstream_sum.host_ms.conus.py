"""upstream_sum.host_ms.conus: the host's time in one step's upstream
flow sums (the banded plan on CONUS), in ms: the median duration of the
program's ``engine.upstream_sum`` spans over both traced stretches."""

from hydrobench import spans

SOURCE = "program_span"
MOVES = "hour_p95_ms"


def read(view):
    got = spans.program()
    return None if got is None else spans.median_ms(got[0],
                                                    "engine.upstream_sum")
