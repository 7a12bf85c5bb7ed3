"""engine.device_allocs_per_hour.conus: device allocations (the caching
allocator's ``cudaMalloc`` calls) made inside the program's routing call,
per CONUS hour: the program's counter ``cuda.device_allocs`` over the
number of its ``engine.route`` spans, both over the traced stretches.
0 means the allocator serves every hour from its cache."""

from hydrobench import spans

SOURCE = "program_counter"
MOVES = "hour_p95_ms"


def read(view):
    got = spans.program()
    if got is None:
        return None
    recs, counts = got
    routes = len(spans.closed(recs, "engine.route"))
    if not routes or "cuda.device_allocs" not in counts:
        return None
    return counts["cuda.device_allocs"] / routes
