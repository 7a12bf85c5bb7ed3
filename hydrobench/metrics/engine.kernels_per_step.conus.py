"""engine.kernels_per_step.conus: device operations (kernels, memcpys and
memsets) in the traced stretch per routing step traced: an exact count
of what the driver loop launches."""

SOURCE = "device_trace"
MOVES = "hour_p95_ms"


def read(view):
    n = len(view.trace.kernels())
    return n / view.steps if n and view.steps else None
