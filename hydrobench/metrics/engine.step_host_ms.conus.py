"""engine.step_host_ms.conus: the host's time in one routing step of a
CONUS hour, in ms: the median duration of the program's ``engine.step``
spans, recorded over both traced stretches (the device-only stretch
holds two thirds of the steps, so the median lies in it).  The step is
bound by the host's launches, so its host time is about its wall time.
The median self time of the step and of each span under it goes to
standard error."""

from hydrobench import spans

SOURCE = "program_span"
MOVES = "hour_p95_ms"


def read(view):
    return spans.step_host_ms()
