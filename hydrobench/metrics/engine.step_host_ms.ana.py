"""engine.step_host_ms.ana: the host's time in one routing step of an
analysis hour (short step, level pool, typed reservoir DA, gage nudging),
in ms: the median duration of the program's ``engine.step`` spans over
both traced stretches.  The median self time of the step and of each span
under it goes to standard error."""

from hydrobench import spans

SOURCE = "program_span"
MOVES = "hour_p95_ms"


def read(view):
    return spans.step_host_ms()
