"""engine.step_host_ms.bmi: the host's time in one routing step of a
BMI update, in ms: the median duration of the program's ``engine.step``
spans, recorded over both traced stretches (the device-only stretch
holds 12 of the 14 cycles).  The median self time of the step and of
each span under it goes to standard error."""

from hydrobench import spans

SOURCE = "program_span"
MOVES = "updates_per_s"


def read(view):
    return spans.step_host_ms()
