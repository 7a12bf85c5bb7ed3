"""bmi.marshal_ms: the host's time per BMI update outside the engine, in
ms: over the updates of both traced stretches, the median of each
update's ``bmi.ingest`` (the pushed arrays to the engine's inputs and the
device) plus ``bmi.publish`` (the last step back to the host and the
output arrays).  The medians of each part, and of the update's own time
outside its three children, go to standard error."""

import sys

from hydrobench import spans

SOURCE = "program_span"
MOVES = "updates_per_s"


def read(view):
    got = spans.program()
    if got is None:
        return None
    recs = got[0]
    v = spans.median_per_request_ms(recs, ("bmi.ingest", "bmi.publish"))
    if v is not None:
        print(f"bmi.marshal_ms: {v!r} ms over "
              f"{len(spans.closed(recs, 'bmi.update_until'))} updates; "
              f"median self times "
              f"{spans.breakdown_ms(recs, 'bmi.update_until')} ms",
              file=sys.stderr)
    return v
