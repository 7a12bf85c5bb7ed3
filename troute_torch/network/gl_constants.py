"""Great Lakes constants.

The reference hardcodes the Great Lakes monthly climatology outflows
(``rfc_lake_gage_crosswalk.py:get_great_lakes_climatology``) for the four
synthetic GL waterbodies — St. Clair (4800002), Detroit (4800004),
Niagara (4800006), and St. Lawrence / Lake Ontario (4800007) — pending
their addition to the hydrofabric.  Same data here.
"""

from __future__ import annotations

import numpy as np

GREAT_LAKE_IDS = (4800002, 4800004, 4800006, 4800007)

# hardcoded lake -> gage crosswalk (reference ``DataAssimilation.py:710-739``:
# the great_lake class builds this inline; 4800007 is fed by the Lake
# Ontario IJC outflow CSV rather than a gage)
GL_USGS_GAGES = {4800002: "04127885", 4800004: "04159130"}
GL_CANADA_GAGES = {4800006: "02HA013"}

# monthly (Jan..Dec) climatology outflows, m3/s
GL_CLIMATOLOGY = np.array([
    [1946, 1907, 1879, 1929, 2105, 2202, 2306, 2378, 2343, 2282, 2235, 2046],
    [4623, 4518, 4946, 5217, 5410, 5494, 5546, 5555, 5519, 5475, 5424, 5253],
    [5630, 5523, 5673, 5921, 6179, 6172, 6089, 5977, 5839, 5751, 5757, 5771],
    [6380, 6561, 6875, 7159, 7418, 7547, 7500, 7360, 7161, 6954, 6852, 6725],
], dtype=np.float32)


def climatology_for(lake_id: int) -> np.ndarray | None:
    try:
        return GL_CLIMATOLOGY[GREAT_LAKE_IDS.index(int(lake_id))]
    except ValueError:
        return None
