"""Domain readers: RouteLink (channel network) and LAKEPARM (waterbodies).

Equivalents of the reference's ``nhd_io.read_netcdf``-based loaders
(``NHDNetwork.read_geo_file``, ``nhd_io.read_lakeparm``) producing columnar
NumPy arrays rather than DataFrames.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from troute_torch.io.netcdf import NetCDFFile

# default column mapping (NWM RouteLink variable names); overridable from
# the config's supernetwork columns block
ROUTELINK_COLUMNS = dict(
    key="link", downstream="to", dx="Length", n="n", ncc="nCC", s0="So",
    bw="BtmWdth", tw="TopWdth", twcc="TopWdthCC", cs="ChSlp",
    waterbody="NHDWaterbodyComID", gages="gages", alt="alt",
    musk="MusK", musx="MusX",
)

LAKEPARM_COLUMNS = ("LkArea", "LkMxE", "OrificeA", "OrificeC", "OrificeE",
                    "WeirC", "WeirE", "WeirL", "ifd")


@dataclass
class RouteLinkData:
    ids: np.ndarray          # int64 [N] segment ids (column 'key')
    downstream: np.ndarray   # int64 [N] downstream ids ('to'; 0 = terminal)
    channel: dict            # {dx,bw,tw,twcc,n,ncc,cs,s0: float32 [N]}
    waterbody: np.ndarray    # int64 [N] containing-lake id (or null code)
    waterbody_null: int
    gages: np.ndarray        # str [N] gage ids ('' if none)
    alt: np.ndarray | None


def read_routelink(path, columns: dict | None = None,
                   mask_ids: np.ndarray | None = None) -> RouteLinkData:
    """Load the channel network description.

    Args:
        columns: override variable-name mapping (config ``columns:`` block)
        mask_ids: optional subset of segment ids to keep (domain mask)
    """
    cols = dict(ROUTELINK_COLUMNS)
    if columns:
        cols.update(columns)
    with NetCDFFile(path) as f:
        ids = f.read(cols["key"]).astype(np.int64)
        down = f.read(cols["downstream"]).astype(np.int64)
        chan = {}
        for k in ("dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0"):
            chan[k] = f.read(cols[k]).astype(np.float32)
        wb = f.read(cols["waterbody"])
        wb = np.where(np.isnan(wb), -9999, wb).astype(np.int64) \
            if wb.dtype.kind == "f" else wb.astype(np.int64)
        gages = (f.read_strings(cols["gages"])
                 if cols.get("gages") in f.variables
                 else np.full(ids.shape, "", dtype=object))
        alt = (f.read(cols["alt"]).astype(np.float32)
               if cols.get("alt") in f.variables else None)

    if mask_ids is not None:
        keep = np.isin(ids, np.asarray(mask_ids, np.int64))
        ids, down, wb, gages = ids[keep], down[keep], wb[keep], gages[keep]
        chan = {k: v[keep] for k, v in chan.items()}
        if alt is not None:
            alt = alt[keep]

    return RouteLinkData(ids=ids, downstream=down, channel=chan,
                         waterbody=wb, waterbody_null=-9999, gages=gages,
                         alt=alt)


@dataclass
class LakeParmData:
    lake_ids: np.ndarray     # int64 [M]
    params: np.ndarray       # float64 [M, 9]: area, max_depth, orifice_area,
                             # orifice_coeff, orifice_elev, weir_coeff,
                             # weir_elev, weir_length, ifd
                             # (reference column order, levelpool.pyx:48-57)


def read_lakeparm(path, lake_id_field="lake_id",
                  lake_id_mask=None) -> LakeParmData:
    with NetCDFFile(path) as f:
        lake_ids = f.read(lake_id_field).astype(np.int64)
        cols = [np.asarray(f.read(c), np.float64) for c in LAKEPARM_COLUMNS]
    params = np.stack(cols, axis=1)
    order = np.argsort(lake_ids)
    lake_ids, params = lake_ids[order], params[order]
    if lake_id_mask is not None:
        keep = np.isin(lake_ids, np.asarray(list(lake_id_mask), np.int64))
        lake_ids, params = lake_ids[keep], params[keep]
    # drop duplicate ids, keeping the first (reference drop_duplicates)
    _, first = np.unique(lake_ids, return_index=True)
    return LakeParmData(lake_ids=lake_ids[first], params=params[first])
