"""HYFeatures (NextGen hydrofabric) network reading.

Equivalent of the reference's ``HYFeaturesNetwork`` geopackage path
(``HYFeaturesNetwork.py:33-120,369-703``) without geopandas/fiona: a
GeoPackage is SQLite, and the routing layers (flowpaths,
flowpath_attributes, network, lakes/lake_attributes, nexus) are attribute
tables — read directly with the stdlib ``sqlite3``.

Layer names are discovered by regex patterns like the reference's
``find_layer_name`` (``HYFeaturesNetwork.py:24-48``), so both hydrofabric
generations load:

* old format: ``flowpath_edge_list`` wb->nex->wb linkage, per-segment
  ``rl_gages``, ``lake_attributes`` keyed by lake id;
* new format: ``flowpaths.toid`` + ``nexus.toid`` linkage, gages derived
  from the ``network`` layer's ``hl_uri``/``hydroseq`` columns
  (``preprocess_data_assimilation``, ``HYFeaturesNetwork.py:606-703``),
  ``lakes`` keyed by ``hl_link`` with the outlet flowpath in ``id``, and
  Great Lakes discovered from nexus ``hl_uri`` WBOut tags
  (``HYFeaturesNetwork.py:547-585``).

HYFeatures id semantics: flowpaths are ``wb-<n>``, junction points are
``nex-<n>`` (or ``tnx-``/terminal codes); lateral inflows arrive per
*nexus* (NEXOUT files) and apply to the flowpath downstream of that nexus.
"""

from __future__ import annotations

import os
import re
import sqlite3
from typing import NamedTuple

import numpy as np

from troute_torch.io.routelink import RouteLinkData

GREAT_LAKE_WBOUT_IDS = (4800002, 4800004, 4800006, 4800007)

# standard column name -> hydrofabric attribute column (reference
# supernetwork default ``columns`` mapping; overridable from
# supernetwork_parameters.columns)
DEFAULT_COLUMNS = {
    "key": "id", "downstream": "toid", "dx": "length_m", "n": "n",
    "ncc": "nCC", "s0": "So", "bw": "BtmWdth", "waterbody":
    "rl_NHDWaterbodyComID", "gages": "rl_gages", "tw": "TopWdth",
    "twcc": "TopWdthCC", "cs": "ChSlp", "musk": "MusK", "musx": "MusX",
    "alt": "alt",
}

LAYER_PATTERNS = {
    "flowpaths": r"^flow[-_]?paths?$|^flow[-_]?lines?$",
    "flowpath_attributes":
        r"flow[-_]?path[-_]?attributes?|flow[-_]?line[-_]?attributes?",
    "flowpath_edge_list": r"flow[-_]?path[-_]?edge[-_]?list",
    "lakes": r"^lakes?$|^lake[-_]?attributes?$",
    "nexus": r"^nexus$",
    "network": r"^network$",
}


class HyfDAInfo(NamedTuple):
    """DA crosswalks extracted from the geopackage itself (no reservoir
    parameter NetCDF needed, unlike the NHD path)."""

    gages: dict            # {segment id: usgs gage id} (streamflow nudging)
    usgs_lake_gage: dict   # {lake id: usgs gage id}
    usace_lake_gage: dict  # {lake id: usace/NID gage id}
    rfc_lake_gage: dict    # {lake id: NWS location id} (predefined table)
    canadian_gage_link: dict  # {segment id: WSC gage} (reference ships an
    #                            empty placeholder, HYFeaturesNetwork.py:641)
    great_lakes: dict      # {GL waterbody id: downstream wb segment id}


def _num(s) -> int:
    """'wb-1234' / 'nex-77' / 'tnx-1000000' -> numeric id."""
    if isinstance(s, (int, np.integer)):
        return int(s)
    tail = str(s).rpartition("-")[2]
    try:
        return int(tail)          # the common case, without the float parse
    except ValueError:
        return int(float(tail))


def _tables(con) -> list[str]:
    return [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")]


def _find_layer(tables, pattern):
    for t in tables:
        if re.search(pattern, t, re.IGNORECASE):
            return t
    return None


def _read_table(con, name) -> dict[str, list]:
    """Whole attribute table as {column: list} (geometry blobs included
    but unused)."""
    cur = con.execute(f'SELECT * FROM "{name}"')
    cols = [d[0] for d in cur.description]
    rows = cur.fetchall()
    return {c: [r[i] for r in rows] for i, c in enumerate(cols)}


def _derive_gage_crosswalks(network: dict, wbody_of_seg: dict) -> tuple:
    """Reference ``preprocess_data_assimilation``
    (``HYFeaturesNetwork.py:606-703``): split ``hl_uri`` into type-value,
    keep 'Gages'/'NID', explode space-separated multi-gage values, and use
    ``hydroseq`` to keep the furthest-downstream location per gage.

    Returns ({seg: usgs_gage}, {lake: usgs_gage}, {lake: usace_gage}).
    """
    recs = []            # (seg_id, gage_value, hydroseq, is_numeric)
    ids = network.get("id", [])
    uris = network.get("hl_uri", [])
    seqs = network.get("hydroseq", [])
    for sid, uri, seq in zip(ids, uris, seqs):
        if uri in (None, "") or seq is None:
            continue
        parts = str(uri).split("-", 1)
        if len(parts) != 2 or parts[0] not in ("Gages", "NID"):
            continue
        seg = _num(sid)
        for val in parts[1].split(" "):
            if not val:
                continue
            recs.append((seg, val, float(seq), val.isnumeric()))

    # streamflow-nudging gages: numeric (USGS), furthest downstream per
    # gage value wins (sort by hydroseq, keep last)
    seg_gage = {}
    best = {}
    for seg, val, seq, numeric in sorted(recs, key=lambda r: r[2]):
        if numeric:
            best[val] = (seg, seq)
    for val, (seg, _) in best.items():
        seg_gage[seg] = val

    # lake-gage crosswalks: per lake, the gage (and per gage the furthest
    # downstream record), USGS (numeric) and USACE (NID) separately
    usgs, usace = {}, {}
    for seg, val, seq, numeric in sorted(recs, key=lambda r: r[2]):
        lake = wbody_of_seg.get(seg)
        if lake is None:
            continue
        (usgs if numeric else usace)[int(lake)] = val
    return seg_gage, usgs, usace


def read_geopkg(path, columns: dict | None = None,
                synthetic_offset: float = 9.99e11):
    """Load routing tables from a HYFeatures geopackage.

    Args:
        columns: supernetwork_parameters.columns standard->actual name
            mapping (defaults per ``DEFAULT_COLUMNS``).

    Returns (RouteLinkData, nexus_of_wb {wb: upstream nexus},
    wb_downstream_nexus {wb: downstream nexus}, HyfDAInfo).
    """
    cols = dict(DEFAULT_COLUMNS)
    if columns:
        cols.update({k: v for k, v in columns.items() if v})

    con = sqlite3.connect(path)
    try:
        tables = _tables(con)
        layer = {k: _find_layer(tables, p) for k, p in
                 LAYER_PATTERNS.items()}
        attrs = _read_table(con, layer["flowpath_attributes"]) \
            if layer["flowpath_attributes"] else {}
        flowpaths = _read_table(con, layer["flowpaths"]) \
            if layer["flowpaths"] else {}
        edges = con.execute(
            f'SELECT id, toid FROM "{layer["flowpath_edge_list"]}"'
        ).fetchall() if layer["flowpath_edge_list"] else []
        nexus = _read_table(con, layer["nexus"]) if layer["nexus"] else {}
        network = _read_table(con, layer["network"]) \
            if layer["network"] else {}
    finally:
        con.close()

    # some hydrofabrics key flowpath_attributes by 'link' instead of 'id'
    # (reference read_geopkg, HYFeaturesNetwork.py:92-94)
    if "link" in attrs and "id" not in attrs:
        attrs["id"] = attrs.pop("link")

    key_c = cols["key"] if cols["key"] in attrs else "id"

    # wb -> nex and nex -> wb linkage: edge list (old) or toid columns (new)
    wb_to_nex: dict[str, str] = {}
    nex_to_wb: dict[str, str] = {}
    if edges:
        for src, dst in edges:
            s, d = str(src), str(dst)
            if s.startswith("wb"):
                wb_to_nex[s] = d
            else:
                nex_to_wb[s] = d
    else:
        for i, t in zip(flowpaths.get("id", []),
                        flowpaths.get("toid", [])):
            if t is not None:
                wb_to_nex[str(i)] = str(t)
        for i, t in zip(nexus.get("id", []), nexus.get("toid", [])):
            if t is not None:
                nex_to_wb[str(i)] = str(t)

    def col(name, default):
        c = cols.get(name, name)
        vals = attrs.get(c)
        if vals is None:
            return [default] * len(attrs.get("id", []))
        return [v if v is not None else default for v in vals]

    ids, down = [], []
    for fid in attrs.get(key_c, attrs.get("id", [])):
        ids.append(_num(fid))
        nex = wb_to_nex.get(str(fid))
        ds_wb = nex_to_wb.get(nex) if nex else None
        down.append(_num(ds_wb) if ds_wb and not str(ds_wb).startswith("tnx")
                    else 0)

    chan = {
        "dx": [v or 1.0 for v in col("dx", 1.0)],
        "bw": [v or 1.0 for v in col("bw", 1.0)],
        "tw": [v or 3.0 for v in col("tw", 3.0)],
        "twcc": [v or 9.0 for v in col("twcc", 9.0)],
        "n": [v or 0.05 for v in col("n", 0.05)],
        "ncc": [v or 0.1 for v in col("ncc", 0.1)],
        "cs": [v or 1.0 for v in col("cs", 1.0)],
        "s0": [max(v or 1e-4, 1e-5) for v in col("s0", 1e-4)],
    }

    # waterbody membership column: comma-separated lake ids per segment
    # (reference preprocess_waterbodies melt, HYFeaturesNetwork.py:484-500)
    wb = np.full(len(ids), -9999, np.int64)
    for k, v in enumerate(col("waterbody", None)):
        if v in (None, "", "None"):
            continue
        try:
            wb[k] = int(float(str(v).split(",")[0]))
        except ValueError:
            continue
    wbody_of_seg = {int(s): int(l) for s, l in zip(ids, wb) if l != -9999}

    # per-segment gages: the network layer's hl_uri derivation when
    # present (new format drops rl_gages, HYFeaturesNetwork.py:408-410),
    # else the old rl_gages attribute column
    da_seg_gage, usgs_lg, usace_lg = _derive_gage_crosswalks(
        network, wbody_of_seg)
    gages = []
    if da_seg_gage:
        for sid in ids:
            gages.append(da_seg_gage.get(int(sid), ""))
    else:
        for sid, g in zip(ids, col("gages", "")):
            s = str(g).strip() if g not in (None, "", "None") else ""
            gages.append(s)
            if s:
                da_seg_gage[int(sid)] = s

    # RFC crosswalk: predefined operational table filtered to this domain's
    # lakes (reference get_rfc_lake_gage_crosswalk, :697-703)
    from troute_torch.network.rfc_crosswalk import RFC_LAKE_GAGE
    domain_lakes = set(wbody_of_seg.values())
    rfc_lg = {lk: g for lk, g in RFC_LAKE_GAGE.items() if lk in domain_lakes}

    # Great Lakes from nexus hl_uri WBOut tags (:547-560)
    great_lakes = {}
    for uri, toid in zip(nexus.get("hl_uri", []), nexus.get("toid", [])):
        if not uri:
            continue
        m = re.search(r"WBOut-(\d+)", str(uri))
        if m and int(m.group(1)) in GREAT_LAKE_WBOUT_IDS and toid:
            great_lakes[int(m.group(1))] = _num(toid)

    rl = RouteLinkData(
        ids=np.asarray(ids, np.int64),
        downstream=np.asarray(down, np.int64),
        channel={k: np.asarray(v, np.float32) for k, v in chan.items()},
        waterbody=wb, waterbody_null=-9999,
        gages=np.asarray(gages, dtype=object),
        alt=None)

    nexus_of_wb = {}
    for nex, wb_id in nex_to_wb.items():
        if not str(wb_id).startswith("tnx"):
            nexus_of_wb[_num(wb_id)] = _num(nex)
    # wb -> its DOWNSTREAM nexus (the reference's output-mask nexus_dict
    # groups flowpaths by toid, HYFeaturesNetwork.py:450)
    wb_downstream_nexus = {_num(w): _num(nx) for w, nx in wb_to_nex.items()}
    da = HyfDAInfo(gages=da_seg_gage, usgs_lake_gage=usgs_lg,
                   usace_lake_gage=usace_lg, rfc_lake_gage=rfc_lg,
                   canadian_gage_link={}, great_lakes=great_lakes)
    return rl, nexus_of_wb, wb_downstream_nexus, da


def read_lake_attributes(path):
    """Lake parameter table from the geopackage, in the reference's
    levelpool column order.  Handles both generations:

    * old ``lake_attributes``: ``id`` IS the lake id (the waterbody is its
      own flowpath);
    * new ``lakes`` layer: ``hl_link`` is the lake id and ``id`` the
      outlet wb flowpath (``HYFeaturesNetwork.py:459-471``).

    Returns (lake_ids [M], params [M, 9], outlet_wb {lake id: wb segment
    id} or None for the old format).
    """
    con = sqlite3.connect(path)
    try:
        tables = _tables(con)
        name = _find_layer(tables, LAYER_PATTERNS["lakes"])
        tab = _read_table(con, name) if name else {}
    finally:
        con.close()
    n = len(tab.get("id", []))
    if not n:
        return np.zeros(0, np.int64), np.zeros((0, 9)), None

    def col(c, default=0.0):
        return [v if v is not None else default
                for v in tab.get(c, [default] * n)]

    new_format = "hl_link" in tab
    if new_format:
        lake_ids = np.asarray([_num(v) for v in tab["hl_link"]], np.int64)
        outlet_wb = {int(l): _num(w)
                     for l, w in zip(lake_ids, tab["id"])}
    else:
        lake_ids = np.asarray([_num(v) for v in tab["id"]], np.int64)
        outlet_wb = None
    params = np.column_stack([
        np.asarray(col(c), np.float64) for c in
        ("LkArea", "LkMxE", "OrificeA", "OrificeC", "OrificeE",
         "WeirC", "WeirE", "WeirL", "ifd")])
    # drop lakes with missing parameters (reference dropna, :475)
    good = np.isfinite(params).all(axis=1)
    return lake_ids[good], params[good], outlet_wb


def read_qlat_nexout(files, segment_ids, nexus_of_wb, binary_folder=None):
    """qlat [n_files, N] from NEXOUT CSVs: each file has one time column of
    nexus discharges; a nexus's flow becomes lateral inflow to the
    flowpath directly downstream of that nexus.

    ``binary_folder``: when set, the per-file CSVs are converted once into
    one parquet table keyed by file stem and reread from there on
    subsequent runs (reference ``nex_files_to_binary``,
    hyfeature_network_utilities.py:452 — NEXOUT csv parsing dominates
    repeat-run forcing time at scale).
    """
    import pandas as pd

    segment_ids = np.asarray(segment_ids, np.int64)
    nex_col = np.asarray(
        [nexus_of_wb.get(int(s), -1) for s in segment_ids], np.int64)

    frames = None
    if binary_folder is not None:
        from pathlib import Path
        binary_folder = Path(binary_folder)
        binary_folder.mkdir(parents=True, exist_ok=True)
        cache = binary_folder / "nexout.parquet"
        stems = [Path(f).name for f in files]
        if cache.exists():
            tbl = pd.read_parquet(cache)
            if all(s in tbl.columns for s in stems):
                frames = {s: tbl[s] for s in stems}
        if frames is None:
            cols = {}
            for f in files:
                df = pd.read_csv(f, index_col=0)
                cols[Path(f).name] = df.iloc[:, 0]
            tbl = pd.DataFrame(cols)
            # written aside and renamed into place, so that another
            # process (a rank of a sharded run) reads the whole table or
            # none of it
            tmp = cache.with_name(f".{cache.name}.{os.getpid()}")
            tbl.to_parquet(tmp)
            os.replace(tmp, cache)
            frames = cols
    out = np.zeros((len(files), segment_ids.size), np.float32)
    for t, f in enumerate(files):
        if frames is not None:
            from pathlib import Path
            series = frames[Path(f).name]
        else:
            df = pd.read_csv(f, index_col=0)
            series = df.iloc[:, 0]
        vals = series.reindex(nex_col).to_numpy(np.float64)
        out[t] = np.where(np.isfinite(vals), vals, 0.0)
    return out
