"""Lateral-inflow (qlat) forcing readers.

Equivalents of ``nhd_io.get_ql_from_chrtout`` / ``get_ql_from_csv``:
lateral inflow per segment per forcing interval, as a [n_times, N] array
aligned to a segment-id index.
"""

from __future__ import annotations

import numpy as np

from troute_torch.io.netcdf import NetCDFFile


def read_qlat_chrtout(files, segment_ids: np.ndarray,
                      index_col: str = "feature_id",
                      value_col: str = "q_lateral",
                      gw_bucket_col: str = "qBucket",
                      runoff_col: str = "qSfcLatRunoff") -> np.ndarray:
    """qlat [n_times, N] from CHRTOUT files, aligned to ``segment_ids``.

    Lateral inflow = gw_bucket_col + runoff_col when both are present, else
    the ``value_col`` variable (reference ``nhd_io.py:397-435``; column
    names configurable via forcing_parameters qlat_file_* keys).

    Files carrying MULTIPLE timesteps per file (2-D [time, N] variables —
    WRF-Hydro multifile output) are delegated to
    ``read_qlat_wrf_hydro_mf``, whose semantics the reference applies to
    that file shape.
    """
    segment_ids = np.asarray(segment_ids, np.int64)
    out = np.zeros((len(files), segment_ids.size), np.float32)
    for t, path in enumerate(files):
        with NetCDFFile(path) as f:
            fids = f.read(index_col).astype(np.int64)
            names = f.variables
            if gw_bucket_col in names and runoff_col in names:
                ql = f.read(gw_bucket_col) + f.read(runoff_col)
            else:
                ql = f.read(value_col)
        if np.ndim(ql) == 2:
            return read_qlat_wrf_hydro_mf(
                files, segment_ids, index_col=index_col,
                value_col=value_col, gw_col=gw_bucket_col,
                runoff_col=runoff_col)
        order = np.argsort(fids)
        pos = np.searchsorted(fids[order], segment_ids)
        pos = np.clip(pos, 0, fids.size - 1)
        hit = fids[order][pos] == segment_ids
        vals = np.asarray(ql, np.float64)[order][pos]
        out[t] = np.where(hit, vals, 0.0).astype(np.float32)
    return out


def read_qlat_wrf_hydro_mf(files, segment_ids: np.ndarray,
                           index_col: str = "feature_id",
                           value_col: str = "q_lateral",
                           gw_col: str = "qBucket",
                           runoff_col: str = "qSfcLatRunoff") -> np.ndarray:
    """qlat [n_times_total, N] from a WRF-Hydro output multifile set.

    Equivalent of the reference's ``nhd_io.get_ql_from_wrf_hydro_mf``
    (``nhd_io.py:437-512``): the globbed files concatenate along time
    (each file may carry one or many timesteps), the ``value_col``
    variable is preferred with the qBucket+qSfcLatRunoff sum as the
    fallback (note the precedence is REVERSED vs ``get_ql_from_chrtout``,
    which prefers the sum), and rows are ordered by the files' ``time``
    coordinate when every file carries one (``open_mfdataset`` nested
    time concat).  Segments absent from a file's index read 0.
    """
    segment_ids = np.asarray(segment_ids, np.int64)
    blocks, times = [], []
    for path in files:
        with NetCDFFile(path) as f:
            fids = np.asarray(f.read(index_col)).astype(np.int64)
            if fids.ndim == 2:
                # per-time replicated index; the reference takes row 0
                # (``ds[index_col].values[0]``, nhd_io.py:497-501)
                fids = fids[0]
            names = f.variables
            if value_col in names:
                ql = np.asarray(f.read(value_col), np.float64)
            else:
                ql = np.asarray(f.read(gw_col), np.float64) \
                    + np.asarray(f.read(runoff_col), np.float64)
            if ql.ndim == 1:
                ql = ql[None, :]
            t = (np.asarray(f.read("time"), np.float64).reshape(-1)
                 if "time" in names else None)
        order = np.argsort(fids)
        pos = np.clip(np.searchsorted(fids[order], segment_ids), 0,
                      fids.size - 1)
        hit = fids[order][pos] == segment_ids
        vals = ql[:, order][:, pos]
        blocks.append(np.where(hit[None, :], vals, 0.0).astype(np.float32))
        times.append(t if t is not None and t.size == ql.shape[0]
                     else np.full(ql.shape[0], np.nan))
    out = np.concatenate(blocks, axis=0)
    tcat = np.concatenate(times)
    if tcat.size and np.isfinite(tcat).all():
        out = out[np.argsort(tcat, kind="stable")]
    return out


def read_qlat_csv(path, segment_ids: np.ndarray) -> np.ndarray:
    """qlat [n_times, N] from a CSV indexed by segment id (cols = times)."""
    import pandas as pd

    df = pd.read_csv(path, index_col=0)
    df.index = df.index.astype(np.int64)
    df = df.reindex(np.asarray(segment_ids, np.int64)).fillna(0.0)
    return df.to_numpy(np.float32).T
