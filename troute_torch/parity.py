"""WRF-Hydro / NWM parity checking.

Equivalent of the reference's ``build_tests.parity_check``
(``troute-routing/build_tests.py:163``): compare simulated flows against
validation CHRTOUT data (actual NWM model output) at chosen nodes or over
the whole domain.
"""

from __future__ import annotations

import numpy as np

from troute_torch.io.netcdf import NetCDFFile


def read_chrtout_streamflow(files, segment_ids):
    """[n_files, N] NWM streamflow from CHRTOUT files (validation data)."""
    segment_ids = np.asarray(segment_ids, np.int64)
    out = np.full((len(files), segment_ids.size), np.nan, np.float64)
    for t, path in enumerate(files):
        with NetCDFFile(path) as f:
            fids = f.read("feature_id").astype(np.int64)
            q = np.asarray(f.read("streamflow"), np.float64)
        order = np.argsort(fids)
        pos = np.searchsorted(fids[order], segment_ids)
        pos = np.clip(pos, 0, fids.size - 1)
        hit = fids[order][pos] == segment_ids
        out[t] = np.where(hit, q[order][pos], np.nan)
    return out


def parity_check(sim_q, ref_q, ids=None, label=""):
    """Compare simulated vs validation flows.

    Args:
        sim_q: [n_times, N] simulated flows at validation times
        ref_q: [n_times, N] validation (NWM CHRTOUT) flows

    Returns a stats dict (rmse, bias, correlation, relative error
    percentiles) over finite pairs.
    """
    sim = np.asarray(sim_q, np.float64).ravel()
    ref = np.asarray(ref_q, np.float64).ravel()
    ok = np.isfinite(sim) & np.isfinite(ref)
    sim, ref = sim[ok], ref[ok]
    if sim.size == 0:
        return {"n": 0}
    diff = sim - ref
    denom = np.maximum(np.abs(ref), 0.01)
    rel = np.abs(diff) / denom
    stats = {
        "n": int(sim.size),
        "rmse": float(np.sqrt(np.mean(diff ** 2))),
        "bias": float(np.mean(diff)),
        "corr": (float(np.corrcoef(sim, ref)[0, 1])
                 if sim.size > 1 and np.std(sim) > 0 and np.std(ref) > 0
                 else 1.0),
        "median_rel_err": float(np.median(rel)),
        "p90_rel_err": float(np.percentile(rel, 90)),
        "ref_mean": float(np.mean(ref)),
        "label": label,
    }
    return stats
