"""Flat-array transport codecs for BMI coupling.

BMI couplers move only numeric arrays, so DataFrame-shaped DA inputs are
disassembled into (values, dates-as-seconds, station-names-as-ASCII-codes)
triples and reassembled on the receiving side.  Mirrors the reference's
``bmi_df2array.py`` / ``bmi_array2df.py`` encodings.  A copy of
``troute_tpu/bmi/codec.py`` (NumPy and pandas only).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def encode_strings(strings):
    """list[str] -> (uint8 ASCII codes concatenated, int32 lengths)."""
    codes = []
    lengths = []
    for s in strings:
        b = str(s).encode("ascii", "replace")
        codes.extend(b)
        lengths.append(len(b))
    return (np.asarray(codes, np.uint8),
            np.asarray(lengths, np.int32))


def decode_strings(codes, lengths):
    """Inverse of :func:`encode_strings`."""
    out = []
    pos = 0
    for n in np.asarray(lengths, np.int64):
        out.append(bytes(np.asarray(codes[pos:pos + n],
                                    np.uint8)).decode("ascii"))
        pos += int(n)
    return out


def time_stations_from_df(df: pd.DataFrame, t0):
    """Transport metadata of a [station x datetime] observation table
    (reference ``_time_stations_from_df``): column datetimes as seconds
    since ``t0``, row station ids as ASCII code + length arrays."""
    dates = pd.to_datetime(df.columns)
    date_secs = ((dates - t0).total_seconds()
                 if hasattr(dates - t0, "total_seconds")
                 else (dates - t0).map(lambda d: d.total_seconds()))
    date_secs = np.asarray(date_secs, np.int64)
    station_codes, station_lengths = encode_strings(df.index)
    return (date_secs, np.int64(date_secs.size), station_codes,
            station_lengths, np.int64(len(df.index)))


def flatten_array(df: pd.DataFrame, dtype=np.float32):
    """Row-major flattening of the table body (reference
    ``_flatten_array``)."""
    return df.to_numpy(dtype).flatten()


def df_from_arrays(flat, date_secs, station_codes, station_lengths, t0):
    """Reassemble the [station x datetime] table from transport arrays."""
    stations = decode_strings(station_codes, station_lengths)
    cols = t0 + pd.to_timedelta(np.asarray(date_secs, np.int64), unit="s")
    body = np.asarray(flat, np.float64).reshape(len(stations), len(cols))
    return pd.DataFrame(body, index=stations, columns=cols)


def disassemble_lastobs(gages, time_since, discharge):
    """lastobs state -> transport arrays (reference
    ``_bmi_disassemble_lastObs``)."""
    codes, lengths = encode_strings(gages)
    return (codes, lengths, np.asarray(time_since, np.float64),
            np.asarray(discharge, np.float64))


def assemble_lastobs(codes, lengths, time_since, discharge):
    gages = decode_strings(codes, lengths)
    return pd.DataFrame({
        "gages": gages,
        "time_since_lastobs": np.asarray(time_since, np.float64),
        "lastobs_discharge": np.asarray(discharge, np.float64),
    }).set_index("gages")
