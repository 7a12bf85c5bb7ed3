"""Minimal NetCDF4 (HDF5-backed) reader/writer on h5py.

NWM domain and forcing files are NetCDF4 = HDF5, so a thin layer over
h5py suffices, with no netCDF4 or xarray: variables with CF
``scale_factor``/``add_offset`` unpacking, ``_FillValue`` masking, and a
writer that emits netCDF4-compatible files (dimension scales + attrs).

``h5py`` is imported by the functions that open a file, never when a
module is imported: every module of the port imports on a machine
without it, and a NetCDF file asked for there fails with the plain
``ImportError`` that names ``h5py``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def _decode_attr(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.size == 1:
        return v.item()
    return v


class NetCDFFile:
    """Read-only NetCDF4 view with CF unpacking."""

    def __init__(self, path):
        import h5py
        self._dataset = h5py.Dataset
        self._f = h5py.File(path, "r")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()

    def close(self):
        self._f.close()

    @property
    def variables(self):
        return [k for k in self._f.keys()
                if isinstance(self._f[k], self._dataset)]

    def attrs(self, var=None) -> dict:
        obj = self._f if var is None else self._f[var]
        return {k: _decode_attr(v) for k, v in obj.attrs.items()}

    def raw(self, var) -> np.ndarray:
        return self._f[var][...]

    def read(self, var, mask_fill=True) -> np.ndarray:
        """Variable with scale_factor/add_offset applied; fill -> NaN."""
        ds = self._f[var]
        data = ds[...]
        attrs = ds.attrs
        scale = attrs.get("scale_factor")
        offset = attrs.get("add_offset")
        fill = attrs.get("_FillValue")
        if scale is not None or offset is not None:
            data = data.astype(np.float64)
            if fill is not None and mask_fill:
                data = np.where(self._raw_equals(ds, fill), np.nan, data)
            if scale is not None:
                data = data * np.asarray(scale).item()
            if offset is not None:
                data = data + np.asarray(offset).item()
        elif fill is not None and mask_fill and np.issubdtype(
                data.dtype, np.floating):
            data = np.where(data == np.asarray(fill), np.nan, data)
        if data.dtype.byteorder == ">":
            data = data.astype(data.dtype.newbyteorder("="))
        return data

    def _raw_equals(self, ds, fill):
        return ds[...] == np.asarray(fill).astype(ds.dtype)

    def read_strings(self, var) -> np.ndarray:
        """Char-array variable [n, len] -> array of stripped strings."""
        data = self._f[var][...]
        if data.dtype.kind == "S" and data.ndim == 2:
            joined = [b"".join(row).decode("utf-8", "replace").strip()
                      for row in data]
            return np.asarray(joined)
        if data.dtype.kind == "S":
            return np.char.strip(np.char.decode(data, "utf-8"))
        return data


def write_netcdf(path, variables: Mapping[str, np.ndarray],
                 dims: Mapping[str, tuple] | None = None,
                 attrs: Mapping[str, Mapping] | None = None,
                 global_attrs: Mapping | None = None):
    """Write a netCDF4-compatible HDF5 file.

    Args:
        variables: name -> array
        dims: name -> tuple of dimension names (defaults to phony dims)
        attrs: name -> attrs dict
        global_attrs: file-level attrs
    """
    import h5py

    dims = dims or {}
    attrs = attrs or {}
    with h5py.File(path, "w") as f:
        # create dimension scale datasets
        dim_sizes: dict[str, int] = {}
        for name, arr in variables.items():
            dnames = dims.get(name)
            if dnames:
                for d, size in zip(dnames, np.shape(arr)):
                    dim_sizes.setdefault(d, size)
        scales = {}
        for d, size in dim_sizes.items():
            if d in variables:
                continue
            ds = f.create_dataset(d, data=np.arange(size, dtype=np.int32))
            ds.make_scale(d)
            scales[d] = ds
        for name, arr in variables.items():
            arr = np.asarray(arr)
            ds = f.create_dataset(name, data=arr)
            for k, v in attrs.get(name, {}).items():
                ds.attrs[k] = v
            for axis, d in enumerate(dims.get(name, ())):
                if d in scales:
                    ds.dims[axis].attach_scale(scales[d])
            if name in dim_sizes and name in dims.get(name, ()):
                ds.make_scale(name)
        for k, v in (global_attrs or {}).items():
            f.attrs[k] = v
