"""Build and load the port's native code.

Each CUDA kernel source ``troute_torch/csrc/<name>.cu`` is compiled by
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes``; the host C++ source ``csrc/topology_kernels.cpp`` is compiled
the same way by ``g++``.  The build runs at first use, into
``build/troute_torch/`` at the root of the checkout, never next to its
source, and the library's file name carries a hash of every source the
build reads (the file itself and the ``csrc/`` headers) and of the flags,
so an edited source or header is rebuilt and an unchanged one is loaded
from the cache.  A missing compiler or a failed build raises: nothing
falls back to another implementation here (``troute_torch/native.py``
decides what to do without the host library).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "troute_torch"

# --fmad=false and no fast-math: each multiply and add rounds on its own,
# as in the plain PyTorch version the kernels are held to
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME, else the toolkit's
    default install prefix."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def sources(src: Path) -> list[Path]:
    """Every file a build of ``src`` may read: the file and the headers
    beside it."""
    return [src] + sorted(p for p in CSRC.iterdir()
                          if p.suffix in (".cuh", ".h") and p.is_file())


def compile_cached(compiler: str, flags: tuple[str, ...], src: Path,
                   suffix: str = ".so") -> tuple[Path, str]:
    """``compiler flags -o build/troute_torch/<stem>-<hash><suffix> src``
    unless that file exists.  Returns its path and the compiler's output,
    which is kept beside it (``.log``), so a cache hit returns it too."""
    h = hashlib.sha256("\0".join(flags).encode())
    for p in sources(src):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    out = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}{suffix}"
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename, the log first: a concurrent
    # build never sees a half-written file or a library without its log
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    tmp_log = tmp + ".log"
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed to build "
                               f"{src.name}:\n{proc.stdout}{proc.stderr}")
        Path(tmp_log).write_text(proc.stdout + proc.stderr)
        os.replace(tmp_log, log)
        os.replace(tmp, out)
    finally:
        for t in (tmp, tmp_log):
            if os.path.exists(t):
                os.unlink(t)
    return out, proc.stdout + proc.stderr


def build(name: str, extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless the cached library is current.

    Returns the library path and the compiler's output.  ``extra_flags``
    (e.g. ``("-Xptxas", "-v")``) join the hash.
    """
    return compile_cached(find_nvcc(), NVCC_FLAGS + tuple(extra_flags),
                          CSRC / f"{name}.cu")


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return compile_cached(gxx, GXX_FLAGS, CSRC / f"{name}.cpp")[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        path, _ = build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
