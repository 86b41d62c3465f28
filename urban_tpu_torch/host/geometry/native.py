"""ctypes binding for the native host contiguity kernel.

Compiles native/contiguity.cpp with g++ on first use (cached next to the
source) and exposes ``contiguity_pairs``; falls back to None when no
compiler is available so the numpy path keeps working.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), 'native')
_SRC = os.path.join(_NATIVE_DIR, 'contiguity.cpp')
_LIB = os.path.join(_NATIVE_DIR, 'libcontiguity.so')

_lib = None
_tried = False


def _build() -> Optional[str]:
    # Rebuild whenever the source is newer OR a build marker recording the
    # source mtime is absent: git checkouts do not preserve mtimes, so a
    # stale (or foreign, e.g. built with different -march) .so from a clone
    # must never be trusted. The binary is gitignored and always built
    # locally; -march=native is opt-in via URBAN_TPU_NATIVE_MARCH.
    marker = _LIB + '.built'
    src_sig = str(os.path.getmtime(_SRC))
    if os.path.exists(_LIB) and os.path.exists(marker):
        try:
            with open(marker) as f:
                if f.read().strip() == src_sig:
                    return _LIB
        except OSError:
            pass
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17']
    march = os.environ.get('URBAN_TPU_NATIVE_MARCH')
    if march:
        cmd.append(f'-march={march}')
    try:
        subprocess.run(cmd + [_SRC, '-o', _LIB], check=True,
                       capture_output=True)
        with open(marker, 'w') as f:
            f.write(src_sig)
        return _LIB
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.contiguity_pairs.restype = ctypes.c_int64
    lib.contiguity_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def contiguity_pairs(segments: np.ndarray, owners: np.ndarray,
                     n_features: int, tol: float) -> Optional[np.ndarray]:
    """Unique (i, j) feature pairs whose segments touch within tol.

    segments: (M, 2, 2) or (M, 4) float64; owners: (M,) int32 feature index.
    Returns (K, 2) int32 sorted-pair array, or None if the native kernel is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    segs = np.ascontiguousarray(segments.reshape(len(segments), 4),
                                dtype=np.float64)
    own = np.ascontiguousarray(owners, dtype=np.int32)
    cap = max(64, 32 * n_features)
    while True:
        out = np.empty((cap, 2), dtype=np.int32)
        n = lib.contiguity_pairs(
            segs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            own.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(segs), n_features, tol,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n >= 0:
            return out[:n]
        cap *= 4
