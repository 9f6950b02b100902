"""ctypes bindings for the native C++ fastloader (native/fastloader.cpp).

Builds the shared library with g++ on first use (cached next to the
source); falls back cleanly when no compiler is available.  The loader
(data/loader.py) uses this as its fast path for spectrogram/code batches.

The port's own copy of melspec_gpt_vqvae_tpu/data/native.py (numpy and the
standard library only): same classes, same batches for the same seed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _source_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native",
        "fastloader.cpp")


def _build(src: str, out: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
             src, "-o", out],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = _source_path()
        if not os.path.exists(src):
            return None
        so = os.path.join(os.path.dirname(src), "libfastloader.so")
        if not os.path.exists(so) or \
                os.path.getmtime(so) < os.path.getmtime(src):
            if not _build(src, so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.fl_load_spec_batch.restype = ctypes.c_int
        lib.fl_load_spec_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int]
        lib.fl_load_codes_batch.restype = ctypes.c_int
        lib.fl_load_codes_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.fl_probe_npy.restype = ctypes.c_int
        lib.fl_probe_npy.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def load_spec_batch(paths, crop_h: int, crop_w: int, scale: float = 2.0,
                    shift: float = -1.0, nthreads: int = 4) -> np.ndarray:
    """Center-crop + affine batch load: (N, crop_h, crop_w) f32 of
    scale*x + shift (the dataset's ``2*spec - 1``,
    reference datasets/vas.py:81)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("fastloader unavailable")
    out = np.empty((len(paths), crop_h, crop_w), np.float32)
    rc = lib.fl_load_spec_batch(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        crop_h, crop_w, scale, shift, nthreads)
    if rc != 0:
        raise IOError(f"fastloader spec batch failed (code {rc})")
    return out


def load_codes_batch(paths, rows: int = 5, cols: int = 53,
                     nthreads: int = 4) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("fastloader unavailable")
    out = np.empty((len(paths), rows, cols), np.int32)
    rc = lib.fl_load_codes_batch(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows, cols, nthreads)
    if rc != 0:
        raise IOError(f"fastloader codes batch failed (code {rc})")
    return out


def probe(path: str):
    lib = get_lib()
    if lib is None:
        return None
    r = ctypes.c_int64()
    c = ctypes.c_int64()
    if lib.fl_probe_npy(path.encode(), ctypes.byref(r),
                        ctypes.byref(c)) != 0:
        return None
    return int(r.value), int(c.value)
