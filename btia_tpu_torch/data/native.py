"""ctypes bindings for the native ingest library (native/btia_ingest.cc).

The C++ path fuses DICOM parse → rescale/window → bilinear resize → RGB
uint8 in one pass and releases the GIL, so decode threads genuinely overlap
with the device loop [B:11; SURVEY §7.3 'single-core host']. Falls back to
the pure-Python implementation (data/dicom.py) when the library can't be
built — behaviour is identical (the Python module is the reference; see
tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libbtia_ingest.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Build the library into a file of this process's own, then rename it
    into place. The rename is atomic, so this package's own builds never
    leave a half-written library at ``_LIB_PATH``. The JAX package's loader
    (``btia_tpu/data/native.py``) still runs ``make`` onto that path in
    place, so a process that builds through it can still be read mid-write;
    the tests that compare the two packages' decodes pin the route."""
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp.name}"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.exists() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.btia_dicom_decode.restype = ctypes.c_int
            lib.btia_dicom_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.btia_resize_u8.restype = ctypes.c_int
            lib.btia_resize_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
            ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def dicom_decode_resize(data: bytes, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """DICOM bytes → (out_h, out_w, 3) uint8 RGB, or None if unsupported
    (caller falls back to the Python path)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.btia_dicom_decode(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h,
        out_w,
    )
    return out if rc == 0 else None


def resize_u8(img: np.ndarray, out_h: int, out_w: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    rc = lib.btia_resize_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h,
        out_w,
    )
    return out if rc == 0 else None
