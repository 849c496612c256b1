"""Loader of the native gsio library (``native/gsio.cpp``): a COLMAP
points3D.bin reader for host file I/O, not a device kernel.

The port's own copy of sixdgs_tpu/utils/native.py: built with g++ at
first use into ``build/torch_native/`` and loaded with ctypes. Returns
None when there is no toolchain or the build fails; every caller then
takes its numpy path, as the JAX package's callers do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "gsio.cpp"
SO_PATH = Path(__file__).resolve().parents[2] / "build" / "torch_native" / "libgsio.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def get_gsio() -> Optional[ctypes.CDLL]:
    """The gsio library with its signatures set, or None (cached)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not SO_PATH.exists():
                if not NATIVE_SRC.exists():
                    return None
                SO_PATH.parent.mkdir(parents=True, exist_ok=True)
                tmp = SO_PATH.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                                "-o", str(tmp), str(NATIVE_SRC)],
                               check=True, capture_output=True)
                os.replace(tmp, SO_PATH)  # a concurrent loader never sees half a file
            lib = ctypes.CDLL(str(SO_PATH))
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.gsio_count_points3d.restype = ctypes.c_longlong
        lib.gsio_count_points3d.argtypes = [ctypes.c_char_p]
        lib.gsio_read_points3d.restype = ctypes.c_longlong
        lib.gsio_read_points3d.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
        ]
        _lib = lib
        return _lib
