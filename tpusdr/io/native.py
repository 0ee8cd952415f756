"""ctypes bindings for the native host runtime (native/tpusdr_native.cpp).

Loads ``libtpusdr_native.so``, building it from the committed source on
first use (or ``make -C native`` / ``python -m tpusdr.io.native --build``).  Every entry point has a NumPy
fallback so the framework runs without the native library — the native path
exists to keep a 20+ Msps ingest loop off the GIL (the role the reference's
C++ BufferPool/FileReader/HackrfSource stack plays, SURVEY.md section 2.3).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

import numpy as np

from tpusdr.utils.logging import get_logger

log = get_logger("io.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libtpusdr_native.so"))

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build(quiet: bool = True) -> bool:
    """Compile the native library in-tree. Returns success.

    The build is atomic: ``make`` writes a file named for this process and
    ``os.replace`` moves it into place, so processes that build at the same
    time (parallel test workers) never load a half-written library."""
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            ["make", "-C", os.path.abspath(_NATIVE_DIR), f"TARGET={os.path.basename(tmp)}"],
            capture_output=quiet,
            check=False,
        )
    except OSError as e:  # no make/g++
        log.warning("native build unavailable: %s", e)
        return False
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, _SO_PATH)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH):
        if not build():
            log.info("native library not built; host conversions use NumPy")
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        log.warning("failed to load %s: %s; host conversions use NumPy", _SO_PATH, e)
        return None

    lib.tsdr_ring_create.restype = ctypes.c_void_p
    lib.tsdr_ring_create.argtypes = [ctypes.c_size_t]
    lib.tsdr_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.tsdr_ring_available.restype = ctypes.c_size_t
    lib.tsdr_ring_available.argtypes = [ctypes.c_void_p]
    lib.tsdr_ring_dropped.restype = ctypes.c_uint64
    lib.tsdr_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.tsdr_ring_close.argtypes = [ctypes.c_void_p]
    lib.tsdr_ring_write.restype = ctypes.c_size_t
    lib.tsdr_ring_write.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    lib.tsdr_ring_read.restype = ctypes.c_size_t
    lib.tsdr_ring_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.tsdr_file_reader_start.restype = ctypes.c_void_p
    lib.tsdr_file_reader_start.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.tsdr_file_reader_stop.argtypes = [ctypes.c_void_p]
    for name, styp in [
        ("tsdr_deinterleave_i8", ctypes.c_void_p),
        ("tsdr_deinterleave_i16", ctypes.c_void_p),
    ]:
        f = getattr(lib, name)
        f.argtypes = [styp, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
    lib.tsdr_deinterleave_f32.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    lib.tsdr_f32_to_i16.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    _lib = lib
    log.info("native library loaded from %s", _SO_PATH)
    return _lib


def native_available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# Ring buffer + file reader (object wrappers)
# ---------------------------------------------------------------------------


class NativeRing:
    """SPSC byte ring (drop-on-overrun writes, blocking reads)."""

    def __init__(self, capacity_bytes: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.tsdr_ring_create(capacity_bytes)
        if not self._h:
            raise MemoryError("ring allocation failed")

    def write(self, data: np.ndarray) -> bool:
        buf = np.ascontiguousarray(data)
        n = self._lib.tsdr_ring_write(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
        )
        return n == buf.nbytes

    def read(self, nbytes: int, dtype=np.uint8, timeout_ms: int = 5000):
        out = np.empty(nbytes // np.dtype(dtype).itemsize, dtype=dtype)
        got = self._lib.tsdr_ring_read(
            self._h, out.ctypes.data_as(ctypes.c_void_p), nbytes, timeout_ms
        )
        if got != nbytes:
            return None
        return out

    @property
    def available(self) -> int:
        return self._lib.tsdr_ring_available(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.tsdr_ring_dropped(self._h)

    def close(self) -> None:
        self._lib.tsdr_ring_close(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.tsdr_ring_destroy(self._h)
                self._h = None
        except Exception:
            pass


class NativeFileStream:
    """Background-thread capture playback through a native ring.

    The C++ FileReader role (64 KiB fread loop) with the read-ahead the
    reference lacks; yields fixed-size numpy blocks like any other source.
    """

    def __init__(
        self,
        path: str,
        block_samples: int,
        input_format: str = "int8",
        ring_blocks: int = 8,
        loop: bool = False,
        timeout_ms: int = 5000,
    ):
        self.dtype = {"int8": np.int8, "int16": np.int16, "cf32": np.complex64}[
            input_format
        ]
        scalars = block_samples if input_format == "cf32" else 2 * block_samples
        self.block_bytes = scalars * np.dtype(self.dtype).itemsize
        self.timeout_ms = timeout_ms
        self.ring = NativeRing(self.block_bytes * ring_blocks)
        lib = get_lib()
        self._lib = lib
        self._fr = lib.tsdr_file_reader_start(
            path.encode(), self.ring._h, 64 << 10, 1 if loop else 0
        )
        if not self._fr:
            raise FileNotFoundError(path)

    def __iter__(self):
        while True:
            blk = self.ring.read(self.block_bytes, self.dtype, self.timeout_ms)
            if blk is None:
                return
            yield blk

    def close(self) -> None:
        if self._fr:
            self._lib.tsdr_file_reader_stop(self._fr)
            self._fr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Deinterleave (pair-split) helpers with NumPy fallback
# ---------------------------------------------------------------------------


def deinterleave_to_planes(x: np.ndarray, scale: float | None = None):
    """Interleaved IQ scalars -> (re, im) float32 planes (one C pass)."""
    n = len(x) // 2
    lib = get_lib()
    if lib is None:
        xf = x.astype(np.float32)
        if scale is not None:
            xf *= scale
        return np.ascontiguousarray(xf[0::2]), np.ascontiguousarray(xf[1::2])
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    x = np.ascontiguousarray(x)
    if x.dtype == np.int8:
        lib.tsdr_deinterleave_i8(p(x), p(re), p(im), n, scale or (1.0 / 128.0))
    elif x.dtype == np.int16:
        lib.tsdr_deinterleave_i16(p(x), p(re), p(im), n, scale or (1.0 / 32768.0))
    elif x.dtype == np.float32:
        lib.tsdr_deinterleave_f32(p(x), p(re), p(im), n)
        if scale is not None:
            re *= scale
            im *= scale
    else:
        raise TypeError(f"unsupported dtype {x.dtype}")
    return re, im


def f32_to_i16(x: np.ndarray) -> np.ndarray:
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    out = np.empty(len(x), np.int16)
    lib.tsdr_f32_to_i16(
        x.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        len(x),
    )
    return out


if __name__ == "__main__":
    if "--build" in sys.argv:
        ok = build(quiet=False)
        print("native build:", "ok" if ok else "FAILED")
        sys.exit(0 if ok else 1)
    print("native available:", native_available())
