"""ctypes bindings of the repository's native prefetching batch loader
(``native/libipdm_native.so``; port of the loader half of
ipdm_tpu/utils/native.py).

The library decodes the training stream's ``.npy`` files ahead of the
step in worker threads (native/ipdm_native.h: ``loader_create``,
``loader_next``, ``loader_destroy``). It is built with ``make -C native``
and is not part of a checkout: :func:`available` is False without it, and
the engine then reads its batches through ``data.sampler.DataLoader``, as
the JAX engine does. The CPU projector bindings of the JAX module come
with the exact physics.
"""

from __future__ import annotations

import ctypes as ct
from pathlib import Path
from typing import Sequence

import numpy as np

_LIB_PATH = (Path(__file__).resolve().parents[2] / "native"
             / "libipdm_native.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        raise OSError(f"native library not built: {_LIB_PATH} "
                      f"(run `make -C native`)")
    lib = ct.CDLL(str(_LIB_PATH))
    lib.loader_create.restype = ct.c_void_p
    lib.loader_create.argtypes = [ct.POINTER(ct.c_char_p), ct.c_int,
                                  ct.c_int64, ct.c_int64,
                                  ct.POINTER(ct.c_int64), ct.c_int64,
                                  ct.c_int, ct.c_int, ct.c_int]
    lib.loader_next.restype = ct.c_int
    lib.loader_next.argtypes = [ct.c_void_p, ct.POINTER(ct.c_float)]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ct.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library loads."""
    try:
        _load()
        return True
    except OSError:
        return False


class NativeLoader:
    """Prefetching batch loader over per-slice ``.npy`` files of one
    [H, W] shape: yields [b, H, W] f32 batches of ``paths[i]`` for the
    ``indices`` in order, ``batch`` at a time (the last may be short).

    One decode worker and the library's default queue depth: with
    several workers the library's in-order delivery can livelock
    (``loader_next`` waits for batch i while the full queue holds later
    batches and batch i's worker waits for room), which happens within a
    few hundred small loaders with two workers."""

    def __init__(self, paths: Sequence[str], H: int, W: int,
                 indices: Sequence[int], batch: int):
        lib = _load()
        self._lib = lib
        self.batch, self.H, self.W = batch, H, W
        # kept referenced while the native loader may read them
        self._paths = (ct.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._idx = np.ascontiguousarray(indices, np.int64)
        self._handle = lib.loader_create(
            self._paths, len(paths), H, W,
            self._idx.ctypes.data_as(ct.POINTER(ct.c_int64)), len(self._idx),
            batch, 1, 0)  # one worker; 0: the default depth
        if not self._handle:
            raise OSError("loader_create failed")
        self._buf = np.empty((batch, H, W), np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        n = self._lib.loader_next(self._handle, self._buf.ctypes.data_as(
            ct.POINTER(ct.c_float)))
        if n <= 0:
            raise StopIteration
        return self._buf[:n].copy()

    def close(self) -> None:
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
