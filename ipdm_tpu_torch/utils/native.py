"""ctypes bindings of the repository's native library
(``native/libipdm_native.so``; port of ipdm_tpu/utils/native.py).

Two halves (native/ipdm_native.h):

* the prefetching batch loader, which decodes the training stream's
  ``.npy`` files ahead of the step in worker threads (``loader_create``,
  ``loader_next``, ``loader_destroy``);
* the CPU functions: ``.npy`` reading and an independent C++ fan-beam
  footprint projector pair, area LUT and OS-SART, the cross-check of
  the port's exact physics (``recon/projector.py``, ``recon/sart.py``).
  numpy in, numpy out, on the CPU.

The library is built with ``make -C native`` and is not part of a
checkout: :func:`available` is False without it, and the engine then
reads its batches through ``data.sampler.DataLoader``, as the JAX engine
does.
"""

from __future__ import annotations

import ctypes as ct
import os
from pathlib import Path
from typing import Sequence

import numpy as np

_LIB_PATH = (Path(__file__).resolve().parents[2] / "native"
             / "libipdm_native.so")
_lib = None


class FanGeomC(ct.Structure):
    """native/ipdm_native.h ``FanGeom``."""
    _fields_ = [("dso", ct.c_double), ("dsd", ct.c_double),
                ("nx", ct.c_int), ("ny", ct.c_int),
                ("dx", ct.c_double), ("dy", ct.c_double),
                ("offset_x", ct.c_double), ("offset_y", ct.c_double),
                ("nr", ct.c_int), ("dr", ct.c_double),
                ("offset_r", ct.c_double), ("na", ct.c_int),
                ("ta_dimx", ct.c_int), ("ta_dimy", ct.c_int)]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        raise OSError(f"native library not built: {_LIB_PATH} "
                      f"(run `make -C native`)")
    lib = ct.CDLL(str(_LIB_PATH))
    f32p = ct.POINTER(ct.c_float)
    lib.npy_read_f32.restype = ct.c_int
    lib.npy_read_f32.argtypes = [ct.c_char_p, f32p, ct.c_int64]
    lib.loader_create.restype = ct.c_void_p
    lib.loader_create.argtypes = [ct.POINTER(ct.c_char_p), ct.c_int,
                                  ct.c_int64, ct.c_int64,
                                  ct.POINTER(ct.c_int64), ct.c_int64,
                                  ct.c_int, ct.c_int, ct.c_int]
    lib.loader_next.restype = ct.c_int
    lib.loader_next.argtypes = [ct.c_void_p, f32p]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ct.c_void_p]
    gp = ct.POINTER(FanGeomC)
    for name, argtypes in (
            ("make_area_lut", [gp, f32p]),
            ("fp_project", [gp, f32p, f32p, f32p, f32p, ct.c_int]),
            ("bp_project", [gp, f32p, f32p, f32p, f32p, ct.c_int]),
            ("sart_reconstruct", [gp, f32p, f32p, f32p, f32p, ct.c_int,
                                  ct.c_int, ct.c_int, ct.c_int])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = argtypes
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library loads."""
    try:
        _load()
        return True
    except OSError:
        return False


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_float))


def _geom_c(geom) -> FanGeomC:
    """The port's ``recon.geometry.FanBeamGeometry`` as the C struct (a
    copy)."""
    return FanGeomC(dso=geom.dso, dsd=geom.dsd, nx=geom.nx, ny=geom.ny,
                    dx=geom.dx, dy=geom.dy, offset_x=geom.offset_x,
                    offset_y=geom.offset_y, nr=geom.nr, dr=geom.dr,
                    offset_r=geom.offset_r, na=geom.na,
                    ta_dimx=geom.ta_dimx, ta_dimy=geom.ta_dimy)


def _threads(n_threads: int) -> int:
    return n_threads or (os.cpu_count() or 1)


def _checked(a, shape, name: str) -> np.ndarray:
    a = _f32(a)
    if a.shape != tuple(shape):
        raise ValueError(f"{name} has shape {a.shape}, expected "
                         f"{tuple(shape)}")
    return a


def npy_read(path: str, shape) -> np.ndarray:
    """The ``.npy`` file at ``path`` (f32, f64, u8/u16, i16/i32; C or
    Fortran order) as an f32 array of ``shape``."""
    lib = _load()
    out = np.empty(int(np.prod(shape)), np.float32)
    rc = lib.npy_read_f32(str(path).encode(), _ptr(out), out.size)
    if rc != 0:
        raise IOError(f"npy_read_f32({path}) failed: {rc}")
    return out.reshape(shape)


def area_lut_native(geom) -> np.ndarray:
    """The footprint area LUT [ta_dimy, ta_dimx] (``recon.geometry.
    area_lut``'s table, computed by the library)."""
    lib = _load()
    g = _geom_c(geom)
    out = np.empty((geom.ta_dimy, geom.ta_dimx), np.float32)
    lib.make_area_lut(ct.byref(g), _ptr(out))
    return out


def fp_project_native(x, geom, lut, betas_deg,
                      n_threads: int = 0) -> np.ndarray:
    """Sinogram [na, nr] of the image x [ny, nx] at the view angles
    ``betas_deg``; ``n_threads`` 0 = one per core."""
    lib = _load()
    g = _geom_c(geom)
    x = _checked(x, (geom.ny, geom.nx), "x")
    lut = _checked(lut, (geom.ta_dimy, geom.ta_dimx), "lut")
    betas = _checked(betas_deg, (geom.na,), "betas_deg")
    out = np.empty((geom.na, geom.nr), np.float32)
    lib.fp_project(ct.byref(g), _ptr(lut), _ptr(betas), _ptr(x), _ptr(out),
                   _threads(n_threads))
    return out


def bp_project_native(proj, geom, lut, betas_deg,
                      n_threads: int = 0) -> np.ndarray:
    """The footprint backprojection [ny, nx] of a sinogram [na, nr]."""
    lib = _load()
    g = _geom_c(geom)
    proj = _checked(proj, (geom.na, geom.nr), "proj")
    lut = _checked(lut, (geom.ta_dimy, geom.ta_dimx), "lut")
    betas = _checked(betas_deg, (geom.na,), "betas_deg")
    out = np.empty((geom.ny, geom.nx), np.float32)
    lib.bp_project(ct.byref(g), _ptr(lut), _ptr(betas), _ptr(proj),
                   _ptr(out), _threads(n_threads))
    return out


def sart_reconstruct_native(proj, geom, lut, betas_deg, nstart: int = 10,
                            ntv: int = 0, nsubsets: int = 40,
                            n_threads: int = 0) -> np.ndarray:
    """OS-SART [ny, nx] of a sinogram [na, nr]: ``nstart`` sweeps of
    ``nsubsets`` subsets, ``ntv`` TV steps after each sweep."""
    lib = _load()
    g = _geom_c(geom)
    proj = _checked(proj, (geom.na, geom.nr), "proj")
    lut = _checked(lut, (geom.ta_dimy, geom.ta_dimx), "lut")
    betas = _checked(betas_deg, (geom.na,), "betas_deg")
    out = np.empty((geom.ny, geom.nx), np.float32)
    lib.sart_reconstruct(ct.byref(g), _ptr(lut), _ptr(betas), _ptr(proj),
                         _ptr(out), nstart, ntv, nsubsets,
                         _threads(n_threads))
    return out


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
