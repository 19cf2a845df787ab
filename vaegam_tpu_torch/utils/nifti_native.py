"""ctypes binding to the native NIfTI decoder (native/libvaegam_io.so).

The port's own copy of ``vaegam_tpu.utils.nifti_native`` (that package
imports JAX), bound to the same shared library in the repo's ``native/``.
Provides decode_f32(path) -> float32 ndarray (Fortran voxel order reshaped
to the header dims) and decode_many_f32(paths) for thread-pooled parallel
ingestion.  Falls back to the pure-numpy codec (``utils.nifti``), which
gives the same bytes, when the shared library is not built — build it with
``make -C native``; ``available()`` says which decoder runs.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

# default thread-pool width for batch writes
DEFAULT_WRITER_THREADS = min(8, (os.cpu_count() or 1) * 2)

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libvaegam_io.so"),
    "libvaegam_io.so",
]

_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.path.sep in p else p)
        except OSError:
            continue
        lib.vaegam_nifti_decode_f32.restype = ctypes.c_int
        lib.vaegam_nifti_decode_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.vaegam_nifti_decode_many_f32.restype = None
        lib.vaegam_nifti_decode_many_f32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
        ]
        try:
            write_fn = lib.vaegam_nifti_write_batch_f32
        except AttributeError:
            write_fn = None  # stale .so built before the writer existed
        if write_fn is not None:
            write_fn.restype = None
            write_fn.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
                ctypes.c_int,
            ]
        _lib = lib
        return lib
    return None


def available() -> bool:
    return _load_lib() is not None


def _probe_dims(lib, path: str) -> tuple:
    dims = (ctypes.c_int64 * 8)()
    rc = lib.vaegam_nifti_decode_f32(
        path.encode(), None, 0, dims
    )
    if rc != 0:
        raise ValueError(f"native nifti probe failed ({rc}): {path}")
    ndim = dims[0]
    return tuple(int(dims[1 + i]) for i in range(ndim))


def decode_f32(path: str) -> np.ndarray:
    """Decode one NIfTI (.nii/.nii.gz) to float32, shaped per its header."""
    lib = _load_lib()
    if lib is None:
        from . import nifti

        return np.asarray(nifti.load(path).dataobj, dtype=np.float32)
    shape = _probe_dims(lib, path)
    n = int(np.prod(shape))
    buf = np.empty(n, dtype=np.float32)
    rc = lib.vaegam_nifti_decode_f32(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        None,
    )
    if rc != 0:
        raise ValueError(f"native nifti decode failed ({rc}): {path}")
    return buf.reshape(shape, order="F")


def writer_available() -> bool:
    lib = _load_lib()
    return lib is not None and hasattr(lib, "vaegam_nifti_write_batch_f32")


def write_batch_f32(header: bytes, data: np.ndarray, shape, paths: List[str],
                    n_threads: int = 0) -> None:
    """Write n single-file .nii volumes with the native thread pool.

    ``header`` is the pre-encoded 352-byte header+pad (utils.nifti.
    encode_header — shared by all volumes in the flush), ``data`` a
    contiguous float32 (n, prod(shape)) array with each row C-ordered over
    ``shape``; the native side transposes to Fortran voxel order and writes
    header+payload, identical bytes to utils.nifti.save.  Falls back to the
    pure-Python writer when the library lacks the symbol.
    """
    d0, d1, d2 = (int(s) for s in shape)
    data = np.ascontiguousarray(data, dtype=np.float32)
    data = data.reshape(data.shape[0], -1) if data.ndim > 1 else data
    # the native side reads row i for every path i — validate on the host
    # so a caller mismatch raises instead of reading out of bounds in C++
    if data.ndim != 2 or data.shape[0] < len(paths) \
            or data.shape[1] != d0 * d1 * d2:
        raise ValueError(
            f"data {data.shape} cannot serve {len(paths)} volumes of "
            f"shape {(d0, d1, d2)}"
        )
    if not writer_available():
        for row, path in zip(data, paths):
            raw = header + row.astype("<f4").reshape(
                (d0, d1, d2)).flatten(order="F").tobytes()
            with open(path, "wb") as f:
                f.write(raw)
        return
    lib = _load_lib()
    n = len(paths)
    if n_threads <= 0:
        n_threads = DEFAULT_WRITER_THREADS
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_status = (ctypes.c_int * n)()
    lib.vaegam_nifti_write_batch_f32(
        header, len(header),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        d0, d1, d2, c_paths, c_status, n, n_threads,
    )
    bad = [(paths[i], int(c_status[i])) for i in range(n) if c_status[i] != 0]
    if bad:
        raise OSError(f"native nifti write failed: {bad[:3]}"
                      f"{' ...' if len(bad) > 3 else ''}")


def decode_many_f32(paths: List[str], n_threads: int = 0) -> List[np.ndarray]:
    """Decode several files in parallel (native thread pool)."""
    lib = _load_lib()
    if lib is None:
        return [decode_f32(p) for p in paths]
    if n_threads <= 0:
        n_threads = min(len(paths), os.cpu_count() or 1)
    shapes = [_probe_dims(lib, p) for p in paths]
    bufs = [np.empty(int(np.prod(s)), dtype=np.float32) for s in shapes]

    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for b in bufs]
    )
    c_elems = (ctypes.c_int64 * n)(*[b.size for b in bufs])
    c_status = (ctypes.c_int * n)()
    lib.vaegam_nifti_decode_many_f32(
        c_paths, c_outs, c_elems, None, c_status, n, n_threads
    )
    out = []
    for p, s, b, rc in zip(paths, shapes, bufs, c_status):
        if rc != 0:
            raise ValueError(f"native nifti decode failed ({rc}): {p}")
        out.append(b.reshape(s, order="F"))
    return out
