"""Minimal native NIfTI-1 reader/writer (no nibabel dependency).

The port's own copy of ``vaegam_tpu.utils.nifti`` (that package imports
JAX); the two write and read the same bytes.

The reference uses nibabel for all volume I/O (DataClass_GP.py:48,
vae_reg_GP.py:618-620, build_model_recons.py:88,113-116, preprocessing
scripts).  This module provides the small API subset the pipeline needs:

    img = load(path)                      # .nii or .nii.gz
    arr = np.array(img.dataobj)           # scl_slope/inter applied when set
    img.affine, img.header
    save(Nifti1Image(arr, affine, header), path)

Implementation is a from-scratch NIfTI-1 (n+1 single-file) codec in pure
numpy: 348-byte header + 4-byte extension flag + Fortran-ordered voxels,
optional gzip container.  Round-trips with nibabel-written files (verified in
tests against hand-built headers).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

_HDR_SIZE = 348
_MAGIC_SINGLE = b"n+1\x00"

# NIfTI-1 datatype code <-> numpy dtype
_DTYPES = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
    1024: np.dtype(np.int64),
    1280: np.dtype(np.uint64),
}
_CODES = {v: k for k, v in _DTYPES.items()}


def _header_dtype(endian: str) -> np.dtype:
    e = endian
    return np.dtype(
        [
            ("sizeof_hdr", e + "i4"),
            ("data_type", "S10"),
            ("db_name", "S18"),
            ("extents", e + "i4"),
            ("session_error", e + "i2"),
            ("regular", "S1"),
            ("dim_info", "u1"),
            ("dim", e + "i2", (8,)),
            ("intent_p1", e + "f4"),
            ("intent_p2", e + "f4"),
            ("intent_p3", e + "f4"),
            ("intent_code", e + "i2"),
            ("datatype", e + "i2"),
            ("bitpix", e + "i2"),
            ("slice_start", e + "i2"),
            ("pixdim", e + "f4", (8,)),
            ("vox_offset", e + "f4"),
            ("scl_slope", e + "f4"),
            ("scl_inter", e + "f4"),
            ("slice_end", e + "i2"),
            ("slice_code", "u1"),
            ("xyzt_units", "u1"),
            ("cal_max", e + "f4"),
            ("cal_min", e + "f4"),
            ("slice_duration", e + "f4"),
            ("toffset", e + "f4"),
            ("glmax", e + "i4"),
            ("glmin", e + "i4"),
            ("descrip", "S80"),
            ("aux_file", "S24"),
            ("qform_code", e + "i2"),
            ("sform_code", e + "i2"),
            ("quatern_b", e + "f4"),
            ("quatern_c", e + "f4"),
            ("quatern_d", e + "f4"),
            ("qoffset_x", e + "f4"),
            ("qoffset_y", e + "f4"),
            ("qoffset_z", e + "f4"),
            ("srow_x", e + "f4", (4,)),
            ("srow_y", e + "f4", (4,)),
            ("srow_z", e + "f4", (4,)),
            ("intent_name", "S16"),
            ("magic", "S4"),
        ]
    )


class Nifti1Header:
    """Thin wrapper around the raw structured header record."""

    def __init__(self, rec: np.ndarray, endian: str):
        self._rec = rec
        self.endian = endian

    def __getitem__(self, key):
        return self._rec[key]

    def __setitem__(self, key, val):
        self._rec[key] = val

    def copy(self) -> "Nifti1Header":
        return Nifti1Header(self._rec.copy(), self.endian)

    @classmethod
    def default(cls) -> "Nifti1Header":
        rec = np.zeros((), dtype=_header_dtype("<"))
        rec["sizeof_hdr"] = _HDR_SIZE
        rec["regular"] = b"r"
        rec["dim"] = [1, 1, 1, 1, 1, 1, 1, 1]
        rec["pixdim"] = [1, 1, 1, 1, 1, 1, 1, 1]
        rec["vox_offset"] = 352.0
        rec["scl_slope"] = 1.0
        rec["magic"] = _MAGIC_SINGLE
        return cls(rec, "<")

    def get_best_affine(self) -> np.ndarray:
        """sform if present, else qform, else pixdim scaling."""
        rec = self._rec
        if rec["sform_code"] > 0:
            aff = np.eye(4)
            aff[0, :] = rec["srow_x"]
            aff[1, :] = rec["srow_y"]
            aff[2, :] = rec["srow_z"]
            return aff
        if rec["qform_code"] > 0:
            return self._qform_affine()
        aff = np.eye(4)
        aff[0, 0], aff[1, 1], aff[2, 2] = rec["pixdim"][1:4]
        return aff

    def _qform_affine(self) -> np.ndarray:
        rec = self._rec
        b, c, d = (float(rec[k]) for k in ("quatern_b", "quatern_c", "quatern_d"))
        a2 = max(0.0, 1.0 - b * b - c * c - d * d)
        a = np.sqrt(a2)
        R = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )
        pixdim = rec["pixdim"]
        qfac = -1.0 if pixdim[0] == -1 else 1.0
        scales = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        aff = np.eye(4)
        aff[:3, :3] = R * scales
        aff[:3, 3] = [rec["qoffset_x"], rec["qoffset_y"], rec["qoffset_z"]]
        return aff


class _ArrayProxy:
    """Lazy array handle mirroring nibabel's ``img.dataobj`` semantics."""

    def __init__(self, raw: np.ndarray, slope: float, inter: float):
        self._raw = raw
        self._slope = slope
        self._inter = inter

    def __array__(self, dtype=None, copy=None):
        arr = self._raw
        slope, inter = self._slope, self._inter
        if slope not in (0.0, 1.0) or inter != 0.0:
            if slope == 0.0:
                slope = 1.0
            arr = arr * np.float64(slope) + np.float64(inter)
        if dtype is not None:
            arr = np.asarray(arr, dtype=dtype)
        return arr

    @property
    def shape(self):
        return self._raw.shape

    @property
    def dtype(self):
        return self._raw.dtype


@dataclass
class Nifti1Image:
    """NIfTI-1 image: array + affine + header (nibabel-compatible subset)."""

    _data: np.ndarray
    affine: np.ndarray | None = None
    header: Nifti1Header | None = None

    def __post_init__(self):
        if self.header is None:
            self.header = Nifti1Header.default()
        else:
            self.header = self.header.copy()
        if self.affine is None:
            self.affine = self.header.get_best_affine()

    @property
    def dataobj(self):
        if isinstance(self._data, _ArrayProxy):
            return self._data
        return _ArrayProxy(self._data, 1.0, 0.0)

    @property
    def shape(self):
        return self._data.shape

    def get_fdata(self) -> np.ndarray:
        return np.array(self.dataobj, dtype=np.float64)


def _open_maybe_gz(path: str, mode: str):
    if str(path).endswith(".gz"):
        if "w" in mode:
            # compresslevel 1 matches nibabel's writer default (its Opener
            # gz_def_mb level); Python's gzip default of 9 is ~5-10x slower
            # on multi-GB 4D volumes for a few % size difference
            return gzip.open(path, mode, compresslevel=1)
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: str) -> Nifti1Image:
    """Load a .nii / .nii.gz file (single-file NIfTI-1)."""
    with _open_maybe_gz(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HDR_SIZE:
        raise ValueError(f"{path}: not a NIfTI-1 file (shorter than header)")
    hdr_le = np.frombuffer(blob[:_HDR_SIZE], dtype=_header_dtype("<"))[0]
    endian = "<"
    if int(hdr_le["sizeof_hdr"]) != _HDR_SIZE:
        endian = ">"
        hdr_be = np.frombuffer(blob[:_HDR_SIZE], dtype=_header_dtype(">"))[0]
        if int(hdr_be["sizeof_hdr"]) != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (bad sizeof_hdr)")
        rec = hdr_be.copy()
    else:
        rec = hdr_le.copy()
    header = Nifti1Header(rec, endian)

    ndim = int(rec["dim"][0])
    shape = tuple(int(d) for d in rec["dim"][1 : 1 + ndim])
    code = int(rec["datatype"])
    if code not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {code}")
    dtype = _DTYPES[code].newbyteorder(endian)
    offset = int(rec["vox_offset"])
    n = int(np.prod(shape)) if shape else 1
    raw = np.frombuffer(blob, dtype=dtype, count=n, offset=offset)
    raw = raw.reshape(shape, order="F")
    proxy = _ArrayProxy(raw, float(rec["scl_slope"]), float(rec["scl_inter"]))
    img = Nifti1Image(proxy, header.get_best_affine(), header)
    img._data = proxy
    return img


def encode_header(header: Nifti1Header | None, shape, dtype,
                  affine=None) -> bytes:
    """Serialize the 348-byte header + 4-byte extension pad for a write.

    Shared by :func:`save` and the native batch writer
    (utils.nifti_native.write_batch_f32) so both producers emit identical
    file bytes for the same (header, shape, dtype, affine).
    """
    hdr = (header or Nifti1Header.default()).copy()
    rec = np.zeros((), dtype=_header_dtype("<"))
    # copy all template fields over, then override geometry/dtype/scaling
    for name in rec.dtype.names:
        rec[name] = hdr._rec[name]
    rec["sizeof_hdr"] = _HDR_SIZE
    dim = np.ones(8, dtype=np.int16)
    dim[0] = len(shape)
    dim[1 : 1 + len(shape)] = shape
    rec["dim"] = dim
    rec["datatype"] = _CODES[np.dtype(dtype).newbyteorder("=")]
    rec["bitpix"] = np.dtype(dtype).itemsize * 8
    rec["vox_offset"] = 352.0
    rec["scl_slope"] = 1.0
    rec["scl_inter"] = 0.0
    rec["magic"] = _MAGIC_SINGLE
    if affine is not None:
        aff = np.asarray(affine, dtype=np.float64)
        rec["sform_code"] = max(1, int(rec["sform_code"]))
        rec["srow_x"] = aff[0, :]
        rec["srow_y"] = aff[1, :]
        rec["srow_z"] = aff[2, :]
    return rec.tobytes() + b"\x00\x00\x00\x00"


def save(img: Nifti1Image, path: str) -> None:
    """Write a single-file NIfTI-1 (.nii or .nii.gz)."""
    data = np.asarray(img._data.__array__() if isinstance(img._data, _ArrayProxy) else img._data)
    if data.dtype not in _CODES:
        data = data.astype(np.float64 if data.dtype.kind == "f" and data.dtype.itemsize > 4 else np.float32)
    # always write little-endian
    data_le = data.astype(data.dtype.newbyteorder("<"), copy=False)

    payload = (encode_header(img.header, data.shape, data_le.dtype.newbyteorder("="), img.affine)
               + data_le.flatten(order="F").tobytes())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)
