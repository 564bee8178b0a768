"""TensorFile: the numpy-exchange tensor container (reference:
include/mitsuba/core/tensor.h, src/libcore/tensor.cpp; counterpart of
``mitsuba2_tpu.utils.tensorfile``, byte for byte): the 'tensor_file'
magic, version 1.0, then per field its name, rank, dtype, offset and
shape, then the fields' data."""

from __future__ import annotations

import struct as _struct

import numpy as np

# Struct::Type enum order (include/mitsuba/core/struct.h)
_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.int64, 8: np.uint64,
    9: np.float16, 10: np.float32, 11: np.float64,
}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


class TensorFile:
    """Read-only view of a tensor_file container; fields load as numpy."""

    def __init__(self, filename: str):
        self.fields: dict[str, np.ndarray] = {}
        with open(filename, "rb") as f:
            header = f.read(12)
            if header != b"tensor_file\x00":
                raise ValueError(f"{filename}: not a tensor_file")
            f.read(2)  # version
            (n_fields,) = _struct.unpack("<I", f.read(4))
            metas = []
            for _ in range(n_fields):
                (name_len,) = _struct.unpack("<H", f.read(2))
                name = f.read(name_len).decode()
                (ndim,) = _struct.unpack("<H", f.read(2))
                (dtype,) = _struct.unpack("<B", f.read(1))
                (offset,) = _struct.unpack("<Q", f.read(8))
                shape = _struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
                metas.append((name, dtype, offset, shape))
            data = f.read()
            base = f.tell() - len(data)
            for name, dtype, offset, shape in metas:
                dt = np.dtype(_DTYPES[dtype])
                count = int(np.prod(shape)) if shape else 1
                start = offset - base
                arr = np.frombuffer(
                    data[start:start + count * dt.itemsize], dt)
                self.fields[name] = arr.reshape(shape)

    def has_field(self, name: str) -> bool:
        return name in self.fields

    def field(self, name: str) -> np.ndarray:
        return self.fields[name]


def write_tensor_file(filename: str, fields: dict[str, np.ndarray]):
    """Writes ``fields`` in the layout ``TensorFile`` reads (for tests and
    exporting)."""
    metas = []
    header_size = 12 + 2 + 4
    meta_size = 0
    items = [(k, np.ascontiguousarray(v)) for k, v in fields.items()]
    for name, arr in items:
        meta_size += 2 + len(name.encode()) + 2 + 1 + 8 + 8 * arr.ndim
    offset = header_size + meta_size
    for name, arr in items:
        metas.append((name, arr, offset))
        offset += arr.nbytes
    with open(filename, "wb") as f:
        f.write(b"tensor_file\x00")
        f.write(bytes([1, 0]))
        f.write(_struct.pack("<I", len(items)))
        for name, arr, off in metas:
            nb = name.encode()
            f.write(_struct.pack("<H", len(nb)))
            f.write(nb)
            f.write(_struct.pack("<H", arr.ndim))
            f.write(_struct.pack("<B", _DTYPE_IDS[arr.dtype]))
            f.write(_struct.pack("<Q", off))
            f.write(_struct.pack(f"<{arr.ndim}Q", *arr.shape))
        for name, arr, off in metas:
            f.write(arr.tobytes())
