"""Streams (parity: include/mitsuba/core/stream.h:32 and fstream, mstream,
zstream and dstream; ``mitsuba2_tpu.core.stream``): the serialization
substrate under ``.serialized`` meshes and cache files. Typed reads and
writes with explicit little-endian layouts; numpy handles the bulk
conversions the reference's StructConverter compiled at run time.
"""

from __future__ import annotations

import io
import struct as _struct
import zlib

import numpy as np

_FMT = {"u8": "<B", "i8": "<b", "u16": "<H", "i16": "<h",
        "u32": "<I", "i32": "<i", "u64": "<Q", "i64": "<q",
        "f32": "<f", "f64": "<d"}


class Stream:
    """Abstract seekable byte stream with typed accessors (stream.h:32)."""

    can_read = True
    can_write = True

    # -- raw interface (implemented by subclasses) -------------------------
    def read(self, n: int) -> bytes:
        raise NotImplementedError

    def write(self, data: bytes) -> int:
        raise NotImplementedError

    def seek(self, pos: int):
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def flush(self):
        pass

    def close(self):
        pass

    # -- typed accessors ----------------------------------------------------
    def _get(self, code):
        fmt = _FMT[code]
        return _struct.unpack(fmt, self.read(_struct.calcsize(fmt)))[0]

    def _put(self, code, v):
        self.write(_struct.pack(_FMT[code], v))

    def read_u8(self): return self._get("u8")
    def read_u16(self): return self._get("u16")
    def read_u32(self): return self._get("u32")
    def read_u64(self): return self._get("u64")
    def read_i32(self): return self._get("i32")
    def read_i64(self): return self._get("i64")
    def read_f32(self): return self._get("f32")
    def read_f64(self): return self._get("f64")
    def write_u8(self, v): self._put("u8", v)
    def write_u16(self, v): self._put("u16", v)
    def write_u32(self, v): self._put("u32", v)
    def write_u64(self, v): self._put("u64", v)
    def write_i32(self, v): self._put("i32", v)
    def write_i64(self, v): self._put("i64", v)
    def write_f32(self, v): self._put("f32", v)
    def write_f64(self, v): self._put("f64", v)

    def read_string(self) -> str:
        """Zero-terminated string (stream.h readLine-style)."""
        out = bytearray()
        while True:
            b = self.read(1)
            if not b or b == b"\0":
                return out.decode("utf-8")
            out += b

    def write_string(self, s: str):
        self.write(s.encode("utf-8") + b"\0")

    def read_array(self, dtype, count) -> np.ndarray:
        dtype = np.dtype(dtype).newbyteorder("<")
        return np.frombuffer(self.read(dtype.itemsize * count),
                             dtype=dtype).copy()

    def write_array(self, arr):
        arr = np.asarray(arr)
        self.write(arr.astype(arr.dtype.newbyteorder("<"),
                              copy=False).tobytes())


class FStream(Stream):
    """File-backed stream (fstream.h)."""

    def __init__(self, filename: str, mode: str = "rb"):
        self._f = open(filename, mode)
        self.can_read = "r" in mode or "+" in mode
        self.can_write = "w" in mode or "a" in mode or "+" in mode
        self.filename = filename

    def read(self, n): return self._f.read(n)
    def write(self, d): return self._f.write(d)
    def seek(self, p): self._f.seek(p)
    def tell(self): return self._f.tell()
    def flush(self): self._f.flush()
    def close(self): self._f.close()

    def size(self):
        pos = self._f.tell()
        self._f.seek(0, 2)
        n = self._f.tell()
        self._f.seek(pos)
        return n


class MemoryStream(Stream):
    """Growable in-memory stream (mstream.h)."""

    def __init__(self, data: bytes = b""):
        self._b = io.BytesIO(data)

    def read(self, n): return self._b.read(n)
    def write(self, d): return self._b.write(d)
    def seek(self, p): self._b.seek(p)
    def tell(self): return self._b.tell()
    def size(self): return len(self._b.getvalue())
    def raw(self) -> bytes: return self._b.getvalue()


class ZStream(Stream):
    """zlib deflate wrapper around a child stream (zstream.h) — the
    reference uses it for the compressed payloads of .serialized files."""

    def __init__(self, child: Stream, mode: str = "r", level: int = 6):
        self.child = child
        self.mode = mode
        if mode == "r":
            self._dec = zlib.decompressobj()
            self._buf = b""
        else:
            self._comp = zlib.compressobj(level)

    def read(self, n):
        while len(self._buf) < n:
            chunk = self.child.read(16384)
            if not chunk:
                self._buf += self._dec.flush()
                break
            self._buf += self._dec.decompress(chunk)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def write(self, d):
        self.child.write(self._comp.compress(d))
        return len(d)

    def flush(self):
        if self.mode != "r":
            self.child.write(self._comp.flush(zlib.Z_SYNC_FLUSH))
        self.child.flush()

    def close(self):
        if self.mode != "r":
            self.child.write(self._comp.flush())
        self.child.flush()

    def tell(self): return self.child.tell()
    def size(self): return self.child.size()

    def seek(self, p):
        raise IOError("ZStream does not support seeking")


class DummyStream(Stream):
    """Counts bytes without storing them (dstream.h) — used to size
    serialized records before writing."""

    def __init__(self):
        self._n = 0

    def write(self, d):
        self._n += len(d)
        return len(d)

    def read(self, n):
        raise IOError("DummyStream is write-only")

    def seek(self, p): self._n = p
    def tell(self): return self._n
    def size(self): return self._n
