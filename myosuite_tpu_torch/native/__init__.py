"""Native (C++) trace sink, built at first use with the host g++.

tracepack (`tracepack.cpp`, the JAX package's sink and file format):
`TracePackWriter` streams numpy arrays through a bounded queue that a
writer thread drains to disk; `read_tracepack` parses a file back into
{name: array}. The library is built into the git-ignored
`myosuite_tpu_torch/_build/`, named by the source's hash. Where no
compiler is found the writer writes the same format synchronously in
Python (`native_available()` says which one runs).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from typing import Dict, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "tracepack.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
MAGIC = b"MTPK1\x00"
_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.int8,
           np.uint16, np.float16]
_DTYPE_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}

_lib = None
_lib_tried = False


def build(force: bool = False) -> str:
  """Compile tracepack.cpp unless this source's library exists (or
  `force`); returns its path. Raises when g++ is missing or fails."""
  with open(SOURCE, "rb") as f:
    key = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                         ).hexdigest()[:16]
  lib = os.path.join(BUILD_DIR, f"libtracepack_{key}.so")
  if os.path.exists(lib) and not force:
    return lib
  gxx = shutil.which("g++")
  if gxx is None:
    raise RuntimeError("g++ not found")
  os.makedirs(BUILD_DIR, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  proc = subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
  os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
  return lib


def load(path: str) -> ctypes.CDLL:
  """The built library at `path`, its C interface declared for ctypes."""
  lib = ctypes.CDLL(path)
  lib.mtp_open.restype = ctypes.c_void_p
  lib.mtp_open.argtypes = [ctypes.c_char_p]
  lib.mtp_append.restype = ctypes.c_int
  lib.mtp_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint8, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_uint64),
                             ctypes.c_void_p, ctypes.c_uint64]
  lib.mtp_close.restype = ctypes.c_uint64
  lib.mtp_close.argtypes = [ctypes.c_void_p]
  lib.mtp_queued_bytes.restype = ctypes.c_uint64
  lib.mtp_queued_bytes.argtypes = [ctypes.c_void_p]
  return lib


def _library() -> Optional[ctypes.CDLL]:
  """The native sink, or None where it cannot be built (tried once)."""
  global _lib, _lib_tried
  if not _lib_tried:
    _lib_tried = True
    try:
      try:
        _lib = load(build())
      except OSError:   # a library another machine built: build it here
        _lib = load(build(force=True))
    except (OSError, RuntimeError):
      _lib = None
  return _lib


def native_available() -> bool:
  return _library() is not None


class TracePackWriter:
  """Streaming trace sink: native-threaded where the library builds, else
  synchronous Python writing the same bytes."""

  def __init__(self, path: str):
    self._lib = _library()
    self._h = self._f = None
    self._count = 0
    if self._lib is not None:
      self._h = self._lib.mtp_open(path.encode())
      if not self._h:
        raise OSError(f"mtp_open failed: {path}")
    else:
      self._f = open(path, "wb")
      self._f.write(MAGIC)

  def append(self, name: str, array) -> None:
    """Queue one record; the array is copied before this returns."""
    arr = np.ascontiguousarray(array)
    code = _DTYPE_CODE.get(arr.dtype)
    if code is None:
      arr = arr.astype(np.float32)
      code = _DTYPE_CODE[arr.dtype]
    if self._h is not None:
      shape = (ctypes.c_uint64 * arr.ndim)(*arr.shape)
      rc = self._lib.mtp_append(
          self._h, name.encode(), code, arr.ndim, shape,
          arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
      if rc != 0:
        raise OSError(f"mtp_append failed rc={rc}")
      return
    nm = name.encode()
    self._f.write(struct.pack("<I", len(nm)) + nm
                  + struct.pack("<BB", code, arr.ndim)
                  + struct.pack(f"<{arr.ndim}Q", *arr.shape)
                  + struct.pack("<Q", arr.nbytes))
    self._f.write(arr.tobytes())
    self._count += 1

  def close(self) -> int:
    """Drain and close; returns the records written."""
    if self._h is not None:
      n = self._lib.mtp_close(self._h)
      self._h = None
      return int(n)
    if self._f is not None:
      self._f.close()
      self._f = None
    return self._count

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def read_tracepack(path: str) -> Dict[str, np.ndarray]:
  """Parse a tracepack file; a repeated name gets a numeric suffix, and a
  truncated last record (a crash mid-write) is dropped."""
  out: Dict[str, np.ndarray] = {}
  with open(path, "rb") as f:
    if f.read(len(MAGIC)) != MAGIC:
      raise ValueError(f"{path} is not a tracepack file")
    while True:
      head = f.read(4)
      if len(head) < 4:
        break
      (name_len,) = struct.unpack("<I", head)
      name = f.read(name_len).decode()
      code, ndim = struct.unpack("<BB", f.read(2))
      shape = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
      (nbytes,) = struct.unpack("<Q", f.read(8))
      payload = f.read(nbytes)
      if len(payload) < nbytes:
        break
      arr = np.frombuffer(payload, dtype=_DTYPES[code]).reshape(shape)
      key, k = name, 1
      while key in out:
        key, k = f"{name}.{k}", k + 1
      out[key] = arr
  return out
