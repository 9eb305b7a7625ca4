"""JPEG decoding of the port: the counterpart of `_decode_image` in
`occnet_tpu/data/nuscenes.py`, which decodes with
`tf.io.decode_jpeg(data, channels=3)`.

TensorFlow's default there is libjpeg-turbo's fast integer IDCT
(`JDCT_IFAST`) with fancy upsampling; PIL decodes with the accurate integer
IDCT (`JDCT_ISLOW`) and cannot be told otherwise, and its pixels differ from
TensorFlow's by up to 6 levels on about 70 % of the pixels of a quality-90
image.  One level moves every logit, so the port carries its own decoder,
`csrc/jpeg_decode.cc`, written to libjpeg-turbo's IFAST arithmetic: the
same file gives TensorFlow's pixels bit for bit.  It decodes baseline
(sequential Huffman) 8-bit JPEG with 1 or 3 components, 4:4:4 / 4:2:2 /
4:2:0 sampling and restart markers; anything else raises `ValueError`.

The decoder runs on the host on every machine, as the JAX package's does.
It is built at first use (never at import) by the host C++ compiler into
`csrc/build/` (git-ignored), keyed by a hash of the source and flags, and
bound with ctypes, which releases the GIL for the call, so a loader's
threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCE = os.path.join(_CSRC, "jpeg_decode.cc")
BUILD_DIR = os.path.join(_CSRC, "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler (c++ / g++, or set CXX): the "
                       "JPEG decoder of occnet_tpu_torch is built at first "
                       "use")


def library() -> ctypes.CDLL:
    """Build (if needed) and load the decoder; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as f:
            src = f.read()
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src)
        so = os.path.join(BUILD_DIR,
                          f"libocc_jpeg_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [_compiler(), *CXX_FLAGS, SOURCE, "-o", tmp]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                                   f"{(res.stdout + res.stderr)[-4000:]}")
            os.replace(tmp, so)    # atomic: another process never sees a
        lib = ctypes.CDLL(so)      # half-written library
        lib.occ_jpeg_size.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.occ_jpeg_size.restype = ctypes.c_int
        lib.occ_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
        lib.occ_jpeg_decode.restype = ctypes.c_int
        _lib = lib
        return lib


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, the pixels of
    `tf.io.decode_jpeg(data, channels=3)`.  Raises ValueError on a file
    outside the decoder's scope or a corrupt one."""
    lib = library()
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.occ_jpeg_size(data, len(data), ctypes.byref(h), ctypes.byref(w),
                         err, len(err)):
        raise ValueError(f"JPEG: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.occ_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                           err, len(err)):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
