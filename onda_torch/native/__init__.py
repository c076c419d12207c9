"""ctypes bindings of the C++ host prep (`dataprep.cpp`, the port's own copy of
`onda_tpu/native`).

The source is compiled with `g++` at first use into
`build/onda_torch_native/libdataprep-<hash of the source>.so` at the
repository root: built under a temporary name and renamed into place, so that
processes building at once never load a half-written library. It links only
zlib's runtime. A failed build raises with the compiler's output; there is no
other data path to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("dataprep.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "onda_torch_native"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-l:libz.so.1", "-lpthread"]

ERRORS = {
    -1: "cannot open or read the file",
    -2: "not a PNG, or a truncated or inconsistent one",
    -3: "unsupported PNG (interlaced, or a label map that is not 8-bit gray or palette)",
    -4: "a label id outside the remap table",
    -5: "the image data does not inflate to the size its header gives",
    -6: "the decoded size differs from the buffer",
    -7: "the prep pool stopped before the batch was made",
}

_lock = threading.Lock()
_lib = None

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)
_c_uint8_p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "png_probe": (ctypes.c_int, [ctypes.c_char_p, _c_int_p, _c_int_p]),
    "decode_png": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, _c_uint8_p, ctypes.c_size_t]),
    "executor_create": (ctypes.c_void_p, [ctypes.c_int]),
    "executor_destroy": (None, [ctypes.c_void_p]),
    "executor_submit_images": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              _c_float_p, _c_float_p, _c_float_p]),
    "executor_submit_labels": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int, _c_int32_p,
                                              ctypes.c_int, _c_int32_p, _c_int32_p]),
    "executor_wait": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, _c_int_p]),
}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libdataprep-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library of this very source exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp, *LIBS]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"building the C++ data prep failed: {' '.join(cmd)}\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _out(arr: np.ndarray, shape, dtype) -> np.ndarray:
    """Check a destination buffer before C++ writes into it."""
    if arr.shape != tuple(shape) or arr.dtype != dtype or not arr.flags.c_contiguous \
            or not arr.flags.writeable:
        raise ValueError(f"destination must be a writable C-contiguous {np.dtype(dtype)} array "
                         f"of shape {tuple(shape)}, got {arr.dtype} {arr.shape}")
    return arr


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: {ERRORS.get(rc, f'error {rc}')}")


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(load().png_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)), path)
    return h.value, w.value


def decode_png(path: str, rgb: bool) -> np.ndarray:
    """The whole PNG: (H, W, 3) uint8 RGB, or (H, W) uint8 gray levels / palette indices."""
    h, w = png_size(path)
    out = np.empty((h, w, 3) if rgb else (h, w), np.uint8)
    _check(load().decode_png(path.encode(), int(rgb), _ptr(out, ctypes.c_uint8), out.nbytes), path)
    return out


def _paths(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


class BatchExecutor:
    """A pool of `workers` C++ threads that prepares whole batches.

    `submit_*` queues one task per file and returns at once; `wait` blocks,
    with the GIL released, until the job's buffers are filled, and raises
    naming the first file that failed. The caller keeps the destination
    arrays alive until it has waited."""

    def __init__(self, workers: int):
        self.workers = max(1, int(workers))
        self._lib = load()
        self._handle = self._lib.executor_create(self.workers)
        self._finalizer = weakref.finalize(self, self._lib.executor_destroy, self._handle)

    def close(self) -> None:
        self._finalizer()

    def submit_images(self, paths, out_hw, mean, std, dst: np.ndarray) -> int:
        """decode → bicubic resize to out_hw → BGR normalize into dst (N, 3, H, W) f32."""
        h, w = out_hw
        _out(dst, (len(paths), 3, h, w), np.float32)
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        return self._lib.executor_submit_images(
            self._handle, _paths(paths), len(paths), h, w, _ptr(mean, ctypes.c_float),
            _ptr(std, ctypes.c_float), _ptr(dst, ctypes.c_float))

    def submit_labels(self, paths, out_hw, res_hw, lut, full: np.ndarray, res: np.ndarray) -> int:
        """decode → nearest resize to out_hw and res_hw → LUT remap into full and res (int32)."""
        (h, w), (rh, rw) = out_hw, res_hw
        _out(full, (len(paths), h, w), np.int32)
        _out(res, (len(paths), rh, rw), np.int32)
        lut = np.ascontiguousarray(lut, np.int32)
        return self._lib.executor_submit_labels(
            self._handle, _paths(paths), len(paths), h, w, rh, rw, _ptr(lut, ctypes.c_int32),
            len(lut), _ptr(full, ctypes.c_int32), _ptr(res, ctypes.c_int32))

    def wait(self, job: int, paths) -> None:
        failed = ctypes.c_int(-1)
        rc = self._lib.executor_wait(self._handle, job, ctypes.byref(failed))
        if rc != 0:
            where = paths[failed.value] if 0 <= failed.value < len(paths) else f"job {job}"
            _check(rc, where)
