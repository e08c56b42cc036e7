"""ctypes binding for the native decode core (port of
``sota_imagenet_tpu/data/native.py``; C entry points in native/imgpipe.cpp
and native/pipeline.cpp, shared with the JAX package).

The C calls release the GIL, so a plain ThreadPoolExecutor gets real
multi-core decode, and ``BatchExecutor`` is a persistent C++ worker pool
that decodes a whole batch per call (the role DALI's C++ pipeline threads
played). The library is built at first use with ``make -C native`` into
``native/libimgpipe.so`` (it needs a C++ compiler and libjpeg's headers and
library). When the build or the load fails, ``available()`` is False and the
callers decode with PIL, as the JAX package does; the first load logs, once,
at warning level, which decoder this process uses and why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from sota_imagenet_tpu_torch.utils.logging import get_logger

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()  # load() races from decode pool threads otherwise

FILT_TRIANGULAR = 0
FILT_CUBIC = 1

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libimgpipe.so")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "ip_jpeg_dims": ([_U8P, ctypes.c_size_t, _INTP, _INTP], ctypes.c_int),
    "ip_decode_crop_resize": ([_U8P, ctypes.c_size_t] + [ctypes.c_int] * 7 + [_U8P], ctypes.c_int),
    "ip_decode_val": ([_U8P, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, _U8P], ctypes.c_int),
    "ip_decode_crop_scaled": ([_U8P, ctypes.c_size_t] + [ctypes.c_int] * 8 + [_U8P, _INTP, _INTP], ctypes.c_int),
    "pp_create": ([ctypes.c_int], ctypes.c_void_p),
    "pp_destroy": ([ctypes.c_void_p], None),
    "pp_submit": (
        [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
         ctypes.POINTER(ctypes.c_size_t), _INTP, _INTP, _U8P, ctypes.c_int, ctypes.c_int],
        ctypes.c_int,
    ),
    "pp_submit_scaled": (
        [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
         ctypes.POINTER(ctypes.c_size_t), _INTP, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, _INTP],
        ctypes.c_int,
    ),
    "pp_wait": ([ctypes.c_void_p, ctypes.c_uint64, _INTP], ctypes.c_int),
}


def _build() -> str:
    """One ``make -C native``; returns why it failed ('' if it ran clean)."""
    if not os.path.exists(os.path.join(NATIVE_DIR, "Makefile")):
        return f"no Makefile in {NATIVE_DIR}"
    try:
        out = subprocess.run(["make", "-C", NATIVE_DIR], capture_output=True, text=True, timeout=120, check=False)
    except (OSError, subprocess.SubprocessError) as e:
        return f"make could not run: {e}"
    if out.returncode:
        tail = (out.stderr or out.stdout).strip().splitlines()[-3:]
        return f"make -C native failed ({out.returncode}): {' | '.join(tail)}"
    return ""


def _load_locked() -> tuple:
    """(library or None, why): build when missing, then load and bind."""
    why = ""
    if not os.path.exists(LIB_PATH):
        why = _build()
    if not os.path.exists(LIB_PATH):
        return None, why or f"{LIB_PATH} was not built"
    try:
        lib = ctypes.CDLL(LIB_PATH)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    except (OSError, AttributeError) as e:  # unloadable, or built from older sources
        return None, f"{LIB_PATH} does not load: {e}"
    return lib, ""


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if _TRIED:  # lost the race: the winner already finished loading
            return _LIB
        lib, why = _load_locked()
        if lib is None:
            get_logger().warning(f"JPEG decode: PIL, because the native libjpeg core is unavailable ({why})")
        else:
            get_logger().warning(f"JPEG decode: the native libjpeg core ({LIB_PATH}); PIL for non-JPEG files")
        _LIB = lib  # publish BEFORE _TRIED: lock-free readers see the pair in order
        _TRIED = True
        return _LIB


def available() -> bool:
    return load() is not None


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), _U8P)


def _out_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def jpeg_dims(data: bytes):
    lib = load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.ip_jpeg_dims(_as_u8p(data), len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_crop_resize(
    data: bytes,
    crop: tuple,  # (x, y, w, h) in full-res coords; (0,0,0,0) = full image
    out_size: tuple,  # (w, h)
    filt: int = FILT_TRIANGULAR,
) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    out_w, out_h = out_size
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.ip_decode_crop_resize(_as_u8p(data), len(data), *crop[:4], out_w, out_h, filt, _out_ptr(out))
    return out if rc == 0 else None


def decode_crop_scaled(
    data: bytes,
    crop: tuple,  # (x, y, w, h) full-res coords; (0,0,0,0) = full image
    target: int,  # the final (device-side) resample size
    canvas: int,  # fixed output canvas (>= target), top-left anchored
) -> Optional[tuple]:
    """Host half of the device-resample split: DCT-scaled decode of the crop,
    no host resampling. Returns (img (canvas, canvas, 3) uint8, sh, sw)."""
    lib = load()
    if lib is None:
        return None
    out = np.empty((canvas, canvas, 3), np.uint8)
    sw, sh = ctypes.c_int(), ctypes.c_int()
    rc = lib.ip_decode_crop_scaled(
        _as_u8p(data), len(data), *crop[:4], target, target, canvas, canvas, _out_ptr(out),
        ctypes.byref(sw), ctypes.byref(sh),
    )
    return (out, sh.value, sw.value) if rc == 0 else None


def decode_val(data: bytes, resize_shorter: int, crop: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    out = np.empty((crop, crop, 3), np.uint8)
    rc = lib.ip_decode_val(_as_u8p(data), len(data), resize_shorter, crop, _out_ptr(out))
    return out if rc == 0 else None


class BatchExecutor:
    """Persistent C++ worker pool decoding whole batches with one call per
    batch (native/pipeline.cpp), the DALI-executor role. Supports
    double-buffering via (submit, wait) tickets. Not thread-safe: one thread
    submits and waits."""

    def __init__(self, workers: int = 8):
        lib = load()
        if lib is None:
            raise RuntimeError("libimgpipe.so not available")
        self._lib = lib
        self._handle = lib.pp_create(int(workers))
        self._ticket = 0
        self._inflight = {}  # ticket -> (out_array, keepalive refs, n)

    def _submit(self, submit_fn, datas, crops, *args, out, extra_keep=()):
        n = len(datas)
        ptrs = (ctypes.c_char_p * n)(*datas)
        lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
        crops_arr = np.ascontiguousarray(np.asarray(crops, np.int32)).reshape(-1)
        self._ticket += 1
        t = self._ticket
        rc = submit_fn(
            self._handle, t, n, ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)), lens,
            crops_arr.ctypes.data_as(_INTP), *args,
        )
        if rc != 0:
            raise RuntimeError(f"{submit_fn.__name__} failed: {rc}")
        # the C workers read these until wait(): keep them alive
        self._inflight[t] = (out, (datas, ptrs, lens, crops_arr, *extra_keep), n)
        return t

    def submit(self, datas, crops, filts, out_size) -> int:
        """datas: list[bytes]; crops: (n,4) int array-like; filts: (n,);
        out_size: (w, h). Returns a ticket. Non-blocking."""
        out_w, out_h = out_size
        out = np.empty((len(datas), out_h, out_w, 3), np.uint8)
        filts_arr = np.ascontiguousarray(np.asarray(filts, np.int32))
        return self._submit(
            self._lib.pp_submit, datas, crops, filts_arr.ctypes.data_as(_INTP), _out_ptr(out), out_w, out_h,
            out=out, extra_keep=(filts_arr,),
        )

    def submit_scaled(self, datas, crops, target: int, canvas: int) -> int:
        """Scaled-decode submit (device-resample split): each slot is a
        (canvas, canvas, 3) uint8 buffer holding the DCT-scaled crop top-left;
        wait_scaled() also returns the (n, 2) valid (h, w) extents."""
        out = np.empty((len(datas), canvas, canvas, 3), np.uint8)
        dims = np.empty((len(datas), 2), np.int32)
        return self._submit(
            self._lib.pp_submit_scaled, datas, crops, target, target, _out_ptr(out), canvas, canvas,
            dims.ctypes.data_as(_INTP), out=out, extra_keep=(dims,),
        )

    def _wait(self, ticket: int):
        out, keep, n = self._inflight.pop(ticket)
        fails = (ctypes.c_int * n)()
        nf = self._lib.pp_wait(self._handle, ticket, fails)
        if nf < 0:
            raise RuntimeError("pp_wait: unknown ticket")
        return out, [fails[i] for i in range(nf)], keep

    def wait(self, ticket: int):
        """Blocks; returns (images (n,h,w,3) uint8, failed_indices list)."""
        out, failed, _ = self._wait(ticket)
        return out, failed

    def wait_scaled(self, ticket: int):
        """Blocks; returns (images (n,canvas,canvas,3) uint8, failed list,
        dims (n,2) int32 = per-slot valid (h, w))."""
        out, failed, keep = self._wait(ticket)
        return out, failed, keep[-1]

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.pp_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
