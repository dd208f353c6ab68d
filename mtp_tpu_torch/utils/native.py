"""ctypes loader for the repository's native host library
(`native/mtp_native.cc`; the port's copy of `mtp_tpu/utils/native.py`).

The source is compiled with `g++ -O3 -shared -fPIC` at the first call that
needs it (never at import) into `mtp_tpu_torch/_build/libmtp_native.so`, and
again when the source is newer.  The compile writes a temporary file and
renames it, so processes that build at once never load a partial library.
Every consumer has a numpy path, so the library speeds the host up and is
never required: without a compiler or the source, each function returns
None and one warning is logged.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "mtp_native.cc"
BUILD = Path(__file__).resolve().parents[1] / "_build"
LIB = BUILD / "libmtp_native.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_log = logging.getLogger(__name__)


def _build() -> Optional[str]:
    """Compile SRC into LIB; None on success, else why it failed."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libmtp_native.", suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        return repr(e)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built when missing or stale), or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    stale = LIB.exists() and SRC.exists() and \
        SRC.stat().st_mtime > LIB.stat().st_mtime
    why = None
    if (not LIB.exists() or stale) and SRC.exists():
        why = _build()
    if not LIB.exists():
        _log.warning("native host library unavailable (%s); using the numpy "
                     "paths", why or f"no source at {SRC}")
        return None
    lib = ctypes.CDLL(str(LIB))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rle_decode.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, u8p]
    lib.rle_encode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i64p,
                               ctypes.c_int64]
    lib.rle_encode.restype = ctypes.c_int64
    lib.rbox_iou.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p]
    lib.quad_iou.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p]
    lib.mask_iou_packed.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                                    ctypes.c_int64, u8p, f64p, f64p, f64p]
    _lib = lib
    return _lib


def rle_decode_native(counts: np.ndarray, h: int, w: int) -> Optional[np.ndarray]:
    """Column-major COCO run lengths → (h, w) uint8 mask, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode(np.ascontiguousarray(counts, np.int64), len(counts), h, w, out)
    return out


def rle_encode_native(mask: np.ndarray) -> Optional[list]:
    """(h, w) binary mask → its column-major run lengths, or None."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = mask.shape
    out = np.zeros(h * w + 2, np.int64)
    n = lib.rle_encode(np.ascontiguousarray(mask, np.uint8), h, w, out,
                       len(out))
    if n < 0:
        return None
    return out[:n].tolist()


def mask_iou_native(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray):
    """(ious (D,G) f64, d_areas, g_areas) from dense binary masks
    (D,H,W)/(G,H,W) via the packed-popcount C++ kernel, or None."""
    lib = get_lib()
    if lib is None:
        return None
    D, G = len(dt), len(gt)
    dp = np.packbits(dt.reshape(D, -1).astype(bool), axis=1)
    gp = np.packbits(gt.reshape(G, -1).astype(bool), axis=1)
    nbytes = dp.shape[1]
    pad = (-nbytes) % 8  # 8-byte rows: aligned whole-word popcounts
    if pad:
        dp = np.pad(dp, ((0, 0), (0, pad)))
        gp = np.pad(gp, ((0, 0), (0, pad)))
        nbytes += pad
    out = np.zeros((D, G), np.float64)
    da = np.zeros(D, np.float64)
    ga = np.zeros(G, np.float64)
    lib.mask_iou_packed(np.ascontiguousarray(dp), D,
                        np.ascontiguousarray(gp), G, nbytes,
                        np.ascontiguousarray(crowd, np.uint8), out, da, ga)
    return out, da, ga


def rbox_iou_native(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """(N,5)x(M,5) rotated IoU (float64 clipping, fp32 out), or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    out = np.zeros((len(a), len(b)), np.float32)
    if len(a) and len(b):
        lib.rbox_iou(a, len(a), b, len(b), out)
    return out


def quad_iou_native(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """(N,8)x(M,8) convex-quad IoU via the C++ clipping kernel, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    out = np.zeros((len(a), len(b)), np.float32)
    if len(a) and len(b):
        lib.quad_iou(a, len(a), b, len(b), out)
    return out
