"""Host mask operations from the repository's C++ library
``native/maskops.cpp`` (counterpart of ``revisit_anything_tpu/native.py``:
``rle_encode`` :75, ``rle_decode`` :100, ``connected_components`` :119,
``remove_small_regions`` :140, ``nms_native`` :169).

The library is compiled with ``g++`` at the first call into
``build/torch_native/<hash of the source>/`` at the checkout root (never
at import, never beside the source) and bound with ``ctypes``. There is
no numpy fallback: a failed build raises. SAM's uncompressed RLE is
column-major, its first count the zeros; components are 8-connected.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_SRC = _ROOT / "native" / "maskops.cpp"
_BUILD_ROOT = _ROOT / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libmaskops.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; raise if g++
    fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            res = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o",
                                  str(tmp)], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("g++ failed on native/maskops.cpp:\n"
                                   + res.stdout + res.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        c_int, c_float = ctypes.c_int, ctypes.c_float
        for name, args, res_t in (
                ("rle_encode", [u8p, c_int, c_int, i32p], c_int),
                ("rle_decode", [i32p, c_int, c_int, c_int, u8p], None),
                ("connected_components", [u8p, c_int, c_int, i32p, i32p],
                 c_int),
                ("remove_small_regions", [u8p, c_int, c_int, c_int, c_int],
                 c_int),
                ("nms", [f32p, f32p, c_int, c_float, i32p], c_int)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res_t
        _lib = lib
        return lib


def rle_encode(mask: np.ndarray) -> dict:
    """Mask [H, W] (cast to uint8; nonzero = foreground) → {'size':
    [H, W], 'counts': [...]}: column-major runs, the first count the
    zeros."""
    h, w = mask.shape
    m = np.ascontiguousarray(mask.astype(np.uint8))
    counts = np.empty(h * w + 1, np.int32)
    n = load().rle_encode(m, h, w, counts)
    return {"size": [h, w], "counts": counts[:n].tolist()}


def rle_decode(rle: dict) -> np.ndarray:
    """SAM uncompressed RLE → bool [H, W]."""
    h, w = rle["size"]
    counts = np.ascontiguousarray(rle["counts"], dtype=np.int32)
    out = np.zeros((h, w), np.uint8)
    load().rle_decode(counts, len(counts), h, w, out)
    return out.astype(bool)


def connected_components(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """8-connected labels [H, W] int32 (0 background, 1..n in raster
    order of each component's first pixel) and areas [n + 1] (areas[0]
    is 0: the background is not counted)."""
    h, w = mask.shape
    m = np.ascontiguousarray(mask.astype(np.uint8))
    labels = np.zeros((h, w), np.int32)
    areas = np.zeros(h * w + 1, np.int32)
    n = load().connected_components(m, h, w, labels, areas)
    return labels, areas[:n + 1]


def remove_small_regions(mask: np.ndarray, area_thresh: int,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """SAM's small-region step (``utils/amg.py:267-300``): ``"holes"``
    fills background components below ``area_thresh``, ``"islands"``
    removes foreground ones (keeping the largest when every one is
    below it). Returns (mask bool, whether anything changed)."""
    if mode not in ("islands", "holes"):
        raise ValueError(f"mode {mode!r} is not 'islands' or 'holes'")
    m = np.ascontiguousarray(mask.astype(np.uint8))
    changed = load().remove_small_regions(m, m.shape[0], m.shape[1],
                                          int(area_thresh),
                                          1 if mode == "holes" else 0)
    return m.astype(bool), bool(changed)


def nms_native(boxes: np.ndarray, scores: np.ndarray,
               iou_thresh: float) -> np.ndarray:
    """Greedy box NMS over XYXY boxes [N, 4] (stable score-descending
    order): kept indices int64 in that order."""
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(len(b), np.int32)
    n = load().nms(b, s, len(b), float(iou_thresh), keep)
    return keep[:n].astype(np.int64)
