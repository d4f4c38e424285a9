"""Build and bind the hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all started together), and the objects are linked into ONE shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at the first CUDA launch (never at import: machines without ``nvcc``
import the package fine) and is cached under
``build/torch_kernels/<hash of the sources>/`` at the checkout root,
beside ``ptxas.log`` (each kernel's registers, shared memory and
spills).

Each C entry point takes raw device pointers, sizes and the CUDA stream,
launches on that stream, and returns ``cudaGetLastError()``; the Python
side raises on a non-zero code. Every kernel has one :class:`Kernel`
handle whose ``launches`` counter goes up by one per launch — a run can
show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every entry point: (argument types), all return int
# (a cudaError_t). The last argument of a launch is always the stream.
SIGNATURES: Dict[str, Sequence] = {
    # q, k, v, bias_h, bias_w, out, bh, n, side, has_bias, scale, hd, stream
    "rat_flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                            _P),
    # q, kvt, pe_kt, v_bias, out, b, n, d, m, heads, kv_shared, stream
    "rat_token_cross_kv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, kt, vt, out, b, n, d, m, heads, kv_shared, stream
    "rat_token_cross": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # qkv, bias_h, bias_w, out, b, n, side, heads, hd, scale, stream
    "rat_win_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # img, peq, tok_k, tok_v, w_q, b_q, w_out, b_out, ln_s, ln_b, w_kv,
    # keys, kvt, b, m, img_shared, eps, stream
    "rat_i2t_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _F, _P),
    # keys, up1_w, up1_b, ln_s, ln_b, up2_w, up2_b, hyper, out,
    # np, gg, content, n_masks, eps, n_ctas, stream
    "rat_mask_head": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _F, _I, _P),
    # logits, h_taps, w_taps, flags, rowst, colany, np, gh, g, n_masks,
    # h, w, thr-off, thr, thr+off, n_sm, stream
    "rat_resize_flags": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                         _F, _F, _I, _P),
    # q1st, tok_k, img0, p1, c1, peq2t, w_q, rows, out, b, m, layer, eps,
    # stream
    "rat_i2t_probs": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # q, img0, p1, c1, p2, c2, w_k, w_v, pekt, rows, v_bias, out, b, m,
    # depth, eps, stream
    "rat_t2i_probs": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _F, _P),
    # img0, p1, c1m, p2, c2m, rows, up1_w, up1_b, ln_s, ln_b, up2_w, up2_b,
    # hyper, out, np, gg, content, n_masks, eps, ln_eps, n_ctas, stream
    "rat_mask_head_probs": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _F, _F, _I, _P),
    # a pointer to one TailParams struct (ops.decode_fused), stream
    "rat_decode_tail": (_P, _P),
    "rat_decode_tail_logits": (_P, _P),
    # reports, no launch: dynamic shared memory of a CTA in bytes
    "rat_token_cross_smem": (_I, _I),           # pe, shared
    "rat_flash_attention_smem": (_I,),          # hd
    "rat_win_attention_smem": (_I, _I),         # side, hd
    "rat_mask_head_smem": (),
    "rat_i2t_update_smem": (),
    "rat_decode_tail_smem": (),
    "rat_i2t_probs_smem": (_I,),                # layer
    "rat_t2i_probs_smem": (_I,),                # depth
    "rat_resize_flags_smem": (_I, _I, _I),      # n_masks, w, h
    "rat_resize_flags_ctas": (_I, _I, _I),      # n_masks, w, h: CTAs an SM
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libratkernels.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, last_build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            t0 = time.perf_counter()
            _build(out)
            last_build_seconds = time.perf_counter() - t0
        else:
            last_build_seconds = 0.0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _build(out: Path) -> None:
    """One nvcc per source, all at once, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    procs = []
    for cu in sorted(_CSRC.glob("*.cu")):
        obj = out.parent / f"{cu.stem}.{tag}.o"
        procs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], False
    for obj, proc in procs:
        logs.append(proc.communicate()[0])
        failed |= proc.returncode != 0
    (out.parent / "ptxas.log").write_text("".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    tmp = out.with_suffix(f".{tag}.so")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *(str(obj) for obj, _ in procs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
    for obj, _ in procs:
        obj.unlink()


class Kernel:
    """One hand-written kernel: its C entry point and its launch count
    (counted under a lock, so it is exact when threads launch)."""

    _count_lock = threading.Lock()

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        self.name = name
        self.entry = entry
        self.source = source          # path in the repository
        self.replaces = replaces      # file:line of the TPU kernel
        self.launches = 0

    def launch(self, *args) -> None:
        """Call the C entry point on the current stream; raise on error."""
        fn = getattr(load(), self.entry)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError {err}")
        with Kernel._count_lock:
            self.launches += 1


_SRC = "revisit_anything_tpu_torch/kernels/csrc/"
FLASH_ATTENTION = Kernel(
    "flash_attention", "rat_flash_attention", _SRC + "flash_attention.cu",
    "revisit_anything_tpu/ops/attention.py:116")
TOKEN_CROSS = Kernel(
    "token_cross_attention", "rat_token_cross_kv", _SRC + "token_cross.cu",
    "revisit_anything_tpu/ops/attention.py:442")
I2T_UPDATE = Kernel(
    "i2t_update", "rat_i2t_update", _SRC + "i2t_update.cu",
    "revisit_anything_tpu/ops/attention.py:375")
MASK_HEAD = Kernel(
    "mask_head", "rat_mask_head", _SRC + "mask_head.cu",
    "revisit_anything_tpu/ops/maskhead.py:299")
RESIZE_FLAGS = Kernel(
    "resize_flags", "rat_resize_flags", _SRC + "resize_flags.cu",
    "revisit_anything_tpu/ops/maskresize.py:207")

I2T_PROBS = Kernel(
    "i2t_probs", "rat_i2t_probs", _SRC + "i2t_probs.cu",
    "revisit_anything_tpu/ops/decode_probs.py:179")
T2I_PROBS = Kernel(
    "t2i_from_probs", "rat_t2i_probs", _SRC + "t2i_probs.cu",
    "revisit_anything_tpu/ops/decode_probs.py:290")
MASK_HEAD_PROBS = Kernel(
    "mask_head_probs", "rat_mask_head_probs", _SRC + "mask_head.cu",
    "revisit_anything_tpu/ops/maskhead.py:257")
DECODE_TAIL = Kernel(
    "decode_tail", "rat_decode_tail", _SRC + "decode_tail.cu",
    "revisit_anything_tpu/ops/decode_fused.py:417")

DECODE_TAIL_LOGITS = Kernel(
    "decode_tail_logits", "rat_decode_tail_logits", _SRC + "decode_tail.cu",
    "revisit_anything_tpu/ops/decode_fused.py:417")
TOKEN_CROSS_SPLIT = Kernel(
    "token_cross_split", "rat_token_cross", _SRC + "token_cross.cu",
    "revisit_anything_tpu/ops/attention.py:178")
WIN_ATTENTION = Kernel(
    "win_attention", "rat_win_attention", _SRC + "win_attention.cu",
    "revisit_anything_tpu/ops/winattn.py:90")

KERNELS = (FLASH_ATTENTION, TOKEN_CROSS, I2T_UPDATE, MASK_HEAD, RESIZE_FLAGS,
           I2T_PROBS, T2I_PROBS, MASK_HEAD_PROBS, DECODE_TAIL,
           DECODE_TAIL_LOGITS, TOKEN_CROSS_SPLIT, WIN_ATTENTION)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def operand(name: str, t: torch.Tensor, dtype: torch.dtype,
            shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Validate a kernel operand before its pointer is handed to C.

    Raises on a tensor that is not on the card, has another dtype or
    shape; returns it contiguous and 32-byte aligned (the kernels load
    16-byte vectors and WMMA fragments straight from device memory),
    copying only when it is not already."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 32:
        t = t.clone()
    return t
