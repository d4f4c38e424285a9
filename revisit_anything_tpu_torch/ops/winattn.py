"""Windowed attention kernel B11: one ViTDet window's whole multi-head
attention with SAM's decomposed rel-pos bias, beside its plain PyTorch
version.

Counterpart of ``revisit_anything_tpu/ops/winattn.py`` ``windowed_attend``
(:112; kernel body ``_win_attn_kernel`` :45). The kernel reads the raw qkv
projection and the q-projected bias components in place: no split,
permute or copy on the torch side. It runs in bf16 or in f32 (an f32 SAM,
the JAX package's default dtype: products in split TF32 on the tensor
cores, entry ``rat_win_attention_f32``). A wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel of the
operands' dtype or raises.
"""

from __future__ import annotations

import math

import torch

from revisit_anything_tpu_torch.kernels.build import (WIN_ATTENTION,
                                                      WIN_ATTENTION_F32,
                                                      operand)
from revisit_anything_tpu_torch.ops.attention import kernel_dtype

# the kernel takes every square window below 1024 tokens (side ≤ 31),
# as many as the encoder's "kernel" rule sends it
MAX_TOKENS = 1023


def windowed_attend_reference(qkv: torch.Tensor, bias_h: torch.Tensor,
                              bias_w: torch.Tensor, heads: int,
                              side: int) -> torch.Tensor:
    """Plain version of :func:`windowed_attend`: scores, bias sum and
    softmax in f32, the probabilities rounded to qkv's dtype before the
    value product (as the TPU kernel rounds them)."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // heads
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, hd)
               .transpose(1, 2).float() for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)  # [B, H, N, N]
    bh = bias_h.reshape(b, n, heads, side).transpose(1, 2).float()
    bw = bias_w.reshape(b, n, heads, side).transpose(1, 2).float()
    # bias[n, kh·side + kw] = bh[n, kh] + bw[n, kw]
    s = s + (bh.repeat_interleave(side, dim=-1) + bw.repeat(1, 1, 1, side))
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    out = torch.matmul(p, v)                                   # [B, H, N, hd]
    return out.transpose(1, 2).reshape(b, n, d).to(qkv.dtype)


def windowed_attend(qkv: torch.Tensor, bias_h: torch.Tensor,
                    bias_w: torch.Tensor, heads: int,
                    side: int) -> torch.Tensor:
    """Multi-head self-attention over every window of a ViTDet windowed
    layer.

    qkv [B, N, 3·D] the raw qkv projection (B windows of N = side²
    tokens; head h's q, k, v at channels h·hd, D + h·hd, 2·D + h·hd);
    bias_h, bias_w [B, N, heads·side] the q-projected decomposed rel-pos
    bias in head-major channels (channel h·side + kh). Returns [B, N, D].

    CUDA: kernel B11 by qkv's dtype, bf16 or f32 (head dim 64 or 80, N ≤
    1023; f32: products in split TF32 on the tensor cores, as accurate as
    f32); other dtypes raise. CPU: :func:`windowed_attend_reference`."""
    b, n, three_d = qkv.shape
    if n != side * side or three_d % (3 * heads):
        raise ValueError(f"windowed attention: N={n}, side={side}, "
                         f"3·D={three_d}, heads={heads} do not fit")
    if not qkv.is_cuda:
        return windowed_attend_reference(qkv, bias_h, bias_w, heads, side)
    d = three_d // 3
    hd = d // heads
    if hd not in (64, 80) or n > MAX_TOKENS:
        raise ValueError(f"windowed attention: head dim {hd}, N={n} not "
                         f"built (64 or 80, N <= {MAX_TOKENS})")
    dt = kernel_dtype("windowed attention", qkv)
    x = operand("qkv", qkv, dt, (b, n, three_d))
    bh = operand("bias_h", bias_h, dt, (b, n, heads * side))
    bw = operand("bias_w", bias_w, dt, (b, n, heads * side))
    out = torch.empty((b, n, d), dtype=dt, device=qkv.device)
    (WIN_ATTENTION_F32 if dt == torch.float32 else WIN_ATTENTION).launch(
        x.data_ptr(), bh.data_ptr(), bw.data_ptr(), out.data_ptr(), b, n,
        side, heads, hd, 1.0 / math.sqrt(hd))
    return out
