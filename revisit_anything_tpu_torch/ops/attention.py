"""Attention kernels K1 (flash attention), K2 (token→image cross
attention), B10 (the same without pe and v bias, on separate kᵀ and vᵀ)
and K5 (fused image→token update), each beside its plain PyTorch version;
each in bf16 and in f32 (an f32 SAM, the JAX package's default).

Counterpart of ``revisit_anything_tpu/ops/attention.py`` (``attend``
:561, ``token_cross_attend_kv`` :467, ``token_cross_attend`` :200,
``i2t_update`` :489). A wrapper
takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from revisit_anything_tpu_torch.kernels.build import (
    FLASH_ATTENTION, FLASH_ATTENTION_F32, FLASH_ATTENTION_F32_BIAS,
    I2T_UPDATE, I2T_UPDATE_F32, TOKEN_CROSS, TOKEN_CROSS_F32,
    TOKEN_CROSS_SPLIT, TOKEN_CROSS_SPLIT_F32, operand)


def i2t_f32_scratch(device: torch.device) -> int:
    """Floats of K5 f32's scratch on ``device`` (the built library's
    ``rat_i2t_update_f32_scratch(SMs)``): Wqᵀ, Woutᵀ and Wkvᵀ as TF32 hi
    and lo planes, then q at layer 1, 64 KB a persistent CTA (one an SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 2 * (256 * 128 + 128 * 256 + 256 * 256) + sms * 2 * 64 * 128


def kernel_dtype(what: str, t: torch.Tensor) -> torch.dtype:
    """The dtype a CUDA operand picks a kernel by: bf16 or f32; raises on
    any other."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: {t.dtype} not built (bfloat16, float32)")
    return t.dtype


def attend_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_h: Optional[torch.Tensor] = None,
                     bias_w: Optional[torch.Tensor] = None,
                     side: int = 0) -> torch.Tensor:
    """Plain version of :func:`attend`: f32 scores and softmax, the
    probabilities rounded to v's dtype before the value product (as the
    TPU kernel rounds them)."""
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
    if bias_h is not None:
        # bias[q, kh·side + kw] = bias_h[q, kh] + bias_w[q, kw]
        s = s + (bias_h.float().repeat_interleave(side, dim=-1)
                 + bias_w.float().repeat(1, 1, 1, side))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias_h: Optional[torch.Tensor] = None,
           bias_w: Optional[torch.Tensor] = None,
           side: int = 0) -> torch.Tensor:
    """softmax(q·kᵀ/√Dh + bias)·v over [B, H, N, Dh] with the optional
    decomposed rel-pos bias bias_h/bias_w [B, H, N, side]
    (bias[q, k] = bias_h[q, k // side] + bias_w[q, k % side], N = side²).

    CUDA: kernel K1 by q's dtype, bf16 or f32 (Dh 64 or 80, side <= 64;
    f32: products in split TF32 on the tensor cores, as accurate as f32,
    entries ``rat_flash_attention_f32`` and, with the bias,
    ``rat_flash_attention_f32_bias``); other dtypes raise. K1 has no
    backward (the TPU kernel has none either): a call under grad mode
    with an input that requires grad raises, so a gradient is never cut
    off silently. CPU: :func:`attend_reference`."""
    if not q.is_cuda:
        return attend_reference(q, k, v, bias_h, bias_w, side)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, bias_h, bias_w)):
        raise RuntimeError("flash attention (K1) has no backward, as the "
                           "TPU kernel has none: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    b, h, n, dh = q.shape
    if dh not in (64, 80):
        raise ValueError(f"flash attention: head dim {dh} not built "
                         "(64, 80)")
    shape = (b, h, n, dh)
    dt = kernel_dtype("flash attention", q)
    qf = operand("q", q, dt, shape)
    kf = operand("k", k, dt, shape)
    vf = operand("v", v, dt, shape)
    has_bias = bias_h is not None
    if has_bias:
        if side * side != n or side > 64:
            raise ValueError(f"bias needs N == side² and side <= 64 (N={n}, "
                             f"side={side})")
        bh = operand("bias_h", bias_h, dt, (b, h, n, side))
        bw = operand("bias_w", bias_w, dt, (b, h, n, side))
    out = torch.empty_like(qf)
    if dt == torch.float32:
        # the kernel's K/V split: K's TF32 hi and lo planes, then Vᵀ's
        # over n rounded up to 64 keys
        n_pad = -(-n // 64) * 64
        scratch = torch.empty(2 * b * h * dh * (n + n_pad),
                              dtype=torch.float32, device=q.device)
        scale = 1.0 / math.sqrt(dh)
        if has_bias:
            FLASH_ATTENTION_F32_BIAS.launch(
                qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), bh.data_ptr(),
                bw.data_ptr(), out.data_ptr(), scratch.data_ptr(), b * h, n,
                side, scale, dh)
        else:
            FLASH_ATTENTION_F32.launch(qf.data_ptr(), kf.data_ptr(),
                                       vf.data_ptr(), out.data_ptr(),
                                       scratch.data_ptr(), b * h, n, scale,
                                       dh)
        return out
    FLASH_ATTENTION.launch(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        bh.data_ptr() if has_bias else None,
        bw.data_ptr() if has_bias else None,
        out.data_ptr(), b * h, n, side if has_bias else 1, int(has_bias),
        1.0 / math.sqrt(dh), dh)
    return out


def token_cross_attend_reference(q: torch.Tensor, kt: torch.Tensor,
                                 vt: torch.Tensor,
                                 heads: int) -> torch.Tensor:
    """Plain version of :func:`token_cross_attend`: per-head f32 softmax,
    probabilities rounded to vt's dtype."""
    b, n, d = q.shape
    hd = d // heads
    m = kt.shape[-1]
    qh = q.reshape(b, n, heads, hd).permute(0, 2, 1, 3).float()
    kh = kt.reshape(kt.shape[0], heads, hd, m).float()
    vh = vt.reshape(vt.shape[0], heads, hd, m).float()
    s = torch.matmul(qh, kh) / math.sqrt(hd)             # [B, H, n, M]
    p = torch.softmax(s, dim=-1).to(vt.dtype).float()
    out = torch.matmul(p, vh.transpose(-1, -2))          # [B, H, n, hd]
    return out.permute(0, 2, 1, 3).reshape(b, n, d).to(q.dtype)


def token_cross_attend(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """Few token queries q [B, n, D] over M image keys, with the projected
    keys and values transposed: kt, vt [B or 1, D, M] (leading dim 1 =
    shared by every prompt). Returns [B, n, D].

    CUDA: kernel B10 by q's dtype, bf16 or f32 (head dim 16, n 7 or 8,
    M % 8 == 0; f32: products in split TF32 on the tensor cores); other
    dtypes raise. CPU: :func:`token_cross_attend_reference`."""
    if not q.is_cuda:
        return token_cross_attend_reference(q, kt, vt, heads)
    b, n, d = q.shape
    lead, _, m = kt.shape
    if d % heads or d // heads != 16 or n not in (7, 8):
        raise ValueError(f"token cross attention: (n={n}, d={d}, "
                         f"heads={heads}) not built (head dim 16, n 7|8)")
    if lead not in (1, b):
        raise ValueError(f"kt leading dim {lead} is neither 1 nor {b}")
    if m % 8:
        raise ValueError(f"token cross attention: M={m} is not a multiple "
                         "of 8")
    dt = kernel_dtype("token cross attention", q)
    qf = operand("q", q, dt, (b, n, d))
    kf = operand("kt", kt, dt, (lead, d, m))
    vf = operand("vt", vt, dt, (lead, d, m))
    out = torch.empty_like(qf)
    (TOKEN_CROSS_SPLIT_F32 if dt == torch.float32 else TOKEN_CROSS_SPLIT
     ).launch(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), b,
              n, d, m, heads, int(lead == 1))
    return out


def token_cross_attend_kv_reference(q: torch.Tensor, kvt: torch.Tensor,
                                    pe_kt: torch.Tensor,
                                    v_bias: torch.Tensor,
                                    heads: int) -> torch.Tensor:
    """Plain version of :func:`token_cross_attend_kv`: k = kvt[:, :D] +
    pe_kt and v = kvt[:, D:] + v_bias in kvt's dtype, then
    :func:`token_cross_attend_reference`."""
    d = q.shape[2]
    dtype = kvt.dtype
    kt = kvt[:, :d] + pe_kt.reshape(1, d, -1).to(dtype)
    vt = kvt[:, d:] + v_bias.to(dtype)[:, None]
    return token_cross_attend_reference(q, kt, vt, heads)


def token_cross_attend_kv(q: torch.Tensor, kvt: torch.Tensor,
                          pe_kt: torch.Tensor, v_bias: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """Few token queries q [B, n, D] over M image keys whose k|v arrive as
    one transposed projection kvt [B or 1, 2D, M] (leading dim 1 = shared
    by every prompt); pe_kt [1, D, M] is added to k and v_bias [D] to v
    inside the kernel. Returns [B, n, D].

    CUDA: kernel K2 by q's dtype, bf16 or f32 (head dim 16, n 7 or 8,
    M % 8 == 0; f32: products in split TF32 on the tensor cores); other
    dtypes raise. CPU: the plain version."""
    if not q.is_cuda:
        return token_cross_attend_kv_reference(q, kvt, pe_kt, v_bias, heads)
    b, n, d = q.shape
    m = kvt.shape[-1]
    if d % heads or d // heads != 16 or n not in (7, 8):
        raise ValueError(f"token cross attention: (n={n}, d={d}, "
                         f"heads={heads}) not built (head dim 16, n 7|8)")
    if kvt.shape[0] not in (1, b):
        raise ValueError(f"kvt leading dim {kvt.shape[0]} is neither 1 "
                         f"nor {b}")
    if m % 8:
        raise ValueError(f"token cross attention: M={m} is not a multiple "
                         "of 8")
    dt = kernel_dtype("token cross attention", q)
    qf = operand("q", q, dt, (b, n, d))
    kv = operand("kvt", kvt, dt, (kvt.shape[0], 2 * d, m))
    pe = operand("pe_kt", pe_kt.to(dt).reshape(d, m), dt, (d, m))
    vb = operand("v_bias", v_bias.to(dt), dt, (d,))
    out = torch.empty_like(qf)
    (TOKEN_CROSS_F32 if dt == torch.float32 else TOKEN_CROSS).launch(
        qf.data_ptr(), kv.data_ptr(), pe.data_ptr(), vb.data_ptr(),
        out.data_ptr(), b, n, d, m, heads, int(kvt.shape[0] == 1 and b > 1))
    return out


def i2t_update_reference(img, peq, tok_k, tok_v, w_q, b_q, w_out, b_out,
                         ln_scale, ln_bias, w_kv_next, heads: int,
                         eps: float):
    """Plain version of :func:`i2t_update`, rounding to img's dtype where
    the kernel rounds: q after its f32 sum, the probabilities, the
    attention output, the out-projection before its bias, the residual,
    the normalized row and the k|v projection."""
    dtype = img.dtype
    b, t, da = tok_k.shape
    m = img.shape[1]
    hd = da // heads
    x = img.float()
    q = (x @ w_q.float() + peq.float() + b_q.float()).to(dtype)
    qh = q.float().reshape(q.shape[0], m, heads, hd).transpose(1, 2)
    kh = tok_k.to(dtype).float().reshape(b, t, heads, hd).permute(0, 2, 3, 1)
    vh = tok_v.to(dtype).float().reshape(b, t, heads, hd).transpose(1, 2)
    s = torch.matmul(qh, kh) / math.sqrt(hd)             # [B, H, M, T]
    p = torch.softmax(s, dim=-1).to(dtype).float()
    attn = torch.matmul(p, vh).transpose(1, 2).reshape(b, m, da).to(dtype)
    out = (attn.float() @ w_out.float()).to(dtype) + b_out.to(dtype)
    y = (img + out).float()
    mu = y.mean(-1, keepdim=True)
    var = torch.clamp((y * y).mean(-1, keepdim=True) - mu * mu, min=0.0)
    keys = ((y - mu) * torch.rsqrt(var + eps) * ln_scale.float()
            + ln_bias.float()).to(dtype)
    kvt = (keys.float() @ w_kv_next.float()).to(dtype).transpose(1, 2)
    return keys, kvt.contiguous()


def i2t_update(img: torch.Tensor, peq: torch.Tensor, tok_k: torch.Tensor,
               tok_v: torch.Tensor, w_q: torch.Tensor, b_q: torch.Tensor,
               w_out: torch.Tensor, b_out: torch.Tensor,
               ln_scale: torch.Tensor, ln_bias: torch.Tensor,
               w_kv_next: torch.Tensor, heads: int, eps: float):
    """The two-way block's image→token update plus the next attention's
    k|v projection: keys = LN(img + Attn(img → tokens)), kvt = the raw
    transposed projection keys · w_kv_next, ready for
    :func:`token_cross_attend_kv`.

    img [B or 1, M, D] (leading dim 1 = the layer-1 branch shared by every
    prompt); peq [1, M, DA] the pre-projected positional term W_q·pe;
    tok_k, tok_v [B, T, DA] the projected token keys/values; w_q [D, DA],
    b_q, w_out [DA, D], b_out, ln_scale, ln_bias; w_kv_next [D, 2·DA2].
    Returns (keys [B, M, D], kvt [B, 2·DA2, M]).

    CUDA: kernel K5 by img's dtype, bf16 or f32 (D 256, DA 128, 8 heads,
    7 tokens, M a multiple of 64; f32: products in split TF32 on the
    tensor cores, as accurate as f32); other dtypes raise. CPU:
    :func:`i2t_update_reference`."""
    if not img.is_cuda:
        return i2t_update_reference(img, peq, tok_k, tok_v, w_q, b_q, w_out,
                                    b_out, ln_scale, ln_bias, w_kv_next,
                                    heads, eps)
    b, t, da = tok_k.shape
    lead, m, d = img.shape
    if ((d, da, t, heads) != (256, 128, 7, 8) or m % 64
            or tuple(w_kv_next.shape) != (256, 256)):
        raise ValueError(f"i2t update: (D={d}, DA={da}, T={t}, heads="
                         f"{heads}, M={m}, w_kv_next {tuple(w_kv_next.shape)})"
                         " not built (256, 128, 7, 8, M % 64 == 0, 256x256)")
    if lead not in (1, b):
        raise ValueError(f"img leading dim {lead} is neither 1 nor {b}")
    dt = kernel_dtype("i2t update", img)
    x = operand("img", img, dt, (lead, m, d))
    pq = operand("peq", peq, dt, (1, m, da))
    tk = operand("tok_k", tok_k, dt, (b, t, da))
    tv = operand("tok_v", tok_v, dt, (b, t, da))
    ws = [operand(name, w.to(dt), dt, shape) for name, w, shape in (
        ("w_q", w_q, (d, da)), ("b_q", b_q, (da,)), ("w_out", w_out, (da, d)),
        ("b_out", b_out, (d,)), ("ln_scale", ln_scale, (d,)),
        ("ln_bias", ln_bias, (d,)), ("w_kv_next", w_kv_next, (d, 256)))]
    keys = torch.empty((b, m, d), dtype=dt, device=img.device)
    kvt = torch.empty((b, 256, m), dtype=dt, device=img.device)
    ptrs = [x.data_ptr(), pq.data_ptr(), tk.data_ptr(), tv.data_ptr(),
            *(w.data_ptr() for w in ws), keys.data_ptr(), kvt.data_ptr()]
    if dt == torch.float32:
        # the kernel's weight split (Wqᵀ, Woutᵀ and Wkvᵀ as TF32 hi and lo
        # planes, 1 MB, made anew every call) and layer 1's q
        scratch = torch.empty(i2t_f32_scratch(img.device), dtype=dt,
                              device=img.device)
        I2T_UPDATE_F32.launch(*ptrs, scratch.data_ptr(), b, m, int(lead == 1),
                              float(eps))
    else:
        I2T_UPDATE.launch(*ptrs, b, m, int(lead == 1), float(eps))
    return keys, kvt
