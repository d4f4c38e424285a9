"""Port parity: kernel B3 (``decode_tail_fused``) in its three emission
modes, and ``decode_masks`` in each of its five ``decode`` forms, against
the JAX package (Pallas kernels in interpret mode, its trace-time decode
flags set to the matching form), f32 on both sides on a small SAM.

The JAX tail's logits mode feeds token rows 1..3 (mask tokens 0..2) to
the hypernetworks of mask tokens 1..3 (ops/decode_fused.py:311), where
SAM and the JAX package's own keys path (decoder.py:722-737) read rows
2..4; on the near-identical mask-token outputs of its own tests
(tests/test_decode_fused.py) the two agree within their tolerance. The
port's logits mode computes SAM's function, so it is held to the JAX
keys path followed by the JAX mask head, and
``test_jax_logits_mode_reads_mask_tokens_0_to_2`` pins the reference's
row choice."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models.sam import (SamArchConfig, decode_masks,
                                             dense_positional_embedding,
                                             embed_points, init_sam_params,
                                             no_mask_dense_embedding)
from revisit_anything_tpu.models.sam import decoder as dec_mod
from revisit_anything_tpu.models.sam.decoder import (_mlp,
                                                     _upscale_masks_blocks)
from revisit_anything_tpu.ops.decode_fused import decode_tail_fused as jtail
from revisit_anything_tpu_torch.kernels.probs_compare import (
    PROBS_F32_MOVED, bf16_ulps)
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PortCfg
from revisit_anything_tpu_torch.models.sam import decoder as pdec
from revisit_anything_tpu_torch.ops import decode_fused as dfu
from revisit_anything_tpu_torch.ops import decode_probs as pdp
from revisit_anything_tpu_torch.ops.decode_fused import decode_tail_fused
from revisit_anything_tpu_torch.weights import sam_from_jax_params

torch.set_float32_matmul_precision("highest")

KW = dict(encoder_dim=64, encoder_depth=1, encoder_heads=4,
          global_attn_indexes=(), image_size=128, patch_size=16,
          window_size=4, prompt_dim=32, decoder_heads=4, decoder_mlp_dim=128,
          iou_head_hidden=32)
JCFG, PCFG = SamArchConfig(**KW), PortCfg(**KW)
REL = 1e-4     # f32 both sides: summation order and reassociation only
# the JAX flags (probs_path, _FUSED_TAIL, _TAIL_KEYS, _TAIL_LOGITS) of
# each decode form; "fused_tail_logits" is held to the keys path, which
# computes the function the JAX logits mode means to (module docstring)
FLAGS = {"shared": (False, "auto", "auto", "off"),
         "probs_split": (True, "off", "auto", "off"),
         "fused_tail_probs": (True, "on", "off", "off"),
         "fused_tail_keys": (True, "on", "on", "off"),
         "fused_tail_logits": (True, "on", "on", "off")}


@contextlib.contextmanager
def jax_decode(decode):
    """Set the JAX decoder's trace-time flags to ``decode``'s form. The
    flags are read at trace time and ``decode_masks`` is jitted: its
    cache is cleared on the way in and out, or the second form would
    reuse the first one's computation."""
    _, fused, keys, logits = FLAGS[decode]
    old = (dec_mod._FUSED_TAIL, dec_mod._TAIL_KEYS, dec_mod._TAIL_LOGITS)
    (dec_mod._FUSED_TAIL, dec_mod._TAIL_KEYS,
     dec_mod._TAIL_LOGITS) = fused, keys, logits
    decode_masks.clear_cache()
    try:
        yield
    finally:
        (dec_mod._FUSED_TAIL, dec_mod._TAIL_KEYS,
         dec_mod._TAIL_LOGITS) = old
        decode_masks.clear_cache()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(np.asarray(x, np.float32)))
    return np.ldexp(1.0, e - 8)


@pytest.fixture(scope="module")
def setup():
    params = init_sam_params(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    sam = sam_from_jax_params(tree, PCFG, device="cpu")
    g = JCFG.grid
    emb = rng.standard_normal((g, g, JCFG.prompt_dim)).astype(np.float32)
    pe = np.array(dense_positional_embedding(jparams, JCFG)[0])
    pts = (rng.random((5, 1, 2)) * JCFG.image_size).astype(np.float32)
    sparse = np.array(embed_points(jparams, JCFG, pts, np.ones((5, 1)),
                                   pad=True))
    dense = np.array(no_mask_dense_embedding(jparams, JCFG, 1))
    return jparams, sam, emb, pe, sparse, dense


def _tail_inputs(seed=4):
    """Random decode-tail inputs (numpy) for 3 prompts of the small SAM."""
    rng = np.random.default_rng(seed)
    b, t, d, da, h = 3, 7, 32, 16, 4
    m = JCFG.grid ** 2

    def rnd(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(img0=rnd(1, m, d), q1st=rnd(1, da, m), peq2t=rnd(1, da, m),
                pek2t=rnd(1, da, m), pekft=rnd(1, da, m),
                tok_k1=rnd(b, t, da), c1m=rnd(b, h * t, d, s=0.3),
                queries_b=rnd(b, t, d), tokens=rnd(b, t, d))


def _jax_tail(dec, x, **kw):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    return jtail(j["img0"].transpose(0, 2, 1), j["q1st"], j["peq2t"],
                 j["pek2t"], j["pekft"], j["tok_k1"], j["c1m"],
                 j["queries_b"], j["tokens"], dec["layers"][1],
                 dec["final_attn"], dec["layers"][0]["i2t"],
                 dec["layers"][0]["norm4"], dec["norm_final"], 4,
                 eps=JCFG.eps, interpret=True, **kw)


def _jax_mask_head(dec, keys2, queries, rows):
    """The JAX package's plain mask head on keys2 with the hypernetworks
    of mask tokens 1..3 on token rows ``rows``."""
    hyper = jnp.stack([_mlp(queries[:, r], dec["hyper_mlps"][1 + i])
                       for i, r in enumerate(rows)], axis=1)
    return np.asarray(_upscale_masks_blocks(keys2, hyper, dec, JCFG,
                                            interleave=False), np.float32)


@pytest.mark.parametrize("emit_keys", [True, False])
def test_decode_tail_matches_jax(setup, emit_keys):
    jparams, sam, *_ = setup
    dec = jparams["decoder"]
    b, t, d, h = 3, 7, 32, 4
    m = JCFG.grid ** 2
    x = _tail_inputs()
    want = [np.asarray(w, np.float32)
            for w in _jax_tail(dec, x, emit_keys=emit_keys)]
    with torch.inference_mode():
        got = decode_tail_fused(sam.decoder,
                                *(torch.from_numpy(v) for v in x.values()),
                                h, JCFG.eps, emit_keys=emit_keys)
    got = [g.float().numpy() for g in got]
    assert len(got) == len(want) == (2 if emit_keys else 4)
    assert got[0].shape == want[0].shape == (b, t, d)
    assert _rel(got[0], want[0]) < REL             # queries
    if emit_keys:
        assert got[1].shape == want[1].shape == (b, m, d)
        assert _rel(got[1], want[1]) < REL         # keys2
    else:
        for g, w in zip(got[1:3], want[1:3]):      # P1, P2: one bf16 ulp
            assert g.shape == w.shape == (b, h * t, m)
            assert np.all(np.abs(g - w) <= _bf16_ulp(w))
        assert _rel(got[3], want[3]) < REL         # C2


@pytest.mark.parametrize("content", [None, 40])
def test_decode_tail_logits_matches_jax(setup, content):
    """The logits mode (the mask head and the multimask hypernetworks run
    in the tail) against the JAX tail's keys mode followed by the JAX
    package's mask head on mask tokens 1..3 (module docstring)."""
    jparams, sam, *_ = setup
    dec = jparams["decoder"]
    x = _tail_inputs()
    m = JCFG.grid ** 2
    c = m if content is None else content
    q, keys2 = _jax_tail(dec, x, emit_keys=True)
    want_q = np.asarray(q, np.float32)
    want = _jax_mask_head(dec, keys2[:, :c], q, rows=(2, 3, 4))
    with torch.inference_mode():
        got_q, got = decode_tail_fused(
            sam.decoder, *(torch.from_numpy(v) for v in x.values()), 4,
            JCFG.eps, mask_head=True, content=content)
    assert got.shape == want.shape == (3, c, 16, 3)
    assert _rel(got_q.numpy(), want_q) < REL
    assert _rel(got.numpy(), want) < REL


def test_jax_logits_mode_reads_mask_tokens_0_to_2(setup):
    """Pins the reference's row choice: the JAX tail's logits mode equals
    its keys mode followed by the mask head with the hypernetworks of
    mask tokens 1..3 on token rows 1..3, not SAM's rows 2..4."""
    jparams, *_ = setup
    dec = jparams["decoder"]
    x = _tail_inputs(seed=5)
    q, keys2 = _jax_tail(dec, x, emit_keys=True)
    _, logits = _jax_tail(dec, x, mask_head=dec, content=JCFG.grid ** 2)
    logits = np.asarray(logits, np.float32)
    assert _rel(logits, _jax_mask_head(dec, keys2, q, (1, 2, 3))) < REL
    assert _rel(logits, _jax_mask_head(dec, keys2, q, (2, 3, 4))) > 10 * REL


@pytest.mark.parametrize("mask_rows", [None, 6])
@pytest.mark.parametrize("decode", list(FLAGS))
def test_decode_masks_matches_jax(setup, decode, mask_rows):
    jparams, sam, emb, pe, sparse, dense = setup
    with jax_decode(decode):
        want_m, want_iou = (np.asarray(x, np.float32) for x in decode_masks(
            jparams, JCFG, emb, pe, sparse, dense, multimask=True,
            dense_shared=True, block_layout=True,
            probs_path=FLAGS[decode][0], mask_rows=mask_rows))
    with torch.inference_mode():
        got_m, got_iou = pdec.decode_masks(
            sam.decoder, PCFG, *(torch.from_numpy(x) for x in
                                 (emb, pe, sparse, dense)),
            mask_rows=mask_rows, decode=decode)
    rows = JCFG.grid if mask_rows is None else mask_rows
    assert got_m.shape == want_m.shape == (5, rows * JCFG.grid, 16, 3)
    assert _rel(got_m.numpy(), want_m) < REL
    assert _rel(got_iou.numpy(), want_iou) < REL


def test_unknown_decode_raises(setup):
    _, sam, emb, pe, sparse, dense = setup
    with pytest.raises(ValueError, match="decode"):
        pdec.decode_masks(sam.decoder, PCFG, *(torch.from_numpy(x) for x in
                                               (emb, pe, sparse, dense)),
                          decode="probs")


ACTIVATIONS = ("img0", "q1st", "peq2t", "pek2t", "pekft", "tok_k1", "c1m",
               "qin", "tok")


@pytest.mark.parametrize("mode", ["keys", "probs", "logits"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tail_kernel_operands_are_never_cast(setup, dtype, mode):
    """The operand list B3's CUDA branch hands ``operand``
    (``tail_operands``), in TailParams' order: each activation is the
    caller's own tensor, held to queries_b's dtype (an f32 img0 beside
    bf16 tokens makes the kernel raise, never rounds it); the weights,
    biases and branch rows, and in the logits mode the mask head's
    weights and the hypernetwork MLPs, are converted to that dtype; P is
    never an operand (the kernel makes P1 and P2)."""
    _, sam, *_ = setup
    x = {k: torch.from_numpy(v) for k, v in _tail_inputs().items()}
    acts = dict(zip(ACTIVATIONS, [x["img0"]] + [
        x[k].to(dtype) for k in ("q1st", "peq2t", "pek2t", "pekft",
                                 "tok_k1", "c1m", "queries_b", "tokens")]))
    ops = dfu.tail_operands(sam.decoder, *acts.values(), 4,
                            mask_head=mode == "logits")
    names = [name for name, *_ in ops]
    assert names == [n for n in dfu._TAIL_POINTERS if n in names]
    assert names[:len(ACTIVATIONS)] == list(ACTIVATIONS)
    assert len(names) == 40 + (12 if mode == "logits" else 0)
    assert not {"p1", "p2", "c2m", "keys2"} & set(names)
    for name, t, dt, shape in ops:
        assert dt == dtype, name
        assert tuple(t.shape) == tuple(shape), name
        if name in ACTIVATIONS:
            assert t is acts[name], name
        else:
            assert t.dtype == dtype, name


# ----------------------------------------------------------------------
# B3 f32's arithmetic (kernels/csrc/decode_tail.cu, the f32 form),
# emulated on the CPU at the kernel's widths in its order: its walks are
# B7 f32 and B8 f32 (tests/test_torch_decode_probs.py emulates both), the
# token side between them f32 and unrounded.

KD, KDA, KH, KT, KMLP = 256, 128, 8, 7, 128


def _kernel_width_tail(seed, b=2, m=128):
    """Seeded numpy inputs and the parameter subtrees the JAX tail reads
    (l2, fa, i1, l1n4, norm_final) at the kernel's widths, MLP 128:
    weights N(0, 0.05²), LayerNorm scales 1 + N(0, 0.05²)."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, s=1.0, off=0.0):
        return (rng.standard_normal(shape) * s + off).astype(np.float32)

    def lin(i, o):
        return {"w": rnd(i, o, s=0.05), "b": rnd(o, s=0.05)}

    def ln(n):
        return {"scale": rnd(n, s=0.05, off=1.0), "bias": rnd(n, s=0.05)}

    def attn():
        return {"q": lin(KD, KDA), "k": lin(KD, KDA), "v": lin(KD, KDA),
                "out": lin(KDA, KD)}

    prm = dict(l2={"t2i": attn(), "i2t": attn(), "norm2": ln(KD),
                   "norm3": ln(KD), "norm4": ln(KD), "lin1": lin(KD, KMLP),
                   "lin2": lin(KMLP, KD)},
               fa=attn(), i1=attn(), l1n4=ln(KD), norm_final=ln(KD))
    x = dict(img0=rnd(1, m, KD), q1st=rnd(1, KDA, m), peq2t=rnd(1, KDA, m),
             pek2t=rnd(1, KDA, m), pekft=rnd(1, KDA, m),
             tok_k1=rnd(b, KT, KDA), c1m=rnd(b, KH * KT, KD, s=0.3),
             queries_b=rnd(b, KT, KD), tokens=rnd(b, KT, KD))
    return x, prm


def _jax_tail_f32(x, prm, emit_keys):
    """JAX ``decode_tail_fused`` in f32 (interpret mode, "highest")."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    with jax.default_matmul_precision("highest"):
        out = jtail(j["img0"].transpose(0, 2, 1), j["q1st"], j["peq2t"],
                    j["pek2t"], j["pekft"], j["tok_k1"], j["c1m"],
                    j["queries_b"], j["tokens"], prm["l2"], prm["fa"],
                    prm["i1"], prm["l1n4"], prm["norm_final"], KH,
                    eps=1e-6, interpret=True, emit_keys=emit_keys)
    return [torch.from_numpy(np.array(o, np.float32)) for o in out]


def _tail_f32_emulated(x, prm, p1_ref, p2_ref, split=True):
    """B3 f32 in the kernel's order: P1 (B7 f32 layer 1: the pe term and
    the softmax in f32, P bf16); the layer-2 token -> image attention as
    B8 f32 at depth 1; the token side f32 and unrounded; P2 as B7 f32
    layer 2; C2; keys2 by two f32 rebuilds (C as two fp16 planes, P as
    fp16 x 2^15; ``split`` False: C rounded once to TF32); the final
    attention as B8 f32 at depth 2. P1 and P2 round to bf16, where an f32
    reassociation may flip one ulp: each is measured against the JAX
    kernel's (``p1_ref``, ``p2_ref``), and the JAX kernel's goes on, so
    that the rest can be held to f32. Returns (qout, keys2, C2 (the
    probability mode's, f32, from the token side between the walks), (the
    largest difference of P1 and P2 in bf16 ulps, the largest share of
    their elements that differ))."""
    from test_torch_decode_probs import _i2t_l2_f32, _rebuild, _t2i_f32
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    prm = jax.tree_util.tree_map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)), prm)
    l2, fa = prm["l2"], prm["fa"]
    t2, i2 = l2["t2i"], l2["i2t"]
    eps = 1e-6

    def dense(a, p):
        return a @ p["w"] + p["b"]

    def ln(a, p):
        mu = a.mean(-1, keepdim=True)
        var = ((a - mu) ** 2).mean(-1, keepdim=True)
        return (a - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]

    p_err = []

    def held(got, ref):
        p_err.append(bf16_ulps(got, ref))
        return ref.to(torch.bfloat16)

    rows = torch.stack([prm["i1"]["out"]["b"], prm["l1n4"]["scale"],
                        prm["l1n4"]["bias"], i2["out"]["b"],
                        l2["norm4"]["scale"], l2["norm4"]["bias"],
                        torch.zeros(KD), torch.zeros(KD)])
    qin, tok, img0, c1 = t["queries_b"], t["tokens"], t["img0"], t["c1m"]
    p1 = held(pdp.i2t_probs_reference(t["q1st"], t["tok_k1"], KH), p1_ref)
    q2 = dense(qin + tok, t2["q"])
    attn = _t2i_f32(q2, img0, p1, c1, None, None, t2["k"]["w"],
                    t2["v"]["w"], t["pek2t"], rows, t2["v"]["b"], KH, eps,
                    split)
    q = ln(qin + dense(attn, t2["out"]), l2["norm2"])
    q = ln(q + dense(torch.relu(dense(q, l2["lin1"])), l2["lin2"]),
           l2["norm3"])
    k2, v2, qf = (dense(q + tok, i2["k"]), dense(q, i2["v"]),
                  dense(q + tok, fa["q"]))
    p2 = held(_i2t_l2_f32(k2, img0, p1, c1, t["peq2t"], i2["q"]["w"], rows,
                          KH, eps, split), p2_ref)
    c2 = pdp.c_matrix(v2, i2["out"]["w"], KH)
    keys1 = _rebuild(img0, p1, c1, rows[0:3], eps, split)
    keys2 = _rebuild(keys1, p2, c2, rows[3:6], eps, split)
    attn = _t2i_f32(qf, img0, p1, c1, p2, c2, fa["k"]["w"], fa["v"]["w"],
                    t["pekft"], rows, fa["v"]["b"], KH, eps, split)
    return (ln(q + dense(attn, fa["out"]), prm["norm_final"]), keys2, c2,
            tuple(max(e) for e in zip(*p_err)))


@pytest.mark.parametrize("c_scale", [1.0, 8.0])
def test_split_f16_decode_tail_arithmetic_matches_jax(c_scale):
    """B3 f32 emulated in f32 (its walks as B7 f32 and B8 f32: C1 and C2
    as two fp16 planes, P as fp16 x 2^15, the scores and the context as
    three fp16 products of planes, the online softmax over 32-position
    tiles; the token side f32) gives JAX ``decode_tail_fused``'s keys
    mode in f32 (interpret mode, "highest" products) at the kernel's
    widths, M 128 (four tiles), 2 prompts: the token state and keys2
    within 1e-5 of their scale, P1 and P2 within one bf16 ulp of the JAX
    kernel's in at most PROBS_F32_MOVED of their elements, and C2 within
    1e-5 of the JAX probability mode's (f32, B3 f32's probability-mode
    output). With C1 and C2
    x 8 (C1m and W_out of the layer-2 update x 8: the rebuilds' products
    outweigh img0) C rounded once to TF32 misses by more than 1e-5."""
    x, prm = _kernel_width_tail(11)
    x["c1m"] = x["c1m"] * np.float32(c_scale)
    prm["l2"]["i2t"]["out"]["w"] = (prm["l2"]["i2t"]["out"]["w"]
                                    * np.float32(c_scale))
    want_q, want_keys = _jax_tail_f32(x, prm, True)
    _, p1, p2, want_c2 = _jax_tail_f32(x, prm, False)
    got_q, got_keys, got_c2, (ulps, moved) = _tail_f32_emulated(x, prm, p1,
                                                                p2)
    assert got_keys.shape == want_keys.shape == (2, 128, KD)
    assert got_c2.shape == want_c2.shape == (2, KH * KT, KD)
    assert _rel(got_q, want_q) < 1e-5
    assert _rel(got_keys, want_keys) < 1e-5
    assert _rel(got_c2, want_c2) < 1e-5
    assert ulps <= 1.0 and moved <= PROBS_F32_MOVED
    if c_scale > 1:
        q1, k1, _, (ulps, moved) = _tail_f32_emulated(x, prm, p1, p2,
                                                      split=False)
        assert (max(_rel(q1, want_q), _rel(k1, want_keys)) > 1e-5
                or ulps > 1.0 or moved > PROBS_F32_MOVED)
