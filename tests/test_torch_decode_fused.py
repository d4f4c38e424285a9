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
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PortCfg
from revisit_anything_tpu_torch.models.sam import decoder as pdec
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
