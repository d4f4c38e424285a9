"""Port parity: kernel B3 (``decode_tail_fused``) in both emission modes,
and ``decode_masks`` in each of its four ``decode`` forms, against the
JAX package (Pallas kernels in interpret mode, its trace-time decode
flags set to the matching form), f32 on both sides on a small SAM."""

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
# the JAX flags (probs_path, _FUSED_TAIL, _TAIL_KEYS) of each decode form;
# _TAIL_LOGITS stays "off", its default
FLAGS = {"shared": (False, "auto", "auto"),
         "probs_split": (True, "off", "auto"),
         "fused_tail_probs": (True, "on", "off"),
         "fused_tail_keys": (True, "on", "on")}


@contextlib.contextmanager
def jax_decode(decode):
    """Set the JAX decoder's trace-time flags to ``decode``'s form. The
    flags are read at trace time and ``decode_masks`` is jitted: its
    cache is cleared on the way in and out, or the second form would
    reuse the first one's computation."""
    _, fused, keys = FLAGS[decode]
    old = (dec_mod._FUSED_TAIL, dec_mod._TAIL_KEYS, dec_mod._TAIL_LOGITS)
    dec_mod._FUSED_TAIL, dec_mod._TAIL_KEYS = fused, keys
    dec_mod._TAIL_LOGITS = "off"
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


@pytest.mark.parametrize("emit_keys", [True, False])
def test_decode_tail_matches_jax(setup, emit_keys):
    jparams, sam, *_ = setup
    dec = jparams["decoder"]
    rng = np.random.default_rng(4)
    b, t, d, da, h = 3, 7, 32, 16, 4
    m = JCFG.grid ** 2

    def rnd(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = dict(img0=rnd(1, m, d), q1st=rnd(1, da, m), peq2t=rnd(1, da, m),
             pek2t=rnd(1, da, m), pekft=rnd(1, da, m), tok_k1=rnd(b, t, da),
             c1m=rnd(b, h * t, d, s=0.3), queries_b=rnd(b, t, d),
             tokens=rnd(b, t, d))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = jtail(j["img0"].transpose(0, 2, 1), j["q1st"], j["peq2t"],
                 j["pek2t"], j["pekft"], j["tok_k1"], j["c1m"],
                 j["queries_b"], j["tokens"], dec["layers"][1],
                 dec["final_attn"], dec["layers"][0]["i2t"],
                 dec["layers"][0]["norm4"], dec["norm_final"], h,
                 eps=JCFG.eps, interpret=True, emit_keys=emit_keys)
    want = [np.asarray(w, np.float32) for w in want]
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
