"""Port encoder-decoder (``repro_torch.models.encdec``) vs the reference.

whisper-tiny's smoke config, the reference's parameters carried across by
``convert.encdec_params_from_numpy`` (its biases and norm parameters drawn
away from 0 and 1), frames and tokens drawn with numpy: ``encode`` (also
over a ragged number of frames), the cross-attention, ``forward``,
``prefill`` (last logits and both caches, written over stale values) and
three ``decode_step``s at per-row positions, fp32 and bf16; then the
port's own prefill -> decode chain against its ``forward``, and the
stored dtypes.

Tolerances: fp32 1e-5 (summation order), as ``tests/test_torch_lm.py``;
bf16 rounds every activation to 8 bits and the residual stream carries
each layer's rounding into the next, so an encoder output or logit of
size up to 4 may sit a few ulps away: 3e-2 absolute (``LOGIT_TOL["bf16"]``)
plus 2^-5 relative (four bf16 ulps).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import encdec as ref_encdec
from repro_torch import configs, convert
from repro_torch.models import attention, encdec
from repro_torch.models.model import build_model

from test_torch_lm import _perturb

CPU = "cpu"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -5, atol=3e-2)}
ARCH = "whisper-tiny"


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _models(dtype, encoder_seq=None):
    rcfg = dataclasses.replace(ref_configs.get_smoke(ARCH), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype)
    if encoder_seq:
        rcfg = dataclasses.replace(rcfg, encoder_seq=encoder_seq)
        cfg = dataclasses.replace(cfg, encoder_seq=encoder_seq)
    rp = _perturb(ref_encdec.init_params(jax.random.key(3), rcfg), 3)
    tp = encdec.EncDecLM(cfg, device=CPU)
    tp.load_state_dict(convert.encdec_params_from_numpy(rp, cfg, device=CPU))
    return rcfg, rp, cfg, tp


def _frames(cfg, b, seed):
    f = np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return jnp.asarray(f), torch.from_numpy(f)


@pytest.mark.parametrize("encoder_seq", [None, 37])
@pytest.mark.parametrize("dtype", list(TOL))
def test_encode_matches_reference(dtype, encoder_seq):
    rcfg, rp, cfg, tp = _models(dtype, encoder_seq)
    jf, tf = _frames(cfg, 2, 1)
    want = jax.jit(ref_encdec.encode, static_argnums=1)(rp, rcfg, jf)
    got = encdec.encode(tp, cfg, tf)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
def test_cross_attend_matches_reference(dtype):
    rcfg, rp, cfg, tp = _models(dtype)
    cd_t, cd_j = getattr(torch, dtype), jnp.dtype(dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    p = rp["decoder"]
    pl = jax.tree.map(lambda a: a[0], p)["cross"]
    want = ref_encdec._cross_attend(pl, rcfg, jnp.asarray(x).astype(cd_j),
                                    jnp.asarray(mem).astype(cd_j), cd_j)
    got = attention.cross_attend(tp.decoder[0].cross, cfg,
                                 torch.from_numpy(x).to(cd_t),
                                 torch.from_numpy(mem).to(cd_t), cd_t)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
def test_forward_matches_reference(dtype):
    rcfg, rp, cfg, tp = _models(dtype)
    jf, tf = _frames(cfg, 2, 4)
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 11))
    want, _ = jax.jit(ref_encdec.forward, static_argnums=1)(
        rp, rcfg, jnp.asarray(toks), jf)
    got, aux = encdec.forward(tp, cfg, torch.from_numpy(toks), tf)
    assert got.dtype == torch.float32 and float(aux["load_balance_loss"]) == 0
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
def test_prefill_decode_match_reference(dtype):
    rcfg, rp, cfg, tp = _models(dtype)
    cd_t, cd_j = getattr(torch, dtype), jnp.dtype(dtype)
    b, s, t = 2, 9, 24
    jf, tf = _frames(cfg, b, 5)
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (b, s))
    rc = ref_encdec.init_cache(rcfg, b, t, cd_j)
    r_logits, rc = jax.jit(ref_encdec.prefill, static_argnums=1)(
        rp, rcfg, jnp.asarray(toks), jf, rc)
    tc = encdec.init_cache(cfg, b, t, cd_t, device=CPU)
    for part in tc.values():          # stale values an earlier wave left
        for layer in part:
            for v in layer.values():
                v.normal_()
    t_logits, tc = encdec.prefill(tp, cfg, torch.from_numpy(toks), tf, tc)
    assert t_logits.shape == (b, 1, cfg.vocab_size)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **tol)
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc["cross_kv"][i][name]),
                                       _np(rc["cross_kv"][name][i]), **tol)
            np.testing.assert_allclose(_np(tc["self"][i][name][:, :s]),
                                       _np(rc["self"][name][i][:, :s]),
                                       **tol)
    dec = jax.jit(ref_encdec.decode_step, static_argnums=1)
    pos = np.array([s, s - 2])
    tok = np.asarray(jnp.argmax(r_logits[:, -1], -1)).astype(np.int32)
    for step in range(3):
        r_logits, rc = dec(rp, rcfg, jnp.asarray(tok),
                           jnp.asarray(pos + step), rc)
        t_logits, tc = encdec.decode_step(tp, cfg, torch.from_numpy(tok),
                                          torch.from_numpy(pos + step), tc)
        assert t_logits.shape == (b, cfg.vocab_size)
        np.testing.assert_allclose(_np(t_logits), _np(r_logits), **tol)
        tok = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)


def test_decode_chain_matches_forward():
    """Through ``Model``: prefill, three greedy steps, then ``forward`` over
    prompt ++ tokens picks the same tokens (the reference's own
    consistency check)."""
    _, _, cfg, tp = _models("float32")
    m = build_model(cfg)
    b, s = 2, 8
    _, tf = _frames(cfg, b, 6)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (b, s)))
    cache = m.init_cache(b, 32, dtype=torch.float32, device=CPU)
    logits, cache = m.prefill(tp, {"tokens": toks, "frames": tf}, cache)
    seq = [logits[:, -1].argmax(-1)]
    for i in range(3):
        lg, cache = m.decode(tp, cache, seq[-1], torch.full((b,), s + i))
        seq.append(lg.argmax(-1))
    full = torch.cat([toks, torch.stack(seq[:-1], 1)], 1)
    fwd, _ = encdec.forward(tp, cfg, full, tf)
    assert torch.equal(fwd[:, s - 1:].argmax(-1), torch.stack(seq, 1))


def test_stored_dtypes_and_init():
    """bf16 matrices; fp32 norms, biases and the two tables the reference
    adds in fp32; ``Model.init`` draws the reference's scales."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="bfloat16")
    rcfg = dataclasses.replace(ref_configs.get_smoke(ARCH), dtype="bfloat16")
    rp = jax.tree.map(np.asarray,
                      ref_encdec.init_params(jax.random.key(0), rcfg))
    sd = convert.encdec_params_from_numpy(rp, cfg, device=CPU)
    want = encdec.EncDecLM(cfg, device=CPU).state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
    for k in ("embed.table", "pos_dec.table", "decoder.1.norm_x.bias"):
        assert sd[k].dtype == torch.float32, k
    assert sd["encoder.0.attn.wq.w"].dtype == torch.bfloat16
    m = build_model(cfg).init(0, device=CPU)
    assert abs(float(m.pos_dec.table.std()) - 0.01) < 1e-3
    assert abs(float(m.embed.table.std()) - 0.02) < 2e-3
    assert torch.equal(m.enc_norm.scale, torch.ones(cfg.d_model))
