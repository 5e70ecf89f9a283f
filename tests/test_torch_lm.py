"""Port LM face (serving, every family) vs the reference, on the CPU.

* K8 (``flash_attention``): the plain twin against the reference's Pallas
  kernel in interpret mode, on ``tests/test_flash_attention.py``'s cases;
* ``layers``: norms, ``linear`` (bias added in fp32 before the one
  rounding), MLPs, RoPE;
* ``gqa_prefill`` / ``gqa_decode``, outputs and the cache rows they write;
* ``Model.prefill`` / ``decode``, a 3-step decode chain and ``forward``
  for the smoke configs of all ten archs (the MoE ones dropless, as the
  reference's own consistency tests run them), a narrow variant with
  qwen2.5-3b's full head layout and a bf16 variant;
* the port's ``BatchServer`` against the reference's on
  ``tests/test_serve.py``'s requests: identical tokens.

Both packages start from the same parameters: the reference's tree, its
biases and norm scales perturbed away from 0 and 1 so that they matter,
carried across by ``convert.lm_params_from_numpy`` (or
``encdec_params_from_numpy``).  Inputs are drawn
with numpy.  Tolerances: fp32 cases differ only by summation order
(XLA's and torch's matmuls), so 1e-5 on values of order 1; bf16 cases
round intermediate values to 8 bits, so an operand that lands on the
other side of a rounding boundary moves by an ulp (2^-7 relative at most) and
the tolerances are stated per test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import attention as ref_attn
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tr
from repro.models.model import build_model as ref_build_model
from repro.serve.engine import BatchServer as RefBatchServer
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, encdec, layers, transformer
from repro_torch.models.model import build_model
from repro_torch.serve.engine import BatchServer

from test_torch_moe import load_module

CPU = "cpu"
DENSE_ARCHS = ("qwen2.5-3b", "internlm2-1.8b", "phi3-medium-14b",
               "command-r-plus-104b", "internvl2-1b")
OTHER_ARCHS = ("deepseek-v3-671b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
               "rwkv6-3b", "whisper-tiny")
FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x, dtype=None):
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
        dtype or torch.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _perturb(tree, seed):
    """The reference's parameter tree as numpy fp32, with biases and norm
    parameters drawn away from their zero / one initial values."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "b" or name == "bias":
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.2, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def _load(module, tree, dtype):
    """Load a reference sub-tree (nested dicts of numpy) into a port
    module: matrices in ``dtype``, biases and norm parameters fp32."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = torch.from_numpy(np.asarray(v)).to(
                    torch.float32 if k in ("b", "scale", "bias") else dtype)
    walk(tree, "")
    module.load_state_dict(flat)
    return module


# --------------------------------------------------------------------------
# K8: the plain twin against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

FLASH_CASES = [
    (2, 300, 300, 8, 2, 32, 32, 64, 96, True),     # GQA, ragged tails
    (1, 128, 128, 4, 4, 16, 16, 128, 128, True),   # MHA single block
    (2, 100, 150, 4, 4, 16, 16, 32, 64, False),    # cross-attn shape
    (1, 257, 257, 2, 1, 64, 32, 64, 64, True),     # dv != dh
]


@pytest.mark.parametrize("b,s,t,h,hk,dh,dv,qc,kc,causal", FLASH_CASES)
def test_flash_plain_matches_pallas(b, s, t, h, hk, dh, dv, qc, kc, causal):
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hk, dv)).astype(np.float32)
    ref = ref_flash(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             q_chunk=qc, kv_chunk=kc)
    assert out.shape == (b, s, h * dv) and out.dtype == torch.float32
    # the same fp32 loop; only the dot products' summation order differs
    np.testing.assert_allclose(_np(out), np.asarray(ref), **FP32_TOL)


def test_flash_plain_matches_pallas_bf16():
    """The reference casts v to fp32 before ``p.astype(v.dtype)``, so p is
    not rounded: in bf16 only the output's one rounding remains, and the
    twin agrees with the Pallas kernel to within one bf16 ulp."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
               for _ in range(3))
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    ref = ref_flash(bf(q), bf(k), bf(v), q_chunk=32, kv_chunk=32)
    out = fa.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                             _t(v, torch.bfloat16), q_chunk=32, kv_chunk=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_masked_sdpa(causal):
    """The two paths of the port's ``_sdpa``: K8's twin (no mask) and the
    torch-op path with the reference's causal mask (or none)."""
    rng = np.random.default_rng(7)
    q = _t(rng.standard_normal((2, 40, 4, 16)))
    k = _t(rng.standard_normal((2, 40, 2, 16)))
    v = _t(rng.standard_normal((2, 40, 2, 16)))
    mask = (attention._causal_mask(2, 40) if causal
            else torch.ones(2, 1, 40, 40, dtype=torch.bool))
    want = attention._sdpa(q, k, v, mask, scale=0.25)
    got = attention._sdpa(q, k, v, None, scale=0.25, causal=causal)
    torch.testing.assert_close(got, want, **FP32_TOL)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_ratio",
                                  "head_dim", "dh_mismatch", "rank",
                                  "strides", "kv_length"])
def test_flash_argument_checks(case):
    """What the kernel does not take raises before a launch (the CUDA
    path's validation; on the card ``flash_attention`` calls it)."""
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    v = torch.zeros(1, 8, 2, 16)
    bad = {
        "dtype": (q.half(), k.half(), v.half()),
        "mixed_dtype": (q, k.bfloat16(), v),
        "head_ratio": (torch.zeros(1, 8, 3, 16), k, v),
        "head_dim": (torch.zeros(1, 8, 4, 512), torch.zeros(1, 8, 2, 512),
                     v),
        "dh_mismatch": (q, torch.zeros(1, 8, 2, 32), v),
        "rank": (q[0], k, v),
        "strides": (torch.zeros(1, 8, 16, 4).transpose(2, 3), k, v),
        "kv_length": (q, k, torch.zeros(1, 9, 2, 16)),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        fa._check(*bad, 512, 512)
    fa._check(q, k, v, 512, 512)   # the good case passes


def test_sdpa_flash_path_checks_the_scale():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        attention._sdpa(q, q, q, None, scale=0.3, causal=True)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: one bf16 ulp apart (2^-7 relative at most), plus an fp32 sum order's
#: slack
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _tol(dtype_name):
    return FP32_TOL if dtype_name == "float32" else BF16_TOL


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_norms_match_reference(kind, dtype):
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 0.5
    p = {"scale": rng.normal(1, 0.2, 48).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(0, 0.3, 48).astype(np.float32)
    ref = ref_layers.norm_apply(p, jnp.asarray(x).astype(jd), kind)
    mod = _load(layers.Norm(48, kind, device=CPU), p, td)
    got = layers.norm_apply(mod, _t(x, td), kind)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_linear_matches_reference(dtype, bias):
    """With a bias the product stays fp32 until the bias is added: a bf16
    product rounded first would move the result by up to an ulp of the
    product, which the tolerance (half that, after the one rounding both
    share) does not allow where the bias is large."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    p = {"w": (rng.standard_normal((64, 40)) / 8).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(0, 4.0, 40).astype(np.float32)
    ref = ref_layers.linear(p, jnp.asarray(x), jd)
    mod = _load(layers.Linear(64, 40, bias=bias, dtype=td, device=CPU), p,
                td)
    got = layers.linear(mod, _t(x), td)
    assert got.dtype == td
    if dtype == "bfloat16":
        # at most one bf16 ulp apart, and where the fp32 sums agree (all
        # but a few entries) exactly equal
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2 ** -7,
                                   atol=0)
        assert np.mean(_np(got) == _np(ref)) > 0.95
    else:
        np.testing.assert_allclose(_np(got), _np(ref), **FP32_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_matches_reference(kind, dtype):
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(3)
    p = jax.tree.map(np.asarray, ref_layers.mlp_init(jax.random.key(3), 32,
                                                     80, kind))
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    ref = ref_layers.mlp_apply(p, jnp.asarray(x).astype(jd), kind, jd)
    mod = _load(layers.MLP(32, 80, kind, dtype=td, device=CPU), p, td)
    got = layers.mlp_apply(mod, _t(x, td), kind, td)
    # bf16: silu and gelu round per op in XLA, once in torch
    tol = FP32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dh,theta", [(16, 10_000.0), (128, 1_000_000.0)])
def test_rope_matches_reference(dh, theta, dtype):
    td, jd = DTYPES[dtype]
    np.testing.assert_array_equal(layers.rope_freqs(dh, theta),
                                  ref_layers.rope_freqs(dh, theta))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 1024, (2, 9))
    ref = ref_layers.apply_rope(jnp.asarray(x).astype(jd), jnp.asarray(pos),
                                theta)
    got = layers.apply_rope(_t(x, td), torch.from_numpy(pos), theta)
    # fp32 cos/sin of angles up to 1024 rad differ by ulps of the angle
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


def test_init_distributions():
    """``Model.init`` draws the reference's distributions, reproducibly."""
    cfg = dataclasses.replace(configs.get_smoke("qwen2.5-3b"), d_model=128,
                              d_ff=256, vocab_size=2048)
    m = build_model(cfg)
    a, b, c = m.init(0, device=CPU), m.init(0, device=CPU), \
        m.init(1, device=CPU)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.table"], sc["embed.table"])
    assert abs(float(sa["embed.table"].std()) - 0.02) < 1e-3
    w = sa["layers.0.mlp.wo.w"]                      # (d_ff, d)
    assert abs(float(w.std()) * np.sqrt(256) - 1.0) < 0.02
    assert not sa["layers.0.attn.wq.b"].any()
    assert torch.equal(sa["final_norm.scale"], torch.ones(128))


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def _narrow_full_heads(cfg):
    """qwen2.5-3b's head layout (16 heads over 2, head_dim 128) at a narrow
    width: 2 layers, d_model 256, vocab 512."""
    return dataclasses.replace(cfg, name="qwen2.5-3b-heads", n_layers=2,
                               d_model=256, n_heads=16, n_kv_heads=2,
                               head_dim=128, d_ff=512, vocab_size=512,
                               dtype="float32")


def _dropless(cfg):
    """The reference's ``tests/test_models_smoke.py::_dropless``: MoE
    capacity drops depend on which tokens compete (a batch in prefill, one
    token per row in decode), so the consistency checks compare the
    drop-free function."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def _cfgs(arch, variant):
    ref, port = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    ref, port = _dropless(ref), _dropless(port)
    if variant == "full_heads":
        return _narrow_full_heads(ref), _narrow_full_heads(port)
    if variant == "bf16":
        return (dataclasses.replace(ref, dtype="bfloat16"),
                dataclasses.replace(port, dtype="bfloat16"))
    return ref, port


@pytest.mark.parametrize("variant", ["smoke", "full_heads"])
def test_gqa_prefill_decode_match_reference(variant):
    rcfg, cfg = _cfgs("qwen2.5-3b", variant)
    p = _perturb(ref_attn.gqa_init(jax.random.key(5), rcfg), 5)
    mod = _load(attention.GQA(cfg, dtype=torch.float32, device=CPU), p,
                torch.float32)
    rng = np.random.default_rng(5)
    b, s, t = 2, 12, 20
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    rc = ref_attn.init_gqa_cache(rcfg, b, t, jnp.float32)
    r_prefill = jax.jit(ref_attn.gqa_prefill, static_argnums=(1, 5))
    r_decode = jax.jit(ref_attn.gqa_decode, static_argnums=(1, 5))
    r_out, rc = r_prefill(p, rcfg, jnp.asarray(x), jnp.asarray(pos), rc,
                          jnp.float32)
    tc = attention.init_gqa_cache(cfg, b, t, torch.float32, device=CPU)
    # stale rows, as an earlier wave leaves them: masked, never read
    tc["k"].normal_()
    tc["v"].normal_()
    t_out, tc = attention.gqa_prefill(mod, cfg, _t(x), torch.from_numpy(
        pos.copy()), tc, torch.float32)
    np.testing.assert_allclose(_np(t_out), _np(r_out), **FP32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name][:, :s]),
                                   _np(rc[name][:, :s]), **FP32_TOL)
    # two decode steps, the rows at different positions
    dpos = np.array([s, s - 3])
    for step in range(2):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        r_out, rc = r_decode(p, rcfg, jnp.asarray(x1),
                             jnp.asarray(dpos + step), rc, jnp.float32)
        t_out, tc = attention.gqa_decode(mod, cfg, _t(x1),
                                         torch.from_numpy(dpos + step), tc,
                                         torch.float32)
        np.testing.assert_allclose(_np(t_out), _np(r_out), **FP32_TOL)
        for row in range(b):
            for name in ("k", "v"):
                hi = dpos[row] + step + 1
                np.testing.assert_allclose(_np(tc[name][row, :hi]),
                                           _np(rc[name][row, :hi]),
                                           **FP32_TOL)


def test_gqa_train_matches_reference_bidirectional():
    rcfg, cfg = _cfgs("qwen2.5-3b", "smoke")
    p = _perturb(ref_attn.gqa_init(jax.random.key(6), rcfg), 6)
    mod = _load(attention.GQA(cfg, dtype=torch.float32, device=CPU), p,
                torch.float32)
    x = np.random.default_rng(6).standard_normal((2, 9, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    for causal in (True, False):
        ref = jax.jit(ref_attn.gqa_train, static_argnums=(1, 4),
                      static_argnames="causal")(
            p, rcfg, jnp.asarray(x), jnp.asarray(pos), jnp.float32,
            causal=causal)
        got = attention.gqa_train(mod, cfg, _t(x),
                                  torch.from_numpy(pos.copy()),
                                  torch.float32, causal=causal)
        np.testing.assert_allclose(_np(got), _np(ref), **FP32_TOL)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["smoke", "bf16"])
def test_mla_prefill_decode_match_reference(variant):
    """``mla_train``, ``mla_prefill`` (output and the compressed cache
    rows, over stale rows) and, in fp32, three absorbed decode steps at
    per-row positions, against the reference."""
    rcfg, cfg = _cfgs("deepseek-v3-671b", variant)
    cdt, jdt = getattr(torch, cfg.dtype), jnp.dtype(cfg.dtype)
    p = _perturb(ref_attn.mla_init(jax.random.key(7), rcfg), 7)
    mod = load_module(attention.MLA(cfg, dtype=cdt, device=CPU), p)
    tol = _tol(cfg.dtype) if variant == "smoke" else LOGIT_TOL["bf16"]
    rng = np.random.default_rng(7)
    b, s, t = 2, 12, 20
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jx = jnp.asarray(x).astype(jdt)
    r_train = jax.jit(ref_attn.mla_train, static_argnums=(1, 4))(
        p, rcfg, jx, jnp.asarray(pos), jdt)
    t_train = attention.mla_train(mod, cfg, _t(x, cdt),
                                  torch.from_numpy(pos.copy()), cdt)
    np.testing.assert_allclose(_np(t_train), _np(r_train), **tol)
    rc = ref_attn.init_mla_cache(rcfg, b, t, jdt)
    r_out, rc = jax.jit(ref_attn.mla_prefill, static_argnums=(1, 5))(
        p, rcfg, jx, jnp.asarray(pos), rc, jdt)
    tc = attention.init_mla_cache(cfg, b, t, cdt, device=CPU)
    for v in tc.values():
        v.normal_()                      # stale rows: masked, never read
    t_out, tc = attention.mla_prefill(mod, cfg, _t(x, cdt), torch.from_numpy(
        pos.copy()), tc, cdt)
    np.testing.assert_allclose(_np(t_out), _np(r_out), **tol)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(tc[name][:, :s]),
                                   _np(rc[name][:, :s]), **tol)
    if variant == "bf16":
        # the reference's bf16 absorbed decode does not run on XLA's CPU
        # backend (a batched bf16 x bf16 -> f32 dot it does not take)
        return
    r_decode = jax.jit(ref_attn.mla_decode, static_argnums=(1, 5))
    dpos = np.array([s, s - 3])
    for step in range(3):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        r_out, rc = r_decode(p, rcfg, jnp.asarray(x1).astype(jdt),
                             jnp.asarray(dpos + step), rc, jdt)
        t_out, tc = attention.mla_decode(mod, cfg, _t(x1, cdt),
                                         torch.from_numpy(dpos + step), tc,
                                         cdt)
        np.testing.assert_allclose(_np(t_out), _np(r_out), **tol)
        for row in range(b):
            hi = dpos[row] + step + 1
            for name in ("c_kv", "k_rope"):
                np.testing.assert_allclose(_np(tc[name][row, :hi]),
                                           _np(rc[name][row, :hi]), **tol)


def test_mla_absorbed_decode_matches_train():
    """The reference's ``tests/test_attention.py`` identity on the port:
    the compressed-space decode equals the expanded attention's last
    row."""
    _, cfg = _cfgs("deepseek-v3-671b", "smoke")
    p = _perturb(ref_attn.mla_init(jax.random.key(0), cfg), 0)
    mod = load_module(attention.MLA(cfg, dtype=torch.float32, device=CPU), p)
    b, s = 2, 10
    x = _t(np.random.default_rng(1).standard_normal((b, s, cfg.d_model))
           * 0.1)
    pos = torch.arange(s).expand(b, s)
    full = attention.mla_train(mod, cfg, x, pos, torch.float32)
    cache = attention.init_mla_cache(cfg, b, 16, torch.float32, device=CPU)
    _, cache = attention.mla_prefill(mod, cfg, x[:, :-1], pos[:, :-1], cache,
                                     torch.float32)
    step, _ = attention.mla_decode(mod, cfg, x[:, -1:],
                                   torch.full((b,), s - 1), cache,
                                   torch.float32)
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch, variant):
    """(reference cfg, model, params; port cfg, model, params), shared by
    the tests of one arch and variant."""
    rcfg, cfg = _cfgs(arch, variant)
    rm = ref_build_model(rcfg)
    rp = _perturb(rm.init(jax.random.key(11)), 11)
    m = build_model(cfg)
    return rcfg, rm, rp, cfg, m, _port_params(rp, cfg)


def _port_params(rp, cfg):
    """The reference tree ``rp`` loaded into the port's module."""
    if cfg.family == "audio":
        tp = encdec.EncDecLM(cfg, device=CPU)
        tp.load_state_dict(convert.encdec_params_from_numpy(rp, cfg,
                                                            device=CPU))
    else:
        tp = transformer.DecoderLM(cfg, device=CPU)
        tp.load_state_dict(convert.lm_params_from_numpy(rp, cfg, device=CPU))
    return tp


def _batch(cfg, tokens, rng):
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal(
            (tokens.shape[0], cfg.n_prefix_embeds, cfg.d_model)) * 0.02
        ).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


#: cache entries indexed by position (compared up to the rows written);
#: every other entry is a recurrent state, compared whole
_POSITIONAL = ("k", "v", "c_kv", "k_rope")


def _cache_pairs(cfg, tc, rc, i):
    """(name, port entry, reference entry) of layer ``i``'s caches."""
    if cfg.family == "audio":
        return [(f"{part}.{name}", tc[part][i][name], rc[part][name][i])
                for part in ("self", "cross_kv") for name in ("k", "v")]
    prefix, period, _ = transformer.period_structure(cfg)
    if i < len(prefix):
        ref = rc["prefix"][i]
    else:
        p, j = divmod(i - len(prefix), len(period))
        ref = jax.tree.map(lambda x: x[p], rc["period"][j])
    return [(name, tc["layers"][i][name], ref[name])
            for name in tc["layers"][i]]


def _forward(cfg, tp, batch):
    """The port's teacher-forced logits for a numpy batch."""
    pt = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cfg.family == "audio":
        return encdec.forward(tp, cfg, pt["tokens"], pt["frames"])
    return transformer.forward(tp, cfg, pt["tokens"],
                               prefix_embeds=pt.get("patches"))


#: logits are of order 1; bf16 runs round every activation
LOGIT_TOL = {"smoke": FP32_TOL, "full_heads": FP32_TOL,
             "bf16": dict(rtol=0, atol=3e-2)}
MODEL_CASES = [(a, "smoke") for a in DENSE_ARCHS + OTHER_ARCHS] + [
    ("qwen2.5-3b", "full_heads"), ("qwen2.5-3b", "bf16")]


def _assert_logits(got, want, variant):
    got, want = _np(got), _np(want)
    tol = LOGIT_TOL[variant]
    np.testing.assert_allclose(got, want, **tol)
    # the greedy token agrees wherever the reference's top two are further
    # apart than the two sides can move
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * (tol["atol"] + tol["rtol"]
                                               * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("arch,variant", MODEL_CASES)
def test_prefill_decode_chain_match_reference(arch, variant):
    """``Model.prefill`` then three greedy ``Model.decode`` steps (the
    reference's tokens fed to both), logits and cache rows, and the
    reference's own check that the chain equals ``forward``."""
    rcfg, rm, rp, cfg, m, tp = _models(arch, variant)
    rng = np.random.default_rng(12)
    b, s, t = 2, 8, 32
    toks = rng.integers(1, cfg.vocab_size, (b, s))
    batch = _batch(cfg, toks, rng)
    n_pre = cfg.n_prefix_embeds if "patches" in batch else 0
    cdt = getattr(torch, cfg.dtype)
    rc = rm.init_cache(b, t, dtype=jnp.dtype(rcfg.dtype))
    r_logits, rc = jax.jit(rm.prefill)(rp, {k: jnp.asarray(v) for k, v in
                                            batch.items()}, rc)
    tc = m.init_cache(b, t, dtype=cdt, device=CPU)
    t_logits, tc = m.prefill(tp, {k: torch.from_numpy(v) for k, v in
                                  batch.items()}, tc)
    assert t_logits.shape == (b, 1, cfg.vocab_size)
    assert t_logits.dtype == torch.float32
    _assert_logits(t_logits, r_logits, variant)

    dec = jax.jit(rm.decode)
    tok = np.asarray(jnp.argmax(r_logits[:, -1], -1)).astype(np.int32)
    seq = [tok]
    for i in range(3):
        pos = np.full(b, s + n_pre + i, np.int32)
        r_logits, rc = dec(rp, rc, jnp.asarray(tok), jnp.asarray(pos))
        t_logits, tc = m.decode(tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        assert t_logits.shape == (b, cfg.vocab_size)
        _assert_logits(t_logits, r_logits, variant)
        tok = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
        seq.append(tok)
    # the caches written by prefill and the chain, first and last layer
    n = s + n_pre + 3
    kv_tol = FP32_TOL if variant != "bf16" else dict(rtol=2e-2, atol=2e-2)
    for i in (0, cfg.n_layers - 1):
        for name, got, want in _cache_pairs(cfg, tc, rc, i):
            tol = dict(kv_tol)
            if name.rsplit(".", 1)[-1] in _POSITIONAL:
                got, want = got[:, :n], want[:, :n]
            else:
                # a recurrent state sums a term per step: its rounding
                # scales with the largest entry, not with each entry
                tol["atol"] *= max(1.0, float(np.abs(_np(want)).max()))
            np.testing.assert_allclose(_np(got), _np(want), **tol,
                                       err_msg=f"layer {i} {name}")

    # the chain equals the port's own forward over prompt ++ tokens
    full = np.concatenate([toks] + [x[:, None] for x in seq[:-1]], axis=1)
    logits, _ = _forward(cfg, tp, dict(batch, tokens=full))
    got = logits[:, n_pre + s - 1:].argmax(-1).numpy()
    if variant != "bf16":   # bf16: the reference's own check is fp32-only
        np.testing.assert_array_equal(got, np.stack(seq, axis=1))


@pytest.mark.parametrize("arch,variant", MODEL_CASES)
def test_forward_matches_reference(arch, variant):
    rcfg, rm, rp, cfg, m, tp = _models(arch, variant)
    rng = np.random.default_rng(13)
    toks = rng.integers(1, cfg.vocab_size, (2, 10))
    batch = _batch(cfg, toks, rng)
    if cfg.family == "audio":
        ref, r_aux = jax.jit(functools.partial(ref_encdec.forward, cfg=rcfg))(
            rp, tokens=jnp.asarray(toks), frames=jnp.asarray(batch["frames"]))
    else:
        pe = batch.get("patches")
        ref, r_aux = jax.jit(functools.partial(ref_tr.forward, cfg=rcfg,
                                               remat=False))(
            rp, tokens=jnp.asarray(toks),
            prefix_embeds=None if pe is None else jnp.asarray(pe))
    got, aux = _forward(cfg, tp, batch)
    assert got.shape == ref.shape
    # the summed MoE load-balance loss (0 without MoE layers)
    np.testing.assert_allclose(float(aux["load_balance_loss"]),
                               float(r_aux["load_balance_loss"]),
                               **FP32_TOL)
    _assert_logits(got, ref, variant)


def test_converted_state_matches_module():
    """Every converted leaf lands on a port parameter of the stored dtype:
    matrices and the embedding in the compute dtype, the rest fp32."""
    rcfg, cfg = _cfgs("qwen2.5-3b", "bf16")
    rp = jax.tree.map(np.asarray,
                      ref_build_model(rcfg).init(jax.random.key(0)))
    sd = convert.lm_params_from_numpy(rp, cfg, device=CPU)
    mod = transformer.DecoderLM(cfg, device=CPU)
    want = mod.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
    assert sd["layers.1.attn.wq.w"].dtype == torch.bfloat16
    assert sd["layers.1.attn.wq.b"].dtype == torch.float32
    np.testing.assert_array_equal(
        sd["layers.1.attn.wk.w"].float().numpy(),
        np.asarray(jnp.asarray(rp["period"][0]["attn"]["wk"]["w"][1])
                   .astype(jnp.bfloat16).astype(jnp.float32)))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    """The reference's ``tests/test_serve.py`` server and the port's on the
    same parameters."""
    rcfg = ref_configs.get_smoke("qwen2.5-3b")
    cfg = configs.get_smoke("qwen2.5-3b")
    rm = ref_build_model(rcfg)
    rp = rm.init(jax.random.key(0))
    m = build_model(cfg)
    tp = transformer.DecoderLM(cfg, device=CPU)
    tp.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp), cfg, device=CPU))
    return (RefBatchServer(rm, rp, slots=4, max_len=64, eos_id=-1),
            BatchServer(m, tp, slots=4, max_len=64, eos_id=-1, device=CPU))


@pytest.mark.parametrize("reqs,n_new", [
    ([[5, 6, 7], [8, 9], [3, 4, 5, 6]], 8),
    ([[11]], 4),
    ([[7, 13, 21]], 4),
])
def test_server_tokens_match_reference(servers, reqs, n_new):
    ref_srv, srv = servers
    want, _ = ref_srv.serve(reqs, max_new_tokens=n_new)
    got, stats = srv.serve(reqs, max_new_tokens=n_new)
    assert got == want
    assert stats.tokens_out == len(reqs) * n_new
    # the cache is reused in place: a second wave gives the same tokens
    again, _ = srv.serve(reqs, max_new_tokens=n_new)
    assert again == got


def test_server_stops_at_eos(servers):
    _, srv = servers
    first, _ = srv.serve([[5, 6, 7]], max_new_tokens=6)
    srv.eos_id = first[0][2]
    try:
        out, stats = srv.serve([[5, 6, 7]], max_new_tokens=6)
    finally:
        srv.eos_id = -1
    assert out[0] == first[0][:3]
    assert stats.tokens_out == 2


# --------------------------------------------------------------------------
# every arch builds, and where it runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_arch_builds(arch):
    """``Model.init`` draws every smoke config on the CPU, each parameter
    in the dtype the converter gives it; the published config builds its
    full module on ``meta`` (no memory)."""
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="bfloat16")
    params = build_model(cfg).init(0, device=CPU)
    sd = params.state_dict()
    assert all(bool(torch.isfinite(v.float()).all()) for v in sd.values())
    fp32_tables = (("embed.table", "pos_dec.table")
                   if cfg.family == "audio" else ())
    for name, v in sd.items():
        fp32 = convert._lm_fp32(name) or name in fp32_tables
        assert v.dtype == (torch.float32 if fp32 else torch.bfloat16), name
    full = configs.get(arch)
    module = (encdec.EncDecLM if full.family == "audio"
              else transformer.DecoderLM)(full, device="meta")
    assert sum(p.numel() for p in module.parameters()) > 0


@pytest.mark.parametrize("arch", OTHER_ARCHS[:4])
def test_converted_fp32_leaves(arch):
    """The converter's state dict loads into the module at a bf16 config,
    and the leaves the reference keeps in fp32 or widens before use stay
    fp32 (MoE's router, RWKV's decay base, bonus and GroupNorm, Mamba's
    dt bias, ``a_log`` and skip)."""
    rcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in
                 (ref_configs.get_smoke(arch), configs.get_smoke(arch)))
    rp = jax.tree.map(np.asarray,
                      ref_build_model(rcfg).init(jax.random.key(0)))
    sd = convert.lm_params_from_numpy(rp, cfg, device=CPU)
    mod = transformer.DecoderLM(cfg, device=CPU)
    want = mod.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
    mod.load_state_dict(sd)
    fp32 = {"router.w", "decay_base", "bonus_u", "gn_scale", "gn_bias",
            "dt_bias_init", "a_log", "d_skip"}
    special = [k for k in sd if any(k.endswith(f) for f in fp32)]
    assert special and all(sd[k].dtype == torch.float32 for k in special)


def test_every_arch_config_matches_reference():
    for name in configs.ARCH_NAMES:
        for get in ("get", "get_smoke"):
            a = getattr(configs, get)(name)
            b = getattr(ref_configs, get)(name)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.param_count() == b.param_count()
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card every LM entry point raises instead of running on the
    CPU: a silent fallback would report CPU numbers as the card's.  A
    dense arch, an MoE one and the encoder-decoder."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("qwen2.5-3b", "qwen3-moe-30b-a3b", "whisper-tiny"):
        cfg = configs.get_smoke(arch)
        m = build_model(cfg)
        with pytest.raises(RuntimeError):
            m.init(0)
        with pytest.raises(RuntimeError):
            m.init_cache(1, 8)
        tp = m.init(0, device=CPU)
        with pytest.raises(RuntimeError):
            BatchServer(m, tp, slots=1, max_len=8)
