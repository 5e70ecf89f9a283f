"""Port Mamba and RWKV-6 mixers vs the reference, on the CPU.

``repro_torch.models.mamba`` against ``repro.models.mamba`` (jamba's smoke
widths) and ``repro_torch.models.rwkv`` against ``repro.models.rwkv``
(rwkv6-3b's smoke widths): the train function over a length that spans
several of the reference's scan chunks and a padded tail, the prefill
(output and the cache it fills, against the reference's ``mamba_train`` +
``transformer._mamba_prefill_cache`` and ``transformer._rwkv_prefill`` on
a zeroed cache; the port's cache holds stale values first, which a
prefill overwrites), three decode steps from there, and the channel mix.
The reference's parameters are loaded into the port's modules in their
stored dtypes; its zero-initialised biases and unit scales are drawn away
from 0 and 1 so that they matter.

Tolerances: fp32 outputs differ by summation order (1e-5 on values of
order 1); a recurrent state sums a term per step, so its absolute
tolerance is 1e-5 times its largest entry.  bf16 rounds every activation:
3e-2 absolute plus one bf16 ulp (2^-7) relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mamba as ref_mamba
from repro.models import rwkv as ref_rwkv
from repro.models import transformer as ref_tr
from repro_torch import configs
from repro_torch.models import mamba, rwkv

from test_torch_moe import load_module

CPU = "cpu"
DTYPES = {"float32": (torch.float32, jnp.float32,
                      dict(rtol=1e-5, atol=1e-5)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16,
                       dict(rtol=2 ** -7, atol=3e-2))}
#: leaves drawn away from their constant initial values
_PERTURB = ("b", "conv_b", "gn_scale", "gn_bias", "mix_base", "cm_mix",
            "d_skip")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key in _PERTURB:
            return (x + rng.normal(0.0, 0.2, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def _close(got, want, tol, state=False, what=""):
    tol = dict(tol)
    if state:
        tol["atol"] *= max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=what)


def _inputs(cfg, shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    td, jd, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _stale(cache):
    """A cache whose entries hold what an earlier wave left."""
    for v in cache.values():
        v.normal_()
    return cache


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mamba(dtype):
    cfg = configs.get_smoke("jamba-v0.1-52b")
    rcfg = ref_configs.get_smoke("jamba-v0.1-52b")
    rp = _perturb(ref_mamba.mamba_init(jax.random.key(1), rcfg), 1)
    mod = mamba.Mamba(cfg, dtype=DTYPES[dtype][0], device=CPU)
    return rcfg, rp, cfg, load_module(mod, rp)


def test_mamba_init_matches_reference():
    """The deterministic leaves are the reference's exactly; the drawn
    ones have its scale."""
    rcfg, _, cfg, _ = _mamba("float32")
    ref = ref_mamba.mamba_init(jax.random.key(0), rcfg)
    p = mamba.mamba_init(mamba.Mamba(cfg, dtype=torch.float32, device=CPU),
                         torch.Generator().manual_seed(0))
    for name in ("dt_bias_init", "a_log", "d_skip", "conv_b"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(ref[name]), err_msg=name)
        assert getattr(p, name).dtype == torch.float32 or name == "conv_b"
    assert abs(float(p.conv_w.std()) * 2 - 1) < 0.1          # 1/sqrt(4)
    assert not p.dt_proj.b.any()


@pytest.mark.parametrize("t", [37, 16])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_train_matches_reference(dtype, t):
    rcfg, rp, cfg, mod = _mamba(dtype)
    td, jd, tol = DTYPES[dtype]
    jx, tx = _inputs(cfg, (2, t, cfg.d_model), 2, dtype)
    want = jax.jit(ref_mamba.mamba_train, static_argnums=(1, 3))(
        rp, rcfg, jx, jd)
    got = mamba.mamba_train(mod, cfg, tx, td)
    assert got.dtype == td and got.shape == (2, t, cfg.d_model)
    _close(got, want, tol)


@pytest.mark.parametrize("t", [21, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_prefill_decode_match_reference(dtype, t):
    """Prefill (a prompt shorter than the conv window included), then
    three decode steps, outputs and caches."""
    rcfg, rp, cfg, mod = _mamba(dtype)
    td, jd, tol = DTYPES[dtype]
    b = 2
    jx, tx = _inputs(cfg, (b, t, cfg.d_model), 3, dtype)
    rc = ref_mamba.init_mamba_cache(rcfg, b, jd)
    want = ref_mamba.mamba_train(rp, rcfg, jx, jd)
    rc = ref_tr._mamba_prefill_cache(rp, rcfg, jx, rc, jd)
    tc = _stale(mamba.init_mamba_cache(cfg, b, td, device=CPU))
    got, tc = mamba.mamba_prefill(mod, cfg, tx, tc, td)
    _close(got, want, tol, what="prefill")
    _close(tc["conv"], rc["conv"], tol, what="conv")
    _close(tc["h"], rc["h"], tol, state=True, what="h")
    dec = jax.jit(ref_mamba.mamba_decode, static_argnums=(1, 4))
    for i in range(3):
        jx1, tx1 = _inputs(cfg, (b, 1, cfg.d_model), 10 + i, dtype)
        want, rc = dec(rp, rcfg, jx1, rc, jd)
        got, tc = mamba.mamba_decode(mod, cfg, tx1, tc, td)
        _close(got, want, tol, what=f"decode {i}")
        _close(tc["conv"], rc["conv"], tol, what=f"conv {i}")
        _close(tc["h"], rc["h"], tol, state=True, what=f"h {i}")


def test_mamba_decode_matches_train():
    """Prefill of T-1 tokens then one decode step gives train's last row
    (the reference's own consistency check, on the port alone)."""
    _, _, cfg, mod = _mamba("float32")
    _, x = _inputs(cfg, (2, 12, cfg.d_model), 4, "float32")
    full = mamba.mamba_train(mod, cfg, x, torch.float32)
    cache = mamba.init_mamba_cache(cfg, 2, torch.float32, device=CPU)
    _, cache = mamba.mamba_prefill(mod, cfg, x[:, :-1], cache, torch.float32)
    step, _ = mamba.mamba_decode(mod, cfg, x[:, -1:], cache, torch.float32)
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# RWKV-6
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rwkv(dtype):
    cfg = configs.get_smoke("rwkv6-3b")
    rcfg = ref_configs.get_smoke("rwkv6-3b")
    rp = _perturb(ref_rwkv.rwkv_init(jax.random.key(5), rcfg), 5)
    mod = rwkv.RWKV(cfg, dtype=DTYPES[dtype][0], device=CPU)
    return rcfg, rp, cfg, load_module(mod, rp)


def test_rwkv_init_matches_reference():
    rcfg, _, cfg, _ = _rwkv("float32")
    ref = ref_rwkv.rwkv_init(jax.random.key(0), rcfg)
    p = rwkv.rwkv_init(rwkv.RWKV(cfg, dtype=torch.bfloat16, device=CPU),
                       torch.Generator().manual_seed(0))
    for name in ("decay_base", "gn_scale", "gn_bias", "mix_base", "cm_mix"):
        np.testing.assert_array_equal(_np(getattr(p, name)),
                                      np.asarray(ref[name]), err_msg=name)
    for name in ("decay_base", "bonus_u", "gn_scale", "gn_bias"):
        assert getattr(p, name).dtype == torch.float32, name
    assert p.wr.w.dtype == torch.bfloat16
    assert abs(float(p.bonus_u.std()) - 0.1) < 0.02


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_time_mix_train_matches_reference(dtype):
    rcfg, rp, cfg, mod = _rwkv(dtype)
    td, jd, tol = DTYPES[dtype]
    jx, tx = _inputs(cfg, (2, 37, cfg.d_model), 6, dtype)
    want = jax.jit(ref_rwkv.rwkv_time_mix_train, static_argnums=(1, 3))(
        rp, rcfg, jx, jd)
    got = rwkv.rwkv_time_mix_train(mod, cfg, tx, td)
    assert got.dtype == td
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_channel_mix_matches_reference(dtype):
    rcfg, rp, cfg, mod = _rwkv(dtype)
    td, jd, tol = DTYPES[dtype]
    jx, tx = _inputs(cfg, (2, 9, cfg.d_model), 7, dtype)
    _close(rwkv.rwkv_channel_mix_train(mod, cfg, tx, td),
           ref_rwkv.rwkv_channel_mix_train(rp, rcfg, jx, jd), tol)
    rc = ref_rwkv.init_rwkv_cache(rcfg, 2, jd)
    tc = rwkv.init_rwkv_cache(cfg, 2, td, device=CPU)
    for i in range(3):
        want, rc = ref_rwkv.rwkv_channel_mix_decode(rp, rcfg, jx[:, i:i + 1],
                                                    rc, jd)
        got, tc = rwkv.rwkv_channel_mix_decode(mod, cfg, tx[:, i:i + 1], tc,
                                               td)
        _close(got, want, tol, what=f"decode {i}")
        _close(tc["x_cm"], rc["x_cm"], tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_prefill_decode_match_reference(dtype):
    rcfg, rp, cfg, mod = _rwkv(dtype)
    td, jd, tol = DTYPES[dtype]
    b = 2
    jx, tx = _inputs(cfg, (b, 19, cfg.d_model), 8, dtype)
    rc = ref_rwkv.init_rwkv_cache(rcfg, b, jd)
    want, rc = ref_tr._rwkv_prefill(rp, rcfg, jx, rc, jd)
    tc = _stale(rwkv.init_rwkv_cache(cfg, b, td, device=CPU))
    got, tc = rwkv.rwkv_time_mix_prefill(mod, cfg, tx, tc, td)
    _close(got, want, tol, what="prefill")
    _close(tc["s"], rc["s"], tol, state=True, what="s")
    _close(tc["x_tm"], rc["x_tm"], tol, what="x_tm")
    dec = jax.jit(ref_rwkv.rwkv_time_mix_decode, static_argnums=(1, 4))
    for i in range(3):
        jx1, tx1 = _inputs(cfg, (b, 1, cfg.d_model), 20 + i, dtype)
        want, rc = dec(rp, rcfg, jx1, rc, jd)
        got, tc = rwkv.rwkv_time_mix_decode(mod, cfg, tx1, tc, td)
        _close(got, want, tol, what=f"decode {i}")
        _close(tc["s"], rc["s"], tol, state=True, what=f"s {i}")
        _close(tc["x_tm"], rc["x_tm"], tol, what=f"x_tm {i}")


def test_rwkv_decode_matches_train():
    _, _, cfg, mod = _rwkv("float32")
    _, x = _inputs(cfg, (2, 12, cfg.d_model), 9, "float32")
    full = rwkv.rwkv_time_mix_train(mod, cfg, x, torch.float32)
    cache = rwkv.init_rwkv_cache(cfg, 2, torch.float32, device=CPU)
    _, cache = rwkv.rwkv_time_mix_prefill(mod, cfg, x[:, :-1], cache,
                                          torch.float32)
    step, _ = rwkv.rwkv_time_mix_decode(mod, cfg, x[:, -1:], cache,
                                        torch.float32)
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=1e-5,
                               atol=1e-5)
