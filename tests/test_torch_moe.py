"""Port MoE (``repro_torch.models.moe``) vs the reference, on the CPU.

The reference's ``tests/test_moe.py`` checks, held against the reference
itself on the same parameters and inputs: ``capacity``; one dispatch
block's output, load-balance loss and drop fraction, with drops and
dropless, SwiGLU and GELU experts, fp32 and bf16; the same chosen experts;
chunked dispatch equal to unchunked; the shared expert added; the owner
sort conserving every assignment.  The reference's parameters (fp32
masters) are loaded into the port's module in its stored dtypes.

Tolerances: fp32 differs by summation order alone (1e-5 on values of
order 1); bf16 rounds every activation, and a product that lands on the
other side of a rounding boundary moves by a bf16 ulp: 3e-2 absolute on
outputs of order 1 (``LOGIT_TOL["bf16"]`` of ``tests/test_torch_lm.py``),
plus two ulps (2^-6) relative, since an output of up to 4 in size is
rounded twice on each side (the combine's sum over k, then the shared
expert's add) and the reference rounds its bf16 segment sum after every
add where the port rounds once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig
from repro.models import moe as ref_moe
from repro_torch.models import moe
from repro_torch.models.layers import mlp_apply

CPU = "cpu"
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -6, atol=3e-2)
DTYPES = {"float32": (torch.float32, jnp.float32, FP32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def load_module(module, tree):
    """A reference sub-tree (nested dicts) loaded into a port module, each
    leaf cast to the dtype the module stores it in."""
    want = module.state_dict()
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                name = f"{prefix}{k}"
                flat[name] = torch.from_numpy(np.array(v, np.float32)).to(
                    want[name].dtype)
    walk(tree, "")
    module.load_state_dict(flat)
    return module


def _setup(e, d, mlp_kind, dtype, seed=0):
    """(reference params, port MoE) from one reference init."""
    rp = jax.tree.map(np.asarray, ref_moe.moe_init(jax.random.key(seed), d,
                                                   mlp_kind, e))
    mod = moe.MoE(d, mlp_kind, e, dtype=DTYPES[dtype][0], device=CPU)
    return rp, load_module(mod, rp)


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    td, jd, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("n_tokens", [1, 4, 37, 2048])
@pytest.mark.parametrize("e", [MoEConfig(8, 2, 16),
                               MoEConfig(256, 8, 2048, capacity_factor=1.25),
                               MoEConfig(16, 2, 8, capacity_factor=16.0)])
def test_capacity_matches_reference(n_tokens, e):
    assert moe.capacity(n_tokens, e) == ref_moe.capacity(n_tokens, e)


#: (capacity factor, whether assignments drop): 0.5 drops about half
CASES = {"drops": 0.5, "dropless": 16.0}


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_block_matches_reference(case, dtype, mlp_kind):
    e = MoEConfig(n_experts=8, top_k=2, expert_ff=24,
                  capacity_factor=CASES[case])
    d = 32
    rp, mod = _setup(e, d, mlp_kind, dtype, seed=1)
    jx, tx = _x((64, d), 1, dtype)
    cd_t, cd_j, tol = DTYPES[dtype]
    y_r, aux_r, drop_r = ref_moe._dispatch_block(rp, e, mlp_kind, jx, cd_j)
    y, aux, drop = moe._dispatch_block(mod, e, mlp_kind, tx, cd_t)
    assert y.shape == (64, d) and y.dtype == cd_t
    # the same experts chosen, so the same assignments kept and dropped
    probs = jax.nn.softmax(jnp.einsum("td,de->te", jx.astype(jnp.float32),
                                      rp["router"]["w"]), axis=-1)
    _, idx_r = jax.lax.top_k(probs, e.top_k)
    np.testing.assert_array_equal(moe._route(mod, e, tx)[2].numpy(),
                                  np.asarray(idx_r))
    assert float(drop) == float(drop_r)
    if case == "drops":
        assert float(drop) > 0.2
    else:
        assert float(drop) == 0.0
    np.testing.assert_allclose(float(aux), float(aux_r), **FP32_TOL)
    np.testing.assert_allclose(_np(y), _np(y_r), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_apply_matches_reference(dtype):
    """The whole layer with a shared expert and several dispatch chunks."""
    e = MoEConfig(n_experts=8, top_k=2, expert_ff=16, n_shared=1,
                  dispatch_chunk=16)                 # b=2 -> 4 chunks of 8
    d = 24
    rp, mod = _setup(e, d, "swiglu", dtype, seed=2)
    jx, tx = _x((2, 32, d), 2, dtype)
    cd_t, cd_j, tol = DTYPES[dtype]
    y_r, aux_r = ref_moe.moe_apply(rp, e, "swiglu", jx, cd_j)
    y, aux = moe.moe_apply(mod, e, "swiglu", tx, cd_t)
    assert y.dtype == tx.dtype
    np.testing.assert_allclose(_np(y), _np(y_r), **tol)
    for key in ("load_balance_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux[key]), float(aux_r[key]),
                                   **FP32_TOL)


def test_chunked_equals_unchunked():
    d = 24
    e1 = MoEConfig(n_experts=4, top_k=2, expert_ff=16, capacity_factor=8.0,
                   dispatch_chunk=1 << 30)
    e2 = dataclasses.replace(e1, dispatch_chunk=16)  # 4 chunks
    _, mod = _setup(e1, d, "swiglu", "float32", seed=3)
    _, tx = _x((2, 32, d), 3, "float32")
    y1, aux1 = moe.moe_apply(mod, e1, "swiglu", tx, torch.float32)
    y2, aux2 = moe.moe_apply(mod, e2, "swiglu", tx, torch.float32)
    # with no capacity drops, chunked dispatch is the same function
    torch.testing.assert_close(y1, y2, **FP32_TOL)
    assert float(aux1["drop_frac"]) == float(aux2["drop_frac"]) == 0.0


def test_shared_expert_added():
    d = 16
    e = MoEConfig(n_experts=4, top_k=1, expert_ff=8, n_shared=1,
                  capacity_factor=8.0)
    rp, mod = _setup(e, d, "swiglu", "float32", seed=4)
    _, tx = _x((1, 8, d), 4, "float32")
    y_with, _ = moe.moe_apply(mod, e, "swiglu", tx, torch.float32)
    shared, mod.shared = mod.shared, None
    y_wo, _ = moe.moe_apply(mod, e, "swiglu", tx, torch.float32)
    torch.testing.assert_close(y_with - y_wo, mlp_apply(
        shared, tx, "swiglu", torch.float32), **FP32_TOL)
    assert not torch.allclose(y_with, y_wo)


@pytest.mark.parametrize("seed", range(10))
def test_owner_sorted_dispatch_conserves_tokens(seed):
    """Every assignment lands in exactly one row of its expert's run (the
    indegree ownership invariant), in the reference's order."""
    rng = np.random.default_rng(seed)
    t, k, n_e = 64, 2, 8
    flat_e = rng.integers(0, n_e, t * k)
    order, se, pos = moe._owner_sort(torch.from_numpy(flat_e), n_e)
    r_order = np.asarray(jnp.argsort(jnp.asarray(flat_e), stable=True))
    np.testing.assert_array_equal(order.numpy(), r_order)
    np.testing.assert_array_equal(se.numpy(), flat_e[r_order])
    for e_i in range(n_e):
        sel = pos.numpy()[se.numpy() == e_i]
        assert sorted(sel.tolist()) == list(range(len(sel)))


def test_dispatch_is_deterministic():
    """Kept rows are written once and the combine sums in a fixed order,
    so two calls agree bitwise (the card's atomics would not)."""
    e = MoEConfig(n_experts=8, top_k=2, expert_ff=16, capacity_factor=0.5)
    _, mod = _setup(e, 32, "swiglu", "bfloat16", seed=5)
    _, tx = _x((2, 48, 32), 5, "bfloat16")
    a = moe.moe_apply(mod, e, "swiglu", tx, torch.bfloat16)[0]
    b = moe.moe_apply(mod, e, "swiglu", tx, torch.bfloat16)[0]
    assert torch.equal(a, b)
