"""Port LM training (loss, gradients, train step, launcher) vs the
reference, on the CPU.

* ``Model.loss`` and its gradients: the reference's ``jax.value_and_grad(
  m.loss)`` and the port's train step's own differentiation
  (``train.loop._value_and_grad``) on the same parameters and batch, for
  the dense smoke archs here and the MoE, MLA, recurrent and
  encoder-decoder ones in ``test_torch_lm_train_families.py``: the loss,
  ``ce`` and ``load_balance_loss`` within ``rtol=1e-5``, and every
  gradient leaf by name within ``1e-4 * max|g_ref| + 1e-7``;
* qwen2.5-3b's smoke config computing in bf16 (fp32 parameters), held by
  the global relative L2 error of the gradients;
* attention's train route: the port's ``_sdpa_chunked`` against the
  reference's at small chunks, causal and not, values and gradients; with
  grad on no K8 call, under ``no_grad`` K8's entry;
* the fp32-output GEMM's ``autograd.Function``: its backward bitwise
  autograd's through the upcast product;
* the train step: two microbatches equal the full batch, the loss falls
  over 10 steps, and ``launch/train.py`` resumed after 5 steps equals its
  uninterrupted 10 bitwise.

Both packages start from the reference's ``m.init(jax.random.key(0))``
tree with its biases and norm parameters perturbed (so that they matter),
carried across in fp32 by ``convert.lm_params_from_numpy`` (or
``encdec_params_from_numpy``) with ``dtype=torch.float32``; the
reference's gradient tree crosses by the same renaming.  Inputs are drawn
with numpy.  fp32 runs differ by summation order alone (XLA's and torch's
matmuls and reductions).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, encdec, layers, transformer
from repro_torch.models.model import build_model
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_mod
from repro_torch.data.pipeline import TokenPipeline

from test_torch_lm import _perturb

CPU = "cpu"
DENSE_ARCHS = ("qwen2.5-3b", "internlm2-1.8b", "phi3-medium-14b",
               "command-r-plus-104b", "internvl2-1b")
B, S = 2, 12
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7
#: bf16 compute: every activation rounds to 8 bits, so the gradients
#: move by a few bf16 ulps of the activations they multiply
BF16_GRAD_REL_L2 = 5e-2
BF16_LOSS_RTOL = 1e-2


def _ref_cfg(arch, dtype="float32"):
    return dataclasses.replace(ref_configs.get_smoke(arch), dtype=dtype)


def _port_cfg(arch, dtype="float32"):
    return dataclasses.replace(configs.get_smoke(arch), dtype=dtype)


def _batch(cfg, seed=21):
    """Tokens (B, S + 1) and the modality stub's input, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def to_port(tree, cfg):
    """A reference tree shaped like the parameters (parameters or
    gradients) as the port's named fp32 tensors."""
    fn = (convert.encdec_params_from_numpy if cfg.family == "audio"
          else convert.lm_params_from_numpy)
    return fn(jax.tree.map(lambda x: np.asarray(x, np.float32), tree), cfg,
              device=CPU, dtype=torch.float32)


def port_params(rp, cfg):
    """The reference tree loaded into a port module, every leaf fp32."""
    cls = (encdec.EncDecLM if cfg.family == "audio"
           else transformer.DecoderLM)
    mod = cls(cfg, device=CPU, dtype=torch.float32)
    mod.load_state_dict(to_port(rp, cfg))
    return mod


def reference_and_port(arch, dtype="float32"):
    """The reference's loss, metrics and gradients (by the port's names),
    and the port's, on the same parameters and batch."""
    rcfg, cfg = _ref_cfg(arch, dtype), _port_cfg(arch, dtype)
    rm = ref_build_model(rcfg)
    rp = _perturb(rm.init(jax.random.key(0)), 0)
    batch = _batch(cfg)
    (r_loss, r_met), r_grads = jax.jit(jax.value_and_grad(
        rm.loss, has_aux=True))(rp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    ref = {"loss": float(r_loss),
           **{k: float(v) for k, v in r_met.items()},
           "grads": to_port(r_grads, cfg)}
    m = build_model(cfg)
    tp = port_params(rp, cfg)
    loss, met, grads = loop._value_and_grad(m, tp, batch)
    port = {"loss": float(loss), **{k: float(v) for k, v in met.items()},
            "grads": grads}
    return ref, port


def check_loss(ref, port):
    assert set(port) == set(ref)
    for key in ("loss", "ce", "load_balance_loss"):
        np.testing.assert_allclose(port[key], ref[key], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)


def check_grads(ref, port):
    want, got = ref["grads"], port["grads"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == torch.float32, name
        diff = float((got[name] - want[name]).abs().max())
        scale = float(want[name].abs().max())
        assert diff <= GRAD_REL * scale + GRAD_ABS, (name, diff, scale)
    # not vacuous: the loss reaches every leaf
    assert all(float(g.abs().max()) > 0 for g in want.values())


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_pair(request):
    return reference_and_port(request.param)


def test_loss_matches_reference(dense_pair):
    check_loss(*dense_pair)


def test_grads_match_reference(dense_pair):
    check_grads(*dense_pair)


def test_bf16_grads_match_reference():
    """qwen2.5-3b's smoke config computing in bf16 on fp32 parameters, the
    reference's ``TrainConfig`` default.  Measured on the CPU: loss
    relative error 3.5e-5, gradient relative L2 error 1.1e-2."""
    ref, port = reference_and_port("qwen2.5-3b", "bfloat16")
    np.testing.assert_allclose(port["loss"], ref["loss"],
                               rtol=BF16_LOSS_RTOL)
    num = sum(float(torch.sum((port["grads"][k] - g) ** 2))
              for k, g in ref["grads"].items())
    den = sum(float(torch.sum(g ** 2)) for g in ref["grads"].values())
    assert np.sqrt(num / den) <= BF16_GRAD_REL_L2, np.sqrt(num / den)


# --------------------------------------------------------------------------
# attention's train route
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,t,causal", [(50, 50, True), (50, 50, False),
                                        (30, 45, False)])
def test_chunked_matches_reference(s, t, causal):
    """The port's ``_sdpa_chunked`` against the reference's at chunks of 16
    (ragged tails on both sides): the output and the gradients of a
    weighted sum of it with respect to q, k and v."""
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    w = rng.standard_normal((2, s, 4 * 8)).astype(np.float32)

    def ref_fn(q, k, v):
        out = ref_attn._sdpa_chunked(q, k, v, scale=0.25, causal=causal,
                                     q_chunk=16, kv_chunk=16)
        return jnp.sum(out * w), out

    (_, r_out), r_g = jax.value_and_grad(ref_fn, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = attention._sdpa_chunked(tq, tk, tv, scale=0.25, causal=causal,
                                  q_chunk=16, kv_chunk=16)
    t_g = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                              (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(r_out),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(t_g, r_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_train_route_switches_to_chunked(causal, monkeypatch):
    """Above ``CHUNK_THRESHOLD`` score elements the train route is the
    chunked loop, below it the masked formula; both the same function."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))
    calls = []
    chunked = attention._sdpa_chunked
    monkeypatch.setattr(attention, "_sdpa_chunked",
                        lambda *a, **kw: calls.append(1) or chunked(
                            *a, **dict(kw, q_chunk=16, kv_chunk=16)))
    plain = attention._sdpa(q, k, v, None, scale=0.25, causal=causal)
    assert not calls
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 40 * 40 - 1)
    tiled = attention._sdpa(q, k, v, None, scale=0.25, causal=causal)
    assert calls
    torch.testing.assert_close(tiled, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b",
                                  "whisper-tiny"])
def test_train_route_never_calls_k8(arch, monkeypatch):
    """With grad on and the parameters requiring grad, no attention call
    reaches K8's entry (whose kernel has no backward); under ``no_grad``
    every full-sequence attention does.  GQA, MLA and the
    encoder-decoder's three kinds."""
    cfg = _port_cfg(arch)
    m = build_model(cfg)
    params = m.init(0, device=CPU, dtype=torch.float32)
    batch = _batch(cfg)
    calls = []
    inner = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    loss, _, grads = loop._value_and_grad(m, params, batch)
    assert calls == [] and all(g.abs().max() > 0 for g in grads.values())
    with torch.no_grad():
        m.loss(params, batch)
    n_attn = (cfg.encoder_layers + 2 * cfg.n_layers if cfg.family == "audio"
              else cfg.n_layers)
    assert len(calls) == n_attn


# --------------------------------------------------------------------------
# the fp32-output GEMM's autograd.Function
# --------------------------------------------------------------------------

def _gemm_operands(batched, b_transposed):
    g = torch.Generator().manual_seed(5)
    if batched:
        a = torch.randn(3, 24, 40, generator=g)
        b = torch.randn(3, 40, 56, generator=g)
    else:
        a = torch.randn(24, 40, generator=g)
        b = (torch.randn(56, 40, generator=g).t() if b_transposed
             else torch.randn(40, 56, generator=g))
    return a.bfloat16(), b.bfloat16()


@pytest.mark.parametrize("batched,b_transposed", [(False, False),
                                                  (False, True),
                                                  (True, False)])
def test_f32_product_backward_is_autograds(batched, b_transposed):
    """``F32Product``'s forward and backward bitwise what autograd computes
    through ``a.float() @ b.float()`` (the CPU branch), with ``b`` as
    stored or as a transposed view (the tied unembedding's, which takes
    ``mm``'s column-major backward rule)."""
    a, b = _gemm_operands(batched, b_transposed)
    cot = torch.randn(a.shape[:-1] + b.shape[-1:],
                      generator=torch.Generator().manual_seed(6))
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    if b_transposed:
        b1 = b.t().clone().requires_grad_(True)
    y1 = layers.F32Product.apply(a1, b1.t() if b_transposed else b1)
    g1 = torch.autograd.grad(y1, (a1, b1), cot)
    a2 = a.clone().requires_grad_(True)
    b2 = (b.t().clone() if b_transposed else b.clone()).requires_grad_(True)
    mm = torch.bmm if batched else torch.mm
    y2 = mm(a2.float(), (b2.t() if b_transposed else b2).float())
    g2 = torch.autograd.grad(y2, (a2, b2), cot)
    assert y1.dtype == torch.float32 and torch.equal(y1, y2)
    for x, y in zip(g1, g2):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)


def test_f32_output_gemm_needs_the_function():
    """On ``meta`` (the card's overloads without a card) the fp32-output
    GEMM alone has no derivative, and through ``F32Product`` it has one,
    of the operands' shapes and dtypes."""
    a = torch.empty(8, 16, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    b = torch.empty(16, 4, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="not implemented"):
        y = torch.mm(a, b, out_dtype=torch.float32)
        torch.autograd.grad(y.sum(), (a, b))
    ga, gb = torch.autograd.grad(layers.F32Product.apply(a, b).sum(), (a, b))
    assert (ga.shape, ga.dtype, gb.shape, gb.dtype) == (
        a.shape, a.dtype, b.shape, b.dtype)


# --------------------------------------------------------------------------
# remat and the train step
# --------------------------------------------------------------------------

def test_remat_policies_give_the_same_gradients():
    """``cfg.remat`` changes what the backward recomputes, not what it
    computes: "none", "full" and "dots" give bitwise the same loss and
    gradients."""
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(_port_cfg("qwen2.5-3b"), remat=remat)
        m = build_model(cfg)
        params = m.init(0, device=CPU, dtype=torch.float32)
        out[remat] = loop._value_and_grad(m, params, _batch(cfg))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for name, g in out["none"][2].items():
            assert torch.equal(out[remat][2][name], g), (remat, name)


def test_grad_accumulation_equals_full_batch():
    """The reference's test on the port: the mean of two microbatches'
    gradients gives the full batch's update (SGD)."""
    cfg = _port_cfg("internlm2-1.8b")
    m = build_model(cfg)
    tcfg = TrainConfig(optimizer="sgd", lr=0.1)
    batch = {"tokens": np.random.default_rng(1).integers(
        1, cfg.vocab_size, (4, 17)).astype(np.int32)}
    got = []
    for mbs in (1, 2):
        params = m.init(0, device=CPU, dtype=torch.float32)
        opt = opt_mod.init_opt_state(tcfg, loop.param_tree(params))
        step = loop.make_train_step(m, tcfg, microbatches=mbs)
        params, _, met = step(params, opt, {"tokens": torch.from_numpy(
            batch["tokens"])}, 0)
        got.append((params.state_dict(), met))
    (p1, m1), (p2, m2) = got
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    for name in p1:
        torch.testing.assert_close(p2[name], p1[name], rtol=1e-5,
                                   atol=1e-6)


def test_loss_decreases_over_steps():
    """The reference's test on the port: AdamW on one ``TokenPipeline``
    batch, 10 steps."""
    cfg = _port_cfg("qwen2.5-3b")
    m = build_model(cfg)
    tcfg = TrainConfig(optimizer="adamw", lr=3e-3, weight_decay=0.0)
    params, opt = loop.init_train_state(
        m, tcfg, torch.Generator(device=CPU).manual_seed(0))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4, seed=1)
    step = loop.make_train_step(m, tcfg)
    losses = []
    for i in range(10):
        params, opt, met = step(params, opt, pipe.batch(0), i)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_module_update_matches_the_tree_update():
    """The module path's leaf-by-leaf in-place update is the functional
    ``apply_updates`` on the whole named tree, bitwise (AdamW)."""
    cfg = _port_cfg("qwen3-moe-30b-a3b")
    m = build_model(cfg)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-2)
    params = m.init(0, device=CPU, dtype=torch.float32)
    opt = opt_mod.init_opt_state(tcfg, loop.param_tree(params))
    batch = _batch(cfg)
    _, _, grads = loop._value_and_grad(m, params, batch)
    grads, _ = opt_mod.clip_by_norm(grads, tcfg.grad_clip)
    want_p, want_s = opt_mod.apply_updates(
        tcfg, {k: v.clone() for k, v in loop.param_tree(params).items()},
        grads, opt, 0)
    step = loop.make_train_step(m, tcfg)
    params, got_s, _ = step(params, opt, batch, 0)
    for name, p in params.named_parameters():
        assert torch.equal(p, want_p[name]), name
        for part in ("m", "v"):
            assert torch.equal(got_s[part][name], want_s[part][name])


def _train(tmp, argv):
    return launch_train.main(["--arch", "qwen2.5-3b", "--device", "cpu",
                              "--save-every", "5", "--ckpt", str(tmp),
                              *argv])


def test_launcher_resume_is_bitwise(tmp_path):
    """``launch/train.py`` at the smoke config: 10 uninterrupted steps,
    and 5 steps, then ``--resume`` and 5 more: the same parameters and
    optimizer state bitwise, and the same losses."""
    full = _train(tmp_path / "full", ["--steps", "10"])
    first = _train(tmp_path / "split", ["--steps", "5"])
    second = _train(tmp_path / "split", ["--steps", "10", "--resume"])
    assert second["start"] == 5
    assert first["losses"] + second["losses"] == full["losses"]
    assert full["losses"][-1] < full["losses"][0]
    want = dict(full["params"].named_parameters())
    for name, p in second["params"].named_parameters():
        assert torch.equal(p, want[name]), name
    for part, tree in full["opt_state"].items():
        for name, x in tree.items():
            assert torch.equal(second["opt_state"][part][name], x)


def test_launcher_refuses_a_mesh():
    """``--mesh``, once refused, trains on a process mesh; a mesh of one
    process joins no world and takes the single-device step's numbers
    (qwen2.5-3b has no experts to cut), and a larger mesh without a
    launch environment in a process that is one of its ranks refuses."""
    argv = ["--arch", "qwen2.5-3b", "--device", "cpu", "--steps", "2",
            "--seq", "16"]
    one = launch_train.main(argv + ["--mesh", "1x1"])
    plain = launch_train.main(argv)
    assert one["losses"] == plain["losses"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PROC_ID", "0")
        for k in ("REPRO_COORD_ADDR", "REPRO_NUM_PROC", "SLURM_PROCID"):
            mp.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="needs 4 processes"):
            launch_train.main(argv + ["--mesh", "2x2"])
