"""The port's training substrate and differentiable workloads against the
reference's (``tests/test_diff.py``, ``src/repro/train``): the optimizers
step for step, the train step on the SNN classifier, the classifier's loss
and gradient, the brunel inversion's forward model, loss and gradient under
the reference's own diffusion draws, and the reference's acceptance smokes
(the classifier above 3x chance, the inversion's reduced fit) on the port's
own draws (the inversion's in ``test_torch_train_inversion.py``, a file
of its own so that the run's workers share its time).  Everything runs
on the CPU (``device="cpu"``).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RefTrainConfig
from repro.diff import classify as ref_classify
from repro.diff import inverse as ref_inverse
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.diff import classify, inverse
from repro_torch.train import loop, optimizer

CPU = "cpu"


def _np(tree):
    """A tree of jax arrays or tensors as one of float64 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32), np.float64)


def _assert_tree_close(got, want, rtol, atol=0.0, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{path}.{k}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

_OPT_CASES = {
    "adamw": dict(optimizer="adamw", weight_decay=0.1),
    "adamw_bf16_master": dict(optimizer="adamw", weight_decay=0.1,
                              param_dtype="bfloat16"),
    "adafactor": dict(optimizer="adafactor", weight_decay=0.01, lr=1e-2),
    "sgd": dict(optimizer="sgd", lr=1e-2),
}


def _tree_arrays(seed):
    """Params and 5 steps of grads: a matrix, a 3-D leaf and a vector."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(6, 5)).astype(np.float32),
         "blk": {"k": rng.normal(size=(2, 3, 4)).astype(np.float32),
                 "b": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [{"w": rng.normal(size=(6, 5)).astype(np.float32),
              "blk": {"k": rng.normal(size=(2, 3, 4)).astype(np.float32),
                      "b": (3.0 * rng.normal(size=(7,))).astype(np.float32)}}
             for _ in range(5)]
    return p, grads


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_apply_updates_matches_reference(case):
    """5 steps of ``apply_updates`` from the same params on the same grads:
    params and optimizer state agree with the reference's to rtol 1e-6
    (fp32 state; bf16 params compared through their fp32 values)."""
    kw = _OPT_CASES[case]
    cfg, rcfg = TrainConfig(**kw), RefTrainConfig(**kw)
    p_np, grads = _tree_arrays(1)
    dt = getattr(jnp, cfg.param_dtype)
    rparams = jax.tree.map(lambda a: jnp.asarray(a, dt), p_np)
    params = convert.opt_state_from_numpy(
        jax.tree.map(np.asarray, rparams), device=CPU)
    assert params["w"].dtype == optimizer.torch_dtype(cfg.param_dtype)
    rstate = ref_opt.init_opt_state(rcfg, rparams)
    state = optimizer.init_opt_state(cfg, params)
    _assert_tree_close(_np(state), _np(rstate), rtol=0)
    for i, g in enumerate(grads):
        gt = convert.opt_state_from_numpy(g, device=CPU)
        rparams, rstate = ref_opt.apply_updates(
            rcfg, rparams, jax.tree.map(jnp.asarray, g), rstate,
            jnp.asarray(i))
        step = i if i % 2 else torch.tensor(i)   # an int or a 0-d tensor
        params, state = optimizer.apply_updates(cfg, params, gt, state, step)
    assert params["blk"]["b"].dtype == optimizer.torch_dtype(cfg.param_dtype)
    _assert_tree_close(_np(params), _np(rparams), rtol=1e-6, atol=1e-7)
    _assert_tree_close(_np(state), _np(rstate), rtol=1e-6, atol=1e-7)
    if case == "adamw_bf16_master":
        assert set(state) == {"m", "v", "master"}


def test_global_norm_and_clip_match_reference():
    _, grads = _tree_arrays(2)
    g = grads[0]
    gt = convert.opt_state_from_numpy(g, device=CPU)
    rg = jax.tree.map(jnp.asarray, g)
    np.testing.assert_allclose(float(optimizer.global_norm(gt)),
                               float(ref_opt.global_norm(rg)), rtol=1e-6)
    for max_norm in (0.5, 1e6):
        clipped, norm = optimizer.clip_by_norm(gt, max_norm)
        rclipped, rnorm = ref_opt.clip_by_norm(rg, max_norm)
        np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
        _assert_tree_close(_np(clipped), _np(rclipped), rtol=1e-6)
    assert float(optimizer.global_norm(
        optimizer.clip_by_norm(gt, 0.5)[0])) == pytest.approx(0.5, rel=1e-5)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizer.init_opt_state(TrainConfig(optimizer="lion"), gt)


# --------------------------------------------------------------------------
# the classifier and the train step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_classifier():
    """The reference classifier's init params and a 32-sample batch of its
    dataset, as numpy."""
    model = ref_classify.SNNClassifier()
    key = jax.random.key(0)
    k_params, k_proto, k_data = jax.random.split(key, 3)
    params = model.init(k_params)
    protos = ref_classify.make_prototypes(k_proto, model)
    data = ref_classify.make_dataset(k_data, model, 32, protos)
    return model, jax.tree.map(np.asarray, params), \
        jax.tree.map(np.asarray, data)


def _port_batch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def test_classifier_loss_and_grad_match_reference(reference_classifier):
    """At the reference's params and batch: the loss, the accuracy and the
    gradient of every param agree with the reference's ``jax.value_and_grad``
    (rtol 1e-4: the input currents are matmuls that XLA and torch sum in
    their own orders)."""
    rmodel, rparams, data = reference_classifier
    model = classify.SNNClassifier(device=CPU)
    params = convert.classifier_params_from_numpy(rparams, device=CPU)
    batch = _port_batch(data)

    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(jax.tree.map(jnp.asarray, rparams),
                                    jax.tree.map(jnp.asarray, data))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, met = model.loss(leaves, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert float(met["accuracy"]) == float(rmet["accuracy"])
    assert float(met["loss"]) == float(loss)
    _assert_tree_close(_np(grads), _np(rgrads), rtol=1e-4, atol=1e-7)
    assert np.abs(_np(grads)["w_in"]).max() > 0
    # the hidden layer spikes, so the surrogate path is exercised
    logits = model.apply(params, batch["spikes"])
    assert logits.shape == (32, model.n_classes)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(reference_classifier, microbatches):
    """One ``make_train_step`` step (AdamW, clipping at 1.0) from the
    reference's params and batch: loss, metrics and updated params agree
    (rtol 1e-4, the loss gradient's; Adam moves a param by about lr)."""
    rmodel, rparams, data = reference_classifier
    kw = dict(optimizer="adamw", lr=0.05, weight_decay=0.0)
    tcfg, rtcfg = TrainConfig(**kw), RefTrainConfig(**kw)
    rp = jax.tree.map(jnp.asarray, rparams)
    rstep = jax.jit(ref_loop.make_train_step(rmodel, rtcfg,
                                             microbatches=microbatches))
    rnew, ropt, rmet = rstep(rp, ref_opt.init_opt_state(rtcfg, rp),
                             jax.tree.map(jnp.asarray, data), jnp.asarray(0))

    model = classify.SNNClassifier(device=CPU)
    params = convert.classifier_params_from_numpy(rparams, device=CPU)
    step = loop.make_train_step(model, tcfg, microbatches=microbatches)
    new, opt, met = step(params, optimizer.init_opt_state(tcfg, params),
                         _port_batch(data), 0)
    assert set(met) == set(rmet) == {"loss", "accuracy", "grad_norm"}
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-4,
                                   err_msg=k)
    _assert_tree_close(_np(new), _np(rnew), rtol=1e-4, atol=1e-6)
    _assert_tree_close(_np(opt), _np(ropt), rtol=1e-4, atol=1e-9)
    assert not any(p.requires_grad for p in new.values())


def test_train_step_refuses_gather_once_with_microbatches(
        reference_classifier):
    """``gather_once`` with microbatches, once refused, now differentiates
    through one bf16 copy of the parameters (``rules.gather_params_once``)
    as the reference's step does: its loss, metrics and updated params
    against the reference's jitted step (the gradients pass through bf16
    in both, so the update is held at 1e-3)."""
    rmodel, rparams, data = reference_classifier
    kw = dict(optimizer="adamw", lr=0.05, weight_decay=0.0,
              gather_once=True)
    tcfg, rtcfg = TrainConfig(**kw), RefTrainConfig(**kw)
    rp = jax.tree.map(jnp.asarray, rparams)
    rstep = jax.jit(ref_loop.make_train_step(rmodel, rtcfg, microbatches=2))
    rnew, _, rmet = rstep(rp, ref_opt.init_opt_state(rtcfg, rp),
                          jax.tree.map(jnp.asarray, data), jnp.asarray(0))
    model = classify.SNNClassifier(device=CPU)
    params = convert.classifier_params_from_numpy(rparams, device=CPU)
    assert params["w_in"].shape == (model.n_in, model.n_hidden)
    step = loop.make_train_step(model, tcfg, microbatches=2)
    new, _, met = step(params, optimizer.init_opt_state(tcfg, params),
                       _port_batch(data), 0)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=1e-3)
    _assert_tree_close(_np(new), _np(rnew), rtol=1e-3, atol=1e-6)
    with pytest.raises(ValueError, match="w_in"):
        convert.classifier_params_from_numpy({"w_in": np.zeros(2)},
                                             device=CPU)


def test_classifier_beats_3x_chance():
    """The reference's acceptance case on the port's own draws: 10 epochs,
    held-out accuracy at least 3x chance, the train loss falling."""
    model = classify.SNNClassifier(device=CPU)
    tcfg = TrainConfig(optimizer="adamw", lr=0.05, weight_decay=0.0)
    params, hist = classify.train_classifier(model, tcfg, epochs=10,
                                             data_parallel=True)
    chance = 1.0 / model.n_classes
    assert hist[-1]["eval_accuracy"] >= 3.0 * chance, hist
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert params["w_in"].shape == (model.n_in, model.n_hidden)


# --------------------------------------------------------------------------
# the brunel inversion
# --------------------------------------------------------------------------

def _reference_noise(key, n_local, n_steps):
    """The reference's diffusion draws from the state key: one split a step,
    ``normal(sub, (n_local,))`` (``engine_step``)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (n_local,),
                                                dtype=jnp.float32)))
    return np.stack(out)


def test_inversion_observe_loss_grad_match_reference():
    """One condition, 120 steps (chunks of 20), the reference's draws
    injected: the targets and ``observe`` at ``(g, eta) = (4.0, 2.2)``
    equal the reference's exactly, the loss to rtol 1e-5 and its gradient
    to rtol 1e-3 (a sum over 120 steps of scattered gradients in each
    package's own order)."""
    kw = dict(n_steps=120, conditions=(1.0,), checkpoint_every=20)
    ref = ref_inverse.BrunelInversion(**kw)
    noise = _reference_noise(ref.state0.key, ref.graph.n_local, 120)
    inv = inverse.BrunelInversion(noise=torch.from_numpy(noise), device=CPU,
                                  **kw)
    assert inv.graph.n_local == ref.graph.n_local
    assert inv.nu_thr_hz == ref.nu_thr_hz
    np.testing.assert_array_equal(inv.targets[1.0].numpy(),
                                  np.asarray(ref.targets[1.0]))
    rp = ref._pack(4.0, 2.2)
    p = inv._pack(4.0, 2.2)
    obs = inv.observe(p, 1.0).detach()
    robs = np.asarray(ref.observe(rp, 1.0))
    assert robs.sum() > 0
    np.testing.assert_array_equal(obs.numpy(), robs)
    rloss, rgrad = ref._loss_grad(rp)
    loss, grad = inv.loss_and_grad(p)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert inv.loss(4.0, 2.2) == float(loss)
    for k in ("log_g", "log_eta"):
        assert float(rgrad[k]) != 0
        np.testing.assert_allclose(float(grad[k]), float(rgrad[k]),
                                   rtol=1e-3, err_msg=k)
