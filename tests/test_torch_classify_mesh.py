"""The surrogate classifier's data-parallel training on a process mesh
(``diff/classify.py::train_classifier(data_parallel=True)`` and
``train/loop.py``'s route for a tree of tensors) over four gloo ranks on
the CPU, against the reference.

(a) The reference's own data-parallel run: ``jax.jit(make_train_step(
    SNNClassifier(), tcfg))`` with each batch placed by ``NamedSharding(
    Mesh(jax.devices(), ("data",)), batch_spec)`` on 4 forced host devices,
    one epoch (8 steps of 64) from the reference's init and dataset, as its
    ``train_classifier(data_parallel=True)`` steps them.  The port's step
    runs on 4 ranks of a ``("data",)`` ``ProcessMesh`` from the same
    parameters and batches, each rank on its block of 16 rows.  Step 1's
    loss, accuracy and gradient norm agree within 1e-4, its parameters and
    optimizer state within 1e-4 / 1e-6, as one process's step does
    (``test_torch_train.py::test_train_step_matches_reference``).  The two
    do not part in this epoch, so every later step is held to the same
    tolerances.  Measured: step 1's metrics equal, its parameters within
    7.6e-8 of each leaf's largest element; over steps 2-8 the metrics
    within 8.7e-6 and the parameters within 2.0e-5 of the leaf's largest
    (``b_out``: AdamW moves each element by about lr whatever the size of
    its gradient, so a small element carries the rounding), at most 0.43
    of the tolerance.
(b) ``train_classifier(data_parallel=True)`` on 4 ranks for 10 epochs
    against the same call in one process (no world): the ranks' parameters
    bitwise equal; each epoch's history within :data:`HISTORY_RTOL` of one
    process's; the reference's acceptance case (eval accuracy at least 3x
    chance, the train loss falling) on the mesh.
(c) A batch that the ``data`` axis does not divide raises ``ValueError``
    naming both sizes; a mesh step issues one all-reduce a gradient leaf,
    one for the loss and one a metric.  The ``nn.Module`` route is the
    LM mesh tests' (``test_torch_mesh_*.py``), unchanged.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _mesh_tp_harness import _env, _free_port, wait
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.diff import classify as ref_classify
from repro.train import loop as ref_loop
from repro_torch.configs.base import TrainConfig
from repro_torch.diff import classify
from repro_torch.train import loop
WORLD, SEED, STEPS, EPOCHS = 4, 0, 8, 10
BATCH, N_TRAIN = 64, 512
TCFG = dict(optimizer="adamw", lr=0.05, weight_decay=0.0)
LEAVES = ("w_in", "w_out", "b_out")
METRICS = ("loss", "accuracy", "grad_norm")
#: a step's loss, accuracy and gradient norm, and its parameters and
#: optimizer state, against the reference's (one process's step test's)
RTOL, ATOL = 1e-4, 1e-6
#: the mesh's per-epoch history against one process's: the gradient is
#: the mean of four block means, so the two differ by the order of
#: summation (8e-8 of the largest parameter after one step, section (a));
#: AdamW carries that on, and a rounding that flips a hidden spike would
#: move a later epoch's loss by far more.  Measured on this recipe: no
#: epoch parts (largest relative error 4.3e-6, epoch 10's train loss;
#: the accuracies equal)
HISTORY_RTOL = 1e-4
#: the batch of the probe that the mesh cannot cut (18 rows over 4)
BAD_BATCH = 18

RANK_CODE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch import convert
    from repro_torch.configs.base import TrainConfig
    from repro_torch.diff import classify
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.launch.train import batch_block
    from repro_torch.sharding import collectives as coll, rules
    from repro_torch.train import loop, optimizer as opt_mod
    job = json.loads(sys.argv[1])
    rank, world, addr = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                             world_size=world, rank=rank)
    tcfg = TrainConfig(**job["tcfg"])
    model = classify.SNNClassifier(device="cpu")
    out, rec = {}, {}
    # (a) the step on the mesh, from the reference's params and batches
    data = np.load(job["data"])
    params = convert.classifier_params_from_numpy(
        {k: data["p_" + k] for k in job["leaves"]}, device="cpu")
    opt = opt_mod.init_opt_state(tcfg, params)
    mesh = ProcessMesh(("data",), (world,))
    step = loop.make_train_step(model, tcfg)
    met, calls = [], []
    with rules.use_mesh(mesh):
        for i in range(job["steps"]):
            batch = {k: batch_block(torch.from_numpy(data[k][i]), mesh)
                     for k in ("spikes", "label")}
            with coll.tally() as t:
                params, opt, m = step(params, opt, batch, i)
            calls.append(t.record()["calls_by_kind"])
            met.append([float(m[k]) for k in job["metrics"]])
            for k in job["leaves"]:
                out[f"p{i}_{k}"] = params[k].numpy()
            if i == 0:
                for s in ("m", "v"):
                    for k in job["leaves"]:
                        out[f"{s}_{k}"] = opt[s][k].numpy()
    rec["metrics"], rec["calls"] = met, calls
    # (b) train_classifier on the mesh
    trained, hist = classify.train_classifier(
        model, tcfg, epochs=job["epochs"], data_parallel=True)
    for k in job["leaves"]:
        out["trained_" + k] = trained[k].numpy()
    rec["history"] = hist
    # (c) a batch the mesh cannot cut
    try:
        classify.train_classifier(model, tcfg, n_train=job["bad"],
                                  n_eval=8, batch_size=job["bad"],
                                  data_parallel=True)
        rec["bad_batch"] = None
    except ValueError as e:
        rec["bad_batch"] = str(e)
    np.savez(f"{job['out']}_{rank}.npz", **out)
    with open(f"{job['out']}_{rank}.json", "w") as f:
        json.dump(rec, f)
    tdist.barrier()
    tdist.destroy_process_group()
""")

REF_CODE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.diff import classify
    from repro.sharding import rules
    from repro.train import loop
    from repro.train.optimizer import init_opt_state
    job = json.loads(sys.argv[1])
    assert len(jax.devices()) == 4, jax.devices()
    tcfg = TrainConfig(**job["tcfg"])
    model = classify.SNNClassifier()
    data = np.load(job["data"])
    params = {k: jnp.asarray(data["p_" + k]) for k in job["leaves"]}
    opt = init_opt_state(tcfg, params)
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    sharding = jax.sharding.NamedSharding(mesh, rules.batch_spec(mesh))
    step = jax.jit(loop.make_train_step(model, tcfg))
    out, met = {}, []
    for i in range(job["steps"]):
        batch = jax.device_put({k: jnp.asarray(data[k][i])
                                for k in ("spikes", "label")}, sharding)
        assert not batch["spikes"].sharding.is_fully_replicated
        params, opt, m = step(params, opt, batch, jnp.asarray(i))
        met.append([float(m[k]) for k in job["metrics"]])
        for k in job["leaves"]:
            out[f"p{i}_{k}"] = np.asarray(params[k])
        if i == 0:
            for s in ("m", "v"):
                for k in job["leaves"]:
                    out[f"{s}_{k}"] = np.asarray(opt[s][k])
    np.savez(job["out"] + ".npz", **out)
    with open(job["out"] + ".json", "w") as f:
        json.dump({"metrics": met}, f)
""")


def _reference_data(path: Path) -> None:
    """The reference's init parameters and its first epoch's batches, as
    its ``train_classifier(seed=SEED)`` draws them."""
    model = ref_classify.SNNClassifier()
    k_params, k_proto, k_train, _ = jax.random.split(jax.random.key(SEED), 4)
    params, _ = ref_loop.init_train_state(model, RefTrainConfig(**TCFG),
                                          k_params)
    protos = ref_classify.make_prototypes(k_proto, model)
    train = ref_classify.make_dataset(k_train, model, N_TRAIN, protos)
    order = np.asarray(jax.random.permutation(jax.random.fold_in(k_train, 0),
                                              N_TRAIN))
    idx = order[:STEPS * BATCH].reshape(STEPS, BATCH)
    np.savez(path, **{"p_" + k: np.asarray(params[k]) for k in LEAVES},
             **{k: np.asarray(v)[idx] for k, v in train.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' and the reference's records, and one process's
    ``train_classifier`` (run here while they run)."""
    tmp = tmp_path_factory.mktemp("classify_mesh")
    _reference_data(tmp / "data.npz")
    job = dict(data=str(tmp / "data.npz"), tcfg=TCFG, leaves=LEAVES,
               metrics=METRICS, steps=STEPS, epochs=EPOCHS, bad=BAD_BATCH)
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE,
         json.dumps(dict(job, out=str(tmp / "rank"))), str(r), str(WORLD),
         addr], env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", REF_CODE,
         json.dumps(dict(job, out=str(tmp / "ref")))], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        single = classify.train_classifier(
            classify.SNNClassifier(device="cpu"), TrainConfig(**TCFG),
            epochs=EPOCHS, data_parallel=True)
    finally:
        wait(procs, timeout=240)
    load = lambda name: (dict(np.load(tmp / f"{name}.npz")),
                         json.loads((tmp / f"{name}.json").read_text()))
    return {"ranks": [load(f"rank_{r}") for r in range(WORLD)],
            "ref": load("ref"), "single": single}


def _close(got: dict, want: dict, keys, rtol, atol, what: str) -> None:
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def test_first_step_matches_reference_mesh(runs):
    """Step 1 on 4 ranks against the reference's 4-device jitted step."""
    (arrs, rec), (rarrs, rrec) = runs["ranks"][0], runs["ref"]
    np.testing.assert_allclose(rec["metrics"][0], rrec["metrics"][0],
                               rtol=RTOL, err_msg=str(METRICS))
    _close(arrs, rarrs, [f"p0_{k}" for k in LEAVES], RTOL, ATOL, "params")
    _close(arrs, rarrs, [f"{s}_{k}" for s in "mv" for k in LEAVES], RTOL,
           ATOL, "opt state")
    assert arrs["p0_w_in"].std() > 1.0     # the reference's 150 pA scale


@pytest.mark.parametrize("step", range(1, STEPS))
def test_later_steps_match_reference_mesh(runs, step):
    """Every later step of the epoch at step 1's tolerances (the module
    docstring: no step parts)."""
    (arrs, rec), (rarrs, rrec) = runs["ranks"][0], runs["ref"]
    np.testing.assert_allclose(rec["metrics"][step], rrec["metrics"][step],
                               rtol=RTOL, err_msg=str(METRICS))
    _close(arrs, rarrs, [f"p{step}_{k}" for k in LEAVES], RTOL, ATOL,
           f"params after step {step + 1}")


@pytest.mark.parametrize("what", ("steps", "trained"))
def test_ranks_hold_the_same_bits(runs, what):
    """Every rank's parameters after every step of (a), and after (b)'s
    training, bitwise equal to rank 0's; so are their metrics."""
    keys = ([f"p{i}_{k}" for i in range(STEPS) for k in LEAVES]
            if what == "steps" else [f"trained_{k}" for k in LEAVES])
    (arrs0, rec0), *rest = runs["ranks"]
    for arrs, rec in rest:
        for k in keys:
            assert np.array_equal(arrs[k], arrs0[k]), k
        assert rec["metrics"] == rec0["metrics"]
        assert rec["history"] == rec0["history"]


def test_step_issues_one_all_reduce_a_leaf_and_metric(runs):
    """A step's collectives: one all-reduce per gradient leaf (3), one for
    the loss and one per metric (the classifier's ``loss`` and
    ``accuracy``); nothing else."""
    for _, rec in runs["ranks"]:
        assert rec["calls"] == [{"all-reduce": len(LEAVES) + 1 + 2}] * STEPS


def test_mesh_training_matches_one_process(runs):
    """(b): the 10 epochs on 4 ranks against one process's."""
    _, rec = runs["ranks"][0]
    _, hist = runs["single"]
    assert len(rec["history"]) == len(hist) == EPOCHS
    for got, want in zip(rec["history"], hist):
        assert got["epoch"] == want["epoch"]
        for k in ("train_loss", "train_accuracy", "eval_accuracy"):
            np.testing.assert_allclose(got[k], want[k], rtol=HISTORY_RTOL,
                                       err_msg=f"epoch {want['epoch']} {k}")


def test_mesh_training_beats_3x_chance(runs):
    """The reference's acceptance case on the mesh."""
    hist = runs["ranks"][0][1]["history"]
    chance = 1.0 / ref_classify.SNNClassifier().n_classes
    assert hist[-1]["eval_accuracy"] >= 3.0 * chance, hist
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]


def test_batch_the_mesh_cannot_cut_raises(runs):
    for _, rec in runs["ranks"]:
        msg = rec["bad_batch"]
        assert msg is not None and str(BAD_BATCH) in msg and str(WORLD) in msg


def test_without_a_world_data_parallel_changes_nothing():
    """No world: no mesh, and ``data_parallel`` gives bitwise the run
    without it (one epoch); a substrate model has no expert axes."""
    assert classify.data_mesh(torch.device("cpu")) is None
    model = classify.SNNClassifier(device="cpu")
    tcfg = TrainConfig(**TCFG)
    kw = dict(n_train=128, n_eval=32, batch_size=32)
    p1, h1 = classify.train_classifier(model, tcfg, data_parallel=True, **kw)
    p0, h0 = classify.train_classifier(model, tcfg, **kw)
    assert h1 == h0
    assert all(torch.equal(p1[k], p0[k]) for k in LEAVES)
    assert loop._expert_axes(model, None) == ()
