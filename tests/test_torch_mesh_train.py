"""LM training on a process mesh (``train/loop.py`` under
``sharding.rules.use_mesh``, ``launch/train.py --mesh``) over gloo ranks
on the CPU, against the reference.

The reference's ``test_distributed_train`` recipe: qwen3-moe's smoke
config, ``TokenPipeline(seq 16, batch 4, seed 5)``, AdamW at lr 2e-3,
two microbatches, six steps on a (2, 1, 2) ``("pod", "data", "model")``
mesh; then its checkpoint restored onto a smaller (1, 2) mesh and three
more steps.  Both packages start from the reference's ``m.init(key(0))``
parameters; each port rank holds its batch block and its expert block
(``convert.mesh_local``), and the checkpoint holds the global leaves.

* The port's mesh losses equal the reference's losses on the same mesh
  (``jax.jit`` under ``rules.use_mesh``, 4 forced host devices) within
  1e-5 relative; with ``gather_once`` the first step's too, and the six
  within 1e-3 (its gradients are rounded to bf16, ``BF16_GRAD_RTOL``).
* Against the reference's single-device jitted step: the first step
  within 1e-2 relative, the six within 3e-2.  A mesh counts MoE capacity
  and the load-balance loss per token slice (the reference's
  ``moe_apply_manual``), so the reference's own mesh and single-device
  losses part too: by 0.36 % at the first step of this recipe and 2.0 %
  at the fourth.
* The elastic restart: the port's (1, 2) run from the step-6 checkpoint
  equals the reference's (1, 2) run from the same checkpoint within
  1e-5, and a single port process resumed from it (which equals the
  reference's single-device restart within 1e-5) within the same bands.
* ``launch/train.py --smoke --mesh 2x2`` through its command line: four
  processes, finite losses, a checkpoint of global leaves.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt_mod

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "qwen3-moe-30b-a3b"
SEQ, BATCH, SEED, LR, MB = 16, 4, 5, 2e-3, 2
STEPS, MORE = 6, 3
MESH_RTOL = 1e-5
#: against one device: the first step (the same parameters and data;
#: the reference's own mesh and single-device first losses part by
#: 0.36 % here), and the six (theirs part by up to 2.0 % by step 4)
SINGLE_FIRST_RTOL, SINGLE_RTOL = 1e-2, 3e-2
#: gather_once differentiates through a bf16 copy, so in both packages
#: every gradient is rounded to bf16 (the copy's cotangent): where the
#: two fp32 sums land on either side of a bf16 rounding the gradient
#: moves by an ulp (2^-8 of it), and AdamW's per-element step carries
#: that into the next steps' losses (the first step's loss is held at
#: MESH_RTOL)
BF16_GRAD_RTOL = 1e-3

RANK_CODE = textwrap.dedent("""
    import json, os, sys
    import torch
    import torch.distributed as tdist
    from repro_torch import configs, convert
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.launch.train import batch_block
    from repro_torch.models import transformer
    from repro_torch.sharding import rules
    from repro_torch.train import loop, optimizer as opt_mod
    job = json.loads(sys.argv[1])
    rank, world, addr = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    if world > 1:
        tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                                 world_size=world, rank=rank)
    cfg = configs.get_smoke(job["arch"])
    mesh = ProcessMesh(job["axes"], job["dims"]) if job["dims"] else None
    n_exp = cfg.moe.n_experts
    params = transformer.DecoderLM(cfg, device="cpu", dtype=torch.float32,
                                   mesh=mesh)
    tcfg = TrainConfig(optimizer="adamw", lr=job["lr"],
                       gather_once=job["gather_once"])
    opt = opt_mod.init_opt_state(tcfg, params)
    if job["resume"]:
        target = (loop.param_tree(params), opt)
        sh = None
        if mesh is not None:
            sh = rules.tree_map_with_path(
                lambda _, sp: rules.NamedSharding(mesh, sp),
                rules.local_specs(mesh, target, n_exp))
        (tree, opt), meta = CheckpointManager(job["ckpt"]).restore(
            target, shardings=sh)
        start = meta["step"]
    else:
        tree = torch.load(job["init"])
        if mesh is not None:
            tree = convert.mesh_local(tree, mesh, n_exp)
        start = 0
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(tree[name])
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                         global_batch=job["batch"], seed=job["seed"])
    step = loop.make_train_step(__import__("repro_torch.models.model",
                                           fromlist=["x"]).build_model(cfg),
                                tcfg, microbatches=job["mb"])
    losses, ce = [], []
    ctx = rules.use_mesh(mesh) if mesh is not None else None
    if ctx is not None:
        ctx.__enter__()
    for i in range(start, start + job["steps"]):
        batch = {"tokens": torch.from_numpy(pipe.batch(i)["tokens"])}
        if mesh is not None:
            batch = {k: batch_block(v, mesh, job["mb"])
                     for k, v in batch.items()}
        params, opt, met = step(params, opt, batch, i)
        losses.append(float(met["loss"]))
        ce.append(float(met["ce"]))
    if ctx is not None:
        ctx.__exit__(None, None, None)
    if job.get("save"):
        state = (loop.param_tree(params), opt)
        if mesh is not None:
            state = convert.mesh_global(state, mesh, n_exp, 0)
        if rank == 0:
            CheckpointManager(job["save"]).save(start + job["steps"], state,
                                                metadata={"step": start
                                                          + job["steps"]})
    if rank == 0:
        with open(job["out"], "w") as f:
            json.dump({"losses": losses, "ce": ce}, f)
    if world > 1:
        tdist.barrier()
        tdist.destroy_process_group()
""")

REF_CODE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import configs
    from repro.configs.base import TrainConfig
    from repro.data.pipeline import TokenPipeline
    from repro.models.model import build_model
    from repro.sharding import rules
    from repro.train.loop import make_train_step
    from repro.train.optimizer import init_opt_state
    job = json.loads(sys.argv[1])
    cfg = configs.get_smoke(job["arch"])
    m = build_model(cfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                         global_batch=job["batch"], seed=job["seed"])

    def unflat(flat):
        tree = {}
        for key, arr in flat.items():
            node, parts = tree, key.split("/")
            for p_ in parts[:-1]:
                node = node.setdefault(p_, {})
            node[parts[-1]] = jnp.asarray(arr)
        if "period" in tree:
            tree["period"] = [tree["period"][str(j)]
                              for j in range(len(tree["period"]))]
        return tree

    out = {}
    for run in job["runs"]:
        tcfg = TrainConfig(optimizer="adamw", lr=job["lr"],
                           gather_once=run["gather_once"])
        if run.get("state"):
            st = dict(np.load(run["state"]))
            params = unflat({k[2:]: v for k, v in st.items()
                             if k.startswith("p/")})
            opt = {"m": unflat({k[2:]: v for k, v in st.items()
                                if k.startswith("m/")}),
                   "v": unflat({k[2:]: v for k, v in st.items()
                                if k.startswith("v/")})}
        else:
            params = m.init(jax.random.key(0))
            opt = init_opt_state(tcfg, params)
        mesh = None
        if run["dims"]:
            n = int(np.prod(run["dims"]))
            mesh = jax.sharding.Mesh(
                np.array(jax.devices()[:n]).reshape(run["dims"]),
                tuple(run["axes"]))
        losses = []
        if mesh is not None:
            cm = rules.use_mesh(mesh)
            cm.__enter__()
        step = jax.jit(make_train_step(m, tcfg, microbatches=job["mb"]))
        for i in range(run["start"], run["start"] + run["steps"]):
            batch = {"tokens": jnp.asarray(pipe.batch(i)["tokens"])}
            params, opt, met = step(params, opt, batch, jnp.asarray(i))
            losses.append(float(met["loss"]))
        if mesh is not None:
            cm.__exit__(None, None, None)
        out[run["name"]] = losses
    with open(job["out"], "w") as f:
        json.dump(out, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _ranks(job, world):
    """``job`` in ``world`` gloo processes (one without a group)."""
    addr = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, json.dumps(job), str(r),
         str(world), addr], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _reference(base: dict, out, run: dict):
    """One reference run in a process of its own (4 forced host
    devices), its losses to ``ref_<name>.json``."""
    return subprocess.Popen(
        [sys.executable, "-c", REF_CODE, json.dumps(dict(
            base, runs=[run], out=str(out / f"ref_{run['name']}.json")))],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout=240):
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]


def _ref_tree_flat(sd: dict, cfg) -> dict:
    """A port state dict (global, by parameter name) as the reference's
    stacked tree, flattened to ``/`` paths with ``period/{j}``."""
    prefix, period, n_periods = transformer.period_structure(cfg)
    assert not prefix
    out = {}
    for j in range(len(period)):
        first = [k for k in sd if k.startswith(f"layers.{j}.")]
        for key in first:
            leaf = key.split(".", 2)[2]
            out[f"period/{j}/" + leaf.replace(".", "/")] = np.stack([
                sd[f"layers.{p * len(period) + j}.{leaf}"].numpy()
                for p in range(n_periods)])
    for key, t in sd.items():
        if not key.startswith("layers."):
            out[key.replace(".", "/")] = t.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    cfg = configs.get_smoke(ARCH)
    rm = ref_build_model(ref_configs.get_smoke(ARCH))
    init = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rm.init(jax.random.key(0))), cfg,
        device="cpu", dtype=torch.float32)
    torch.save(init, out / "init.pt")
    base = dict(arch=ARCH, seq=SEQ, batch=BATCH, seed=SEED, lr=LR, mb=MB)
    mesh3 = dict(dims=[2, 1, 2], axes=["pod", "data", "model"])
    mesh2 = dict(dims=[1, 2], axes=["data", "model"])
    # stage 1: the port on (2, 1, 2), plain and gather_once, and the
    # reference's mesh and single-device runs
    procs = _ranks(dict(base, **mesh3, steps=STEPS, gather_once=False,
                        resume=False, init=str(out / "init.pt"),
                        save=str(out / "ckpt"), out=str(out / "p_mesh.json")),
                   4)
    # the reference's runs, a process each (their compiles take longest)
    single = dict(dims=None, axes=None)
    refs = [_reference(base, out, dict(
        name=f"{tag}{'_g' if g else ''}", gather_once=g, start=0,
        steps=STEPS, **m_))
        for g in (False, True) for tag, m_ in (("mesh", mesh3),
                                               ("single", single))]
    _wait(procs)
    # stage 2, once the step-6 checkpoint is written: gather_once on
    # (2, 1, 2); the elastic restart onto (1, 2), a single process resumed
    # from the same checkpoint, and the reference's (1, 2) and
    # single-device restarts from it
    procs = _ranks(dict(base, **mesh3, steps=STEPS, gather_once=True,
                        resume=False, init=str(out / "init.pt"),
                        out=str(out / "p_mesh_g.json")), 4)
    common = dict(base, steps=MORE, gather_once=False, resume=True,
                  ckpt=str(out / "ckpt"))
    procs += (_ranks(dict(common, **mesh2, out=str(out / "p_restart.json")),
                     2)
              + _ranks(dict(common, dims=None, axes=None,
                            out=str(out / "p_restart_single.json")), 1))
    # the step-6 checkpoint as the reference's trees, for its restart
    params = transformer.DecoderLM(cfg, device="cpu", dtype=torch.float32)
    tcfg = TrainConfig(optimizer="adamw", lr=LR)
    target = (dict(params.named_parameters()),
              opt_mod.init_opt_state(tcfg, params))
    (tree, opt), meta = CheckpointManager(str(out / "ckpt")).restore(target)
    assert meta["step"] == STEPS
    flat = {}
    for tag, sd in (("p", tree), ("m", opt["m"]), ("v", opt["v"])):
        flat.update({f"{tag}/{k}": v
                     for k, v in _ref_tree_flat(sd, cfg).items()})
    np.savez(out / "state6.npz", **flat)
    refs += [_reference(base, out, dict(
        name=f"restart_{tag}", gather_once=False,
        state=str(out / "state6.npz"), start=STEPS, steps=MORE, **m_))
        for tag, m_ in (("mesh", mesh2), ("single", single))]
    _wait(procs + refs, timeout=300)
    res = {}
    for name in ("mesh", "single", "mesh_g", "single_g", "restart_mesh",
                 "restart_single"):
        res.update(json.loads((out / f"ref_{name}.json").read_text()))
    for name in ("p_mesh", "p_mesh_g", "p_restart", "p_restart_single"):
        res[name] = json.loads((out / f"{name}.json").read_text())
    return res


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("gather_once", (False, True),
                         ids=("plain", "gather_once"))
def test_mesh_losses_equal_reference_mesh(runs, gather_once):
    g = "_g" if gather_once else ""
    got, want = runs[f"p_mesh{g}"]["losses"], runs[f"mesh{g}"]
    assert len(got) == STEPS and all(np.isfinite(got))
    assert _rel(got[:1], want[:1]) <= MESH_RTOL, (got, want)
    assert _rel(got, want) <= (BF16_GRAD_RTOL if gather_once
                               else MESH_RTOL), (got, want)
    assert got[-1] < got[0]


@pytest.mark.parametrize("gather_once", (False, True),
                         ids=("plain", "gather_once"))
def test_mesh_losses_near_reference_single_device(runs, gather_once):
    g = "_g" if gather_once else ""
    got = runs[f"p_mesh{g}"]["losses"]
    assert _rel(got[:1], runs[f"single{g}"][:1]) <= SINGLE_FIRST_RTOL
    assert _rel(got, runs[f"single{g}"]) <= SINGLE_RTOL
    # the reference's own mesh and single-device runs part as much
    assert _rel(runs[f"mesh{g}"], runs[f"single{g}"]) > MESH_RTOL


def test_elastic_restart_equals_reference_restart(runs):
    got = runs["p_restart"]["losses"]
    assert len(got) == MORE and all(np.isfinite(got))
    assert _rel(got, runs["restart_mesh"]) <= MESH_RTOL
    assert max(got) < runs["p_mesh"]["losses"][0]


def test_elastic_restart_continues_as_single_process(runs):
    got = runs["p_restart"]["losses"]
    single = runs["p_restart_single"]["losses"]
    assert _rel(single, runs["restart_single"]) <= MESH_RTOL
    assert _rel(got[:1], single[:1]) <= SINGLE_FIRST_RTOL
    assert _rel(got, single) <= SINGLE_RTOL


def test_launcher_cli_mesh(tmp_path):
    """``launch/train.py --smoke --mesh 2x2`` as a user runs it: four
    processes over gloo, their losses, and a checkpoint of global leaves
    that restores whole into a single-process model."""
    rec = tmp_path / "rec.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--mesh", "2x2", "--steps", "3", "--seq", str(SEQ),
         "--batch", str(BATCH), "--device", "cpu", "--ckpt",
         str(tmp_path / "ck"), "--save-every", "3", "--record", str(rec)],
        env=_env(), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = json.loads(rec.read_text())["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    cfg = configs.get_smoke(ARCH)
    params = transformer.DecoderLM(cfg, device="cpu", dtype=torch.float32)
    target = (dict(params.named_parameters()),
              opt_mod.init_opt_state(TrainConfig(), params))
    (tree, _), meta = CheckpointManager(str(tmp_path / "ck")).restore(target)
    assert meta["step"] == 3
    assert tree["layers.0.moe.wi_gate"].shape[0] == cfg.moe.n_experts


def test_use_mesh_is_seen_from_another_thread():
    """The autograd engine recomputes a checkpointed layer on its own
    device thread: the mesh entered by ``use_mesh`` is visible there, and
    gone once the block ends."""
    import threading
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import rules
    seen = []
    mesh = make_test_mesh((2, 2))
    with rules.use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(
            rules.current_mesh()))
        t.start()
        t.join()
    assert seen[0] is not None and seen[0].mesh is mesh
    assert rules.current_mesh() is None


def test_batch_block_cuts_each_microbatch():
    """A process's rows: the reference's microbatch ``i`` (global rows
    ``i * B / mb`` on) cut over the batch axes, in microbatch order."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.train import batch_block

    class Mesh(MeshShape):
        def __init__(self, dims, axes, coords):
            super().__init__(axes, dims)
            object.__setattr__(self, "coords", coords)

        def axis_size(self, axes):
            return int(np.prod([self.shape[a] for a in axes]))

        def axis_index(self, axes):
            idx = 0
            for a in axes:
                idx = idx * self.shape[a] + self.coords[a]
            return idx

    rows = torch.arange(8)
    for pod, want in ((0, [0, 1, 4, 5]), (1, [2, 3, 6, 7])):
        mesh = Mesh((2, 1, 2), ("pod", "data", "model"),
                    {"pod": pod, "data": 0, "model": 1})
        assert batch_block(rows, mesh, 2).tolist() == want
        assert batch_block(rows, mesh, 1).tolist() == list(
            range(4 * pod, 4 * pod + 4))
