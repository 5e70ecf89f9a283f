"""FSDP over ``data`` and tensor parallelism over ``model`` for the dense
parameters on a process mesh (``sharding.rules.local_specs`` as the
reference's ``param_specs``), over gloo ranks on the CPU, against the
reference's sharded mesh run and the single-process port.

The ranks start once for the module (``OMP_NUM_THREADS=1``, at most four
at a time) on the smoke configs of qwen2.5-3b (tied embeddings, qkv
bias) and qwen3-moe (untied, qk-norm, experts):

* every leaf a rank holds is its ``param_specs`` block of the global
  leaf, and the reference's run places the same leaves sharded;
* prefill and decode logits (``init_params`` on the mesh) within 1e-5
  relative of the single-process port's (qwen3-moe at a capacity factor
  where no token drops: a mesh counts capacity per token slice);
* from the reference's ``m.init(key(0))`` parameters and
  ``TokenPipeline(seq 16, batch 4, seed 5)``: three AdamW steps, two
  Adafactor steps (the second loss after the first update) and
  ``gather_once`` with two microbatches on (2, 2), against the
  reference's ``jax.jit`` step on 4 forced host devices with its
  parameters and state placed by ``param_specs``; then the elastic
  restart of the AdamW run's step-3 checkpoint onto (1, 2), against the
  reference's restart from the same checkpoint;
* each new collective's backward against the single-process gradient in
  fp64: the FSDP gather, the reduce-scatter, the column-parallel input
  (``sum_grad``), the row-parallel output (``psum``) and the
  vocab-parallel cross-entropy;
* a spec that cuts inside a head: qwen2.5-3b's 2 kv heads on a (1, 4)
  mesh, against one process;
* rwkv6-3b and deepseek-v3 (not in this slice) keep their dense leaves
  whole on a mesh.
"""

import dataclasses
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
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer
from repro_torch.models.model import cross_entropy
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt_mod

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ("qwen2.5-3b", "qwen3-moe-30b-a3b")
SEQ, BATCH, SEED, LR = 16, 4, 5, 2e-3
STEPS, AF_STEPS, RESTART = 3, 2, 2
MESH, RESTART_MESH, AXES = (2, 2), (1, 2), ("data", "model")
RTOL = 1e-5
#: the collectives' fp64 gradients against one process's
F64_RTOL = 1e-12
#: ``cross_entropy`` computes in fp32 (as the reference's): its vocab
#: blocks' sums part from one process's by fp32 roundings
CE_RTOL = 1e-6
#: gather_once differentiates through a bf16 copy, so every gradient is
#: rounded to bf16 (the copy's cotangent) and its microbatches' parts
#: added in bf16: the batch blocks of a mesh group those sums otherwise
#: than one device or XLA does, a small gradient of cancelling parts
#: (a bias, a norm scale) moves by some 1e-3 of itself, and AdamW's
#: per-element step carries that into the next losses (the first loss is
#: held at RTOL; ``test_torch_mesh_train``'s band for the same case)
BF16_GRAD_RTOL = 1e-3
#: the MoE capacity factor of the logits' comparison with one process: a
#: mesh counts capacity per token slice, one process per chunk (the
#: reference's semantics, ROADMAP Queue 3), and the two agree where
#: nothing drops
DROPLESS_CF = 16.0

RANK_CODE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch import configs, convert
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.launch.train import batch_block
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model, cross_entropy
    from repro_torch.sharding import collectives as coll, rules
    from repro_torch.train import loop, optimizer as opt_mod
    job = json.loads(sys.argv[1])
    rank, world, addr = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                             world_size=world, rank=rank)
    mesh = ProcessMesh(job["axes"], job["dims"])
    out = {"coords": mesh.coords}

    def t(x):
        return x.detach().numpy().tolist()

    def collectives():
        # fp64, every process's inputs from one seed (the test redoes the
        # whole computation in one process)
        g = np.random.default_rng(7)
        w = torch.from_numpy(g.standard_normal((4, 6)))
        a = torch.from_numpy(g.standard_normal((4, 4, 6)))
        x = torch.from_numpy(g.standard_normal((4, 4, 3)))
        b = torch.from_numpy(g.standard_normal((4, 2, 3)))
        h = torch.from_numpy(g.standard_normal((3, 5)))
        w1 = torch.from_numpy(g.standard_normal((5, 8)))
        w2 = torch.from_numpy(g.standard_normal((8, 4)))
        tt = torch.from_numpy(g.standard_normal((3, 4)))
        logits = torch.from_numpy(g.standard_normal((2, 5, 10)))
        d, m = mesh.coords["data"], mesh.coords["model"]
        res = {}
        # the FSDP gather over data on dim 0
        blk = w[2 * d:2 * d + 2].clone().requires_grad_(True)
        whole = coll.gather_blocks(blk, mesh, ("data",), 0)
        torch.sum(torch.tanh(whole) * a[rank]).backward()
        res["gather"] = t(blk.grad)
        # the reduce-scatter over data on dim 0
        xr = x[rank].clone().requires_grad_(True)
        y = coll.reduce_scatter(xr, mesh, ("data",), 0)
        torch.sum(torch.tanh(y) * b[rank]).backward()
        res["reduce_scatter"] = t(xr.grad)
        res["reduce_scatter_y"] = t(y)
        # a column-parallel product (w1's columns) and a row-parallel one
        # (w2's rows) over model: every process the same loss
        hr = h.clone().requires_grad_(True)
        b1 = w1[:, 4 * m:4 * m + 4].clone().requires_grad_(True)
        b2 = w2[4 * m:4 * m + 4].clone().requires_grad_(True)
        z = coll.psum(torch.tanh(coll.sum_grad(hr, mesh, ("model",)) @ b1)
                      @ b2, mesh, ("model",))
        loss = torch.sum(torch.tanh(z) * tt)
        loss.backward()
        res.update(tp_loss=float(loss), tp_dh=t(hr.grad), tp_dw1=t(b1.grad),
                   tp_dw2=t(b2.grad))
        # the vocab-parallel cross-entropy: targets in both halves and
        # one ignored
        tgt = torch.tensor([[0, 4, 5, 9, -1], [7, 2, 2, 6, 1]])
        lb = logits[..., 5 * m:5 * m + 5].clone().requires_grad_(True)
        ce = cross_entropy(lb, tgt, mesh=mesh)
        ce.backward()
        res.update(ce=float(ce), ce_grad=t(lb.grad))
        return res

    def dropless(cfg):
        if cfg.moe is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=job["dropless_cf"]))

    def reshard(params, tree):
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(tree[name])

    def train(arch, opt_name, steps, mb, gather_once, save=None):
        cfg = configs.get_smoke(arch)
        n_exp = cfg.moe.n_experts if cfg.moe else 0
        params = transformer.DecoderLM(cfg, device="cpu",
                                       dtype=torch.float32, mesh=mesh)
        tcfg = TrainConfig(optimizer=opt_name, lr=job["lr"],
                           gather_once=gather_once)
        opt = opt_mod.init_opt_state(tcfg, params)
        start = 0
        if job.get("ckpt"):
            target = (loop.param_tree(params), opt)
            sh = rules.tree_map_with_path(
                lambda _, sp: rules.NamedSharding(mesh, sp),
                rules.local_specs(mesh, target, n_exp))
            (tree, opt), meta = CheckpointManager(
                job["ckpt"][arch]).restore(target, shardings=sh)
            start = meta["step"]
        else:
            tree = convert.mesh_local(torch.load(job["init"][arch]), mesh,
                                      n_exp)
        reshard(params, tree)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                             global_batch=job["batch"], seed=job["seed"])
        step = loop.make_train_step(build_model(cfg), tcfg, microbatches=mb)
        losses, gnorms = [], []
        with rules.use_mesh(mesh):
            for i in range(start, start + steps):
                batch = {"tokens": batch_block(
                    torch.from_numpy(pipe.batch(i)["tokens"]), mesh, mb)}
                params, opt, met = step(params, opt, batch, i)
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
        if save:
            state = convert.mesh_global((loop.param_tree(params), opt),
                                        mesh, n_exp, 0)
            if rank == 0:
                CheckpointManager(save).save(start + steps, state,
                                             metadata={"step": start + steps})
        return {"losses": losses, "grad_norms": gnorms}

    def serve(arch):
        cfg = dropless(configs.get_smoke(arch))
        params = transformer.init_params(cfg, 0, device="cpu", mesh=mesh)
        toks = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (job["batch"], 13)))
        mine = batch_block(toks, mesh)
        with rules.use_mesh(mesh):
            cache = transformer.init_cache(cfg, mine.shape[0], 16,
                                           torch.float32, device="cpu")
            pre, cache = transformer.prefill(params, cfg, mine[:, :12],
                                             cache)
            dec, cache = transformer.decode_step(
                params, cfg, mine[:, 12], torch.full((mine.shape[0],), 12),
                cache)
        return {"prefill": t(pre[:, 0]), "decode": t(dec),
                "cache_kv_heads": cache["layers"][0]["k"].shape[2]}

    def layout(arch):
        cfg = configs.get_smoke(arch)
        params = transformer.DecoderLM(cfg, device="cpu",
                                       dtype=torch.float32, mesh=mesh)
        return {n: [list(p.shape), list(p.global_shape), repr(p.spec)]
                for n, p in params.named_parameters()}

    for task in job["tasks"]:
        kind, arch = (task.split(":") + [None])[:2]
        if kind == "collectives":
            out[task] = collectives()
        elif kind == "serve":
            out[task] = serve(arch)
        elif kind == "layout":
            out[task] = layout(arch)
        elif kind == "adamw":
            out[task] = train(arch, "adamw", job["steps"], 1, False,
                              save=job["save"][arch])
        elif kind == "adafactor":
            out[task] = train(arch, "adafactor", job["af_steps"], 1, False)
        elif kind == "gather_once":
            out[task] = train(arch, "adamw", job["steps"], 2, True)
        elif kind == "restart":
            out[task] = train(arch, "adamw", job["restart"], 1, False)
    with open(f"{job['out']}_{rank}.json", "w") as f:
        json.dump(out, f)
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

    def sharded(tree):
        return sum(not x.sharding.is_fully_replicated
                   for x in jax.tree.leaves(tree))

    out = {}
    for run in job["runs"]:
        tcfg = TrainConfig(optimizer=run["opt"], lr=job["lr"],
                           gather_once=run["gather_once"])
        n = int(np.prod(run["dims"]))
        # a mesh built from jax.devices(), as the reference's own
        # test_distributed_train places its leaves
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(run["dims"]),
            tuple(run["axes"]))
        with rules.use_mesh(mesh):
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
            params = jax.tree.map(jax.device_put, params, rules.param_specs(
                mesh, jax.eval_shape(lambda: params)))
            opt = jax.tree.map(jax.device_put, opt, rules.param_specs(
                mesh, jax.eval_shape(lambda: opt)))
            rec = {"sharded": sharded(params),
                   "leaves": len(jax.tree.leaves(params)),
                   "opt_sharded": sharded(opt)}
            step = jax.jit(make_train_step(m, tcfg,
                                           microbatches=run["mb"]))
            losses, gnorms = [], []
            for i in range(run["start"], run["start"] + run["steps"]):
                batch = {"tokens": jnp.asarray(pipe.batch(i)["tokens"])}
                params, opt, met = step(params, opt, batch, jnp.asarray(i))
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
            rec.update(losses=losses, grad_norms=gnorms,
                       sharded_after=sharded(params))
        out[run["name"]] = rec
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


def _ranks(job, dims):
    world = int(np.prod(dims))
    addr = f"127.0.0.1:{_free_port()}"
    job = dict(job, dims=list(dims), axes=list(AXES))
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, json.dumps(job), str(r),
         str(world), addr], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _reference(arch, runs, out):
    job = dict(arch=arch, seq=SEQ, batch=BATCH, seed=SEED, lr=LR, runs=runs,
               out=str(out))
    return subprocess.Popen([sys.executable, "-c", REF_CODE,
                             json.dumps(job)], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(procs, timeout=300):
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]


def _load(prefix, world):
    return [json.loads(Path(f"{prefix}_{r}.json").read_text())
            for r in range(world)]


def _ref_tree_flat(sd: dict, cfg) -> dict:
    """A port state dict (global, by parameter name) as the reference's
    stacked tree, flattened to ``/`` paths with ``period/{j}``."""
    prefix, period, n_periods = transformer.period_structure(cfg)
    assert not prefix
    out = {}
    for j in range(len(period)):
        for key in [k for k in sd if k.startswith(f"layers.{j}.")]:
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
    out = tmp_path_factory.mktemp("mesh_tp")
    init, save = {}, {}
    for arch in ARCHS:
        rm = ref_build_model(ref_configs.get_smoke(arch))
        sd = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, rm.init(jax.random.key(0))),
            configs.get_smoke(arch), device="cpu", dtype=torch.float32)
        init[arch] = str(out / f"init_{arch}.pt")
        save[arch] = str(out / f"ckpt_{arch}")
        torch.save(sd, init[arch])
    base = dict(seq=SEQ, batch=BATCH, seed=SEED, lr=LR, steps=STEPS,
                dropless_cf=DROPLESS_CF,
                af_steps=AF_STEPS, restart=RESTART, init=init, save=save)
    tasks = ["collectives"] + [f"{k}:{a}" for a in ARCHS for k in (
        "layout", "serve", "adamw", "adafactor", "gather_once")] + [
        "layout:rwkv6-3b", "layout:deepseek-v3-671b"]
    procs = _ranks(dict(base, tasks=tasks, out=str(out / "m22")), MESH)
    ref_runs = [dict(name="adamw", opt="adamw", gather_once=False, mb=1,
                     steps=STEPS),
                dict(name="adafactor", opt="adafactor", gather_once=False,
                     mb=1, steps=AF_STEPS),
                dict(name="gather_once", opt="adamw", gather_once=True, mb=2,
                     steps=STEPS)]
    refs = [_reference(arch, [dict(r, dims=list(MESH), axes=list(AXES),
                                   start=0) for r in ref_runs],
                       out / f"ref_{arch}.json") for arch in ARCHS]
    _wait(procs)
    # stage 2, once the step-3 checkpoints are written: the head-cut
    # case on (1, 4), the port's restart onto (1, 2) and the reference's
    # restart from the same checkpoint
    procs = _ranks(dict(base, tasks=["serve:qwen2.5-3b", "adamw:qwen2.5-3b"],
                        save={"qwen2.5-3b": None}, out=str(out / "m14")),
                   (1, 4))
    _wait(procs + refs)
    procs = _ranks(dict(base, tasks=[f"restart:{a}" for a in ARCHS],
                        ckpt=save, out=str(out / "m12")), RESTART_MESH)
    restarts = []
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        params = transformer.DecoderLM(cfg, device="cpu",
                                       dtype=torch.float32)
        target = (dict(params.named_parameters()), opt_mod.init_opt_state(
            TrainConfig(optimizer="adamw", lr=LR), params))
        (tree, opt), meta = CheckpointManager(save[arch]).restore(target)
        assert meta["step"] == STEPS
        flat = {}
        for tag, sd in (("p", tree), ("m", opt["m"]), ("v", opt["v"])):
            flat.update({f"{tag}/{k}": v
                         for k, v in _ref_tree_flat(sd, cfg).items()})
        np.savez(out / f"state_{arch}.npz", **flat)
        restarts.append(_reference(arch, [dict(
            name="restart", opt="adamw", gather_once=False, mb=1,
            steps=RESTART, dims=list(RESTART_MESH), axes=list(AXES),
            start=STEPS, state=str(out / f"state_{arch}.npz"))],
            out / f"ref_restart_{arch}.json"))
    _wait(procs + restarts)
    res = {"m22": _load(out / "m22", 4), "m14": _load(out / "m14", 4),
           "m12": _load(out / "m12", 2)}
    for arch in ARCHS:
        res[f"ref_{arch}"] = json.loads(
            (out / f"ref_{arch}.json").read_text())
        res[f"ref_{arch}"].update(json.loads(
            (out / f"ref_restart_{arch}.json").read_text()))
    return res


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# --------------------------------------------------------------------------
# the layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_its_param_specs_block(runs, arch):
    """Each rank's leaf is ``shard_shape(global, param_specs)``, the spec
    it carries is ``param_specs``'; and the reference's run places as
    many leaves sharded as the port cuts."""
    cfg = configs.get_smoke(arch)
    meta = transformer.DecoderLM(cfg, device="meta", dtype=torch.float32)
    mesh = make_test_mesh(MESH)
    want = rules.param_specs(mesh, dict(meta.named_parameters()))
    cut = 0
    for rank in runs["m22"]:
        got = rank[f"layout:{arch}"]
        assert set(got) == set(want)
        for name, (shape, whole, spec) in got.items():
            assert tuple(whole) == tuple(meta.get_parameter(name).shape)
            assert tuple(shape) == rules.shard_shape(whole, want[name],
                                                     mesh), name
            assert spec == repr(want[name]), name
    # the reference stacks each period slot: count its leaves by slot
    slots = {n.split(".", 2)[2] if n.startswith("layers.") else n: sp
             for n, sp in want.items()}
    cut = sum(len(sp) > 0 for sp in slots.values())
    ref = runs[f"ref_{arch}"]["adamw"]
    assert ref["sharded"] == ref["sharded_after"] == cut > 0
    assert ref["opt_sharded"] >= cut
    assert cut < ref["leaves"]          # norms (and the router) replicated
    if arch == "qwen2.5-3b":            # vocab over model, d over data
        assert want["embed.table"] == rules.P("model", "data")
        assert want["layers.0.attn.wk.b"] == rules.P("model")
        assert want["layers.0.mlp.wo.w"] == rules.P("model", "data")


@pytest.mark.parametrize("arch", ("rwkv6-3b", "deepseek-v3-671b"))
def test_families_outside_the_slice_keep_whole_leaves(runs, arch):
    """MLA, Mamba and RWKV-6 keep every dense leaf whole on a process
    mesh (``rules.shards_dense``); only the expert stacks are cut."""
    for rank in runs["m22"]:
        for name, (shape, whole, spec) in rank[f"layout:{arch}"].items():
            if ".moe.w" in name:
                assert shape[0] < whole[0], name
            else:
                assert shape == whole and spec == repr(rules.P()), name
    assert not rules.shards_dense({"attn", "mla"})
    assert rules.shards_dense({"attn"})


# --------------------------------------------------------------------------
# serving and training against one process and the reference's mesh
# --------------------------------------------------------------------------

def _single_serve(arch):
    cfg = configs.get_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=DROPLESS_CF))
    params = transformer.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (BATCH, 13)))
    cache = transformer.init_cache(cfg, BATCH, 16, torch.float32,
                                   device="cpu")
    pre, cache = transformer.prefill(params, cfg, toks[:, :12], cache)
    dec, _ = transformer.decode_step(params, cfg, toks[:, 12],
                                     torch.full((BATCH,), 12), cache)
    return pre[:, 0].numpy(), dec.numpy()


@pytest.mark.parametrize("arch,mesh", (("qwen2.5-3b", "m22"),
                                       ("qwen3-moe-30b-a3b", "m22"),
                                       ("qwen2.5-3b", "m14")))
def test_prefill_decode_logits_equal_one_process(runs, arch, mesh):
    """The mesh's prefill and decode logits, gathered over ``model`` to
    ``(B, vocab)``, within 1e-5 relative of one process's; the processes
    of a batch block agree bit for bit; the cache holds the local kv
    heads.  (1, 4) cuts qwen2.5-3b's kv projections inside a head."""
    pre, dec = _single_serve(arch)
    cfg = configs.get_smoke(arch)
    ranks = runs[mesh]
    rows = BATCH // (2 if mesh == "m22" else 1)
    for r in ranks:
        got = r[f"serve:{arch}"]
        d = r["coords"]["data"]
        sl = slice(d * rows, (d + 1) * rows)
        assert _rel(got["prefill"], pre[sl]) <= RTOL
        assert _rel(got["decode"], dec[sl]) <= RTOL
        same = [q for q in ranks if q["coords"]["data"] == d]
        assert got["prefill"] == same[0][f"serve:{arch}"]["prefill"]
        n_model = 2 if mesh == "m22" else 4
        if cfg.n_kv_heads % n_model == 0:
            assert got["cache_kv_heads"] == cfg.n_kv_heads // n_model
        else:                           # the one kv head its q heads read
            assert got["cache_kv_heads"] == 1


@pytest.mark.parametrize("kind", ("adamw", "adafactor", "gather_once"))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_equals_reference_sharded_mesh(runs, arch, kind):
    """Three AdamW steps, two Adafactor steps (the second loss after the
    first update) and ``gather_once`` with two microbatches on (2, 2):
    the losses and the clipped gradients' global norms within 1e-5
    relative of the reference's sharded run (``gather_once``: its first
    loss, computed before any bf16 gradient, within 1e-5, every loss and
    norm within BF16_GRAD_RTOL); every rank the same."""
    ref = runs[f"ref_{arch}"][kind]
    got = runs["m22"][0][f"{kind}:{arch}"]
    for r in runs["m22"][1:]:
        assert r[f"{kind}:{arch}"] == got
    assert len(got["losses"]) == len(ref["losses"])
    tol = BF16_GRAD_RTOL if kind == "gather_once" else RTOL
    assert _rel(got["losses"][:1], ref["losses"][:1]) <= RTOL, (got, ref)
    for key in ("losses", "grad_norms"):
        assert _rel(got[key], ref[key]) <= tol, (got, ref)
    assert all(np.isfinite(got["losses"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_restart_equals_reference_restart(runs, arch):
    """The step-3 checkpoint (global leaves, gathered from the (2, 2)
    blocks) restored onto (1, 2): within 1e-5 of the reference's restart
    from the same checkpoint, and below the first loss."""
    got = runs["m12"][0][f"restart:{arch}"]
    assert runs["m12"][1][f"restart:{arch}"] == got
    ref = runs[f"ref_{arch}"]["restart"]
    assert _rel(got["losses"], ref["losses"]) <= RTOL, (got, ref)
    assert _rel(got["grad_norms"], ref["grad_norms"]) <= RTOL
    assert max(got["losses"]) < runs["m22"][0][f"adamw:{arch}"]["losses"][0]


def test_head_cut_mesh_trains_as_reference(runs):
    """qwen2.5-3b on (1, 4): the kv projections are cut inside a head,
    gathered at use; three AdamW steps within 1e-5 of the reference's
    sharded (2, 2) run of the same steps (the same global batch)."""
    got = runs["m14"][0]["adamw:qwen2.5-3b"]
    ref = runs["ref_qwen2.5-3b"]["adamw"]
    assert _rel(got["losses"], ref["losses"]) <= RTOL
    assert _rel(got["grad_norms"], ref["grad_norms"]) <= RTOL


# --------------------------------------------------------------------------
# the collectives' gradients in fp64, against one process
# --------------------------------------------------------------------------

def _inputs():
    g = np.random.default_rng(7)
    names = ("w", "a", "x", "b", "h", "w1", "w2", "tt", "logits")
    shapes = ((4, 6), (4, 4, 6), (4, 4, 3), (4, 2, 3), (3, 5), (5, 8),
              (8, 4), (3, 4), (2, 5, 10))
    return {n: torch.from_numpy(g.standard_normal(s))
            for n, s in zip(names, shapes)}


def _coll(runs, rank):
    return runs["m22"][rank]["collectives"]


def _rank(d, m):
    return d * MESH[1] + m


def test_gather_blocks_backward_sums_into_the_owner(runs):
    """The FSDP gather over ``data``: each block's gradient is the sum of
    the gradients of every process's loss along ``data`` (not the own
    rows of the token-slice ``all_gather``)."""
    v = _inputs()
    for m in range(MESH[1]):
        w = v["w"].clone().requires_grad_(True)
        sum(torch.sum(torch.tanh(w) * v["a"][_rank(d, m)])
            for d in range(MESH[0])).backward()
        for d in range(MESH[0]):
            got = np.asarray(_coll(runs, _rank(d, m))["gather"])
            assert _rel(got, w.grad[2 * d:2 * d + 2]) <= F64_RTOL


def test_reduce_scatter_sums_and_gathers_back(runs):
    """The reduce-scatter over ``data``: each process gets the sum of its
    block's parts, and its input's gradient holds every block's
    cotangent."""
    v = _inputs()
    for m in range(MESH[1]):
        xs = [v["x"][_rank(d, m)].clone().requires_grad_(True)
              for d in range(MESH[0])]
        total = 0
        for d in range(MESH[0]):
            y = sum(x[2 * d:2 * d + 2] for x in xs)
            got = _coll(runs, _rank(d, m))["reduce_scatter_y"]
            assert _rel(got, y.detach()) <= F64_RTOL
            total = total + torch.sum(torch.tanh(y) * v["b"][_rank(d, m)])
        total.backward()
        for d in range(MESH[0]):
            got = _coll(runs, _rank(d, m))["reduce_scatter"]
            assert _rel(got, xs[d].grad) <= F64_RTOL


def _tp_single():
    v = _inputs()
    h = v["h"].clone().requires_grad_(True)
    w1 = v["w1"].clone().requires_grad_(True)
    w2 = v["w2"].clone().requires_grad_(True)
    loss = torch.sum(torch.tanh(torch.tanh(h @ w1) @ w2) * v["tt"])
    loss.backward()
    return loss.item(), h.grad, w1.grad, w2.grad


def test_sum_grad_is_the_column_parallel_input(runs):
    """A column-parallel product's input enters through ``sum_grad``: its
    gradient on every process is the whole input's, summed over
    ``model``."""
    loss, dh, _, _ = _tp_single()
    for r in range(4):
        got = _coll(runs, r)
        assert abs(got["tp_loss"] - loss) <= F64_RTOL * abs(loss)
        assert _rel(got["tp_dh"], dh) <= F64_RTOL


def test_psum_is_the_row_parallel_output(runs):
    """A row-parallel product's partial sums leave through ``psum``: the
    sum over ``model`` forward, the cotangent passed to every part as it
    is, so each block's gradient is the single process's block."""
    _, _, dw1, dw2 = _tp_single()
    for r in range(4):
        m = r % MESH[1]
        got = _coll(runs, r)
        assert _rel(got["tp_dw1"], dw1[:, 4 * m:4 * m + 4]) <= F64_RTOL
        assert _rel(got["tp_dw2"], dw2[4 * m:4 * m + 4]) <= F64_RTOL


def test_vocab_parallel_cross_entropy(runs):
    """The cross-entropy of vocab blocks over ``model``: the same loss on
    every process as one process's of the whole logits, and each block's
    gradient its block of the whole gradient (a target outside a
    process's range adds nothing there; an ignored one nothing at all),
    within CE_RTOL (it computes in fp32)."""
    logits = _inputs()["logits"].clone().requires_grad_(True)
    tgt = torch.tensor([[0, 4, 5, 9, -1], [7, 2, 2, 6, 1]])
    ce = cross_entropy(logits, tgt)
    ce.backward()
    for r in range(4):
        m = r % MESH[1]
        got = _coll(runs, r)
        assert abs(got["ce"] - ce.item()) <= CE_RTOL * ce.item()
        assert _rel(got["ce_grad"], logits.grad[..., 5 * m:5 * m + 5]) \
            <= CE_RTOL
