"""rwkv6-3b at published width on the card: the learning rates of
``chip_smoke.py``'s training leg (f), and the first step's gradient on a
(2, 2) process mesh against one process, leaf by leaf.

    python3 scripts/rwkv_mesh_probe.py lr [LAYERS]
    python3 scripts/rwkv_mesh_probe.py grads [LAYERS]

``lr``: one process runs leg (f) (``chip_smoke.lm_mesh_dense(leg="rwkv")``:
fp32 parameters, bf16 compute, B 4 x S 128 seeded tokens) for four AdamW
steps at lr 1e-3, 1e-4, 3e-5 and 1e-5, one JSON line each (losses,
gradient norms, s a step, peak memory).

``grads``: the gradient of the first step's loss (seed 0's parameters,
``TokenPipeline(seed 0)``'s batch 0), leaf by leaf, on one process and on
four gloo processes sharing the card as a (2, 2) ``("data", "model")``
mesh (each leaf's squares summed over the axes that cut it), with bf16
compute and with fp32 compute, and once more on one process in bf16 with
each batch row's gradient taken alone and averaged (the same function
rounded otherwise).  Prints each run's loss and global norm and the
leaves that part most.  LAYERS defaults to 8.  Needs a CUDA device;
imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.launch.train import batch_block  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import collectives as coll  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import loop  # noqa: E402

DEV = torch.device("cuda")
OUT = os.path.join(ROOT, "build", "rwkv_mesh_probe")


def lr_sweep(layers: int) -> None:
    import chip_smoke as c
    c.LM_MESH_DENSE_STEPS = 4
    c.LM_MESH_TRAIN_LEGS["rwkv"]["layers"] = layers
    for lr in (1e-3, 1e-4, 3e-5, 1e-5):
        c.LM_MESH_TRAIN_LEGS["rwkv"]["lr"] = lr
        r = c.lm_mesh_dense(leg="rwkv")
        print(json.dumps({"layers": layers, "lr": lr, "losses": r["losses"],
                          "grad_norms": r["grad_norms"],
                          "step_s": r["step_s"],
                          "peak_device_mem_bytes":
                              r["peak_device_mem_bytes"]}), flush=True)


def _cfg(compute: str, layers: int):
    return dataclasses.replace(configs.get("rwkv6-3b"), n_layers=layers,
                               dtype=compute)


def _tokens():
    pipe = TokenPipeline(vocab_size=65_536, seq_len=128, global_batch=4,
                         seed=0)
    return torch.as_tensor(pipe.batch(0)["tokens"], device=DEV)


def _squares(grads) -> dict:
    return {n: float(torch.sum(torch.square(g.float())))
            for n, g in grads.items()}


def one_process(compute: str, layers: int, rows: bool = False):
    m = build_model(_cfg(compute, layers))
    params = m.init(0, device=DEV, dtype=torch.float32)
    toks = _tokens()
    if not rows:
        loss, _, g = loop._value_and_grad(m, params, {"tokens": toks})
        return float(loss), _squares(g)
    g, loss = None, 0.0
    for i in range(toks.shape[0]):
        li, _, gi = loop._value_and_grad(m, params,
                                         {"tokens": toks[i:i + 1]})
        loss += float(li) / toks.shape[0]
        g = gi if g is None else {n: g[n] + gi[n] for n in g}
    return loss, _squares({n: v / toks.shape[0] for n, v in g.items()})


def mesh_rank(compute: str, layers: int) -> None:
    """One process of the (2, 2) mesh (started by :func:`grads`)."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import join_process_mesh
    torch.cuda.set_device(0)
    mesh = join_process_mesh((2, 2), ("data", "model"), device=DEV)
    m = build_model(_cfg(compute, layers))
    params = m.init(0, device=DEV, dtype=torch.float32, mesh=mesh)
    specs = {n: rules.spec_of(p) for n, p in params.named_parameters()}
    with rules.use_mesh(mesh):
        loss, met, g = loop._value_and_grad(
            m, params, {"tokens": batch_block(_tokens(), mesh)})
        loss, _, g = loop._reduce_over_mesh(mesh, (), specs, loss, met, g)
        sq = {n: float(coll.all_reduce_sum(
            torch.sum(torch.square(v.float())), mesh,
            loop._cut_axes(specs[n]))) for n, v in g.items()}
    if mesh.rank == 0:
        with open(os.path.join(OUT, f"mesh_{compute}.json"), "w") as f:
            json.dump({"loss": float(loss), "sq": sq}, f)
    tdist.barrier()
    tdist.destroy_process_group()


def grads(layers: int) -> None:
    from repro_torch.launch.multihost import _free_port
    os.makedirs(OUT, exist_ok=True)
    res = {}
    for compute in ("float32", "bfloat16"):
        res[f"one {compute}"] = one_process(compute, layers)
        torch.cuda.empty_cache()
        env = dict(os.environ, REPRO_COORD_ADDR=f"127.0.0.1:{_free_port()}",
                   REPRO_NUM_PROC="4", LOCAL_WORLD_SIZE="4",
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "rank", compute, str(layers)],
            env=dict(env, REPRO_PROC_ID=str(r))) for r in range(4)]
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a mesh process failed")
        with open(os.path.join(OUT, f"mesh_{compute}.json")) as f:
            rec = json.load(f)
        res[f"mesh {compute}"] = (rec["loss"], rec["sq"])
    res["one bfloat16, rows alone"] = one_process("bfloat16", layers, True)
    for name, (loss, sq) in res.items():
        print(json.dumps({"run": name, "layers": layers, "loss": loss,
                          "grad_norm": sum(sq.values()) ** 0.5}))
    for a, b in (("one float32", "mesh float32"),
                 ("one bfloat16", "mesh bfloat16"),
                 ("one bfloat16", "one bfloat16, rows alone")):
        x, y = res[a][1], res[b][1]
        worst = sorted(((abs(x[n] ** 0.5 - y[n] ** 0.5)
                         / max(x[n] ** 0.5, 1e-30), n) for n in x),
                       reverse=True)[:3]
        print(json.dumps({"pair": [a, b], "worst_leaf_norm_rel":
                          [[n, e] for e, n in worst]}))


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "rank":
        mesh_rank(sys.argv[2], int(sys.argv[3]))
    else:
        n_layers = int(sys.argv[2]) if len(sys.argv) > 2 else 8
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        {"lr": lr_sweep, "grads": grads}[mode](n_layers)
