"""How far rounding alone moves three training steps of a smoke LM, on
the CPU: the bands of ``tests/_mesh_tp_harness.py`` (``NORM_CHAOS_RTOL``,
``BF16_CHAOS_RTOL``) and ROADMAP Queue 3's gather_once entry.

    PYTHONPATH=src python scripts/mesh_rounding_probe.py port ARCH [go]
    PYTHONPATH=src python scripts/mesh_rounding_probe.py mesh ARCH [go]
    PYTHONPATH=src python scripts/mesh_rounding_probe.py ref ARCH [go] [single]
    PYTHONPATH=src python scripts/mesh_rounding_probe.py leaves ARCH
    PYTHONPATH=src python scripts/mesh_rounding_probe.py forced ARCH
    PYTHONPATH=src python scripts/mesh_rounding_probe.py flips ARCH

Every run starts from the reference's ``m.init(key(0))`` parameters of
ARCH's smoke config and takes three AdamW steps (lr 2e-3) on
``TokenPipeline(seq 16, batch 4, seed 5)``, as the mesh tests do; ``go``
takes them with ``gather_once`` and two microbatches.  ``port``: one
process of the port; ``mesh``: the port on a (2, 2) ``("data", "model")``
mesh of four gloo processes (the tests' ranks); ``ref``: the reference's
``jax.jit`` step on 4 forced host devices as a (2, 2) mesh with its
leaves placed by ``param_specs`` (``single``: on one device).  Each runs
three times: as is, and with the initial parameters scaled by ``1 +
1e-7 N(0, 1)`` under two seeds; one line of ``(loss, gradient norm)`` a
step per run.  ``leaves``: the first step's ``gather_once`` gradient
(bf16) of one process of the port against the reference's on one
device, leaf by leaf, as the largest difference over the leaf's largest
magnitude; the ten largest.  ``forced``: the reference's ``go`` run on
(2, 2) writes its state before each step, and the port's (2, 2) mesh
takes one ``gather_once`` step from each (the tests' ``forced`` task):
per step the loss and norm of both, the worst leaf's relative L2 error,
and the gradient elements whose sign (or zero) differs.  ``flips``: the
reference's ``go`` run on (2, 2) with about 350 of its zero gradient
elements a step (each with probability 0.011) made residues of
``+-1e-6``, under six seeds (seed 0: none).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

SEQ, BATCH, SEED, LR, STEPS, TRIALS = 16, 4, 5, 2e-3, 3, 3


def _init_state_dict(arch: str):
    import jax
    import torch
    from repro import configs as ref_configs
    from repro.models.model import build_model as ref_build_model
    from repro_torch import configs, convert
    rm = ref_build_model(ref_configs.get_smoke(arch))
    return convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rm.init(jax.random.key(0))),
        configs.get_smoke(arch), device="cpu", dtype=torch.float32)


def _perturbed(sd: dict, trial: int) -> dict:
    import torch
    if trial == 0:
        return sd
    g = torch.Generator().manual_seed(trial)
    return {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g))
            for k, v in sd.items()}


def port(arch: str, go: bool) -> None:
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt_mod
    cfg = configs.get_smoke(arch)
    sd0 = _init_state_dict(arch)
    for trial in range(TRIALS):
        params = transformer.DecoderLM(cfg, device="cpu",
                                       dtype=torch.float32)
        params.load_state_dict(_perturbed(sd0, trial))
        tcfg = TrainConfig(optimizer="adamw", lr=LR, gather_once=go)
        opt = opt_mod.init_opt_state(tcfg, params)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, seed=SEED)
        step = loop.make_train_step(build_model(cfg), tcfg,
                                    microbatches=2 if go else 1)
        out = []
        for i in range(STEPS):
            params, opt, met = step(params, opt, {"tokens": torch.from_numpy(
                pipe.batch(i)["tokens"])}, i)
            out.append((float(met["loss"]), float(met["grad_norm"])))
        print(json.dumps({"run": "port", "arch": arch, "gather_once": go,
                          "trial": trial, "steps": out}), flush=True)


def mesh(arch: str, go: bool) -> None:
    import torch
    from _mesh_tp_harness import MESH, base_job, load, ranks, wait
    sd0 = _init_state_dict(arch)
    kind = "gather_once" if go else "adamw"
    with tempfile.TemporaryDirectory() as tmp:
        for trial in range(TRIALS):
            init = os.path.join(tmp, f"init_{trial}.pt")
            torch.save(_perturbed(sd0, trial), init)
            out = os.path.join(tmp, f"m{trial}")
            wait(ranks(dict(base_job({arch: init}, {}),
                            tasks=[f"{kind}:{arch}"], out=out), MESH))
            got = load(out, 4)[0][f"{kind}:{arch}"]
            print(json.dumps({"run": "mesh (2, 2)", "arch": arch,
                              "gather_once": go, "trial": trial,
                              "steps": list(zip(got["losses"],
                                                got["grad_norms"]))}),
                  flush=True)


REF_RUN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.configs.base import TrainConfig
from repro.data.pipeline import TokenPipeline
from repro.models.model import build_model
from repro.sharding import rules
from repro.train.loop import make_train_step
from repro.train.optimizer import init_opt_state
arch, trial, go, single = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1", sys.argv[4] == "1"
cfg = configs.get_smoke(arch)
m = build_model(cfg)
tcfg = TrainConfig(optimizer="adamw", lr=%(lr)r, gather_once=go)
pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=%(seq)r, global_batch=%(batch)r, seed=%(seed)r)
params = m.init(jax.random.key(0))
if trial:
    keys = iter(jax.random.split(jax.random.key(100 + trial), 10000))
    params = jax.tree.map(lambda p: p * (1 + 1e-7 * jax.random.normal(next(keys), p.shape)) if p.dtype == jnp.float32 else p, params)
opt = init_opt_state(tcfg, params)
step = jax.jit(make_train_step(m, tcfg, microbatches=2 if go else 1))
out = []
def run(params, opt):
    for i in range(%(steps)r):
        params, opt, met = step(params, opt, {"tokens": jnp.asarray(pipe.batch(i)["tokens"])}, jnp.asarray(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
if single:
    run(params, opt)
else:
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    with rules.use_mesh(mesh):
        params = jax.tree.map(jax.device_put, params, rules.param_specs(mesh, jax.eval_shape(lambda: params)))
        opt = jax.tree.map(jax.device_put, opt, rules.param_specs(mesh, jax.eval_shape(lambda: opt)))
        run(params, opt)
print(json.dumps({"run": "reference " + ("one device" if single else "mesh (2, 2)"), "arch": arch, "gather_once": go, "trial": trial, "steps": out}))
""" % dict(lr=LR, seq=SEQ, batch=BATCH, seed=SEED, steps=STEPS)


def ref(arch: str, go: bool, single: bool) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", REF_RUN, arch, str(t),
                               str(int(go)), str(int(single))], env=env,
                              stdout=subprocess.PIPE, text=True)
             for t in range(TRIALS)]
    for p in procs:
        print(p.communicate()[0].strip().splitlines()[-1], flush=True)


def forced(arch: str) -> None:
    from _mesh_tp_harness import (MESH, base_job, load, mesh_runs, ranks,
                                  reference, wait)
    with tempfile.TemporaryDirectory() as tmp:
        wait([reference(arch, [dict(run, dump=tmp) for run in
                               mesh_runs(["gather_once"])],
                        os.path.join(tmp, "ref.json"))])
        ref_rec = json.load(open(os.path.join(tmp, "ref.json")))
        out = os.path.join(tmp, "f")
        wait(ranks(dict(base_job({}, {}), tasks=[f"forced:{arch}"],
                        forced=tmp, out=out), MESH))
        got = load(out, 4)[0][f"forced:{arch}"]
    print(json.dumps({"run": "gather_once from the reference's states",
                      "arch": arch,
                      "reference": ref_rec["gather_once"], "port": got}))


FLIP_RUN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.configs.base import TrainConfig
from repro.data.pipeline import TokenPipeline
from repro.models.model import build_model
from repro.sharding import rules
from repro.train.loop import make_train_step
from repro.train.optimizer import init_opt_state
arch, seed = sys.argv[1], int(sys.argv[2])
cfg = configs.get_smoke(arch)
m = build_model(cfg)
tcfg = TrainConfig(optimizer="adamw", lr=%(lr)r, gather_once=True)
pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=%(seq)r, global_batch=%(batch)r, seed=%(seed)r)
params = m.init(jax.random.key(0))
opt = init_opt_state(tcfg, params)

def step_fn(i):
    def flip(grads):
        if not seed:
            return grads
        leaves, tdef = jax.tree.flatten(grads)
        keys = jax.random.split(jax.random.key(1000 * seed + i), len(leaves))
        def one(g, k):
            k1, k2 = jax.random.split(k)
            pick = (g == 0) & (jax.random.uniform(k1, g.shape) < 0.011)
            sign = jnp.where(jax.random.uniform(k2, g.shape) < 0.5, -1.0, 1.0)
            return jnp.where(pick, sign * 1e-6, g)
        return tdef.unflatten([one(g, k) for g, k in zip(leaves, keys)])
    return jax.jit(make_train_step(m, tcfg, microbatches=2, grad_transform=flip))
out = []
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
with rules.use_mesh(mesh):
    params = jax.tree.map(jax.device_put, params, rules.param_specs(mesh, jax.eval_shape(lambda: params)))
    opt = jax.tree.map(jax.device_put, opt, rules.param_specs(mesh, jax.eval_shape(lambda: opt)))
    for i in range(%(steps)r):
        params, opt, met = step_fn(i)(params, opt, {"tokens": jnp.asarray(pipe.batch(i)["tokens"])}, jnp.asarray(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
print(json.dumps({"run": "reference mesh (2, 2), residue flips", "arch": arch, "seed": seed, "steps": out}))
""" % dict(lr=LR, seq=SEQ, batch=BATCH, seed=SEED, steps=STEPS)


def flips(arch: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", FLIP_RUN, arch,
                               str(s)], env=env, stdout=subprocess.PIPE,
                              text=True) for s in range(7)]
    for p in procs:
        print(p.communicate()[0].strip().splitlines()[-1], flush=True)


def leaves(arch: str) -> None:
    import jax
    import jax.numpy as jnp
    import torch
    from repro import configs as ref_configs
    from repro.data.pipeline import TokenPipeline as RefPipeline
    from repro.models.model import build_model as ref_build_model
    from repro.sharding.rules import gather_params_once
    from repro_torch import configs, convert
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.train import loop
    cfg = configs.get_smoke(arch)
    rm = ref_build_model(ref_configs.get_smoke(arch))
    rp = rm.init(jax.random.key(0))
    toks = RefPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       global_batch=BATCH, seed=SEED).batch(0)["tokens"]
    mbs = {"tokens": jnp.asarray(toks).reshape(2, BATCH // 2, -1)}

    def total_loss(params, mbs):
        cp = gather_params_once(params)

        def micro(lsum, mb):
            return lsum + rm.loss(cp, mb)[0], None
        lsum, _ = jax.lax.scan(jax.checkpoint(micro),
                               jnp.zeros((), jnp.float32), mbs)
        return lsum / 2

    rg = convert.lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jax.grad(total_loss)(rp, mbs)),
        cfg, device="cpu", dtype=torch.float32)
    params = transformer.DecoderLM(cfg, device="cpu", dtype=torch.float32)
    params.load_state_dict(_init_state_dict(arch))
    _, _, pg = loop._gathered_value_and_grad(
        build_model(cfg), params,
        {"tokens": torch.from_numpy(np.asarray(toks)).reshape(
            2, BATCH // 2, -1)}, 2)
    errs = sorted(((float((pg[k] - rg[k]).abs().max()
                          / rg[k].abs().max().clamp_min(1e-30)), k)
                   for k in pg), reverse=True)
    print(json.dumps({"run": "gather_once leaves, port against reference",
                      "arch": arch, "largest": [[k, e] for e, k in
                                                errs[:10]]}))


if __name__ == "__main__":
    cmd, arch_ = sys.argv[1], sys.argv[2]
    flags = set(sys.argv[3:])
    if cmd == "port":
        port(arch_, "go" in flags)
    elif cmd == "mesh":
        mesh(arch_, "go" in flags)
    elif cmd == "ref":
        ref(arch_, "go" in flags, "single" in flags)
    elif cmd == "leaves":
        leaves(arch_)
    elif cmd == "forced":
        forced(arch_)
    elif cmd == "flips":
        flips(arch_)
    else:
        sys.exit(f"unknown command {cmd!r}")
