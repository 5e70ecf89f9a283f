"""The harness of the process-mesh FSDP x TP tests
(``test_torch_mesh_tp*.py``): gloo ranks of the port and the reference's
``param_specs``-placed mesh run, each a subprocess on the CPU.

* :data:`RANK_CODE` is one rank of a ``ProcessMesh``: it runs the job's
  tasks (``layout``, ``serve``, ``serve_cache``, ``traffic``, ``adamw``,
  ``adafactor``, ``gather_once``, ``forced``, ``restart``, ``grad64``,
  ``encdec``, ``collectives``; a task is ``kind:arch``, or ``kind:name``
  of a case in the job) and writes its record to ``{out}_{rank}.json``.
  An arch is a decoder-only one or the encoder-decoder (whisper-tiny,
  built as an ``EncDecLM``; its batches carry :func:`stub_inputs`'
  ``frames``), and ``{arch}+v{vocab}`` or ``{arch}+h{heads}`` is its
  smoke config with that vocab or those heads (:func:`smoke`).
  ``traffic`` runs one cell of ``launch.dryrun`` (a prefill, a decode
  step or a train step) on the mesh inside ``collectives.tally`` and
  records the tally.
* :data:`REF_CODE` runs the reference's ``jax.jit(make_train_step)`` on
  4 forced host devices with its parameters and state placed by
  ``param_specs``, for each of the job's runs; a run with ``dump`` writes
  its state before each step and that step's gradient (before the clip)
  there, from which ``forced`` takes one step of the port each.
* ``grad64`` is the gradient of the cross-entropy of batch 0 (the MoE
  load-balance term left out: a mesh counts it per token slice) on the
  mesh, reduced as the train step reduces it, against one process's of
  the same parameters, both in fp64: the rank widens the model code's
  fp32 casts (``Tensor.float``) to fp64 for the task, so that a
  cotangent summed zero times or twice shows as an error of order one
  against rounding of order 1e-15.  Each leaf's block error, and the
  global norm (``loop._mesh_norm``, which squares in fp32) against one
  process's.
"""

import dataclasses
import inspect
import json
import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from repro_torch.models import transformer

SRC = str(Path(__file__).resolve().parents[1] / "src")
SEQ, BATCH, SEED, LR = 16, 4, 5, 2e-3
STEPS, AF_STEPS, RESTART = 3, 2, 2
MESH, RESTART_MESH, AXES = (2, 2), (1, 2), ("data", "model")
RTOL = 1e-5
#: gather_once differentiates through a bf16 copy, so every gradient is
#: rounded to bf16 (the copy's cotangent) and its microbatches' parts
#: added in bf16: the batch blocks of a mesh group those sums otherwise
#: than one device or XLA does, a small gradient of cancelling parts
#: (a bias, a norm scale) moves by some 1e-3 of itself, and AdamW's
#: per-element step carries that into the next losses (the first loss is
#: held at RTOL; ``test_torch_mesh_train``'s band for the same case)
BF16_GRAD_RTOL = 1e-3
#: the gradient norms after the first step, in fp32: AdamW's per-element
#: step carries a gradient's last-bit roundings into the parameters and
#: the next norms amplify them.  ``scripts/mesh_rounding_probe.py``: a
#: 1e-7 relative perturbation of the initial parameters moves one
#: process's third norm by up to 1.7e-4 for rwkv6-3b and 2.3e-5 for
#: jamba, and the reference's own mesh and one-device third norms part
#: by 1.8e-5 for rwkv6-3b; so those norms are held to this band, and the
#: losses, which move by 3e-6, to RTOL
NORM_CHAOS_RTOL = 1e-3
#: ``gather_once``'s gradient norms after its first step, three steps
#: run on from the same parameters.  From each of the reference's states
#: (``forced``) the port's step agrees with the reference's to rounding:
#: the loss within 1.5e-7, the norm within 2.6e-5, each leaf's bf16
#: gradient within 5.2e-3 relative L2 (1.3 bf16 ulps).  Run on, they part
#: (third loss 8.3e-4, third norm 2.5 %), because a gradient element whose
#: microbatch parts cancel is a residue of rounding (up to 6e-5 against
#: leaves of 0.05-0.9), 0 in one package and one ulp of the parts in the
#: other: some 350 of jamba's 779 328 a step (``forced``'s ``flips``),
#: and AdamW (eps 1e-8) gives each a whole step of lr, or none.  The
#: reference itself, with about 350 of its zero gradient elements a step
#: made residues of 1e-6 (``scripts/mesh_rounding_probe.py flips``, six
#: seeds), spreads its third norm by -3.4 % to +2.3 % and its second loss
#: by 2.6e-3
BF16_CHAOS_RTOL = 5e-2
#: a leaf's ``gather_once`` gradient against the reference's from the
#: same state (``forced``), as relative L2: two bf16 ulps (2**-7)
BF16_LEAF_RTOL = 2.0 ** -7
#: a MoE mesh run against one process (``test_torch_mesh_train``'s
#: bands): a mesh counts capacity and the load-balance loss per token
#: slice, the reference's semantics (ROADMAP Queue 3), so the two part
#: by some 1e-3: the first step, and all
MOE_SINGLE_FIRST_RTOL, MOE_SINGLE_RTOL = 1e-2, 3e-2
#: the MoE capacity factor of the logits' comparison with one process: a
#: mesh counts capacity per token slice, one process per chunk (the
#: reference's semantics, ROADMAP Queue 3), and the two agree where
#: nothing drops
DROPLESS_CF = 16.0
#: a leaf's fp64 gradient block against one process's (relative to the
#: largest magnitude of the leaf's whole gradient)
GRAD64_RTOL = 1e-10
#: the global gradient norm: ``_mesh_norm`` squares in fp32
NORM_RTOL = 1e-6



def smoke(configs, name: str):
    """``configs.get_smoke`` of the arch ``name`` (the port's or the
    reference's ``configs``), its vocab replaced where ``name`` holds
    ``+v{vocab}`` (whisper-tiny's odd-vocab variant, whose table ``model``
    cannot cut, as the published 51 865) and its heads where it holds
    ``+h{heads}`` (as many query and kv heads, each of the smoke config's
    width: whisper-tiny's 6 heads, which a 4-wide ``model`` cuts inside a
    head, as the published config's; RWKV-6's heads are ``d_model /
    head_dim``, so ``rwkv6-3b+h6`` is 6 heads of 16 at ``d_model`` 96,
    which a 4-wide ``model`` cuts inside a head, as a 16-wide one cuts the
    published 40)."""
    arch, *mods = name.split("+")
    cfg = configs.get_smoke(arch)
    for mod in mods:
        n = int(mod[1:])
        if mod[0] == "v":
            cfg = dataclasses.replace(cfg, vocab_size=n)
        elif cfg.rwkv is not None:
            cfg = dataclasses.replace(cfg, n_heads=n, n_kv_heads=n,
                                      d_model=n * cfg.rwkv.head_dim)
        else:
            cfg = dataclasses.replace(cfg, n_heads=n, n_kv_heads=n,
                                      head_dim=cfg.resolved_head_dim)
    return cfg


def stub_inputs(cfg, batch: int, seed) -> dict:
    """The encoder-decoder's stub input of a batch: ``frames`` (batch,
    encoder_seq, d) fp32 from numpy's generator ``seed`` (the same in
    both packages), ``N(0, 0.02^2)`` as the launcher draws them; ``{}``
    for a decoder-only arch."""
    if cfg.family != "audio":
        return {}
    g = np.random.default_rng(seed)
    return {"frames": (0.02 * g.standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model))).astype(np.float32)}


#: the functions both RANK_CODE and REF_CODE read configs and stub
#: inputs with
SHARED_CODE = ("import dataclasses\nimport numpy as np\n"
               + inspect.getsource(smoke) + inspect.getsource(stub_inputs))

RANK_CODE = SHARED_CODE + textwrap.dedent("""
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
    from repro_torch.models import encdec, transformer
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

    def module(cfg, dtype=torch.float32):
        # the arch's model built on the mesh, uninitialised
        ctor = (encdec.EncDecLM if cfg.family == "audio"
                else transformer.DecoderLM)
        return ctor(cfg, device="cpu", dtype=dtype, mesh=mesh)

    def batch_at(cfg, pipe, i, mb=1):
        # this process's rows of batch i: tokens, and frames
        b = {"tokens": pipe.batch(i)["tokens"],
             **stub_inputs(cfg, job["batch"], [job["seed"], i])}
        return {k: batch_block(torch.from_numpy(v), mesh, mb)
                for k, v in b.items()}

    def reshard(params, tree):
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(tree[name])

    def train(arch, opt_name, steps, mb, gather_once, save=None):
        cfg = smoke(configs, arch)
        n_exp = cfg.moe.n_experts if cfg.moe else 0
        params = module(cfg)
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
                batch = batch_at(cfg, pipe, i, mb)
                params, opt, met = step(params, opt, batch, i)
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
        if save:
            state = convert.mesh_global((loop.param_tree(params), opt),
                                        mesh, n_exp, 0)
            if rank == 0:
                CheckpointManager(save).save(start + steps, state,
                                             metadata={"step": start + steps})
        rec = {"losses": losses, "grad_norms": gnorms}
        if opt_name == "adafactor":
            # the mesh's layout of (params, state), a checkpoint's, by path
            specs = {}
            rules.tree_map_with_path(
                lambda path, sp: specs.__setitem__(path, repr(sp)),
                rules.local_specs(mesh, (loop.param_tree(params), opt),
                                  n_exp))
            rec["state_specs"] = specs
        return rec

    def ref_tree(path, cfg, tag=None):
        # a reference's tree dumped by REF_CODE (``tag``: its p/m/v part)
        # by the port's parameter names, global
        flat = dict(np.load(path))
        if tag:
            flat = {k[2:]: v for k, v in flat.items()
                    if k.startswith(tag + "/")}
        tree = {}
        for key, arr in flat.items():
            node, parts = tree, key.split("/")
            for p_ in parts[:-1]:
                node = node.setdefault(p_, {})
            node[parts[-1]] = arr
        if "period" in tree:
            tree["period"] = [tree["period"][str(j)]
                              for j in range(len(tree["period"]))]
        return convert.lm_params_from_numpy(tree, cfg, device="cpu",
                                            dtype=torch.float32)

    def forced(arch):
        # one gather_once step from each state of the reference's run
        # (REF_CODE's dump): the loss and norm of each, and on rank 0 each
        # leaf's gradient (after the data reduction) against the
        # reference's: its relative L2 error, the worst leaf, and the
        # elements whose sign (or zero) differs
        cfg = configs.get_smoke(arch)
        n_exp = cfg.moe.n_experts if cfg.moe else 0
        params = transformer.DecoderLM(cfg, device="cpu",
                                       dtype=torch.float32, mesh=mesh)
        named = dict(params.named_parameters())
        tcfg = TrainConfig(optimizer="adamw", lr=job["lr"], gather_once=True)
        got = {}

        def keep(grads):
            got.clear()
            for name, g in grads.items():
                got[name] = g.clone()
                got[name].spec = named[name].spec
                got[name].global_shape = named[name].global_shape
            return grads

        step = loop.make_train_step(build_model(cfg), tcfg, microbatches=2,
                                    grad_transform=keep)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                             global_batch=job["batch"], seed=job["seed"])
        res = {"losses": [], "grad_norms": [], "leaf_err": [], "worst": [],
               "flips": []}
        for i in range(job["steps"]):
            state = f"{job['forced']}/state_{i}.npz"
            reshard(params, convert.mesh_local(ref_tree(state, cfg, "p"),
                                               mesh, n_exp))
            opt = {tag: convert.mesh_local(ref_tree(state, cfg, tag), mesh,
                                           n_exp) for tag in ("m", "v")}
            with rules.use_mesh(mesh):
                batch = {"tokens": batch_block(
                    torch.from_numpy(pipe.batch(i)["tokens"]), mesh, 2)}
                params, opt, met = step(params, opt, batch, i)
            res["losses"].append(float(met["loss"]))
            res["grad_norms"].append(float(met["grad_norm"]))
            whole = convert.mesh_global(got, mesh, n_exp, 0)
            if rank == 0:
                want = ref_tree(f"{job['forced']}/grad_{i}.npz", cfg)
                err = {k: float((whole[k] - w).norm()
                                / w.norm().clamp_min(1e-30))
                       for k, w in want.items()}
                worst = max(err, key=err.get)
                res["leaf_err"].append(err[worst])
                res["worst"].append(worst)
                res["flips"].append(sum(int((torch.sign(whole[k])
                                             != torch.sign(w)).sum())
                                        for k, w in want.items()))
        return res

    def serve(arch):
        cfg = dropless(smoke(configs, arch))
        m = build_model(cfg)
        params = m.init(0, device="cpu", mesh=mesh)
        toks = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (job["batch"], 13)))
        mine = {k: batch_block(torch.as_tensor(v), mesh) for k, v in dict(
            tokens=toks[:, :12], **stub_inputs(cfg, job["batch"],
                                               12)).items()}
        b = mine["tokens"].shape[0]
        with rules.use_mesh(mesh):
            cache = m.init_cache(b, 16, torch.float32, device="cpu")
            pre, cache = m.prefill(params, mine, cache)
            dec, cache = m.decode(params, cache,
                                  batch_block(toks[:, 12], mesh),
                                  torch.full((b,), 12))
        layers = cache.get("layers") or cache["self"] + cache["cross_kv"]
        kv = [c["k"].shape[2] for c in layers if "k" in c]
        return {"prefill": t(pre[:, 0]), "decode": t(dec),
                "cache_kv_heads": kv[0] if kv else None,
                "cache_shapes": [{k: list(v.shape) for k, v in c.items()}
                                 for c in layers]}

    def cache_leaves(cache):
        # path -> leaf: layers/{i}/{k}, or self/{i}/{k} and cross_kv/{i}/{k}
        return {f"{part}/{i}/{k}": x for part, lst in cache.items()
                for i, c in enumerate(lst) for k, x in c.items()}

    def serve_cache(name):
        # a serve case of job["cache_cases"] from the reference's initial
        # parameters (job["init"]): a prefill of S prompt tokens (and the
        # encoder-decoder's frames) into a cache of T rows and a decode
        # step at each of "pos"; the logits, and the cache's blocks after
        # the prefill and after each step
        case = job["cache_cases"][name]
        cfg = dropless(smoke(configs, case["arch"]))
        n_exp = cfg.moe.n_experts if cfg.moe else 0
        m = build_model(cfg)
        bsz, t_max, s = case["batch"], case["T"], case["S"]
        toks = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (bsz, s + len(case["pos"]))))
        rep = bsz == 1              # global batch 1: every process, the row
        whole = dict(tokens=toks, **{k: torch.from_numpy(v) for k, v in
                                     stub_inputs(cfg, bsz, 13).items()})
        mine = whole if rep else {k: batch_block(v, mesh)
                                  for k, v in whole.items()}
        prompt = dict(mine, tokens=mine["tokens"][:, :s])
        b = mine["tokens"].shape[0]
        off_mesh = m.init_cache(b, t_max, torch.float32, device="cpu")
        with rules.use_mesh(mesh, replicated_batch=rep):
            if case.get("raises"):
                try:
                    m.init_cache(b, t_max, torch.float32, device="cpu")
                except ValueError as e:
                    return {"raised": str(e)}
                return {"raised": None}
            params = module(cfg)
            reshard(params, convert.mesh_local(
                torch.load(job["init"][case["arch"]]), mesh, n_exp))
            bf16 = m.init_cache(b, t_max, device="cpu")
            rec = {"cache_bytes_bf16": sum(
                x.numel() * x.element_size()
                for x in cache_leaves(bf16).values())}
            del bf16
            if case.get("refuse"):      # a cache built off the mesh
                try:
                    m.prefill(params, prompt, off_mesh)
                    rec["refused"] = None
                except ValueError as e:
                    rec["refused"] = str(e)
            cache = m.init_cache(b, t_max, torch.float32, device="cpu")
            rec["specs"] = {path: repr(x.spec)
                            for path, x in cache_leaves(cache).items()}
            arrays = {}

            def dump(step):
                for path, x in cache_leaves(cache).items():
                    arrays[f"{step}/{path}"] = x.numpy().copy()
            pre, cache = m.prefill(params, prompt, cache)
            rec["logits"] = [t(pre[:, 0])]
            dump(0)
            for i, p_ in enumerate(case["pos"]):
                lg, cache = m.decode(params, cache, mine["tokens"][:, s + i],
                                     torch.full((b,), p_))
                rec["logits"].append(t(lg))
                dump(i + 1)
        np.savez(f"{job['out']}_{rank}_{name}.npz", **arrays)
        return rec

    def traffic(name):
        # a cell of job["traffic_cases"] (launch.dryrun's: arch, kind,
        # seq, batch, microbatches, gather_once) run once on the mesh
        # from seeded parameters and tokens, its collectives tallied
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        case = job["traffic_cases"][name]
        cfg = smoke(configs, case["arch"])
        m = build_model(cfg)
        shape = ShapeConfig(name, case["kind"], case["seq"], case["batch"],
                            case.get("microbatches", 1))
        rep = not dryrun._batch_divides(shape, mesh)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=case["seq"],
                             global_batch=case["batch"], seed=job["seed"])
        with rules.use_mesh(mesh, replicated_batch=rep):
            if case["kind"] == "train":
                tcfg = dataclasses.replace(
                    dryrun.train_config_for(cfg),
                    gather_once=case.get("gather_once", False))
                mb = dryrun._microbatches(shape, mesh)
                params = m.init(0, device="cpu", mesh=mesh,
                                dtype=opt_mod.torch_dtype(tcfg.param_dtype))
                opt = opt_mod.init_opt_state(tcfg, params)
                step = loop.make_train_step(m, tcfg, microbatches=mb)
                batch = {k: batch_block(torch.from_numpy(v), mesh, mb)
                         for k, v in dict(
                             tokens=pipe.batch(0)["tokens"],
                             **stub_inputs(cfg, case["batch"], 3)).items()}
                with coll.tally() as tl:
                    step(params, opt, batch, 0)
                return tl.record()
            params = m.init(0, device="cpu", mesh=mesh)
            whole = {"tokens": pipe.batch(0)["tokens"][:, :case["seq"]],
                     **stub_inputs(cfg, case["batch"], 3)}
            mine = {k: (torch.from_numpy(v) if rep else batch_block(
                torch.from_numpy(v), mesh)) for k, v in whole.items()}
            b = mine["tokens"].shape[0]
            cache = m.init_cache(b, case["seq"], device="cpu")
            with coll.tally() as tl:
                m.prefill(params, mine, cache)
            if case["kind"] == "prefill":
                return tl.record()
            with coll.tally() as tl:
                m.decode(params, cache, mine["tokens"][:, -1],
                         torch.full((b,), case["seq"] - 1))
            return tl.record()

    def layout(arch):
        params = module(smoke(configs, arch))
        return {n: [list(p.shape), list(p.global_shape), repr(p.spec)]
                for n, p in params.named_parameters()}

    class CE:
        # Model.loss less the MoE load-balance term (the encoder-decoder
        # has none: its Model.loss)
        def __init__(self, cfg):
            self.cfg = cfg

        def loss(self, params, batch):
            if self.cfg.family == "audio":
                return build_model(self.cfg).loss(params, batch)
            tok = batch["tokens"]
            logits, _ = transformer.train_forward(params, self.cfg,
                                                  tok[:, :-1])
            return cross_entropy(logits, tok[:, 1:], mesh=transformer.
                                 vocab_mesh(params)), {}

    def grad64(arch):
        # the model code's fp32 widenings in fp64, for this task alone
        widen, torch.Tensor.float = torch.Tensor.float, torch.Tensor.double
        try:
            cfg = dataclasses.replace(dropless(smoke(configs, arch)),
                                      dtype="float64")
            n_exp = cfg.moe.n_experts if cfg.moe else 0
            pipe = TokenPipeline(vocab_size=cfg.vocab_size,
                                 seq_len=job["seq"],
                                 global_batch=job["batch"],
                                 seed=job["seed"])
            whole = {"tokens": pipe.batch(0)["tokens"],
                     **stub_inputs(cfg, job["batch"], [job["seed"], 0])}
            whole = {k: torch.from_numpy(v) for k, v in whole.items()}
            model = CE(cfg)
            m = build_model(cfg)
            one = m.init(0, device="cpu", dtype=torch.float64)
            mine = m.init(0, device="cpu", dtype=torch.float64, mesh=mesh)
            for p in (*one.parameters(), *mine.parameters()):
                p.data = p.data.double()
            _, _, want = loop._value_and_grad(model, one, whole)
            specs = {n: rules.spec_of(p)
                     for n, p in mine.named_parameters()}
            with rules.use_mesh(mesh):
                loss, met, got = loop._value_and_grad(
                    model, mine, {k: batch_block(v, mesh)
                                  for k, v in whole.items()})
                _, _, got = loop._reduce_over_mesh(
                    mesh, loop._expert_axes(model, mesh), specs, loss, met,
                    got)
                norm = float(loop._mesh_norm(mesh, got, specs))
            err = {}
            for name, g in got.items():
                w = want[name]
                if name.split(".")[-1] in ("wi_gate", "wi_up", "wo") \\
                        and ".moe." in name:
                    blk = w.shape[0] // mesh.axis_size(
                        rules.expert_axes_for(mesh, n_exp))
                    i = mesh.axis_index(rules.expert_axes_for(mesh, n_exp))
                    w_blk = w[i * blk:(i + 1) * blk]
                else:
                    w_blk = rules.NamedSharding(mesh, specs[name]).shard(w)
                err[name] = float((g - w_blk).abs().max()
                                  / w.abs().max().clamp_min(1e-300))
            return {"err": err, "norm": norm,
                    "norm_one": float(opt_mod.global_norm(want))}
        finally:
            torch.Tensor.float = widen

    for task in job["tasks"]:
        kind, arch = (task.split(":") + [None])[:2]
        if kind == "collectives":
            out[task] = collectives()
        elif kind == "serve":
            out[task] = serve(arch)
        elif kind == "serve_cache":
            out[task] = serve_cache(arch)
        elif kind == "traffic":
            out[task] = traffic(arch)
        elif kind == "layout":
            out[task] = layout(arch)
        elif kind == "grad64":
            out[task] = grad64(arch)
        elif kind == "encdec":
            # the encoder-decoder's layout on this process mesh
            from repro_torch.models.encdec import EncDecLM
            enc = EncDecLM(configs.get_smoke(arch), device="meta",
                           dtype=torch.float32)
            out[task] = {n: repr(sp) for n, sp in rules.local_specs(
                mesh, dict(enc.named_parameters()), 0).items()}
        elif kind == "adamw":
            out[task] = train(arch, "adamw", job["steps"], 1, False,
                              save=job["save"].get(arch))
        elif kind == "adafactor":
            out[task] = train(arch, "adafactor", job["af_steps"], 1, False)
        elif kind == "gather_once":
            out[task] = train(arch, "adamw", job["steps"], 2, True)
        elif kind == "forced":
            out[task] = forced(arch)
        elif kind == "restart":
            out[task] = train(arch, "adamw", job["restart"], 1, False)
    with open(f"{job['out']}_{rank}.json", "w") as f:
        json.dump(out, f)
    tdist.barrier()
    tdist.destroy_process_group()
""")

REF_CODE = SHARED_CODE + textwrap.dedent("""
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
    cfg = smoke(configs, job["arch"])
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

    def flat(tree, prefix):
        out = {}
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                  for k in path)] = np.asarray(x, np.float32)
        return out

    def with_grads(tcfg, mb):
        # the train step, its gradients (before the clip) in the metrics
        def step(params, opt, batch, i):
            got = {}

            def keep(grads):
                got["grads"] = grads
                return grads
            params, opt, met = make_train_step(
                m, tcfg, microbatches=mb, grad_transform=keep)(
                    params, opt, batch, i)
            return params, opt, dict(met, grads=got["grads"])
        return step

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
            step = jax.jit(with_grads(tcfg, run["mb"]))
            losses, gnorms = [], []
            for i in range(run["start"], run["start"] + run["steps"]):
                batch = {k: jnp.asarray(v) for k, v in dict(
                    tokens=pipe.batch(i)["tokens"], **stub_inputs(
                        cfg, job["batch"], [job["seed"], i])).items()}
                if run.get("dump"):
                    np.savez(f"{run['dump']}/state_{i}.npz",
                             **flat(params, "p/"), **flat(opt["m"], "m/"),
                             **flat(opt["v"], "v/"))
                params, opt, met = step(params, opt, batch, jnp.asarray(i))
                if run.get("dump"):
                    np.savez(f"{run['dump']}/grad_{i}.npz",
                             **flat(met["grads"], ""))
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
            rec.update(losses=losses, grad_norms=gnorms,
                       sharded_after=sharded(params))
        out[run["name"]] = rec

    def serve(name, case):
        # a serve case on its mesh: parameters placed by param_specs, the
        # cache by cache_specs (seq_shard at global batch 1), jax.jit's
        # prefill (with the encoder-decoder's frames, stub_inputs seed 13)
        # and decode with the cache specs as out_shardings; the logits,
        # and the whole cache after each call in {name}_{i}.npz
        c = smoke(configs, case["arch"])
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=job["dropless_cf"]))
        mdl = build_model(c)
        n = int(np.prod(case["dims"]))
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(case["dims"]),
            tuple(job["axes"]))
        bsz, t_max, s = case["batch"], case["T"], case["S"]
        toks = np.random.default_rng(11).integers(
            0, c.vocab_size, (bsz, s + len(case["pos"])))
        frames = {k: jnp.asarray(v)
                  for k, v in stub_inputs(c, bsz, 13).items()}
        with rules.use_mesh(mesh):
            cache = mdl.init_cache(bsz, t_max, dtype=jnp.float32)
            try:
                csh = rules.cache_specs(mesh, jax.eval_shape(lambda: cache),
                                        seq_shard=bsz == 1)
            except Exception as e:
                return {"raised": f"{type(e).__name__}: {e}"}
            cache = jax.device_put(cache, csh)
            params = mdl.init(jax.random.key(0))
            params = jax.tree.map(jax.device_put, params, rules.param_specs(
                mesh, jax.eval_shape(lambda: params)))
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())

        def pre(params, batch, cache):
            with rules.use_mesh(mesh):
                return mdl.prefill(params, batch, cache)

        def dec(params, cache, token, pos):
            with rules.use_mesh(mesh):
                return mdl.decode(params, cache, token, pos)
        pre = jax.jit(pre, out_shardings=(rep, csh))
        dec = jax.jit(dec, out_shardings=(rep, csh))
        specs = {}
        for path, sh in jax.tree_util.tree_flatten_with_path(csh)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            specs[key] = [list(e) if isinstance(e, tuple) else e
                          for e in sh.spec]
        lg, cache = pre(params, {"tokens": jnp.asarray(toks[:, :s]),
                                 **frames}, cache)
        logits = [np.asarray(lg[:, 0]).tolist()]
        np.savez(f"{job['out']}_{name}_0.npz", **flat(cache, ""))
        for i, p_ in enumerate(case["pos"]):
            lg, cache = dec(params, cache, jnp.asarray(toks[:, s + i]),
                            jnp.full((bsz,), p_, jnp.int32))
            logits.append(np.asarray(lg).tolist())
            np.savez(f"{job['out']}_{name}_{i + 1}.npz", **flat(cache, ""))
        return {"raised": None, "logits": logits, "specs": specs}

    for name, case in job.get("serve", {}).items():
        out[name] = serve(name, case)
    with open(job["out"], "w") as f:
        json.dump(out, f)
""")

#: the reference's runs from its own initial parameters on MESH
REF_RUNS = {
    "adamw": dict(name="adamw", opt="adamw", gather_once=False, mb=1,
                  steps=STEPS),
    "adafactor": dict(name="adafactor", opt="adafactor", gather_once=False,
                      mb=1, steps=AF_STEPS),
    "gather_once": dict(name="gather_once", opt="adamw", gather_once=True,
                        mb=2, steps=STEPS)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def base_job(init, save, **kw) -> dict:
    """The fields every rank job shares."""
    return dict(seq=SEQ, batch=BATCH, seed=SEED, lr=LR, steps=STEPS,
                dropless_cf=DROPLESS_CF, af_steps=AF_STEPS, restart=RESTART,
                init=init, save=save, **kw)


def ranks(job, dims):
    """The ranks of a ``dims`` mesh, started on ``job``."""
    world = int(np.prod(dims))
    addr = f"127.0.0.1:{_free_port()}"
    job = dict(job, dims=list(dims), axes=list(AXES))
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, json.dumps(job), str(r),
         str(world), addr], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def reference(arch, runs, out, serve=None):
    """The reference's ``runs`` of ``arch``, their records to ``out``;
    and its ``serve`` cases (name -> case: ``arch``, ``dims``, ``batch``,
    cache rows ``T``, prompt length ``S``, decode positions ``pos``), each
    case's cache after each call beside ``out``."""
    job = dict(arch=arch, seq=SEQ, batch=BATCH, seed=SEED, lr=LR, runs=runs,
               out=str(out), serve=serve or {}, axes=list(AXES),
               dropless_cf=DROPLESS_CF)
    return subprocess.Popen([sys.executable, "-c", REF_CODE,
                             json.dumps(job)], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def mesh_runs(names, dims=MESH, start=0):
    """The reference's runs of ``names`` on a ``dims`` mesh."""
    return [dict(REF_RUNS[n], dims=list(dims), axes=list(AXES), start=start)
            for n in names]


def wait(procs, timeout=300):
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]


def load(prefix, world):
    return [json.loads(Path(f"{prefix}_{r}.json").read_text())
            for r in range(world)]


def ref_tree_flat(sd: dict, cfg) -> dict:
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


def ref_leaves_cut(cfg, specs: dict) -> int:
    """How many leaves of the reference's tree (its prefix layers, its
    period slots stacked over the periods, the rest; the
    encoder-decoder's ``encoder`` and ``decoder`` stacked over their
    layers, the rest) the port's ``specs`` (by parameter name) cut."""
    leaves = {}
    if cfg.family == "audio":
        for name, spec in specs.items():
            leaves[re.sub(r"^(encoder|decoder)\.\d+\.", r"\1.", name)] = \
                len(spec) > 0
        return sum(leaves.values())
    prefix, period, _ = transformer.period_structure(cfg)
    for name, spec in specs.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            i = int(i)
            name = (f"prefix.{i}.{leaf}" if i < len(prefix) else
                    f"period.{(i - len(prefix)) % len(period)}.{leaf}")
        leaves[name] = len(spec) > 0
    return sum(leaves.values())


def single_restart(arch: str, ckpt: str) -> dict:
    """One process of the port resumed from a mesh's checkpoint (global
    leaves) for RESTART AdamW steps: ``{"losses", "grad_norms"}``."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.model import build_model
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt_mod
    cfg = smoke(configs, arch)
    ctor = EncDecLM if cfg.family == "audio" else transformer.DecoderLM
    params = ctor(cfg, device="cpu", dtype=torch.float32)
    tcfg = TrainConfig(optimizer="adamw", lr=LR)
    target = (dict(params.named_parameters()),
              opt_mod.init_opt_state(tcfg, params))
    (tree, opt), meta = CheckpointManager(ckpt).restore(target)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(tree[name])
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=BATCH, seed=SEED)
    step = loop.make_train_step(build_model(cfg), tcfg)
    out = {"losses": [], "grad_norms": [], "start": meta["step"]}
    for i in range(meta["step"], meta["step"] + RESTART):
        batch = dict(tokens=pipe.batch(i)["tokens"],
                     **stub_inputs(cfg, BATCH, [SEED, i]))
        params, opt, met = step(params, opt, {
            k: torch.from_numpy(v) for k, v in batch.items()}, i)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
    return out


def check_restart(ranks_, want: dict, task: str, moe: bool) -> None:
    """A (1, 2) restart against one process resumed from the same
    checkpoint: both ranks the same; the losses within RTOL, the first
    norm too and the second within NORM_CHAOS_RTOL (``moe``: the first
    loss and norm within MOE_SINGLE_FIRST_RTOL, all within
    MOE_SINGLE_RTOL)."""
    got = ranks_[0][task]
    assert ranks_[1][task] == got
    assert want["start"] == STEPS
    first, rest = ((MOE_SINGLE_FIRST_RTOL, MOE_SINGLE_RTOL) if moe
                   else (RTOL, NORM_CHAOS_RTOL))
    for key in ("losses", "grad_norms"):
        assert rel(got[key][:1], want[key][:1]) <= first, (got, want)
    assert rel(got["losses"], want["losses"]) <= (
        MOE_SINGLE_RTOL if moe else RTOL), (got, want)
    assert rel(got["grad_norms"], want["grad_norms"]) <= rest, (got, want)


def check_training(ranks_, ref: dict, task: str, bf16: bool) -> None:
    """A mesh run's losses and gradient norms (every rank the same)
    against the reference's run: the first loss at RTOL, the first norm
    at RTOL (``bf16``: BF16_GRAD_RTOL), the later steps at RTOL for the
    losses (``bf16``: BF16_GRAD_RTOL) and NORM_CHAOS_RTOL for the norms
    (``bf16``: BF16_CHAOS_RTOL)."""
    got = ranks_[0][task]
    for r in ranks_[1:]:
        assert r[task] == got
    assert len(got["losses"]) == len(ref["losses"])
    assert all(np.isfinite(got["losses"]))
    first = BF16_GRAD_RTOL if bf16 else RTOL
    assert rel(got["losses"][:1], ref["losses"][:1]) <= RTOL, (got, ref)
    assert rel(got["grad_norms"][:1], ref["grad_norms"][:1]) <= first, \
        (got, ref)
    assert rel(got["losses"], ref["losses"]) <= first, (got, ref)
    assert rel(got["grad_norms"], ref["grad_norms"]) <= (
        BF16_CHAOS_RTOL if bf16 else NORM_CHAOS_RTOL), (got, ref)


def check_forced(ranks_, ref: dict, task: str) -> None:
    """``forced``: each ``gather_once`` step from the reference's state
    (every rank the same) against the reference's step: the loss within
    RTOL, the gradient norm within BF16_GRAD_RTOL, and every leaf's
    gradient within BF16_LEAF_RTOL."""
    got = ranks_[0][task]
    for r in ranks_[1:]:
        assert (r[task]["losses"], r[task]["grad_norms"]) == (
            got["losses"], got["grad_norms"])
    assert len(got["losses"]) == len(ref["losses"]) == len(got["leaf_err"])
    for i in range(len(ref["losses"])):
        assert rel(got["losses"][i], ref["losses"][i]) <= RTOL, (i, got, ref)
        assert rel(got["grad_norms"][i], ref["grad_norms"][i]) <= \
            BF16_GRAD_RTOL, (i, got, ref)
        assert got["leaf_err"][i] <= BF16_LEAF_RTOL, (i, got["worst"][i],
                                                      got["leaf_err"][i])


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
