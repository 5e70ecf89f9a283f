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
  mesh, against one process, its cache every kv head on a block of the
  sequence (``cache_specs``; ``test_torch_mesh_cache.py`` holds those
  blocks to the reference's);
* rwkv6-3b and deepseek-v3 hold their ``param_specs`` blocks too (their
  mesh runs: ``test_torch_mesh_tp_ssm.py``, ``test_torch_mesh_tp_mla.py``),
  and so does the encoder-decoder (``test_torch_mesh_tp_encdec.py``).

The ranks and the reference's run are ``tests/_mesh_tp_harness.py``.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _mesh_tp_harness import (AF_STEPS, AXES, BATCH, BF16_GRAD_RTOL,
                              DROPLESS_CF, LR, MESH, RESTART, RESTART_MESH,
                              RTOL, SEED, SEQ, STEPS)
from _mesh_tp_harness import load as _load
from _mesh_tp_harness import ranks as _ranks
from _mesh_tp_harness import ref_tree_flat as _ref_tree_flat
from _mesh_tp_harness import reference as _reference
from _mesh_tp_harness import rel as _rel
from _mesh_tp_harness import wait as _wait
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

ARCHS = ("qwen2.5-3b", "qwen3-moe-30b-a3b")
#: the collectives' fp64 gradients against one process's
F64_RTOL = 1e-12
#: ``cross_entropy`` computes in fp32 (as the reference's): its vocab
#: blocks' sums part from one process's by fp32 roundings
CE_RTOL = 1e-6


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
    """RWKV-6 and MLA (with MoE) hold every leaf as its ``param_specs``
    block on a process mesh, as the GQA archs do (``rules.shards_dense``
    is true for every set of mixers, the encoder-decoder's too)."""
    cfg = configs.get_smoke(arch)
    meta = transformer.DecoderLM(cfg, device="meta", dtype=torch.float32)
    mesh = make_test_mesh(MESH)
    want = rules.param_specs(mesh, dict(meta.named_parameters()))
    for rank in runs["m22"]:
        got = rank[f"layout:{arch}"]
        assert set(got) == set(want)
        for name, (shape, whole, spec) in got.items():
            assert tuple(shape) == rules.shard_shape(whole, want[name],
                                                     mesh), name
            assert spec == repr(want[name]), name
        assert sum(shape != whole for shape, whole, _ in got.values()) > \
            len(got) // 4
    for mixers in ({"attn"}, {"mla"}, {"mamba", "attn"}, {"rwkv"},
                   {"attn", "mla", "mamba", "rwkv"}, {"encdec"},
                   {"attn", "encdec"}):
        assert rules.shards_dense(mixers)


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
    of a batch block agree bit for bit; the cache holds its
    ``cache_specs`` block: the local kv heads where they divide
    ``model``, else every kv head and a block of the sequence.  (1, 4)
    cuts qwen2.5-3b's kv projections inside a head, and its cache's
    sequence."""
    pre, dec = _single_serve(arch)
    cfg = configs.get_smoke(arch)
    ranks = runs[mesh]
    rows = BATCH // (2 if mesh == "m22" else 1)
    blocks = rules.cache_blocks(
        make_test_mesh(MESH if mesh == "m22" else (1, 4)),
        transformer.init_cache(cfg, BATCH, 16, torch.float32,
                               device="meta"))["layers"]
    for r in ranks:
        got = r[f"serve:{arch}"]
        d = r["coords"]["data"]
        sl = slice(d * rows, (d + 1) * rows)
        assert _rel(got["prefill"], pre[sl]) <= RTOL
        assert _rel(got["decode"], dec[sl]) <= RTOL
        same = [q for q in ranks if q["coords"]["data"] == d]
        assert got["prefill"] == same[0][f"serve:{arch}"]["prefill"]
        n_model = 2 if mesh == "m22" else 4
        assert got["cache_shapes"] == [{k: list(b.shape) for k, b in
                                        blk.items()} for blk in blocks]
        if cfg.n_kv_heads % n_model == 0:
            assert got["cache_kv_heads"] == cfg.n_kv_heads // n_model
        else:               # every kv head, 16 / 4 rows of the sequence
            assert got["cache_kv_heads"] == cfg.n_kv_heads
            assert got["cache_shapes"][0]["k"][1] == 16 // n_model


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
