"""FSDP over ``data`` and tensor parallelism over ``model`` for the Mamba
(jamba) and RWKV-6 (rwkv6-3b) families on a process mesh, over gloo
ranks on the CPU, against the reference's ``param_specs``-placed mesh run
and the single-process port (harness: ``tests/_mesh_tp_harness.py``).

On the smoke configs (jamba: 7 Mamba layers, one GQA layer of 4 / 2
heads, MoE every other layer; rwkv6-3b: 2 layers of 4 heads):

* every leaf a rank holds is its ``param_specs`` block, and the
  reference's run places the same leaves sharded;
* prefill and decode logits within 1e-5 relative of one process's on
  (2, 2) and (1, 4) (where jamba's ``in_proj`` blocks regroup unevenly
  and its 2 kv heads are cut inside a head), the caches holding the
  local channels and heads;
* from the reference's ``m.init(key(0))`` parameters: three AdamW steps
  for both, and for jamba two Adafactor steps, ``gather_once`` with two
  microbatches and the elastic restart (2, 2) -> (1, 2), within 1e-5 of
  the reference's runs (``gather_once``: its first loss, then the
  losses within ``BF16_GRAD_RTOL``, the norms after the first within
  ``BF16_CHAOS_RTOL``; and one step from each of the reference's states
  within 1e-5, ``BF16_GRAD_RTOL`` and two bf16 ulps a leaf);
* the traps of the local view, each by the fp64 gradient against one
  process's: ``in_proj``'s regrouping and its backward, ``x_proj``'s
  replicated output summed over ``model`` once, RWKV-6's replicated
  leaves read on local heads (``gn_scale``, ``gn_bias``, ``bonus_u``, the
  decay path), and the clip norm counting a replicated leaf once.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from _mesh_tp_harness import (BATCH, DROPLESS_CF, GRAD64_RTOL, MESH,
                              NORM_CHAOS_RTOL, NORM_RTOL, RESTART,
                              RESTART_MESH, RTOL, STEPS, base_job,
                              check_forced, check_restart, check_training,
                              load,
                              mesh_runs, ranks,
                              ref_leaves_cut, ref_tree_flat, reference, rel,
                              single_restart, wait)
from repro import configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt_mod

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
ARCHS = (JAMBA, RWKV)
#: jamba's reference runs, each its own process (they compile apart)
JAMBA_RUNS = ("adamw", "adafactor", "gather_once")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_tp_ssm")
    init = {}
    save = {a: str(out / f"ckpt_{a}") for a in ARCHS}
    for arch in ARCHS:
        rm = ref_build_model(ref_configs.get_smoke(arch))
        sd = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, rm.init(jax.random.key(0))),
            configs.get_smoke(arch), device="cpu", dtype=torch.float32)
        init[arch] = str(out / f"init_{arch}.pt")
        torch.save(sd, init[arch])
    base = base_job(init, save)
    tasks = [f"{k}:{a}" for a in ARCHS
             for k in ("layout", "serve", "grad64", "adamw")] + [
        f"{k}:{JAMBA}" for k in ("adafactor", "gather_once")]
    procs = ranks(dict(base, tasks=tasks, out=str(out / "m22")), MESH)
    dump = out / "forced"
    dump.mkdir()
    refs = [reference(JAMBA, [dict(run, dump=str(dump))
                              if name == "gather_once" else run
                              for run in mesh_runs([name])],
                      out / f"ref_jamba_{name}.json")
            for name in JAMBA_RUNS]
    refs.append(reference(RWKV, mesh_runs(["adamw"]), out / "ref_rwkv.json"))
    # the forced steps (below) read the gather_once run's dump
    dumped = refs.pop(JAMBA_RUNS.index("gather_once"))
    wait(procs + [dumped])
    # once the step-3 checkpoint is written: the (1, 4) cases, its restart
    # onto (1, 2), and the reference's restart from it
    procs = ranks(dict(base, tasks=[f"serve:{JAMBA}", f"serve:{RWKV}",
                                    f"grad64:{JAMBA}"],
                       out=str(out / "m14")), (1, 4))
    procs += ranks(dict(base, tasks=[f"restart:{a}" for a in ARCHS],
                        ckpt=save, out=str(out / "m12")), RESTART_MESH)
    # one gather_once step from each of the reference's states
    procs += ranks(dict(base, tasks=[f"forced:{JAMBA}"], forced=str(dump),
                        out=str(out / "f22")), MESH)
    cfg = configs.get_smoke(JAMBA)
    params = transformer.DecoderLM(cfg, device="cpu", dtype=torch.float32)
    target = (dict(params.named_parameters()), opt_mod.init_opt_state(
        TrainConfig(optimizer="adamw"), params))
    (tree, opt), meta = CheckpointManager(save[JAMBA]).restore(target)
    assert meta["step"] == STEPS
    flat = {}
    for tag, sd in (("p", tree), ("m", opt["m"]), ("v", opt["v"])):
        flat.update({f"{tag}/{k}": v
                     for k, v in ref_tree_flat(sd, cfg).items()})
    np.savez(out / "state_jamba.npz", **flat)
    restart = reference(JAMBA, [dict(
        name="restart", opt="adamw", gather_once=False, mb=1, steps=RESTART,
        dims=list(RESTART_MESH), axes=["data", "model"], start=STEPS,
        state=str(out / "state_jamba.npz"))], out / "ref_restart.json")
    wait(procs + refs + [restart])
    res = {"m22": load(out / "m22", 4), "m14": load(out / "m14", 4),
           "m12": load(out / "m12", 2), "f22": load(out / "f22", 4),
           f"ref_{JAMBA}": {}}
    for name in JAMBA_RUNS:
        res[f"ref_{JAMBA}"].update(json.loads(
            (out / f"ref_jamba_{name}.json").read_text()))
    res[f"ref_{JAMBA}"].update(json.loads(
        (out / "ref_restart.json").read_text()))
    res[f"ref_{RWKV}"] = json.loads((out / "ref_rwkv.json").read_text())
    res["single_restart"] = {RWKV: single_restart(RWKV, save[RWKV])}
    return res


# --------------------------------------------------------------------------
# the layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_its_param_specs_block(runs, arch):
    """Each rank's leaf is ``shard_shape(global, param_specs)`` and
    carries that spec (Mamba: ``x_proj`` rows, ``conv_w`` columns,
    ``a_log`` rows over ``model``); the reference's run places as many
    leaves sharded as the port cuts."""
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
    cut = ref_leaves_cut(cfg, want)
    # (XLA may give a replicated leaf read on local heads, such as
    # rwkv's decay_base, a sharded output; the placed leaves are counted)
    ref = runs[f"ref_{arch}"]["adamw"]
    assert ref["sharded"] == cut > 0
    assert cut < ref["leaves"]
    if arch == JAMBA:
        assert want["layers.0.mamba.x_proj.w"] == rules.P("model")
        assert want["layers.0.mamba.conv_w"] == rules.P(None, "model")
        assert want["layers.0.mamba.a_log"] == rules.P("model")
        assert want["layers.0.mamba.in_proj.w"] == rules.P("data", "model")
    else:
        assert want["layers.0.rwkv.gn_scale"] == rules.P()
        assert want["layers.0.rwkv.wr.w"] == rules.P("data", "model")


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
    return pre[:, 0].numpy(), dec.numpy(), cache


@pytest.mark.parametrize("mesh", ("m22", "m14"))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_equal_one_process(runs, arch, mesh):
    """The mesh's prefill and decode logits within 1e-5 relative of one
    process's, the processes of a batch block bit for bit equal, each
    cache of the local channels (Mamba), heads (RWKV-6; GQA where its kv
    heads divide ``model``, else every kv head on a block of the
    sequence: ``cache_specs``) and whole shifts."""
    pre, dec, cache = _single_serve(arch)
    n_model = 2 if mesh == "m22" else 4
    rows = BATCH // (2 if mesh == "m22" else 1)
    ranks_ = runs[mesh]
    for r in ranks_:
        got = r[f"serve:{arch}"]
        d = r["coords"]["data"]
        sl = slice(d * rows, (d + 1) * rows)
        assert rel(got["prefill"], pre[sl]) <= RTOL
        assert rel(got["decode"], dec[sl]) <= RTOL
        same = [q for q in ranks_ if q["coords"]["data"] == d]
        assert got["prefill"] == same[0][f"serve:{arch}"]["prefill"]
        assert got["decode"] == same[0][f"serve:{arch}"]["decode"]
        for mine, whole in zip(got["cache_shapes"], cache["layers"]):
            for key, shape in mine.items():
                want = [rows] + list(whole[key].shape[1:])
                if key in ("h", "s"):           # channels / heads
                    want[1] //= n_model
                elif key == "conv":
                    want[2] //= n_model
                elif key in ("k", "v") and want[2] % n_model == 0:
                    want[2] //= n_model         # the kv heads read
                elif key in ("k", "v"):         # every head, its rows
                    want[1] //= n_model
                assert shape == want, (key, shape, want)


@pytest.mark.parametrize("kind,arch", (("adamw", JAMBA), ("adamw", RWKV),
                                       ("adafactor", JAMBA),
                                       ("gather_once", JAMBA)))
def test_mesh_training_equals_reference_sharded_mesh(runs, arch, kind):
    """The losses within 1e-5 relative of the reference's sharded run,
    the first clipped gradient norm too, the later ones within
    NORM_CHAOS_RTOL (``gather_once``: its first loss within 1e-5, the
    later losses and the first norm within BF16_GRAD_RTOL, the later
    norms within BF16_CHAOS_RTOL); every rank the same."""
    check_training(runs["m22"], runs[f"ref_{arch}"][kind], f"{kind}:{arch}",
                   kind == "gather_once")


def test_gather_once_step_from_reference_state(runs):
    """jamba's ``gather_once`` step taken from each of the reference's
    three states (its parameters and AdamW moments, placed on the mesh):
    the loss within 1e-5 of the reference's step, the gradient norm
    within BF16_GRAD_RTOL, and every leaf's gradient after the data
    reduction within two bf16 ulps (relative L2) of the reference's, the
    new leaf kinds among them (1-d and ``conv_w`` cut over ``model``,
    ``a_log``'s rows, replicated leaves summed in the backward).  Run on
    from one state, rounding alone parts the two by more (the test
    above)."""
    check_forced(runs["f22"], runs[f"ref_{JAMBA}"]["gather_once"],
                 f"forced:{JAMBA}")


def test_elastic_restart_equals_reference_restart(runs):
    """jamba's step-3 checkpoint (global leaves, gathered from the (2, 2)
    blocks) restored onto (1, 2): within 1e-5 of the reference's restart
    from the same checkpoint, and below the first loss."""
    got = runs["m12"][0][f"restart:{JAMBA}"]
    assert runs["m12"][1][f"restart:{JAMBA}"] == got
    ref = runs[f"ref_{JAMBA}"]["restart"]
    assert rel(got["losses"], ref["losses"]) <= RTOL, (got, ref)
    assert rel(got["grad_norms"][:1], ref["grad_norms"][:1]) <= RTOL
    assert rel(got["grad_norms"], ref["grad_norms"]) <= NORM_CHAOS_RTOL
    assert max(got["losses"]) < runs["m22"][0][f"adamw:{JAMBA}"]["losses"][0]


def test_elastic_restart_continues_as_one_process(runs):
    """rwkv6-3b's step-3 checkpoint restored onto (1, 2) (its leaves cut
    for that mesh: ``convert.mesh_global``, then ``CheckpointManager.
    restore(shardings=)``) continues as one process resumed from it:
    the losses within 1e-5, the first norm too, the second within
    NORM_CHAOS_RTOL; both ranks the same."""
    check_restart(runs["m12"], runs["single_restart"][RWKV], f"restart:{RWKV}",
                  False)


# --------------------------------------------------------------------------
# the traps, by the fp64 gradient against one process's
# --------------------------------------------------------------------------

#: trap -> (arch, mesh, the leaves whose gradient it spoils)
TRAPS = {
    "in_proj_regroup_22": (JAMBA, "m22", r"mamba\.(in_proj|conv_|a_log|d_s)"),
    "in_proj_regroup_14": (JAMBA, "m14", r"mamba\.(in_proj|conv_|a_log|d_s)"),
    "x_proj_summed_once": (JAMBA, "m22", r"mamba\.(x_proj|dt_proj|in_proj)"),
    "rwkv_head_leaves": (RWKV, "m22",
                         r"rwkv\.(gn_scale|gn_bias|bonus_u|decay_)"),
}


@pytest.mark.parametrize("trap", sorted(TRAPS))
def test_local_view_gradient_in_fp64(runs, trap):
    """Every leaf's gradient block on every rank within 1e-10 of one
    process's, in fp64 (a cotangent summed zero times or twice, or routed
    back to the wrong process, is off by order one), the trap's leaves
    among them; the processes along ``model`` hold the same gradient of a
    replicated leaf, so its copies cannot drift apart."""
    arch, mesh, pat = TRAPS[trap]
    hit = 0
    for r in runs[mesh]:
        err = r[f"grad64:{arch}"]["err"]
        for name, e in err.items():
            assert e <= GRAD64_RTOL, (name, e)
            hit += bool(re.search(pat, name))
    assert hit > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_clip_norm_counts_each_leaf_once(runs, arch):
    """The mesh's global gradient norm (``loop._mesh_norm``: a cut leaf's
    squares summed over its cutting axes, a replicated leaf's counted
    once, not once a process) equals one process's norm of the whole
    gradient."""
    for r in runs["m22"]:
        got = r[f"grad64:{arch}"]
        assert abs(got["norm"] - got["norm_one"]) <= NORM_RTOL * \
            got["norm_one"]
