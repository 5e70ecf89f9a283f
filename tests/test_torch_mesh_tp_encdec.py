"""FSDP over ``data`` and tensor parallelism over ``model`` for the
encoder-decoder (whisper-tiny, ``EncDecLM``) on a process mesh, over gloo
ranks on the CPU, against the reference's ``param_specs``-placed mesh run
and the single-process port (harness: ``tests/_mesh_tp_harness.py``).

On the smoke config (2 encoder + 2 decoder layers, d 64, 4 heads, d_ff
128) with its vocab of 512, which ``model`` cuts (the table
vocab-parallel), and with an odd vocab of 511 (``+v511``, in both
packages), whose table stays whole over ``model`` and is cut over
``data`` on ``d``, as the published 51 865 is:

* every leaf a rank holds is its ``param_specs`` block (the encoder's
  attention, the decoder's self-attention and cross-attention: ``wq``,
  ``wk``, ``wv`` columns and ``wo`` rows over ``model``; the MLPs; the
  position table whole), and the reference's run places as many of its
  stacked leaves sharded;
* prefill and decode logits in fp32 within 1e-5 of one process's largest
  logit, the self and cross caches on the local kv heads;
* three AdamW and two Adafactor steps (the two stacks' factored slots)
  from the reference's ``m.init(key(0))`` parameters, the batch's
  ``frames`` drawn with numpy from the seed in both packages, within 1e-5
  of the reference's run on the first loss and the harness's bands after;
* the fp64 gradient of every leaf within 1e-10 of one process's: the
  decoder's rows and the encoder's memory each enter a process's heads
  through ``sum_grad`` once, and the clip norm counts each leaf once;
* the AdamW checkpoint restored onto (1, 2), against one process resumed
  from it;
* ``launch/train.py --arch whisper-tiny --mesh 2x2 --device cpu`` as a
  user runs it: four processes over gloo, against the single-process
  launcher.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import json
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _mesh_tp_harness import (BATCH, GRAD64_RTOL, MESH, NORM_RTOL,
                              RESTART_MESH, RTOL, SEQ, _env, base_job,
                              check_restart, check_training, load,
                              mesh_runs, ranks, ref_leaves_cut, reference,
                              rel, single_restart, smoke, stub_inputs, wait)
from repro import configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.model import build_model
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt_mod

ARCH = "whisper-tiny"
ODD = "whisper-tiny+v511"
ARCHS = (ARCH, ODD)
CLI_STEPS = 3


def _cli(*extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
            "--smoke", "--steps", str(CLI_STEPS), "--seq", str(SEQ),
            "--batch", str(BATCH), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_tp_encdec")
    init = {}
    for i, arch in enumerate(ARCHS):
        rm = ref_build_model(smoke(ref_configs, arch))
        sd = convert.encdec_params_from_numpy(
            jax.tree.map(np.asarray, rm.init(jax.random.key(0))),
            smoke(configs, arch), device="cpu", dtype=torch.float32)
        init[arch] = str(out / f"init_{i}.pt")
        torch.save(sd, init[arch])
    save = {ARCH: str(out / "ckpt")}
    base = base_job(init, save)
    procs = ranks(dict(base, tasks=[f"{k}:{a}" for a in ARCHS for k in (
        "layout", "serve", "grad64", "adamw", "adafactor")],
        out=str(out / "m22")), MESH)
    refs = [reference(a, mesh_runs(["adamw", "adafactor"]),
                      out / f"ref_{i}.json") for i, a in enumerate(ARCHS)]
    wait(procs)
    procs = ranks(dict(base, tasks=[f"restart:{ARCH}"], ckpt=save,
                       out=str(out / "m12")), RESTART_MESH)
    cli = subprocess.Popen(
        _cli("--mesh", "2x2", "--ckpt", str(out / "cli_ck"),
             "--save-every", str(CLI_STEPS), "--record",
             str(out / "cli.json")),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    wait(procs + refs + [cli])
    return {"m22": load(out / "m22", 4), "m12": load(out / "m12", 2),
            "ref": {a: json.loads((out / f"ref_{i}.json").read_text())
                    for i, a in enumerate(ARCHS)},
            "single_restart": single_restart(ARCH, save[ARCH]),
            "cli": json.loads((out / "cli.json").read_text()),
            "cli_ck": str(out / "cli_ck")}


def _want_specs(arch):
    meta = EncDecLM(smoke(configs, arch), device="meta",
                    dtype=torch.float32)
    return rules.param_specs(make_test_mesh(MESH),
                             dict(meta.named_parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_its_param_specs_block(runs, arch):
    """Each rank's leaf is ``shard_shape(global, param_specs)`` and
    carries that spec; the reference's run places as many of its stacked
    leaves sharded as the port cuts; the token table is vocab-parallel at
    vocab 512 and cut over ``data`` alone at 511, the position table
    whole."""
    want = _want_specs(arch)
    mesh = make_test_mesh(MESH)
    for rank in runs["m22"]:
        got = rank[f"layout:{arch}"]
        assert set(got) == set(want)
        for name, (shape, whole, spec) in got.items():
            assert tuple(shape) == rules.shard_shape(whole, want[name],
                                                     mesh), name
            assert spec == repr(want[name]), name
    cfg = smoke(configs, arch)
    assert runs["ref"][arch]["adamw"]["sharded"] == \
        ref_leaves_cut(cfg, want) > 0
    assert want["embed.table"] == (rules.P("model", "data") if arch == ARCH
                                   else rules.P(None, "data"))
    assert want["pos_dec.table"] == rules.P()
    for attn in ("encoder.0.attn", "decoder.1.self_attn", "decoder.0.cross"):
        assert want[f"{attn}.wq.w"] == rules.P("data", "model")
        assert want[f"{attn}.wo.w"] == rules.P("model", "data")
    assert want["decoder.1.mlp.wi.w"] == rules.P("data", "model")


def _single_serve(arch):
    cfg = smoke(configs, arch)
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (BATCH, 13)))
    batch = {"tokens": toks[:, :12], **{
        k: torch.from_numpy(v) for k, v in stub_inputs(cfg, BATCH,
                                                       12).items()}}
    cache = m.init_cache(BATCH, 16, torch.float32, device="cpu")
    pre, cache = m.prefill(params, batch, cache)
    dec, _ = m.decode(params, cache, toks[:, 12], torch.full((BATCH,), 12))
    return pre[:, 0].numpy(), dec.numpy(), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_equal_one_process(runs, arch):
    """The mesh's prefill (K8's route on the local heads of the encoder,
    the causal self-attention and the cross-attention) and decode logits
    within 1e-5 of one process's largest logit, the processes of a batch
    block bit for bit equal, the self and cross caches on 2 of the 4 kv
    heads."""
    pre, dec, cache = _single_serve(arch)
    rows = BATCH // MESH[0]
    whole = cache["self"] + cache["cross_kv"]
    for r in runs["m22"]:
        got = r[f"serve:{arch}"]
        d = r["coords"]["data"]
        sl = slice(d * rows, (d + 1) * rows)
        assert rel(got["prefill"], pre[sl]) <= RTOL
        assert rel(got["decode"], dec[sl]) <= RTOL
        same = [q for q in runs["m22"] if q["coords"]["data"] == d]
        assert got["decode"] == same[0][f"serve:{arch}"]["decode"]
        assert got["cache_kv_heads"] == 2
        for mine, w in zip(got["cache_shapes"], whole, strict=True):
            assert mine == {k: [rows, v.shape[1], 2, v.shape[3]]
                            for k, v in w.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("opt", ("adamw", "adafactor"))
def test_mesh_training_equals_reference_sharded_mesh(runs, arch, opt):
    """Three AdamW (two Adafactor) steps: the losses within 1e-5
    relative of the reference's sharded run, the first clipped gradient
    norm too, the later ones within NORM_CHAOS_RTOL; every rank the
    same."""
    check_training(runs["m22"], runs["ref"][arch][opt], f"{opt}:{arch}",
                   False)


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_and_rows_enter_heads_once(runs, arch):
    """The fp64 gradient of every leaf on every rank within 1e-10 of one
    process's (the encoder's memory and the decoder's rows each enter a
    process's heads through ``sum_grad`` once; the vocab-parallel or
    ``data``-cut table's gradient summed where its lookup and the tied
    unembedding read it), and the clip norm equal to one process's."""
    for r in runs["m22"]:
        got = r[f"grad64:{arch}"]
        assert set(got["err"]) == set(_want_specs(arch))
        for name, e in got["err"].items():
            assert e <= GRAD64_RTOL, (name, e)
        assert abs(got["norm"] - got["norm_one"]) <= NORM_RTOL * \
            got["norm_one"]


def test_elastic_restart_continues_as_one_process(runs):
    """The step-3 checkpoint restored onto (1, 2) continues as one
    process resumed from it: the losses within RTOL, the later norm
    within NORM_CHAOS_RTOL; both ranks the same."""
    check_restart(runs["m12"], runs["single_restart"], f"restart:{ARCH}",
                  False)


def test_launcher_cli_mesh(runs):
    """``launch/train.py --arch whisper-tiny --mesh 2x2 --device cpu``:
    four processes over gloo, the frames of each batch cut with its
    tokens; the losses within RTOL of the single-process launcher's, and
    a checkpoint of global leaves that restores whole into a
    single-process model."""
    losses = runs["cli"]["losses"]
    assert len(losses) == CLI_STEPS and all(np.isfinite(losses))
    one = launch_train.main(_cli()[3:])["losses"]
    assert rel(losses, one) <= RTOL, (losses, one)
    cfg = configs.get_smoke(ARCH)
    params = EncDecLM(cfg, device="cpu", dtype=torch.float32)
    target = (dict(params.named_parameters()),
              opt_mod.init_opt_state(TrainConfig(), params))
    (tree, _), meta = CheckpointManager(runs["cli_ck"]).restore(target)
    assert meta["step"] == CLI_STEPS
    assert tree["embed.table"].shape == (cfg.vocab_size, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_state_layout_reads_both_stacks(runs, arch):
    """The mesh's layout of ``(params, Adafactor state)`` (a checkpoint's,
    ``rules.local_specs``) names the state's stacked slots by the
    encoder's and decoder's stacks (``encoder.<leaf>``,
    ``decoder.<leaf>``, ``EncDecLM.period_slots``): each slot's factored
    moments whole, every parameter its ``param_specs`` block."""
    want = _want_specs(arch)
    for r in runs["m22"]:
        got = r[f"adafactor:{arch}"]["state_specs"]
        for name, spec in want.items():
            assert got["0/" + name.replace(".", "/")] == repr(spec), name
        slots = {p for p in got if re.match(r"1/v_(row|col)/(encoder|"
                                            r"decoder)/[a-z]", p)}
        assert slots and {got[p] for p in slots} == {repr(rules.P())}
        unstacked = [n for n in want
                     if not re.match(r"(encoder|decoder)\.\d+\.", n)]
        assert len(got) == len(want) + len(slots) + 2 * len(unstacked)
