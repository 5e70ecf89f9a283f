"""FSDP over ``data`` and tensor parallelism over ``model`` for the MLA
family (deepseek-v3: MLA, a dense prefix, MoE with a shared expert) on a
process mesh, over gloo ranks on the CPU, against the reference's
``param_specs``-placed mesh run and the single-process port (harness:
``tests/_mesh_tp_harness.py``).

On the smoke config (3 dense MLA + MLP layers, then 2 MLA + MoE layers
with a shared expert; 4 heads):

* every leaf a rank holds is its ``param_specs`` block (``wq_a`` and
  ``wkv_a`` over ``data`` only, ``wq_b`` and ``wkv_b`` columns and
  ``wo`` rows over ``model``, the shared expert tensor-parallel), and
  the reference's run places the same leaves sharded;
* prefill and decode logits within 1e-5 relative of one process's on
  (2, 2) and (1, 4) (one head a process), the cache ``c_kv`` / ``k_rope``
  a block of the sequence over ``model`` (``cache_specs``);
* three AdamW steps from the reference's ``m.init(key(0))`` parameters
  within 1e-5 of the reference's run, and their checkpoint restored onto
  (1, 2) against one process resumed from it;
* the trap of the local view: the shared rope key (and the q and kv
  latents) read by each process for its own heads, its cotangent summed
  over ``model`` once, by the fp64 gradient against one process's; and
  the clip norm counting a replicated leaf once;
* on the same process mesh the encoder-decoder's layout (``local_specs``
  of an ``EncDecLM`` on ``meta``) is ``param_specs``' too.
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
                              NORM_RTOL, RESTART_MESH, RTOL, base_job,
                              check_restart, check_training, load,
                              mesh_runs, ranks, ref_leaves_cut, reference,
                              rel, single_restart, wait)
from repro import configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer
from repro_torch.sharding import rules

ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_tp_mla")
    rm = ref_build_model(ref_configs.get_smoke(ARCH))
    sd = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rm.init(jax.random.key(0))),
        configs.get_smoke(ARCH), device="cpu", dtype=torch.float32)
    init = {ARCH: str(out / "init.pt")}
    torch.save(sd, init[ARCH])
    save = {ARCH: str(out / "ckpt")}
    base = base_job(init, save)
    procs = ranks(dict(base, tasks=[f"{k}:{ARCH}" for k in (
        "layout", "serve", "grad64", "adamw")] + ["encdec:whisper-tiny"],
        out=str(out / "m22")), MESH)
    ref = reference(ARCH, mesh_runs(["adamw"]), out / "ref.json")
    wait(procs)
    procs = ranks(dict(base, tasks=[f"serve:{ARCH}"], out=str(out / "m14")),
                  (1, 4))
    procs += ranks(dict(base, tasks=[f"restart:{ARCH}"], ckpt=save,
                        out=str(out / "m12")), RESTART_MESH)
    wait(procs + [ref])
    return {"m22": load(out / "m22", 4), "m14": load(out / "m14", 4),
            "m12": load(out / "m12", 2),
            "ref": json.loads((out / "ref.json").read_text()),
            "single_restart": single_restart(ARCH, save[ARCH])}


def test_every_leaf_is_its_param_specs_block(runs):
    """Each rank's leaf is ``shard_shape(global, param_specs)`` and
    carries that spec; the reference's run places as many leaves
    sharded as the port cuts."""
    cfg = configs.get_smoke(ARCH)
    meta = transformer.DecoderLM(cfg, device="meta", dtype=torch.float32)
    mesh = make_test_mesh(MESH)
    want = rules.param_specs(mesh, dict(meta.named_parameters()))
    for rank in runs["m22"]:
        got = rank[f"layout:{ARCH}"]
        assert set(got) == set(want)
        for name, (shape, whole, spec) in got.items():
            assert tuple(shape) == rules.shard_shape(whole, want[name],
                                                     mesh), name
            assert spec == repr(want[name]), name
    assert runs["ref"]["adamw"]["sharded"] == ref_leaves_cut(cfg, want) > 0
    assert want["layers.0.attn.wq_a.w"] == rules.P("data")
    assert want["layers.0.attn.wkv_b.w"] == rules.P(None, "model")
    assert want["layers.3.moe.shared.wo.w"] == rules.P("model", "data")


def _single_serve():
    cfg = configs.get_smoke(ARCH)
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
def test_prefill_decode_logits_equal_one_process(runs, mesh):
    """The mesh's prefill (K8's route on the local heads) and absorbed
    decode logits within 1e-5 relative of one process's, the processes
    of a batch block bit for bit equal, the MLA cache its block of the
    sequence over ``model`` (16 / 2 or 16 / 4 rows)."""
    pre, dec, cache = _single_serve()
    rows = BATCH // (2 if mesh == "m22" else 1)
    for r in runs[mesh]:
        got = r[f"serve:{ARCH}"]
        d = r["coords"]["data"]
        sl = slice(d * rows, (d + 1) * rows)
        assert rel(got["prefill"], pre[sl]) <= RTOL
        assert rel(got["decode"], dec[sl]) <= RTOL
        same = [q for q in runs[mesh] if q["coords"]["data"] == d]
        assert got["decode"] == same[0][f"serve:{ARCH}"]["decode"]
        n_model = 2 if mesh == "m22" else 4
        for mine, whole in zip(got["cache_shapes"], cache["layers"],
                               strict=True):
            assert mine == {k: [rows, v.shape[1] // n_model]
                            + list(v.shape[2:]) for k, v in whole.items()}


def test_mesh_training_equals_reference_sharded_mesh(runs):
    """Three AdamW steps: the losses within 1e-5 relative of the
    reference's sharded run, the first clipped gradient norm too, the
    later ones within NORM_CHAOS_RTOL; every rank the same."""
    check_training(runs["m22"], runs["ref"]["adamw"], f"adamw:{ARCH}",
                   False)


def test_elastic_restart_continues_as_one_process(runs):
    """The step-3 checkpoint restored onto (1, 2) continues as one
    process resumed from it, within the MoE bands of a mesh against one
    process (MOE_SINGLE_FIRST_RTOL, MOE_SINGLE_RTOL: a mesh counts
    capacity and the load-balance loss per token slice); both ranks the
    same."""
    check_restart(runs["m12"], runs["single_restart"], f"restart:{ARCH}",
                  True)


@pytest.mark.parametrize("leaves", (r"attn\.(wkv_a|kv_a_norm)",
                                    r"attn\.(wq_a|q_a_norm)"))
def test_rope_key_and_latents_enter_heads_once(runs, leaves):
    """The fp64 gradient of every leaf on every rank within 1e-10 of one
    process's: the shared rope key and the normed latents (whose
    gradients reach ``wkv_a``, ``kv_a_norm``, ``wq_a``, ``q_a_norm``) are
    each read by every process for its own heads and enter them through
    ``sum_grad`` once."""
    hit = 0
    for r in runs["m22"]:
        for name, e in r[f"grad64:{ARCH}"]["err"].items():
            assert e <= GRAD64_RTOL, (name, e)
            hit += bool(re.search(leaves, name))
    assert hit > 0


def test_clip_norm_counts_each_leaf_once(runs):
    """The mesh's global gradient norm equals one process's norm of the
    whole gradient (a replicated leaf counted once, not once a
    process)."""
    for r in runs["m22"]:
        got = r[f"grad64:{ARCH}"]
        assert abs(got["norm"] - got["norm_one"]) <= NORM_RTOL * \
            got["norm_one"]


def test_encoder_decoder_keeps_whole_leaves(runs):
    """On the same process mesh the encoder-decoder's leaves are their
    ``param_specs`` blocks, as a decoder-only model's
    (``rules.shards_dense`` is true for it too; its mesh path is
    ``tests/test_torch_mesh_tp_encdec.py``'s): the attention and MLP
    matrices cut over ``data`` and ``model``, the position table and
    the norms whole."""
    from repro_torch.models.encdec import EncDecLM
    meta = EncDecLM(configs.get_smoke("whisper-tiny"), device="meta",
                    dtype=torch.float32)
    want = {n: repr(sp) for n, sp in rules.param_specs(
        make_test_mesh(MESH), dict(meta.named_parameters())).items()}
    for r in runs["m22"]:
        assert r["encdec:whisper-tiny"] == want
    assert want["decoder.0.cross.wo.w"] == repr(rules.P("model", "data"))
    assert want["pos_dec.table"] == repr(rules.P())
