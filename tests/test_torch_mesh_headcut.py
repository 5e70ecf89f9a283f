"""RWKV-6 on a process mesh whose ``model`` axis cuts inside a head, over
gloo ranks on the CPU, against the reference's ``param_specs``-placed
mesh run (its ``jax.jit`` train step, and its prefill and decode with the
cache placed by ``cache_specs``) and one process of the port (harness:
``tests/_mesh_tp_harness.py``).

The harness's ``rwkv6-3b+h6`` is the smoke config with 6 heads of 16
(``d_model`` 96).  On (1, 4) ``param_specs`` cuts ``wr``, ``wk``, ``wv``
and ``wg`` into 24 columns a process and ``wo`` into 24 rows: 1.5 heads,
as a 16-wide ``model`` cuts rwkv6-3b's 40 heads of 64 into 160 channels.
The port keeps those blocks, gathers the four projections whole over
``model`` at use, runs all 6 heads on every process, and gives ``wo`` its
rows' share (``models/rwkv.py``); the state cache ``s`` holds every head,
whole over ``model``, as the reference's ``cache_specs`` lays it out.  On
(2, 2) the 6 heads divide ``model``: 3 a process, the route of the
heads that split.

From the reference's ``m.init(key(0))`` parameters: every leaf is its
``param_specs`` block; after a prefill of 7 tokens into a 16-row cache
and each of three decode steps every cache leaf is the reference's
block of its own mesh cache, and the logits are within 1e-5 relative of
the reference's mesh run and of one process; three AdamW steps are
within 1e-5 of the reference's mesh run; the fp64 gradient of every leaf
(the gathered projections, ``wo``, and the unsliced ``bonus_u``,
``gn_*`` and decay among them) is within ``GRAD64_RTOL`` of one
process's.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import json
import math
import re

import jax
import numpy as np
import pytest
import torch

from _mesh_tp_harness import (GRAD64_RTOL, RTOL, base_job, check_training,
                              load, mesh_runs, ranks, reference, rel, smoke,
                              wait)
from repro import configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import transformer
from repro_torch.sharding import rules
from test_torch_dryrun_lm import _port_names
from test_torch_mesh_cache import _block

RW = "rwkv6-3b+h6"
M14, M22 = (1, 4), (2, 2)
T, S, POS = 16, 7, [7, 8, 9]
#: name -> serve case (the harness's ``serve_cache`` and the reference's
#: ``serve``)
CASES = {f"m{d[0]}{d[1]}": dict(arch=RW, dims=list(d), batch=4, T=T, S=S,
                                pos=POS) for d in (M14, M22)}
#: the leaves whose fp64 gradient each group of the route spoils if a
#: cotangent is summed zero times or twice
GRAD_GROUPS = {
    "gathered_projections": r"rwkv\.(wr|wk|wv|wg)\.w$",
    "wo_rows": r"rwkv\.wo\.w$",
    "bonus_u": r"rwkv\.bonus_u$",
    "group_norm": r"rwkv\.gn_(scale|bias)$",
    "decay": r"rwkv\.decay_(base|lora)",
    "streams": r"rwkv\.mix_(base|lora)",
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_headcut")
    rm = ref_build_model(smoke(ref_configs, RW))
    sd = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rm.init(jax.random.key(0))),
        smoke(configs, RW), device="cpu", dtype=torch.float32)
    init = {RW: str(out / "init.pt")}
    torch.save(sd, init[RW])
    ref = reference(RW, mesh_runs(["adamw"], dims=M14), out / "ref.json",
                    serve=CASES)
    got = {}
    for dims in (M14, M22):
        tag = "m{}{}".format(*dims)
        tasks = [f"layout:{RW}", f"serve_cache:{tag}", f"grad64:{RW}"]
        if dims == M14:
            tasks.append(f"adamw:{RW}")
        wait(ranks(dict(base_job(init, {}), cache_cases=CASES, tasks=tasks,
                        out=str(out / tag)), dims))
        got[tag] = load(out / tag, math.prod(dims))
        for r, rec in enumerate(got[tag]):
            rec["arrays"] = str(out / f"{tag}_{r}_{tag}.npz")
    wait([ref], timeout=600)
    return {"ranks": got, "ref": json.loads((out / "ref.json").read_text()),
            "ref_dir": out, "init": init}


def _single(runs):
    """One process of the port on the reference's parameters and the
    cases' tokens: the prefill's last logits and each decode step's, (1 +
    steps, B, V)."""
    cfg = smoke(configs, RW)
    params = transformer.DecoderLM(cfg, device="cpu", dtype=torch.float32)
    params.load_state_dict(torch.load(runs["init"][RW]))
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4, S + len(POS))))
    cache = transformer.init_cache(cfg, 4, T, torch.float32, device="cpu")
    pre, cache = transformer.prefill(params, cfg, toks[:, :S], cache)
    out = [pre[:, 0]]
    for i, p in enumerate(POS):
        lg, cache = transformer.decode_step(params, cfg, toks[:, S + i],
                                            torch.full((4,), p), cache)
        out.append(lg)
    return torch.stack(out).numpy()


def test_the_rule_runs_every_head_where_model_cuts_inside_one():
    """``rules.model_blocks`` is 1 for RWKV-6 where ``model`` cuts its
    leaves inside a head (the smoke ``+h6`` on (1, 4), rwkv6-3b's 40
    heads on the reference's 16 x 16 and 2 x 16 x 16), the head count
    where the heads divide (2 on (2, 2)); the layer's cut leaves are the
    four projections' columns and ``wo``'s rows; a cut inside an MLA head
    still raises, naming the ROADMAP item that keeps it."""
    cfg = smoke(configs, RW)
    assert rules.model_blocks(cfg, "rwkv", make_test_mesh(M14)) == 1
    assert rules.model_blocks(cfg, "rwkv", make_test_mesh(M22)) == 2
    pub = configs.get("rwkv6-3b")
    for multi_pod in (False, True):
        assert rules.model_blocks(pub, "rwkv", make_production_mesh(
            multi_pod=multi_pod)) == 1
    leaves, heads = rules._tp_leaves(pub, "rwkv")
    assert heads == 40
    assert sorted((p, dim) for p, _, dim in leaves) == [
        ("rwkv/wg/w", 1), ("rwkv/wk/w", 1), ("rwkv/wo/w", 0),
        ("rwkv/wr/w", 1), ("rwkv/wv/w", 1)]
    mla = smoke(configs, "deepseek-v3-671b+h6")
    with pytest.raises(ValueError, match="ROADMAP Queue 1"):
        rules.model_blocks(mla, "mla", make_test_mesh(M14))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_every_leaf_is_its_param_specs_block(runs, tag):
    """Each rank's leaf is ``shard_shape(global, param_specs)`` and
    carries that spec: on (1, 4) the projections' 24 of 96 columns (1.5
    heads of 16) and ``wo``'s 24 rows, ``bonus_u`` and the norms whole."""
    cfg = smoke(configs, RW)
    meta = transformer.DecoderLM(cfg, device="meta", dtype=torch.float32)
    mesh = make_test_mesh(tuple(CASES[tag]["dims"]))
    want = rules.param_specs(mesh, dict(meta.named_parameters()))
    for r in runs["ranks"][tag]:
        got = r[f"layout:{RW}"]
        assert set(got) == set(want)
        for name, (shape, whole, spec) in got.items():
            assert tuple(shape) == rules.shard_shape(whole, want[name],
                                                     mesh), name
            assert spec == repr(want[name]), name
        if tag == "m14":
            assert got["layers.0.rwkv.wr.w"][:1] == [[96, 24]]
            assert got["layers.0.rwkv.wo.w"][:1] == [[24, 96]]
            assert got["layers.0.rwkv.bonus_u"][2] == repr(rules.P())


@pytest.mark.parametrize("tag", sorted(CASES))
def test_cache_blocks_are_the_references_blocks(runs, tag):
    """After the prefill and after each decode step every process's
    cache leaf is the block the reference's ``cache_specs`` gives it of
    the reference's own mesh cache (shape exactly, values within 1e-5 of
    the leaf's largest magnitude): the state ``s`` holds all 6 heads on
    (1, 4), whole over ``model``, and 3 on (2, 2)."""
    case = CASES[tag]
    cfg = smoke(configs, RW)
    ref = runs["ref"][tag]
    assert ref["raised"] is None
    heads = {"m14": 6, "m22": 3}[tag]
    assert ref["specs"]["period/0/s"] == (
        [None, "data"] if tag == "m14" else [None, "data", "model"])
    checked = 0
    for step in range(1 + len(case["pos"])):
        want = dict(np.load(runs["ref_dir"] / f"ref.json_{tag}_{step}.npz"))
        for r in runs["ranks"][tag]:
            got = np.load(r["arrays"])
            assert got[f"{step}/layers/0/s"].shape[1] == heads
            for path, arr in want.items():
                spec = ref["specs"][path]
                for p, port in enumerate(_port_names(cfg, path)):
                    blk = _block(arr[p], spec[1:], case["dims"],
                                 r["coords"])
                    mine = got[f"{step}/{port}"]
                    assert mine.shape == blk.shape, (tag, port, step)
                    err = np.abs(mine - blk).max() / max(
                        np.abs(arr[p]).max(), 1e-30)
                    assert err <= RTOL, (tag, port, step, err)
                    checked += 1
    assert checked == (1 + len(case["pos"])) * 4 * 3 * cfg.n_layers
    for r in runs["ranks"][tag]:
        assert r[f"serve_cache:{tag}"]["specs"]["layers/0/s"] == repr(
            rules.P("data") if tag == "m14" else rules.P("data", "model"))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_logits_equal_reference_mesh_and_one_process(runs, tag):
    """The prefill's and each decode step's logits of every process's
    rows within 1e-5 relative of the reference's mesh run and of one
    process of the port; the processes of a batch block bit for bit
    equal."""
    ref = np.asarray(runs["ref"][tag]["logits"])
    one = _single(runs)
    procs = runs["ranks"][tag]
    n = 4 // CASES[tag]["dims"][0]
    for r in procs:
        got = np.asarray(r[f"serve_cache:{tag}"]["logits"])
        d = r["coords"]["data"]
        rows = slice(d * n, (d + 1) * n)
        assert got.shape == one[:, rows].shape
        assert rel(got, ref[:, rows]) <= RTOL, rel(got, ref[:, rows])
        assert rel(got, one[:, rows]) <= RTOL, rel(got, one[:, rows])
        same = [q for q in procs if q["coords"]["data"] == d]
        assert got.tolist() == same[0][f"serve_cache:{tag}"]["logits"]


def test_training_equals_reference_mesh_run(runs):
    """Three AdamW steps on (1, 4) from the reference's initial
    parameters: the losses within 1e-5 relative of the reference's
    ``param_specs``-placed run on the same mesh, the first clipped
    gradient norm too, the later ones within ``NORM_CHAOS_RTOL``; every
    rank the same."""
    check_training(runs["ranks"]["m14"], runs["ref"]["adamw"],
                   f"adamw:{RW}", False)


@pytest.mark.parametrize("group", sorted(GRAD_GROUPS))
@pytest.mark.parametrize("tag", sorted(CASES))
def test_gradients_in_fp64_equal_one_process(runs, tag, group):
    """Every leaf's fp64 gradient block on every rank within 1e-10 of
    one process's (a cotangent summed zero times or twice is off by
    order one), the group's leaves among them; and the mesh's clip norm
    equal to one process's."""
    hit = 0
    for r in runs["ranks"][tag]:
        got = r[f"grad64:{RW}"]
        for name, e in got["err"].items():
            assert e <= GRAD64_RTOL, (name, e)
            hit += bool(re.search(GRAD_GROUPS[group], name))
        assert abs(got["norm"] - got["norm_one"]) <= 1e-6 * got["norm_one"]
    assert hit > 0
