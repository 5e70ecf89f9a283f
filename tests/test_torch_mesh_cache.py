"""The reference's sequence-cut serving cache on a process mesh
(``transformer.init_cache`` by ``rules.cache_blocks``, the distributed
decode softmax of ``attention._sdpa_blocks`` and ``mla_decode``), over
gloo ranks on the CPU, against the reference's ``jax.jit`` prefill and
decode on 4 forced host devices with its parameters placed by
``param_specs`` and its cache by ``cache_specs`` (``seq_shard`` at global
batch 1), and against one process of the port (harness:
``tests/_mesh_tp_harness.py``).

From the reference's ``m.init(key(0))`` parameters, MoE dropless
(``DROPLESS_CF``): a prefill of 7 prompt tokens into a cache of 16 rows,
then decode steps at positions 7, 8, 9 (one row before the block boundary
at 8, in every cut here), for

* qwen2.5-3b on (1, 4) at batch 4: 2 kv heads do not divide ``model``,
  so the sequence is cut over ``model`` and each process holds every kv
  head and 4 of the 16 rows;
* internvl2-1b on (2, 2) (1 kv head, 7 query heads: every process every
  head, the sequence over ``model``) and deepseek-v3 on (2, 2) and
  (1, 4) (MLA: the sequence over ``model``) at batch 4;
* at batch 1 (``seq_shard``, ``use_mesh(replicated_batch=True)``) on
  (2, 2): jamba (kv heads over ``model``, the sequence over ``data``),
  deepseek-v3 (the sequence over ``("data", "model")``) and qwen2.5-3b;
* the encoder-decoder (``encdec.init_cache``: its ``self`` and
  ``cross_kv`` caches) at the harness's ``whisper-tiny+h6``, the smoke
  config with 6 heads and 6 kv heads as the published one has (the smoke
  config's 4 divide every mesh here), its frames the harness's
  ``stub_inputs`` (seed 13) in both packages: on (2, 2) at batch 4 (the
  kv heads over ``model``, 3 a process), at batch 1 (also the rows and
  frames over ``data``) and on (1, 4) at batch 4 (6 heads do not divide
  4: every head on a quarter of the rows and frames, the decode's
  cross-attention the distributed softmax), and a position past the end
  there.

Each case: (a) after the prefill and after each decode step every
process's cache leaf (Mamba's too) is, within 1e-5 of the leaf's largest
magnitude, the block the reference's spec gives it of the reference's
own mesh cache (the encoder-decoder's ``self`` and ``cross_kv`` too);
(b) the prefill and decode logits are within 1e-5 of the
reference's mesh run and of one process, and the processes of a batch
block agree bit for bit; the bytes a process allocates for the cache
equal the dry run's per-device cache bytes of the same cell.  And: a
position past the end (the last row written, every row attended), held
to the reference; a length the cut does not divide keeps the sequence
whole; at batch 1 on (1, 4) the reference's spec maps ``data`` twice
and both packages refuse it (the encoder-decoder too).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from _mesh_tp_harness import (DROPLESS_CF, RTOL, base_job, load, ranks,
                              reference, rel, smoke, stub_inputs, wait)
from repro import configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import encdec, transformer
from repro_torch.sharding import rules
from test_torch_dryrun_lm import _port_names

QWEN, VL, DS, JAMBA = ("qwen2.5-3b", "internvl2-1b", "deepseek-v3-671b",
                       "jamba-v0.1-52b")
#: whisper-tiny's smoke config with the published config's 6 heads
WHISPER = "whisper-tiny+h6"
T, S, POS = 16, 7, [7, 8, 9]
M14, M22 = (1, 4), (2, 2)


def _case(arch, dims, batch, t=T, pos=POS, **kw):
    return dict(arch=arch, dims=list(dims), batch=batch, T=t, S=S,
                pos=list(pos), **kw)


#: name -> case; the first nine are the tentpole's, the rest the extras
CASES = {
    "qwen_m14": _case(QWEN, M14, 4, refuse=True),
    "internvl_m22": _case(VL, M22, 4),
    "deepseek_m22": _case(DS, M22, 4),
    "deepseek_m14": _case(DS, M14, 4),
    "jamba_m22_b1": _case(JAMBA, M22, 1),
    "deepseek_m22_b1": _case(DS, M22, 1),
    "qwen_m22_b1": _case(QWEN, M22, 1),
    "qwen_m14_past_end": _case(QWEN, M14, 4, pos=[7, 8, T + 2]),
    "deepseek_m22_b1_past_end": _case(DS, M22, 1, pos=[7, 8, T + 3]),
    "qwen_m14_t18": _case(QWEN, M14, 4, t=18),
    "qwen_m14_b1": _case(QWEN, M14, 1, raises=True),
    "whisper_m22": _case(WHISPER, M22, 4, refuse=True),
    "whisper_m22_b1": _case(WHISPER, M22, 1),
    "whisper_m14": _case(WHISPER, M14, 4),
    "whisper_m14_past_end": _case(WHISPER, M14, 4, pos=[7, 8, T + 2]),
    "whisper_m14_b1": _case(WHISPER, M14, 1, raises=True),
}
SERVED = [n for n, c in CASES.items() if not c.get("raises")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_cache")
    init = {}
    for arch in sorted({c["arch"] for c in CASES.values()}):
        rm = ref_build_model(smoke(ref_configs, arch))
        cfg = smoke(configs, arch)
        to_port = (convert.encdec_params_from_numpy if cfg.family == "audio"
                   else convert.lm_params_from_numpy)
        sd = to_port(jax.tree.map(np.asarray, rm.init(jax.random.key(0))),
                     cfg, device="cpu", dtype=torch.float32)
        init[arch] = str(out / f"init_{arch}.pt")
        torch.save(sd, init[arch])
    ref = reference(QWEN, [], out / "ref.json", serve=CASES)
    got = {}
    for dims in (M14, M22):
        tag = "m{}{}".format(*dims)
        names = [n for n, c in CASES.items() if tuple(c["dims"]) == dims]
        wait(ranks(dict(base_job(init, {}), cache_cases=CASES,
                        tasks=[f"serve_cache:{n}" for n in names],
                        out=str(out / tag)), dims))
        for r, rec in enumerate(load(out / tag, math.prod(dims))):
            for n in names:
                got.setdefault(n, []).append(dict(
                    rec[f"serve_cache:{n}"], coords=rec["coords"],
                    arrays=str(out / f"{tag}_{r}_{n}.npz")))
    wait([ref], timeout=600)
    return {"ranks": got, "ref": json.loads((out / "ref.json").read_text()),
            "ref_dir": out, "init": init}


def _cfg(arch):
    cfg = smoke(configs, arch)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DROPLESS_CF))


def _single(runs, name):
    """One process of the port on the same parameters and tokens: the
    prefill's last logits and each decode step's, (1 + steps, B, V)."""
    case = CASES[name]
    cfg = _cfg(case["arch"])
    audio = cfg.family == "audio"
    mod = encdec if audio else transformer
    params = (encdec.EncDecLM if audio else transformer.DecoderLM)(
        cfg, device="cpu", dtype=torch.float32)
    params.load_state_dict(torch.load(runs["init"][case["arch"]]))
    b = case["batch"]
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, S + len(case["pos"]))))
    cache = mod.init_cache(cfg, b, case["T"], torch.float32, device="cpu")
    if audio:
        frames = torch.from_numpy(stub_inputs(cfg, b, 13)["frames"])
        pre, cache = encdec.prefill(params, cfg, toks[:, :S], frames, cache)
    else:
        pre, cache = transformer.prefill(params, cfg, toks[:, :S], cache)
    out = [pre[:, 0]]
    for i, p in enumerate(case["pos"]):
        lg, cache = mod.decode_step(params, cfg, toks[:, S + i],
                                    torch.full((b,), p), cache)
        out.append(lg)
    return torch.stack(out).numpy()


def _rows(case, coords):
    """This process's rows of the global batch."""
    if case["batch"] == 1:
        return slice(0, 1)
    n = case["batch"] // case["dims"][0]
    return slice(coords["data"] * n, (coords["data"] + 1) * n)


def _block(arr, spec, dims, coords):
    """The block of ``arr`` that ``spec`` (a list of entries: None, an
    axis, a list of axes) gives the process at ``coords``."""
    shape = dict(zip(("data", "model"), dims))
    idx = []
    for i, entry in enumerate(spec):
        axes = [] if entry is None else (
            [entry] if isinstance(entry, str) else list(entry))
        k = 0
        for a in axes:
            k = k * shape[a] + coords[a]
        n = arr.shape[i] // math.prod(shape[a] for a in axes)
        idx.append(slice(k * n, (k + 1) * n))
    return arr[tuple(idx)]


@pytest.mark.parametrize("name", SERVED)
def test_cache_blocks_are_the_references_blocks(runs, name):
    """After the prefill and after each decode step every process's
    cache leaf is the block the reference's ``cache_specs`` gives it of
    the reference's own mesh cache (shape exactly, values within 1e-5 of
    the leaf's largest magnitude)."""
    case = CASES[name]
    cfg = _cfg(case["arch"])
    ref = runs["ref"][name]
    assert ref["raised"] is None
    checked = 0
    for step in range(1 + len(case["pos"])):
        want = dict(np.load(runs["ref_dir"] / f"ref.json_{name}_{step}.npz"))
        for r in runs["ranks"][name]:
            got = np.load(r["arrays"])
            for path, arr in want.items():
                spec = ref["specs"][path]
                stacked = path.startswith(("period/", "self/", "cross_kv/"))
                for p, port in enumerate(_port_names(cfg, path)):
                    whole = arr[p] if stacked else arr
                    blk = _block(whole, spec[1:] if stacked else spec,
                                 case["dims"], r["coords"])
                    mine = got[f"{step}/{port}"]
                    assert mine.shape == blk.shape, (name, port, step)
                    err = np.abs(mine - blk).max() / max(
                        np.abs(whole).max(), 1e-30)
                    assert err <= RTOL, (name, port, step, err)
                    checked += 1
    assert checked >= 2 * (1 + len(case["pos"])) * len(runs["ranks"][name])


@pytest.mark.parametrize("name", SERVED)
def test_logits_equal_reference_mesh_and_one_process(runs, name):
    """The prefill's and each decode step's logits of every process's
    rows within 1e-5 relative of the reference's mesh run and of one
    process of the port; the processes of a batch block bit for bit
    equal."""
    case = CASES[name]
    ref = np.asarray(runs["ref"][name]["logits"])
    one = _single(runs, name)
    procs = runs["ranks"][name]
    for r in procs:
        got = np.asarray(r["logits"])
        rows = _rows(case, r["coords"])
        assert got.shape == one[:, rows].shape
        assert rel(got, ref[:, rows]) <= RTOL, (name, rel(got, ref[:, rows]))
        assert rel(got, one[:, rows]) <= RTOL, (name, rel(got, one[:, rows]))
        same = [q for q in procs if _rows(case, q["coords"]) == rows]
        assert r["logits"] == same[0]["logits"]


@pytest.mark.parametrize("name", SERVED)
def test_cache_bytes_equal_the_dry_runs(runs, name):
    """The bytes a process allocates for a bf16 cache of the case's
    batch and rows equal the cache argument bytes ``launch.dryrun``
    records for one device of the same mesh, batch and length; no leaf
    of GQA or MLA is larger than its ``cache_specs`` block."""
    case = CASES[name]
    cfg = _cfg(case["arch"])
    seq = case["T"] - (cfg.n_prefix_embeds if cfg.family == "vlm" else 0)
    cell = dryrun.build_cell(cfg, ShapeConfig(name, "decode", seq,
                                              case["batch"]),
                             make_test_mesh(tuple(case["dims"])))
    want = dryrun.memory_record(cell)["argument_bytes_by_role"]["cache"]
    for r in runs["ranks"][name]:
        assert r["cache_bytes_bf16"] == want, (name, r["cache_bytes_bf16"],
                                               want)


def test_sequence_cuts_follow_the_reference(runs):
    """The specs each case's leaves carry: qwen2.5-3b's sequence over
    ``model`` on (1, 4); internvl2-1b's too (1 kv head); MLA's over
    ``model``, and over ``("data", "model")`` at batch 1; jamba's at
    batch 1 over ``data`` with its kv heads over ``model``; a length of
    18 that 4 does not divide keeps the sequence whole."""
    def spec(name, leaf):
        return runs["ranks"][name][0]["specs"][leaf]
    assert spec("qwen_m14", "layers/0/k") == repr(rules.P("data", "model"))
    assert spec("internvl_m22", "layers/0/k") == repr(rules.P("data",
                                                              "model"))
    assert spec("deepseek_m22", "layers/0/c_kv") == repr(rules.P("data",
                                                                 "model"))
    assert spec("deepseek_m22_b1", "layers/0/c_kv") == repr(
        rules.P(None, ("data", "model")))
    attn = next(i for i, k in enumerate(transformer.layer_kinds(
        configs.get_smoke(JAMBA))) if k[0] == "attn")
    assert spec("jamba_m22_b1", f"layers/{attn}/k") == repr(
        rules.P(None, "data", "model"))
    assert spec("qwen_m14_t18", "layers/0/k") == repr(rules.P("data"))
    assert spec("qwen_m22_b1", "layers/0/k") == repr(
        rules.P(None, "data", "model"))
    for r in runs["ranks"]["qwen_m14_t18"]:
        assert np.load(r["arrays"])["0/layers/0/k"].shape[1] == 18


@pytest.mark.parametrize("name,want", [
    ("whisper_m22", rules.P("data", None, "model")),
    ("whisper_m22_b1", rules.P(None, "data", "model")),
    ("whisper_m14", rules.P("data", "model")),
])
def test_encdec_caches_follow_the_reference(runs, name, want):
    """The encoder-decoder's ``self`` and ``cross_kv`` leaves carry the
    reference's ``cache_specs`` spec (without its stacked layer dim),
    the reference's own spec of each: on (2, 2) the kv heads over
    ``model``, at batch 1 also the rows and frames over ``data``, on
    (1, 4) every head on a block of the rows and frames over ``model``;
    each process holds its block of the ``T`` rows and the
    ``encoder_seq`` frames."""
    cfg = _cfg(WHISPER)
    case = CASES[name]
    ref_specs = runs["ref"][name]["specs"]
    for part, length in (("self", case["T"]), ("cross_kv", cfg.encoder_seq)):
        assert ref_specs[f"{part}/k"][1:] == [
            list(e) if isinstance(e, tuple) else e for e in want]
        seq_axes = rules._axes(want[1]) if len(want) > 1 else ()
        cut = math.prod(dict(zip(("data", "model"), case["dims"]))[a]
                        for a in seq_axes)
        for r in runs["ranks"][name]:
            for i in range(cfg.n_layers):
                assert r["specs"][f"{part}/{i}/k"] == repr(want)
                blk = np.load(r["arrays"])[f"0/{part}/{i}/k"]
                assert blk.shape[1] == length // cut, (name, part)


def test_batch_one_on_a_one_wide_data_axis_raises_in_both(runs):
    """At global batch 1 on (1, 4) the reference's spec maps ``data`` to
    the batch and the sequence both: JAX refuses it, and so does the
    port, naming the spec."""
    for name in ("qwen_m14_b1", "whisper_m14_b1"):
        assert "DuplicateSpec" in runs["ref"][name]["raised"]
        for r in runs["ranks"][name]:
            assert "P('data', ('data', 'model'))" in r["raised"]
    whole = transformer.init_cache(configs.get_smoke(QWEN), 1, T,
                                   device="meta")
    with pytest.raises(ValueError, match="more than once"):
        rules.cache_blocks(make_test_mesh(M14), whole, seq_shard=True)


def test_a_cache_laid_out_otherwise_is_refused(runs):
    """On a mesh, a cache built off it raises with the reason (in the
    ranks); off a mesh, a block of a mesh's cache raises too; on a
    ``MeshShape`` the blocks are device 0's."""
    for name in ("qwen_m14", "whisper_m22"):
        for r in runs["ranks"][name]:
            assert "carries no layout" in r["refused"]
    leaf = torch.zeros((2, 8, 2, 16))
    leaf.spec, leaf.global_shape = rules.P("data", "model"), (4, 16, 2, 16)
    with pytest.raises(ValueError, match="of a process mesh, used off"):
        rules.check_cache_blocks({"layers": [{"k": leaf}]}, 2)
    whole = transformer.init_cache(configs.get_smoke(QWEN), 4, T,
                                   device="meta")
    blk = rules.cache_blocks(make_test_mesh(M22), whole)["layers"][0]["k"]
    assert (blk.spec, blk.shape, blk.start) == (
        rules.P("data", None, "model"), (2, 16, 1, 16), (0, 0, 0, 0))
