"""The LM dry run's collectives (``launch.dryrun.count_collectives``:
one device's share of a cell's mesh program on ``meta``, under a
``launch.mesh.StandInMesh`` whose collectives only tally) against the
same program run by gloo ranks on the CPU with
``sharding.collectives.tally`` open (harness: ``tests/_mesh_tp_harness.py``,
its ``traffic`` rank task), at smoke sizes.  Each rank's tally equals the
dry run's count of the same cell (``build_cell``'s arch, kind, batch and
length on ``make_test_mesh``), kind by kind, in bytes and in calls,
exactly, for:

* qwen2.5-3b served on (1, 4) (the sequence-cut cache: the decode's
  query gathers, ``pmax`` and ``psum``s);
* qwen3-moe served on (2, 2) (the expert all-to-alls);
* jamba served on (2, 2) (Mamba's ``all_to_all_v`` and ``x_proj``
  ``psum``);
* deepseek-v3 served on (2, 2) (MLA; its cache's sequence over
  ``model``);
* rwkv6-3b, one train step on (2, 2);
* rwkv6-3b at the harness's ``+h6`` (6 heads of 16) on (1, 4), which
  cuts inside a head: the four projections gathered over ``model`` and
  ``wo``'s rows summed, served and one train step;
* whisper-tiny (``+h6``: 6 heads) served on (2, 2) at batch 1 and on
  (1, 4) at batch 4 (the cross cache's distributed softmax);
* qwen2.5-3b, one train step of two microbatches on (2, 2), with and
  without ``TrainConfig.gather_once``.

A served cell is a prefill of the cell's length into a cache of as many
rows, and a decode step at its last row; each is tallied on its own.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import math

import pytest

from _mesh_tp_harness import base_job, load, ranks, smoke, wait
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

SEQ = 16
M14, M22 = (1, 4), (2, 2)


def _serve(arch, dims, batch=4):
    return [dict(arch=arch, dims=list(dims), kind=kind, seq=SEQ,
                 batch=batch) for kind in ("prefill", "decode")]


def _train(arch, dims, batch=4, microbatches=1, gather_once=False):
    return [dict(arch=arch, dims=list(dims), kind="train", seq=SEQ,
                 batch=batch, microbatches=microbatches,
                 gather_once=gather_once)]


#: name -> cell
CELLS = {}
for _name, _cells in (
        ("qwen_m14", _serve("qwen2.5-3b", M14)),
        ("moe_m22", _serve("qwen3-moe-30b-a3b", M22)),
        ("jamba_m22", _serve("jamba-v0.1-52b", M22)),
        ("deepseek_m22", _serve("deepseek-v3-671b", M22)),
        ("rwkv_m22", _train("rwkv6-3b", M22)),
        ("rwkv_headcut_m14", _serve("rwkv6-3b+h6", M14)
         + _train("rwkv6-3b+h6", M14)),
        ("whisper_m22_b1", _serve("whisper-tiny+h6", M22, batch=1)),
        ("whisper_m14", _serve("whisper-tiny+h6", M14)),
        ("qwen_train_m22", _train("qwen2.5-3b", M22, batch=8,
                                  microbatches=2)),
        ("qwen_gather_once_m22", _train("qwen2.5-3b", M22, batch=8,
                                        microbatches=2, gather_once=True))):
    for _c in _cells:
        CELLS[f"{_name}_{_c['kind']}"] = _c


@pytest.fixture(scope="module")
def tallies(tmp_path_factory):
    """Each rank's tally of each cell, by cell name: one spawn of ranks a
    mesh shape, every cell of that shape a task of it."""
    out = tmp_path_factory.mktemp("mesh_traffic")
    procs, names = {}, {}
    for dims in (M14, M22):
        tag = "m{}{}".format(*dims)
        names[dims] = [n for n, c in CELLS.items()
                       if tuple(c["dims"]) == dims]
        procs[dims] = ranks(dict(base_job({}, {}), traffic_cases=CELLS,
                                 tasks=[f"traffic:{n}" for n in names[dims]],
                                 out=str(out / tag)), dims)
    got = {}
    for dims, ps in procs.items():
        wait(ps)
        for rec in load(out / "m{}{}".format(*dims), math.prod(dims)):
            for n in names[dims]:
                got.setdefault(n, []).append(rec[f"traffic:{n}"])
    return got


def _count(cell) -> dict:
    cfg = smoke(configs, cell["arch"])
    shape = ShapeConfig("cell", cell["kind"], cell["seq"], cell["batch"],
                        cell.get("microbatches", 1))
    tcfg = None
    if cell["kind"] == "train":
        tcfg = dataclasses.replace(dryrun.train_config_for(cfg),
                                   gather_once=cell["gather_once"])
    return dryrun.count_collectives(cfg, shape,
                                    make_test_mesh(tuple(cell["dims"])),
                                    tcfg=tcfg)


@pytest.mark.parametrize("name", list(CELLS))
def test_rank_tallies_equal_the_dry_runs_count(tallies, name):
    """Every rank's tally of the cell equals the dry run's count on
    ``meta``: calls, bytes and ring volumes by kind, and the totals."""
    want = _count(CELLS[name])
    assert want["collective_model"] == "program"
    assert want["calls_by_kind"], name
    for r, got in enumerate(tallies[name]):
        assert got["calls_by_kind"] == want["calls_by_kind"], (name, r)
        assert got["by_kind"] == want["by_kind"], (name, r)
        assert got["total_bytes"] == want["total_bytes"], (name, r)
        assert got["ring_by_kind"] == want["ring_by_kind"], (name, r)
        assert got["ring_total_bytes"] == want["ring_total_bytes"], (name,
                                                                      r)


@pytest.mark.parametrize("name,kinds", [
    ("moe_m22_prefill", {"all-to-all"}),
    ("jamba_m22_prefill", {"all-to-all"}),
    ("qwen_m14_decode", {"all-gather", "all-reduce"}),
    ("rwkv_headcut_m14_decode", {"all-gather", "all-reduce"}),
    ("rwkv_headcut_m14_train", {"all-gather", "all-reduce",
                                "reduce-scatter"}),
    ("whisper_m14_decode", {"all-gather", "all-reduce"}),
    ("qwen_train_m22_train", {"all-gather", "all-reduce",
                              "reduce-scatter"}),
])
def test_the_count_holds_what_the_program_runs(tallies, name, kinds):
    """The kinds each mechanism sends are in the count: the MoE and
    Mamba all-to-alls, the sequence-cut decode's query gathers and its
    softmax's sums, RWKV-6's projections gathered over ``model`` where it
    cuts inside a head (and their reduce-scatters in a train step), a
    train step's FSDP gathers, reduce-scatters and gradient sums."""
    assert kinds <= set(tallies[name][0]["calls_by_kind"]), name


def test_gather_once_gathers_once(tallies):
    """With ``gather_once`` a two-microbatch step gathers each FSDP
    block once (the bf16 copy), without it at every use: fewer
    all-gather calls and reduce-scatters."""
    once = tallies["qwen_gather_once_m22_train"][0]["calls_by_kind"]
    every = tallies["qwen_train_m22_train"][0]["calls_by_kind"]
    assert once["all-gather"] < every["all-gather"]
    assert once["reduce-scatter"] < every["reduce-scatter"]
