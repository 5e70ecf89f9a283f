"""Port build vs reference build: the numpy pipeline must agree bit for bit.

``repro_torch.core.builder`` is a jax-free copy of the reference builder.
Every ``ShardGraph`` and ``BlockedGraph`` field it emits must be
``array_equal`` (same dtype too) to the reference's, at 1 and 4 shards, for
both connectivity modes.
"""

import dataclasses
import os

import numpy as np
import pytest

from repro.core import builder as ref_builder
from repro.core import graph as ref_graph
from repro.core import models as ref_models
from repro_torch.core import builder, graph, models
from repro_torch.core.layout import BlockedGraph


def _specs(connectivity, scale=0.02):
    ref_spec, _ = ref_models.hpc_benchmark(scale)
    spec, _ = models.hpc_benchmark(scale)
    return (dataclasses.replace(ref_spec, connectivity=connectivity),
            dataclasses.replace(spec, connectivity=connectivity))


def _assert_same(name, a, b):
    if a is None or b is None:
        assert a is None and b is None, name
    elif isinstance(a, (int, np.integer)):
        assert int(a) == int(b), name
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("connectivity", ["materialized", "procedural"])
def test_build_arrays_equal_reference(connectivity, n_shards):
    ref_spec, spec = _specs(connectivity)
    ref_dec = ref_builder.decompose(ref_spec, n_shards)
    dec = builder.decompose(spec, n_shards)
    for a, b in zip(ref_dec.parts, dec.parts):
        np.testing.assert_array_equal(a, b)
    ref_shards = ref_builder.build_shards(ref_spec, ref_dec)
    shards = builder.build_shards(spec, dec)
    assert len(shards) == len(ref_shards) == n_shards
    for rg, g in zip(ref_shards, shards):
        names = [f.name for f in dataclasses.fields(g)]
        assert names == [f.name for f in dataclasses.fields(rg)]
        for name in names:
            if name != "blocked":
                _assert_same(name, getattr(rg, name), getattr(g, name))
        assert (np.asarray(g.delay) == 0).any(), "no padding edges"
        for f in dataclasses.fields(BlockedGraph):
            _assert_same(f"blocked.{f.name}", getattr(rg.blocked, f.name),
                         getattr(g.blocked, f.name))


def test_analytic_counts_and_spec_roundtrip_equal_reference():
    ref_spec, spec = _specs("procedural")
    ref_dec = ref_builder.decompose(ref_spec, 4)
    dec = builder.decompose(spec, 4)
    np.testing.assert_array_equal(ref_builder.shard_edge_counts(ref_spec,
                                                                ref_dec),
                                  builder.shard_edge_counts(spec, dec))
    for dev in range(4):
        np.testing.assert_array_equal(
            ref_builder.shard_row_degrees(ref_spec, ref_dec, dev),
            builder.shard_row_degrees(spec, dec, dev))
    d = builder.spec_to_dict(spec)
    assert d == ref_builder.spec_to_dict(ref_spec)
    assert builder.spec_to_dict(builder.spec_from_dict(d)) == d


def test_graph_algebra_copy_agrees():
    """The copied sub-graph algebra (eqs. 4-16): indegree partitions never
    conflict, outdegree ones do - the same counts as the reference."""
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 40, (300, 2))
    g, rg = (m.DirectedGraph.from_edges(40, edges)
             for m in (graph, ref_graph))
    parts = graph.partition_vertices(40, 4)
    for fmt in ("in", "out"):
        assert (graph.ownership_conflicts(g, parts, fmt)
                == ref_graph.ownership_conflicts(rg, parts, fmt))
    assert graph.ownership_conflicts(g, parts, "in") == 0


def test_block_shapes_wait_for_a_hopper_autotuner():
    spec, _ = models.hpc_benchmark(0.02)
    with pytest.raises(NotImplementedError, match="Hopper"):
        builder.build_shards(spec, builder.decompose(spec, 1),
                             block_shapes="auto")


def test_a_library_is_stale_when_a_header_is_newer(tmp_path, monkeypatch):
    """``_build._stale``: a kernel's library is rebuilt when it is missing,
    or older than its source or than any ``csrc/*.cuh`` (a source may
    include any of them), and loaded as it is otherwise."""
    from repro_torch.kernels import _build
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, lib = csrc / "k.cu", build / "libk.so"
    header, other = csrc / "math.cuh", csrc / "other.cu"
    for f in (src, header, other):
        f.write_text("")
    assert _build._stale("k")                      # no library yet
    lib.write_text("")
    stamp = lambda f, t: os.utime(f, (t, t))
    for f in (src, header, other):
        stamp(f, 1000)
    stamp(lib, 2000)
    assert not _build._stale("k")
    stamp(other, 3000)                             # another kernel's source
    assert not _build._stale("k")
    stamp(header, 3000)
    assert _build._stale("k")
    stamp(header, 1000)
    stamp(src, 3000)
    assert _build._stale("k")


def test_build_all_compiles_every_kernel_it_is_given(tmp_path,
                                                     monkeypatch):
    """``_build.build_all`` starts one compiler per kernel named, stale or
    not (so that a run's build time and ptxas report are its own; ``load``
    builds only a stale kernel), and returns each one's compiler output."""
    from repro_torch.kernels import _build
    started = []

    class Done:         # a compiler process that has exited
        def poll(self):
            return 0

    monkeypatch.setattr(_build, "_stale", lambda name: name == "b")
    monkeypatch.setattr(_build, "_start", lambda name: started.append(name)
                        or (Done(), tmp_path / f"{name}.tmp", None))
    monkeypatch.setattr(_build, "_finish",
                        lambda name, proc, tmp, lib: f"log of {name}")
    out = _build.build_all(("a", "b"))
    assert out["ptxas"] == {"a": "log of a", "b": "log of b"}
    assert started == ["a", "b"]
