"""The port's checkpoint manager (``repro_torch.checkpoint.manager``) on
the CPU, held against the reference's ``repro.checkpoint.manager``.

* the on-disk format: a dict checkpoint written by either package loads in
  the other (``load_host``, and ``restore`` by structure);
* ``network_metadata``, ``session_metadata`` and ``restore_spec`` give the
  reference's dicts and round-trip the specs;
* the reference's ``tests/test_checkpoint_fault.py`` cases on the port's
  manager: round trip, async save, atomic commit, GC, a failed async save
  re-raised with ``LATEST`` unchanged, the walk-back past a corrupt
  ``.npy`` and a missing manifest, an explicit corrupt step, a stale
  ``.tmp``, a shape mismatch;
* what the port's manager flattens itself: dataclass states with their
  static markers, ``torch.Generator`` leaves (restored in place, refused
  across device types), and host COPIES taken at save time.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro.core import models as ref_models
from repro_torch.checkpoint import manager as port_manager
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CorruptCheckpointError)
from repro_torch.core import builder, engine, models

CPU = "cpu"


def state_tree(v=0.0):
    return {"params": {"w": torch.full((4, 3), v), "b": torch.zeros(3)},
            "opt": {"m": torch.full((4, 3), v * 2)},
            "step": torch.tensor(int(v))}


def numpy_tree(v=0.0):
    return {"params": {"w": np.full((4, 3), v, np.float32),
                       "b": np.zeros(3, np.float32)},
            "opt": {"m": np.full((4, 3), v * 2, np.float32),
                    "count": np.arange(5, dtype=np.int32)},
            "step": np.asarray(int(v), np.int32)}


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


# --------------------------------------------------------------------------
# the on-disk format, across packages
# --------------------------------------------------------------------------

def test_reference_checkpoint_loads_in_the_port(tmp_path):
    tree = numpy_tree(1.5)
    ref_manager.CheckpointManager(str(tmp_path)).save(
        7, tree, metadata={"note": "x", "nested": {"a": 1}})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    step, host, md = mgr.load_host()
    assert step == 7 and md == {"note": "x", "nested": {"a": 1}}
    _assert_tree_equal(host, tree)
    assert mgr.load_metadata() == md
    tgt = numpy_tree()
    tgt["params"]["w"] = torch.zeros(4, 3)
    restored, _ = mgr.restore(tgt)
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  tree["params"]["w"])
    np.testing.assert_array_equal(restored["opt"]["count"],
                                  tree["opt"]["count"])


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = numpy_tree(2.5)
    CheckpointManager(str(tmp_path)).save(
        9, {**tree, "t": torch.arange(4, dtype=torch.int32)},
        metadata={"note": "y"})
    ref = ref_manager.CheckpointManager(str(tmp_path))
    step, host, md = ref.load_host()
    assert step == 9 and md == {"note": "y"}
    _assert_tree_equal(host, {**tree, "t": np.arange(4, dtype=np.int32)})
    ref_tree = {**{k: v for k, v in tree.items()},
                "t": jnp.zeros(4, jnp.int32)}
    restored, _ = ref.restore(ref_tree)
    np.testing.assert_array_equal(np.asarray(restored["opt"]["count"]),
                                  np.arange(5))


def test_manifests_agree_leaf_for_leaf(tmp_path):
    """Both packages write the same leaf keys, files, shapes and dtypes, in
    the same order."""
    tree = numpy_tree(1.0)
    ref_manager.CheckpointManager(str(tmp_path / "ref")).save(1, tree)
    CheckpointManager(str(tmp_path / "port")).save(1, tree)
    leaves = []
    for d in ("ref", "port"):
        with open(tmp_path / d / "step_000000001" / "manifest.json") as f:
            leaves.append([{k: r[k] for k in ("key", "file", "shape",
                                              "dtype", "prng")}
                           for r in json.load(f)["leaves"]])
    assert leaves[0] == leaves[1]
    assert leaves[0][0]["key"] == "['opt']['count']"


# --------------------------------------------------------------------------
# network identity metadata
# --------------------------------------------------------------------------

SPECS = {"hpc": lambda m: m.hpc_benchmark(0.02, stdp=True)[0],
         "lif_procedural": lambda m: dataclasses.replace(
             m.model_demo("lif", 0.02)[0], connectivity="procedural"),
         "marmoset": lambda m: m.marmoset(0.002, n_areas=4)}


@pytest.mark.parametrize("name", list(SPECS))
def test_network_metadata_matches_reference(name):
    port_spec, ref_spec = SPECS[name](models), SPECS[name](ref_models)
    extra = {"step": 3, "sweep": "flat"}
    md = port_manager.network_metadata(port_spec, seed=5, extra=extra)
    want = ref_manager.network_metadata(ref_spec, seed=5, extra=extra)
    assert json.loads(json.dumps(md)) == json.loads(json.dumps(want))
    sess = port_manager.session_metadata(port_spec, seed=5, session_id=2,
                                         step=40)
    assert json.loads(json.dumps(sess)) == json.loads(json.dumps(
        ref_manager.session_metadata(ref_spec, seed=5, session_id=2,
                                     step=40)))


@pytest.mark.parametrize("name", list(SPECS))
def test_restore_spec_round_trips(name):
    spec = SPECS[name](models)
    md = json.loads(json.dumps(port_manager.network_metadata(spec, seed=11)))
    back, seed = port_manager.restore_spec(md)
    assert seed == 11
    assert builder.spec_to_dict(back) == builder.spec_to_dict(spec)
    # the reference's metadata restores the same spec in the port
    ref_md = json.loads(json.dumps(ref_manager.network_metadata(
        SPECS[name](ref_models), seed=11)))
    assert builder.spec_to_dict(port_manager.restore_spec(ref_md)[0]) == \
        builder.spec_to_dict(spec)
    with pytest.raises(KeyError, match="network_metadata"):
        port_manager.restore_spec({"step": 1})


# --------------------------------------------------------------------------
# the reference's checkpoint cases, on the port's manager
# --------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, state_tree(1.5), metadata={"note": "x"})
    restored, meta = mgr.restore(state_tree())
    assert meta["note"] == "x"
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((4, 3), 1.5))
    assert restored["step"].dtype == torch.int64


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    (t,) = mgr.timings
    assert t["step"] == 1 and t["bytes"] == 4 * (12 + 3 + 12) + 8
    assert t["snapshot_s"] >= 0 and t["write_s"] > 0


def test_atomic_commit_no_partial_visible(tmp_path):
    """A .tmp dir must never be treated as a checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state_tree(3.0))
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert mgr.latest_step() == 3
    restored, _ = mgr.restore(state_tree())
    assert int(restored["step"]) == 3


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state_tree(float(s)))
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert names == ["step_000000003", "step_000000004"]


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0))
    bad = state_tree()
    bad["params"]["w"] = torch.zeros((5, 5))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(bad)
    bad = state_tree()
    del bad["opt"]
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(bad)


def _truncate_largest_npy(step_dir):
    arrs = sorted(n for n in os.listdir(step_dir) if n.endswith(".npy"))
    target = os.path.join(
        step_dir,
        max(arrs, key=lambda n: os.path.getsize(os.path.join(step_dir, n))))
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)


def test_async_save_failure_raises_and_keeps_latest(tmp_path, monkeypatch):
    """A failed background write surfaces at wait() (once) and does NOT
    advance LATEST past the previous committed checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0))
    real_save = np.save

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(port_manager.np, "save", boom)
    mgr.save(2, state_tree(2.0), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save at step 2"):
        mgr.wait()
    mgr.wait()  # raised exactly once
    monkeypatch.setattr(port_manager.np, "save", real_save)
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(state_tree())
    assert int(restored["step"]) == 1
    mgr.save(3, state_tree(3.0))   # the manager stays usable
    assert mgr.latest_step() == 3


def test_latest_step_scan_fallback(tmp_path):
    """LATEST is a hint: a dangling pointer or a truncated manifest falls
    back to the newest committed step that reads."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0))
    mgr.save(2, state_tree(2.0))
    with open(tmp_path / "LATEST", "w") as f:   # points at a missing dir
        f.write("99\n")
    assert mgr.latest_step() == 2
    with open(tmp_path / "step_000000002" / "manifest.json", "w") as f:
        f.write('{"truncated')                   # garbage manifest
    assert mgr.latest_step() == 1
    os.unlink(tmp_path / "LATEST")
    assert mgr.latest_step() == 1


def test_restore_falls_back_past_corrupt_npy(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0))
    mgr.save(2, state_tree(2.0))
    _truncate_largest_npy(str(tmp_path / "step_000000002"))
    restored, _ = mgr.restore(state_tree())
    assert int(restored["step"]) == 1


def test_restore_falls_back_past_missing_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0))
    mgr.save(2, state_tree(2.0))
    os.unlink(tmp_path / "step_000000002" / "manifest.json")
    step, tree, _ = mgr.load_host()
    assert step == 1
    np.testing.assert_array_equal(tree["params"]["w"], np.full((4, 3), 1.0))


def test_restore_explicit_corrupt_step_raises(tmp_path):
    """An EXPLICIT step= must not silently fall back."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0))
    mgr.save(2, state_tree(2.0))
    _truncate_largest_npy(str(tmp_path / "step_000000002"))
    with pytest.raises(CorruptCheckpointError):
        mgr.restore(state_tree(), step=2)
    with pytest.raises(CorruptCheckpointError):
        mgr.load_host(step=2)


def test_restore_all_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(1.0))
    _truncate_largest_npy(str(tmp_path / "step_000000001"))
    with pytest.raises(CorruptCheckpointError, match="tried"):
        mgr.restore(state_tree())


def test_restore_ignores_stale_tmp_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state_tree(4.0))
    os.makedirs(tmp_path / "step_000000008.tmp")
    with open(tmp_path / "step_000000008.tmp" / "manifest.json", "w") as f:
        json.dump({"leaves": []}, f)
    assert mgr.latest_step() == 4
    restored, _ = mgr.restore(state_tree())
    assert int(restored["step"]) == 4


# --------------------------------------------------------------------------
# what the port's manager flattens itself
# --------------------------------------------------------------------------

def _engine_state(seed=0):
    spec, _ = models.hpc_benchmark(0.02, stdp=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    return engine.init_state(g, list(spec.groups), seed, sweep="cuda",
                             device=CPU)


def test_engine_state_round_trips_with_its_generator(tmp_path):
    """An EngineState saves every tensor and its generator (flagged by
    device type) under the reference's key strings, not its static
    markers; ``restore`` takes values from the file, structure and
    markers from the target, and sets the target's generator in place."""
    st = _engine_state()
    st.generator.manual_seed(123)
    torch.rand(7, generator=st.generator)
    want_next = torch.rand(5, generator=torch.Generator().set_state(
        st.generator.get_state()))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, st)
    with open(tmp_path / "step_000000004" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    keys = [r["key"] for r in leaves]
    assert keys[:2] == [".neurons.v_m", ".neurons.syn_ex"]
    assert ".generator" in keys and ".weights_layout" not in keys
    (gen,) = [r for r in leaves if r["key"] == ".generator"]
    assert gen["generator"] == "cpu" and gen["dtype"] == "uint8"

    tgt = _engine_state(seed=9)
    tgt.neurons.v_m.fill_(3.0)
    restored, _ = mgr.restore(tgt)
    assert restored.generator is tgt.generator
    assert torch.equal(torch.rand(5, generator=restored.generator),
                       want_next)
    assert torch.equal(restored.neurons.v_m, st.neurons.v_m)
    assert torch.equal(restored.weights, st.weights)
    assert restored.weights_layout == st.weights_layout != "flat"
    with pytest.raises(CorruptCheckpointError, match="dict-saved"):
        mgr.load_host()


def test_generator_of_another_device_type_is_refused(tmp_path):
    """A CPU mt19937 state is never set into a CUDA generator, nor a CUDA
    Philox state into a CPU one: a clear message, nothing restored."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"g": torch.Generator(), "x": torch.zeros(2)})
    manifest = tmp_path / "step_000000001" / "manifest.json"
    meta = json.loads(manifest.read_text())
    meta["leaves"][0]["generator"] = "cuda"    # as a card's save flags it
    manifest.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="do not mix"):
        mgr.restore({"g": torch.Generator(), "x": torch.zeros(2)})
    with pytest.raises(ValueError, match="do not mix"):
        mgr.restore({"g": torch.zeros(5056, dtype=torch.uint8),
                     "x": torch.zeros(2)})


def test_save_takes_a_host_copy(tmp_path):
    """The port's steps write state in place: what ``save`` returns with
    is a copy, so an async write is not torn by the next step."""
    st = {"v": torch.zeros(1000), "a": np.zeros(10)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st, blocking=False)
    st["v"].fill_(7.0)
    st["a"][:] = 7.0
    mgr.wait()
    _, host, _ = mgr.load_host()
    assert not host["v"].any() and not host["a"].any()


def test_dataclass_and_list_leaves(tmp_path):
    """Dataclass fields write ``.name`` keys and list items ``[i]``; None
    writes no leaf; python scalars in a dict are leaves and come back in
    the target's type."""
    @dataclasses.dataclass
    class S:
        x: torch.Tensor
        gens: list
        tag: str = "t"
        opt: object = None

    st = {"s": S(torch.arange(3.0), [torch.Generator(), torch.Generator()]),
          "n": 4, "f": 2.5}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st)
    keys = [r["key"] for r in json.loads((
        tmp_path / "step_000000001" / "manifest.json").read_text())["leaves"]]
    assert keys == ["['f']", "['n']", "['s'].x", "['s'].gens[0]",
                    "['s'].gens[1]"]
    tgt = {"s": S(torch.zeros(3), [torch.Generator(), torch.Generator()],
                  tag="u"), "n": 0, "f": 0.0}
    out, _ = mgr.restore(tgt)
    assert out["n"] == 4 and isinstance(out["n"], int) and out["f"] == 2.5
    assert out["s"].tag == "u" and torch.equal(out["s"].x, st["s"].x)
