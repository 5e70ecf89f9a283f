"""Port multi-tenant SNN sessions vs the reference (DESIGN.md §16).

* the jax-free bookkeeping (``SessionTable``, ``SpikeLog``): one seeded
  sequence of operations through both packages' copies;
* the reference's ``test_session_in_batch_matches_solo`` interleave on the
  reference's ``SessionEngine(sweep="flat")``, and on the port's (``flat``
  and ``cuda``, its kernels' plain twins on the CPU) with each session's
  reference Poisson draws injected: identical rasters, ``v_m`` within the
  fp32 tolerance of
  ``test_torch_engine.py::test_flat_backend_matches_reference_flat_with_injected_drive``;
* each session bitwise its own solo ``engine.run`` on the port's own
  drive, on ``flat``, ``cuda`` and a gate that updates weights in place
  (``test_torch_sessions_solo.py``: a file of its own, so that the run's
  workers share these cases' time);
* a stochastic model, eviction, backpressure, a supervised crash, and the
  slot-batch functions.

Every spike comparison first requires spikes (``bits.sum() > 0``).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import session_metadata as ref_session_metadata
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import neuron_models as ref_nm
from repro.serve import sessions as ref_sessions
from repro.serve.snn import SessionEngine as RefSessionEngine
from repro_torch.core import engine, models
from repro_torch.runtime.fault import RestartPolicy
from repro_torch.runtime.inject import FaultInjector, FaultSpec
from repro_torch.serve import sessions
from repro_torch.serve.sessions import Backpressure
from repro_torch.serve.snn import SessionEngine

CPU = "cpu"
SCALE = 0.01
# brunel's first spike under the collapsed Poisson drive lands ~step 118
# at this scale; run well past it so equality pins real activity
N_STEPS = 160
# the reference's ragged interleave: (session, steps) of step(), or a
# tuple of sessions stepped together by step_wave(); "c" arrives last
INTERLEAVE = (("a", 40), (("a", "b"), 80), ("b", 80), ("a", N_STEPS - 120),
              ("c", N_STEPS))
SEEDS = {"a": 0, "b": 1, "c": 2}


def _engine(**kw):
    return SessionEngine(device=CPU, **kw)


def _drive_interleave(eng, create, inputs=None, plan=INTERLEAVE):
    """Run ``plan`` on ``eng`` (either package's engine): sessions are
    created on first use through ``create(eng, seed)``; ``inputs(name,
    start, n)`` gives a port session's injected draws as a ``(drive,
    model_uniform)`` pair.  Returns ``({name: raster}, {name: sid})``."""
    sid, got, steps = {}, {}, {}
    for who, n in plan:
        names = who if isinstance(who, tuple) else (who,)
        for name in names:
            if name not in sid:
                sid[name] = create(eng, SEEDS[name])
                got[name], steps[name] = [], 0
        kw = {}
        if inputs is not None:
            per = {name: inputs(name, steps[name], n) for name in names}
            for k, key in enumerate(("drive", "model_uniform")):
                if any(p[k] is not None for p in per.values()):
                    kw[key] = ({sid[m]: p[k] for m, p in per.items()}
                               if isinstance(who, tuple) else per[who][k])
        if isinstance(who, tuple):
            w = eng.step_wave([sid[m] for m in names], n=n, **kw)
            for m in names:
                got[m].append(np.asarray(w[sid[m]]))
        else:
            got[who].append(np.asarray(eng.step(sid[who], n, **kw)))
        for m in names:
            steps[m] += n
    return {m: np.concatenate(c, axis=0) for m, c in got.items()}, sid


def _ref_poisson_drives(ref_eng, seed, n_steps):
    """Session ``seed``'s reference drive stream: a masked slot's key is
    frozen, so its k-th active step splits the key chain of
    ``jax.random.key(seed)`` as a solo run does."""
    st = ref_engine.init_state(ref_eng.graph, list(ref_eng.spec.groups),
                               jax.random.key(seed),
                               neuron_model=ref_eng.cfg.neuron_model)

    def body(key, _):
        key, sub = jax.random.split(key)
        return key, ref_engine._poisson_drive(sub, ref_eng.graph, 0.1,
                                              jnp.float32)

    _, d = jax.jit(lambda k: jax.lax.scan(body, k, None,
                                          length=n_steps))(st.key)
    return torch.from_numpy(np.array(d))


def _ref_uniforms(ref_eng, seed, n_steps):
    """A stochastic model's reference draws: ``_gid_uniform(drive_key, t,
    global_id)`` for t = 0 .. n_steps - 1."""
    st = ref_engine.init_state(ref_eng.graph, list(ref_eng.spec.groups),
                               jax.random.key(seed),
                               neuron_model=ref_eng.cfg.neuron_model)
    draw = jax.jit(lambda t: ref_nm._gid_uniform(st.drive_key, t,
                                                 ref_eng.graph.global_id))
    return torch.from_numpy(np.stack([np.asarray(draw(jnp.int32(t)))
                                      for t in range(n_steps)]))


def _solo(eng, seed, n_steps):
    """The uninterrupted single-tenant run on the engine's own graph,
    table and cfg: ``(flat final state, raster)``."""
    st = eng.ctx.init_state(list(eng.spec.groups), seed, dtype=eng.dtype)
    return engine.run(st, eng.graph, eng.param_table, eng.cfg, n_steps,
                      device=CPU)


def _leaves(state):
    """Every value of a state, the generator's as its state bytes."""
    return {"v_m": state.neurons.v_m, "syn_ex": state.neurons.syn_ex,
            "syn_in": state.neurons.syn_in,
            "ref_count": state.neurons.ref_count,
            "spike": state.neurons.spike, "ring": state.ring,
            "weights": state.weights, "k_pre": state.traces.k_pre,
            "k_post": state.traces.k_post, "t": state.t,
            "gate_overflow": state.gate_overflow,
            "generator": state.generator.get_state(),
            **{f"extra.{k}": v for k, v in state.neurons.extra.items()}}


def _assert_same_state(got, want, what):
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k} differs"
    assert got.weights_layout == want.weights_layout


def _boosted_hpc(scale, boost=2.0):
    """``hpc_benchmark(scale, stdp=True)`` with the Poisson drive boosted
    2x (at small scales the plain drive is silent for ~250 steps), as
    ``tests/test_torch_runtime.py`` runs it."""
    spec, stdp = models.hpc_benchmark(scale, stdp=True)
    pops = [dataclasses.replace(p, ext_rate_hz=p.ext_rate_hz * boost)
            for p in spec.populations]
    return dataclasses.replace(spec, populations=pops), stdp


# --------------------------------------------------------------------------
# bookkeeping
# --------------------------------------------------------------------------

def _bookkeeping_trace(mod, seed, n_ops=300):
    """A seeded sequence of create/place/touch/displace/enqueue/close and
    spike-log append/truncate on ``mod``'s ``SessionTable`` -> what each
    operation observed (records, LRU choice, queue, counts, windows)."""
    rng = np.random.default_rng(seed)
    tab = mod.SessionTable(3, queue_limit=2, spike_window=7)
    trace = []

    def records():
        return [(r.sid, r.seed, r.status, r.slot, r.step, r.last_used,
                 r.committed_step, r.spike_log.recorded_steps)
                for r in tab.sessions.values()]

    for _ in range(n_ops):
        open_ = [s for s, r in tab.sessions.items() if r.status != mod.CLOSED]
        op = rng.integers(0, 8)
        sid = int(rng.choice(open_)) if open_ else None
        if op == 0 or sid is None:
            rec = tab.new_session(int(rng.integers(0, 100)))
            trace.append(("new", rec.sid, tab.enqueue(rec.sid)))
        elif op == 1:
            slot = tab.free_slot()
            rec = tab.get(sid)
            if slot is not None and rec.status != mod.RESIDENT:
                tab.place(sid, slot)
            trace.append(("place", sid, slot))
        elif op == 2:
            tab.touch(sid)
            trace.append(("touch", sid))
        elif op == 3:
            victim = tab.lru_resident(exclude={sid})
            if victim is not None:
                trace.append(("displace", victim, tab.displace(victim)))
            else:
                trace.append(("no-victim", sid))
        elif op == 4:
            trace.append(("close", sid, tab.close(sid).status))
        elif op == 5:
            rec = tab.get(sid)
            n = int(rng.integers(1, 5))
            bits = rng.random((n, 4)) < 0.3
            rec.spike_log.append(rec.step, bits)
            rec.step += n
        elif op == 6:
            rec = tab.get(sid)
            rec.step = int(rng.integers(0, rec.step + 1))
            rec.spike_log.truncate(rec.step)
        else:
            rec = tab.get(sid)
            w = [None, int(rng.integers(0, 10))][int(rng.integers(0, 2))]
            first, bits = rec.spike_log.window_bits(w)
            trace.append(("window", sid, first, bits.shape, bits.tobytes()))
        bp = tab.backpressure("probe")
        trace.append((records(), tab.lru_resident(), list(tab.queue),
                      tab.counts(), list(tab.slots), tab.next_queued(),
                      (bp.reason, bp.resident, bp.queued, bool(bp))))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bookkeeping_matches_reference(seed):
    assert _bookkeeping_trace(sessions, seed) == \
        _bookkeeping_trace(ref_sessions, seed)


def test_spike_log_window_and_truncate():
    log = sessions.SpikeLog(window=5)
    rng = np.random.default_rng(0)
    chunks = [rng.random((n, 3)) < 0.5 for n in (2, 3, 4)]
    start = 0
    for c in chunks:
        log.append(start, c)
        start += len(c)
    first, bits = log.window_bits()
    # the oldest chunk goes once the rest hold the window: 3 + 4 >= 5
    assert first == 2 and np.array_equal(bits, np.concatenate(chunks[1:]))
    log.truncate(4)
    first, bits = log.window_bits()
    assert first == 2 and np.array_equal(bits, chunks[1][:2])
    assert log.recorded_steps == 2
    with pytest.raises(ValueError):
        log.append(0, np.zeros(3, bool))
    assert not Backpressure("r", 1, 0)


# --------------------------------------------------------------------------
# interleaved sessions against the reference's engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_interleave():
    eng = RefSessionEngine(max_sessions=4, sweep="flat")
    bits, sid = _drive_interleave(
        eng, lambda e, seed: e.create("brunel", seed=seed, scale=SCALE))
    v_m = {m: np.asarray(eng.snapshot(s)[0].neurons.v_m)
           for m, s in sid.items()}
    drives = {m: _ref_poisson_drives(eng, SEEDS[m], len(bits[m]))
              for m in sid}
    return bits, v_m, drives


@pytest.mark.parametrize("sweep", ["flat", "cuda"])
def test_interleaved_sessions_match_reference(sweep, reference_interleave):
    """The reference's ragged interleave (a alone, a + b together, b
    alone, a alone, a late c) with each session's reference draws
    injected at its own step count: the port's rasters equal the
    reference engine's; ``v_m`` within 1e-4 (torch's and XLA's CPU
    kernels may order or contract float ops differently)."""
    ref_bits, ref_vm, drives = reference_interleave
    eng = _engine(max_sessions=4, sweep=sweep)
    bits, sid = _drive_interleave(
        eng, lambda e, seed: e.create("brunel", seed=seed, scale=SCALE),
        inputs=lambda m, start, n: (drives[m][start:start + n], None))
    for m in ref_bits:
        assert ref_bits[m].sum() > 0, "vacuous: no spikes fired"
        np.testing.assert_array_equal(bits[m], ref_bits[m])
        np.testing.assert_allclose(
            eng.snapshot(sid[m])[0].neurons.v_m.numpy(), ref_vm[m],
            atol=1e-4)
    first, logged = eng.spikes(sid["a"])
    assert first == 0 and np.array_equal(logged, bits["a"])


def test_stochastic_model_sessions():
    """``brunel(0.01, poisson_input=True)`` (the lif+poisson composite):
    a wave of two sessions against the reference's engine with its
    uniforms injected, and bitwise against the port's own solo runs on
    its own draws."""
    seeds = {"a": 5, "b": 9}
    ref = RefSessionEngine(max_sessions=3, sweep="flat")
    ra = ref.create("brunel", seed=5, scale=SCALE, poisson_input=True)
    rb = ref.create("brunel", seed=9, scale=SCALE, poisson_input=True)
    ref_w = ref.step_wave([ra, rb], n=60)
    uniforms = {m: _ref_uniforms(ref, s, 60) for m, s in seeds.items()}
    for make_inputs in (True, False):
        eng = _engine(max_sessions=3, sweep="cuda")
        sid = {m: eng.create("brunel", seed=s, scale=SCALE,
                             poisson_input=True) for m, s in seeds.items()}
        kw = ({"model_uniform": {sid[m]: u for m, u in uniforms.items()}}
              if make_inputs else {})
        w = eng.step_wave(list(sid.values()), n=60, **kw)
        for m, r in (("a", ra), ("b", rb)):
            got = w[sid[m]]
            assert got.sum() > 0, "vacuous: no spikes fired"
            if make_inputs:
                np.testing.assert_array_equal(got, np.asarray(ref_w[r]))
            else:
                _, want = _solo(eng, seeds[m], 60)
                np.testing.assert_array_equal(got, want.numpy())


# --------------------------------------------------------------------------
# eviction, backpressure, supervision
# --------------------------------------------------------------------------

def test_evict_restore_continue_bit_exact(tmp_path):
    """One slot, two tenants, drive on (the generator's state rides the
    checkpoint): stepping B evicts A; stepping A again restores it and
    evicts B.  Both stitched trajectories equal their uninterrupted runs;
    A's snapshot while evicted equals the one taken while resident."""
    eng = _engine(max_sessions=1, sweep="cuda", ckpt_dir=str(tmp_path))
    a = eng.create("brunel", seed=0, scale=SCALE)
    chunks = [eng.step(a, 60)]
    resident_snap, resident_md = eng.snapshot(a)
    b = eng.create("brunel", seed=1, scale=SCALE)   # parks in the queue
    assert eng.session_info(b)["status"] == "queued"
    b_bits = [eng.step(b, 60)]                      # evicts A (LRU)
    info = eng.session_info(a)
    assert info["status"] == "evicted" and info["committed_step"] == 60
    evicted_snap, evicted_md = eng.snapshot(a)
    _assert_same_state(evicted_snap, resident_snap, "evicted snapshot")
    assert evicted_md == resident_md
    chunks.append(eng.step(a, N_STEPS - 60))        # restores A, evicts B
    assert eng.session_info(b)["status"] == "evicted"
    b_bits.append(eng.step(b, 40))                  # restores B
    bits = np.concatenate(chunks, axis=0)
    assert bits.sum() > 0, "vacuous: no spikes fired"
    want_fin, want = _solo(eng, 0, N_STEPS)
    np.testing.assert_array_equal(bits, want.numpy())
    _, want_b = _solo(eng, 1, 100)
    np.testing.assert_array_equal(np.concatenate(b_bits), want_b.numpy())
    eng.step(b, 1)                                  # evicts A again
    _assert_same_state(eng.snapshot(a)[0], want_fin, "A after 160 steps")


def test_slot_exhaustion_is_backpressure_not_exception():
    """No ckpt_dir -> no eviction: a full engine answers with a falsy
    Backpressure value (queue first, then hard backpressure), and close()
    pumps the queue."""
    eng = _engine(max_sessions=1, sweep="flat", queue_limit=1)
    a = eng.create("brunel", seed=0, scale=SCALE)
    assert eng.session_info(a)["status"] == "resident"
    b = eng.create("brunel", seed=1, scale=SCALE)
    assert eng.session_info(b)["status"] == "queued"
    c = eng.create("brunel", seed=2, scale=SCALE)
    assert isinstance(c, Backpressure) and not c
    assert c.resident == 1 and c.queued == 1
    # stepping the parked session cannot displace anyone without a
    # checkpoint path - clean backpressure again, nobody's state moved
    r = eng.step(b, 4)
    assert isinstance(r, Backpressure) and not r
    assert isinstance(eng.step_wave([a, b], 4), Backpressure)
    assert eng.session_info(a)["step"] == 0
    eng.close(a)                       # frees the slot; b is promoted
    assert eng.session_info(b)["status"] == "resident"
    assert eng.step(b, 4).shape == (4, eng.graph.n_local)
    assert eng.stats()["closed"] == 1
    with pytest.raises(KeyError):
        eng.step(a, 1)                 # closed sessions are gone


def test_supervised_crash_restores_all_residents(tmp_path):
    """run_supervised under an injected kill at its step 47, drive on:
    both tenants restore from the commit at 40 and replay to exactly the
    uninterrupted trajectories; a third session, evicted, is untouched."""
    eng = _engine(max_sessions=2, sweep="cuda", ckpt_dir=str(tmp_path))
    a = eng.create("brunel", seed=0, scale=SCALE)
    b = eng.create("brunel", seed=1, scale=SCALE)
    eng.step_wave([a, b], n=100)       # pre-roll into the spiking regime
    inj = FaultInjector([FaultSpec.parse("kill@47")], mode="raise")
    sup = eng.run_supervised(60, save_every=20, injector=inj,
                             policy=RestartPolicy(backoff_s=0.001))
    kinds = [e.split("@")[0] for e in sup.events]
    assert "fail" in kinds and "restore" in kinds
    assert "restore@40" in sup.events
    for sid, seed in ((a, 0), (b, 1)):
        assert eng.session_info(sid)["step"] == 160
        assert eng.session_info(sid)["committed_step"] == 160
        first, bits = eng.spikes(sid)
        assert bits.sum() > 0, "vacuous: no spikes fired"
        want_fin, solo = _solo(eng, seed, 160)
        np.testing.assert_array_equal(bits, solo.numpy()[first:])
        _assert_same_state(eng.snapshot(sid)[0], want_fin,
                           f"session {sid}")


def test_supervised_crash_before_any_commit_rewinds(tmp_path):
    """A kill before the first commit rewinds a never-committed session
    to its t = 0 state and a fresh generator; the replay equals the
    uninterrupted run and the log holds no step twice."""
    eng = _engine(max_sessions=1, sweep="flat", ckpt_dir=str(tmp_path))
    a = eng.create("brunel", seed=3, scale=SCALE)
    inj = FaultInjector([FaultSpec.parse("kill@7")], mode="raise")
    sup = eng.run_supervised(N_STEPS, save_every=50, injector=inj,
                             policy=RestartPolicy(backoff_s=0.001))
    assert "restore@0" in sup.events
    first, bits = eng.spikes(a)
    assert first == N_STEPS - len(bits) and bits.sum() > 0
    _, solo = _solo(eng, 3, N_STEPS)
    np.testing.assert_array_equal(bits, solo.numpy()[first:])


# --------------------------------------------------------------------------
# the slot batch and the engine's small contracts
# --------------------------------------------------------------------------

def _tiny_engine(max_sessions=2, sweep="flat"):
    eng = _engine(max_sessions=max_sessions, sweep=sweep)
    for seed in range(max_sessions):
        eng.create("brunel", seed=seed, scale=SCALE)
    return eng


def test_slot_batch_functions_leave_inputs_unchanged():
    eng = _tiny_engine()
    old = eng._batch
    old_states = old.states
    snap = [_leaves(engine.clone_state(s)) for s in old_states]
    new, bits = eng._step_fn(old, np.array([True, False]), 3)
    assert old.states is old_states
    for s, want in zip(old.states, snap):
        got = _leaves(s)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert not bits[:, 1].any()
    assert new.states[1] is old.states[1]            # untouched slot
    assert int(new.states[0].t) == 3 and int(old.states[0].t) == 0
    picked = engine.masked_select(torch.tensor([False, True]), new, old)
    assert picked.states == (old.states[0], new.states[1])
    assert new.states[0] is not old.states[0]
    put = engine.set_slot_state(old, 1, new.states[0])
    assert put.states[1] is new.states[0] and old.states[1] is not \
        new.states[0]
    assert engine.slot_state(put, 0) is old.states[0]
    assert engine.set_slot_state(put, 0, None).states[0] is None
    with pytest.raises(ValueError, match=r"active mask must be \(2,\)"):
        eng._step_fn(old, np.ones(3, bool))
    with pytest.raises(ValueError, match="active but holds no state"):
        eng._step_fn(engine.stack_states([None, None]), [True, False])
    with pytest.raises(ValueError, match="drive must be"):
        eng._step_fn(old, [True, True], 2,
                     drive=torch.zeros(2, 1, eng.graph.n_local))


def test_stack_states_refuses_mixed_markers():
    eng = _tiny_engine()
    s0 = engine.slot_state(eng._batch, 0)
    other = dataclasses.replace(s0, weights_layout="blocked:1x1")
    with pytest.raises(ValueError, match="mixed static markers"):
        engine.stack_states([s0, other])
    with pytest.raises(ValueError, match="mixed static markers"):
        engine.set_slot_state(eng._batch, 1, other)
    assert len(engine.stack_states([s0, None, s0])) == 3


def test_step_context_and_step_fn():
    """``make_step_fn`` is ``engine_step`` with everything bound;
    ``StepContext.init_state`` is ``init_state`` in the native layout."""
    eng = _tiny_engine(sweep="cuda")
    ctx = eng.ctx
    st = ctx.init_state(list(eng.spec.groups), 4)
    want = engine.init_state(eng.graph, list(eng.spec.groups), 4,
                             sweep="cuda", device=CPU)
    _assert_same_state(st, want, "init_state")
    assert st.weights_layout.startswith("blocked:")
    step = engine.make_step_fn(eng.graph, eng.param_table, eng.cfg)
    a, bits_a = step(st)
    b, bits_b = engine.engine_step(want, eng.graph, eng.param_table,
                                   eng.cfg)
    assert torch.equal(bits_a, bits_b)
    _assert_same_state(a, b, "one step")
    with pytest.raises(ValueError, match="max_sessions must be >= 1"):
        engine.make_session_step_fn(eng.graph, eng.param_table, eng.cfg, 0)


@pytest.mark.parametrize("name,kw", [
    ("brunel", dict(scale=SCALE)), ("brunel", dict(scale=SCALE,
                                                   poisson_input=True)),
    ("hpc_benchmark", dict(scale=0.02, stdp=True))])
def test_scenario_id_and_metadata_match_reference(name, kw):
    eng = _engine(max_sessions=1)
    sid = eng.create(name, seed=7, **kw)
    ref_spec, _ = ref_models.get_scenario(name, **kw)
    ref_id = ref_models.scenario_id(ref_spec)
    assert eng.scenario_id == ref_id == models.scenario_id(eng.spec)
    _, md = eng.snapshot(sid)
    assert md == ref_session_metadata(ref_spec, seed=7, session_id=sid,
                                      step=0,
                                      extra={"scenario_id": ref_id})


def test_one_scenario_per_engine_and_the_device_rule():
    eng = _engine(max_sessions=2)
    eng.create("brunel", seed=0, scale=SCALE)
    with pytest.raises(ValueError, match="ONE scenario"):
        eng.create("brunel", seed=1, scale=0.02)
    with pytest.raises(ValueError, match="ONE scenario"):
        eng.create("hpc_benchmark", seed=1, scale=0.02)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SessionEngine()
    with pytest.raises(ValueError, match="unknown sweep backend"):
        _engine(sweep="triton")
    with pytest.raises(RuntimeError, match="no sessions"):
        _engine(ckpt_dir="unused").run_supervised(1)
    with pytest.raises(RuntimeError, match="needs ckpt_dir"):
        eng.run_supervised(1)
