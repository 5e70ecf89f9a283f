"""Port multi-tenant SNN sessions: each session bitwise its own solo
``engine.run`` on the port's own drive, on ``flat``, ``cuda``,
``bucketed`` and a gate that updates weights in place.  The cases of
``test_torch_sessions.py`` (whose helpers they use) in a file of their
own, so that the run's workers share their time."""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import numpy as np
import pytest

from repro_torch.core import engine

from test_torch_sessions import (SEEDS, _assert_same_state, _boosted_hpc,
                                 _drive_interleave, _engine, _solo)


# --------------------------------------------------------------------------
# each session bitwise its own solo run, the port's own draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sweep,scale", [
    ("flat", 0.02), ("cuda", 0.02), ("bucketed", 0.02),
    # the forced gate updates weights in place (K7): at scale 0.2 its
    # capacity, 8 blocks, is below the 9 blocks of the net
    ("cuda:sparse:1e-7", 0.2)])
def test_sessions_bitwise_their_solo_runs(sweep, scale):
    """Two sessions, drive on, a ragged interleave: each session's raster
    and final state (flat weights, ``v_m``, traces, ring, generator)
    equal its uninterrupted ``engine.run`` bitwise.  On the in-place
    gate this pins that no two slots share a tensor or a generator."""
    spec, stdp = _boosted_hpc(scale)
    eng = _engine(max_sessions=3, sweep=sweep)
    plan = (("a", 40), (("a", "b"), 80), ("b", 80), ("a", 40))
    bits, sid = _drive_interleave(
        eng, lambda e, seed: e.create(spec, seed=seed, stdp=stdp),
        plan=plan)
    slots = [engine.slot_state(eng._batch, eng.table.get(s).slot)
             for s in sid.values()]
    assert slots[0].weights.data_ptr() != slots[1].weights.data_ptr()
    assert slots[0].generator is not slots[1].generator
    if sweep.startswith("cuda:sparse"):
        assert eng.ctx.backend.stdp_in_place(eng.ctx.layout)
    for m, s in sid.items():
        want, want_bits = _solo(eng, SEEDS[m], len(bits[m]))
        assert want_bits.sum() > 0, "vacuous: no spikes fired"
        np.testing.assert_array_equal(bits[m], want_bits.numpy())
        got, md = eng.snapshot(s)
        assert md["session"] == {"id": s, "step": len(bits[m])}
        _assert_same_state(got, want, f"{sweep} session {m}")
