"""Multi-tenant SNN serving: N resident brunel sessions on the card.

The port of ``examples/serve_snn.py``.  The session engine (DESIGN.md
§16) holds every tenant's state as one slot of a fixed batch and advances
the residents through one resolved step - the graph, parameter table and
backend are built once, per-session cost is a slot of state.  This
driver:

1. creates N sessions with different seeds (same network - one engine
   serves ONE scenario),
2. steps them interleaved - solo steps, partial waves, full waves -
   exactly as an interactive multi-tenant workload would,
3. streams each session's recent spike window and prints per-tenant rates,
4. (with --ckpt-dir) over-subscribes the slots so sessions park in the
   queue and eviction round-trips through the checkpoint manager.

    python -m repro_torch.examples.serve_snn --sessions 4 --steps 400
    python -m repro_torch.examples.serve_snn --sessions 4 --slots 2 \\
        --ckpt-dir /tmp/snn_sessions --steps 400

Modules: ``serve/snn.py::SessionEngine``, ``serve/sessions.py``,
``core/engine.py::make_session_step_fn``, ``checkpoint/manager.py``
(eviction).  On ``"cuda"`` each session-step launches K1 with the LIF
step as its epilogue.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import models
from repro_torch.examples import add_device
from repro_torch.serve.sessions import Backpressure
from repro_torch.serve.snn import SessionEngine

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--slots", type=int, default=None,
                    help="resident slots (default: --sessions; fewer "
                         "slots + --ckpt-dir exercises eviction)")
    ap.add_argument("--steps", type=int, default=400,
                    help="steps per session (dt=0.1 ms)")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--sweep", default="cuda",
                    help="execution backend: cuda | cuda:sparse | flat | "
                         "bucketed")
    ap.add_argument("--ckpt-dir", default=None,
                    help="enables eviction (and slot over-subscription)")
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    slots = args.slots or args.sessions
    eng = SessionEngine(max_sessions=slots, sweep=args.sweep,
                        ckpt_dir=args.ckpt_dir, device=args.device)
    sids, created, refused = [], [], []
    for seed in range(args.sessions):
        sid = eng.create("brunel", seed=seed, scale=args.scale)
        if isinstance(sid, Backpressure):
            print(f"seed {seed}: backpressure ({sid.reason})")
            refused.append({"seed": seed, "reason": sid.reason})
            continue
        sids.append(sid)
        status = eng.session_info(sid)["status"]
        created.append({"sid": sid, "seed": seed, "status": status})
        print(f"session {sid}: seed={seed} status={status}")

    n = eng.graph.n_local
    print(f"\nnetwork: {n} neurons/session x {slots} slots, "
          f"backend={args.sweep}")

    # interleaved workload: a solo warmup for session 0, then half-waves,
    # then everyone in lockstep for the remainder
    eng.step(sids[0], 40)
    half = sids[:max(len(sids) // 2, 1)]
    eng.step_wave(half, n=40)
    done = {sid: eng.session_info(sid)["step"] for sid in sids}
    remaining = {sid: args.steps - done[sid] for sid in sids}
    # ragged tails: step each session to the same final step count
    for sid in sids:
        r = eng.step(sid, remaining[sid])
        if isinstance(r, Backpressure):   # parked + no eviction path
            print(f"session {sid}: backpressure ({r.reason})")
            refused.append({"sid": sid, "reason": r.reason})

    print(f"\nper-session rates over the last {min(args.steps, 200)} "
          f"recorded steps:")
    sessions = {}
    for sid in sids:
        info = eng.session_info(sid)
        if info["step"] == 0:
            continue
        first, bits = eng.spikes(sid, window=200)
        rate = models.firing_rate_hz(np.asarray(bits, np.float32), n)
        sessions[sid] = {"step": info["step"], "status": info["status"],
                         "rate_hz": rate,
                         "window": [first, first + len(bits)]}
        print(f"  session {sid}: step={info['step']:>5} "
              f"status={info['status']:>8} rate={rate:6.2f} Hz "
              f"(window [{first}, {first + len(bits)}))")

    s = eng.stats()
    print(f"\nengine: slots={s['slots']} resident={s['resident']} "
          f"evicted={s['evicted']} queued={s['queued']}")
    return {"created": created, "refused": refused, "sessions": sessions,
            "stats": s, "neurons": n, "sweep": args.sweep}


if __name__ == "__main__":
    main(sys.argv[1:])
