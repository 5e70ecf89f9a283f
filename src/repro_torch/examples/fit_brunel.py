"""Parameter inversion demo: recover brunel's (g, eta) by gradient descent
through the simulator (DESIGN.md §17), on the card.

The port of ``examples/fit_brunel.py``: builds the quick-geometry brunel
network at the TRUE parameters, records per-neuron PSTH targets at two
drive conditions, then fits ``(g, eta)`` from a perturbed init: an Adam
descent in log-parameter space through the surrogate-gradient rollout,
followed by an eta-profiled g scan that pins the sharp joint minimum.
The full fit lands within 5% relative error; ``--smoke`` runs the
CI-sized fit (looser landing, 25%).

    python -m repro_torch.examples.fit_brunel --init-g 4.0 --init-eta 2.5
    python -m repro_torch.examples.fit_brunel --smoke

Modules: ``diff/inverse.py::invert_brunel`` (``diff/rollout.py``,
``diff/surrogate.py``, ``core/engine.py``).  Gradients run on the
``"flat"`` backend, as the reference's rollout does, so the fit launches
no hand-written kernel.  ``main`` returns the record; run as a module it
exits 0 when both parameters land inside the bar, else 1.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.diff import inverse
from repro_torch.examples import add_device

__all__ = ["build_parser", "main", "SMOKE"]

#: ``--smoke``'s fit: shorter rollouts, one profiled round
SMOKE = dict(n_steps=300, adam_iters=8, g_rounds=((0.12, 5),),
             eta_radii=(0.003, 0.001), eta_points=4)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="fit brunel (g, eta) from PSTH targets by gradient")
    ap.add_argument("--init-g", type=float, default=4.0,
                    help="perturbed init for g (truth: 5.0)")
    ap.add_argument("--init-eta", type=float, default=2.5,
                    help="perturbed init for eta (truth: 2.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized fit: shorter rollouts, one profiled "
                         "round")
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    kwargs = dict(SMOKE) if args.smoke else {}

    print(f"fitting from init (g={args.init_g}, eta={args.init_eta}) ...")
    t0 = time.perf_counter()
    res = inverse.invert_brunel(args.init_g, args.init_eta,
                                device=args.device, **kwargs)
    dt = time.perf_counter() - t0

    err = res.rel_error
    print(f"  true     g={res.true_g:.4f}  eta={res.true_eta:.4f}")
    print(f"  fitted   g={res.g:.4f}  eta={res.eta:.4f}")
    print(f"  rel err  g={100 * err['g']:.2f}%  "
          f"eta={100 * err['eta']:.2f}%")
    print(f"  loss {res.loss_history[0]:.3e} -> {res.final_loss:.3e} "
          f"({res.n_evals} loss evals, {dt:.0f}s)")
    bar = 0.25 if args.smoke else 0.05
    ok = err["g"] <= bar and err["eta"] <= bar
    print("  OK" if ok else f"  MISSED the {bar:.0%} bar")
    return {"ok": ok, "bar": bar, "g": res.g, "eta": res.eta,
            "true_g": res.true_g, "true_eta": res.true_eta,
            "rel_error": dict(err), "final_loss": res.final_loss,
            "loss_history": list(res.loss_history), "n_evals": res.n_evals,
            "wall_s": dt, "fit": kwargs}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
