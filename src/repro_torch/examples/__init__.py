"""The repository's entry points (``examples/*.py``) as the port's CLIs.

One module per script, with the script's file name::

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.run_scenario --scenario microcircuit
    python -m repro_torch.examples.simulate_marmoset --grid 2x2
    python -m repro_torch.examples.serve_snn --sessions 4 --steps 400
    python -m repro_torch.examples.fit_brunel --smoke
    python -m repro_torch.examples.serve_lm
    python -m repro_torch.examples.train_lm --steps 60

Each keeps every flag of its script, with the script's name and default,
and adds ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
twins, and ``cuda`` without a card raises).  The SNN drivers that take
``--sweep`` default to ``"cuda"`` (the hand-written kernels; the
script's ``"flat"`` stays selectable).  Where a script switches to the
sharded engine because JAX sees more than one device, the port's driver
takes ``--grid ROWSxWIDTH`` (default ``1x1``) and steps the stacked
shards on the one card.

Each module's ``main(argv=None) -> dict`` prints the script's lines in its
format and order and returns the record it printed (plus the arrays a
caller checks), so tests and ``chip_smoke.py`` drive the same code a user
types.  Spike counts are summed on the device and read once: no driver
synchronises with the host every step.
"""

from __future__ import annotations

import argparse

__all__ = ["add_device", "add_grid", "parse_grid", "WINDOW_STEPS"]

#: steps per rate window in the drivers' records (25 ms at dt = 0.1 ms; the
#: window of ``scripts/reference_zoo_rates.py``)
WINDOW_STEPS = 250


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the hand-written kernels; "
                         "raises without a card) or cpu (their plain twins)")


def parse_grid(text: str) -> tuple[int, int]:
    """``"ROWSxWIDTH"`` -> ``(rows, width)``, both at least 1."""
    try:
        rows, width = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--grid wants ROWSxWIDTH (e.g. 2x2), got {text!r}") from None
    if rows < 1 or width < 1:
        raise argparse.ArgumentTypeError(f"--grid {text!r}: both >= 1")
    return rows, width


def add_grid(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--grid", type=parse_grid, default=(1, 1),
                    help="ROWSxWIDTH shards stepped together on the one "
                         "device (the script's multi-device branch); 1x1 "
                         "is the single-shard engine")
