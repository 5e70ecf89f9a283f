"""The reference's reduced brunel inversion fit on the port's own draws
(``tests/test_diff.py``'s acceptance smoke).  A case of
``test_torch_train.py`` in a file of its own, so that the run's workers
share its time.  Runs on the CPU (``device="cpu"``).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses

import pytest

from repro_torch.diff import inverse

CPU = "cpu"


def test_brunel_inversion_smoke():
    """The reference's reduced fit on the port's own draws: the loss
    descends and lands within the reference's loose bars (0.25 in g, 0.05
    in eta)."""
    res = inverse.invert_brunel(
        init_g=4.0, init_eta=2.2, n_steps=300, adam_iters=8,
        g_rounds=((0.12, 5),), eta_radii=(0.003, 0.001), eta_points=4,
        device=CPU)
    assert res.final_loss < res.loss_history[0]
    assert res.rel_error["g"] <= 0.25
    assert res.rel_error["eta"] <= 0.05
    assert res.n_evals == 8 + 4 * (1 + 2 * 4)
    with pytest.raises(ValueError, match="n_bins"):
        inverse.BrunelInversion(n_steps=100, n_bins=6, device=CPU)
    assert dataclasses.asdict(res)["true_g"] == 5.0
