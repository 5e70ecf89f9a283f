"""The port's gradient compression (``repro_torch.train.grad_compress``)
against the reference's (``repro.train.grad_compress``).

* ``quantize``, ``dequantize`` and ``ef_compress_step`` bitwise the
  reference's on seeded inputs, ties included (round half to even);
* the reference's three cases (``tests/test_train_substrate.py``): the
  round-trip bound, the bounded error-feedback residual (over ten seeds
  instead of hypothesis' draws) and the mean preserved over rounds;
* the cross-pod reduce over two gloo ranks (two pods) bitwise the
  reference's formula in numpy, compressed and plain, and the identity
  without a ``"pod"`` axis.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import grad_compress as ref_gc
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.train import grad_compress as gc

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _inputs(seed, shape=(64, 32), scale=3.0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_match_reference(seed):
    x = _inputs(seed)
    q, s = gc.quantize(torch.from_numpy(x))
    rq, rs = ref_gc.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    np.testing.assert_array_equal(gc.dequantize(q, s).numpy(),
                                  np.asarray(ref_gc.dequantize(rq, rs)))


def test_quantize_rounds_half_to_even_and_floors_the_scale():
    """Ties go to even (2.5 -> 2, 3.5 -> 4, as ``jnp.round``), values clip
    at +-127, and an all-zero tensor takes the 1e-12 floor."""
    x = torch.tensor([127.0, 2.5, 3.5, -2.5, -127.0])
    q, s = gc.quantize(x)
    assert s.item() == np.float32(1.0)
    assert q.tolist() == [127, 2, 4, -2, -127]
    rq, _ = ref_gc.quantize(jnp.asarray(x.numpy()))
    assert q.tolist() == np.asarray(rq).tolist()
    q0, s0 = gc.quantize(torch.zeros(5))
    assert s0.item() == np.float32(np.float32(1e-12) / np.float32(127.0))
    assert q0.abs().max() == 0


@pytest.mark.parametrize("seed", [0, 7])
def test_ef_compress_step_matches_reference(seed):
    g = _inputs(seed, (257,), 1.0)
    err = _inputs(seed + 100, (257,), 0.01)
    got = gc.ef_compress_step(torch.from_numpy(g), torch.from_numpy(err))
    want = ref_gc.ef_compress_step(jnp.asarray(g), jnp.asarray(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_init_error_state_is_zero_fp32_like_the_tree():
    tree = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
            "b": [torch.ones(4)]}
    err = gc.init_error_state(tree)
    assert err["w"].dtype == torch.float32 and err["w"].shape == (3, 2)
    assert err["b"][0].shape == (4,) and not err["b"][0].any()


# -- the reference's three cases ---------------------------------------------

def test_quantize_roundtrip_bound():
    x = torch.from_numpy(_inputs(0))
    q, s = gc.quantize(x)
    err = (gc.dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("seed", range(10))
def test_error_feedback_bounded(seed):
    """The EF residual stays bounded over repeated rounds on a fixed
    gradient."""
    g = torch.from_numpy(_inputs(seed, (32,), 1.0))
    err = torch.zeros_like(g)
    for _ in range(20):
        _, scale, err = gc.ef_compress_step(g, err)
    assert float(err.abs().max()) <= float(scale) * 1.0 + 1e-5


def test_ef_mean_preserved_over_time():
    """Averaged over rounds, the sent values converge to the true gradient
    (the EF property that preserves SGD's convergence)."""
    g = torch.tensor([0.3, -0.7, 1.1, 0.001])
    err = torch.zeros_like(g)
    sent_sum = torch.zeros_like(g)
    n = 50
    for _ in range(n):
        q, s, err = gc.ef_compress_step(g, err)
        sent_sum = sent_sum + gc.dequantize(q, s)
    np.testing.assert_allclose((sent_sum / n).numpy(), g.numpy(), atol=5e-3)


# -- the cross-pod reduce -----------------------------------------------------

def test_reduce_is_the_identity_without_a_pod_axis():
    grads = {"w": torch.randn(3, 2), "b": torch.randn(4)}
    err = gc.init_error_state(grads)
    for mesh in (make_production_mesh(multi_pod=False),
                 make_test_mesh((2, 2))):
        out, new_err = gc.make_cross_pod_reduce(mesh)(grads, err)
        assert out is grads and new_err is err


POD_CODE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import grad_compress as gc

    rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    tdist.init_process_group("gloo", init_method=addr, world_size=2,
                             rank=rank)
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    rng = np.random.default_rng(rank)
    grads = {"w": torch.from_numpy(rng.normal(0, 1 + rank, (16, 8))
                                   .astype(np.float32)),
             "b": [torch.from_numpy(rng.normal(0, 0.1, 5)
                                    .astype(np.float32))]}
    err = {"w": torch.from_numpy(rng.normal(0, 0.01, (16, 8))
                                 .astype(np.float32)),
           "b": [torch.zeros(5)]}
    red, new_err = gc.make_cross_pod_reduce(mesh)(grads, err)
    plain, same = gc.make_cross_pod_reduce(mesh, compress=False)(grads, err)
    res = dict(
        g={"w": grads["w"].tolist(), "b": grads["b"][0].tolist()},
        err={"w": err["w"].tolist(), "b": err["b"][0].tolist()},
        red={"w": red["w"].tolist(), "b": red["b"][0].tolist()},
        new_err={"w": new_err["w"].tolist(), "b": new_err["b"][0].tolist()},
        plain={"w": plain["w"].tolist(), "b": plain["b"][0].tolist()},
        same=same["w"] is err["w"] and same["b"][0] is err["b"][0])
    with open(f"{out}/pod{rank}.json", "w") as f:
        json.dump(res, f)
    tdist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_quantize(x):
    """The reference's quantize in numpy, float32 throughout."""
    scale = np.maximum(np.abs(x).max(), np.float32(1e-12)) / np.float32(127)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


def test_cross_pod_reduce_over_two_gloo_ranks(tmp_path):
    """Two pods, one gloo rank each: every rank gets the reference's
    reduce, ``sum_p dequant(q_p, s_p) / 2`` over the pods' error-fed
    payloads, bitwise, and its own residual ``target - sent``; the plain
    reduce is the mean."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", POD_CODE, str(r), addr, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    ranks = [json.loads((tmp_path / f"pod{r}.json").read_text())
             for r in range(2)]
    f32 = lambda x: np.asarray(x, np.float32)
    for leaf in ("w", "b"):
        targets = [f32(r["g"][leaf]) + f32(r["err"][leaf]) for r in ranks]
        packed = [_np_quantize(t) for t in targets]
        summed = np.zeros_like(targets[0])
        for q, s in packed:
            summed = summed + q.astype(np.float32) * s
        want = summed / np.float32(2)
        mean = (f32(ranks[0]["g"][leaf]) + f32(ranks[1]["g"][leaf])) \
            / np.float32(2)
        for r, rank in enumerate(ranks):
            np.testing.assert_array_equal(f32(rank["red"][leaf]), want)
            q, s = packed[r]
            np.testing.assert_array_equal(
                f32(rank["new_err"][leaf]),
                targets[r] - q.astype(np.float32) * s)
            np.testing.assert_array_equal(f32(rank["plain"][leaf]), mean)
            assert rank["same"]
    assert np.abs(want).max() > 0
