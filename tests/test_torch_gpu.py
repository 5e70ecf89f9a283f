"""Port kernels on the card: each CUDA kernel against its plain-torch twin.

These cases need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports no JAX, so it also runs where only the port's
dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import builder, engine, models, snn
from repro_torch.kernels import lif_step as lif_mod
from repro_torch.kernels import stdp_update as stdp_mod
from repro_torch.kernels import synaptic_gather as gather_mod

pytestmark = pytest.mark.gpu

STDP_PARAMS = (0.1, 0.0513, 0.4, 45.61, 0.0, 200.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def sorted_blocked(rng, nb, eb, pb, m, d_max):
    """Random blocked ELL arrays in the builder's slot order: each block's
    live slots sorted by (delay, post), padding (delay 0) at the tail."""
    pre = np.zeros((nb, eb), np.int32)
    post = np.zeros((nb, eb), np.int32)
    delay = np.zeros((nb, eb), np.int32)
    for b in range(nb):
        live = int(rng.integers(eb // 2, eb + 1))
        d = rng.integers(1, d_max + 1, live)
        p = rng.integers(0, pb, live)
        order = np.lexsort((p, d))
        delay[b, :live], post[b, :live] = d[order], p[order]
        pre[b, :live] = rng.integers(0, m, live)
    w = rng.normal(0, 50, (nb, eb)).astype(np.float32)
    chan = rng.integers(0, 2, (nb, eb)).astype(np.int32)
    return pre, post, w, delay, chan


@pytest.mark.parametrize("t", [0, 3, 1001])
@pytest.mark.parametrize("with_fresh", [False, True])
def test_gather_kernel_matches_plain(cuda, with_fresh, t):
    rng = np.random.default_rng(5 + t)
    pre, post, w, delay, chan = sorted_blocked(rng, 3, 512, 64, 700, 16)
    ring = (rng.uniform(size=(16, 700)) < 0.3).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda)
            for x in (pre, post, w, delay, chan, ring)]
    fresh = (torch.from_numpy((rng.uniform(size=700) < 0.3)
                              .astype(np.float32)).to(cuda)
             if with_fresh else None)
    tt = torch.tensor(t, dtype=torch.int32, device=cuda)
    launches = gather_mod.synaptic_gather.launches
    outs = [gather_mod.synaptic_gather(*args, tt, max_delay=16, pb=64,
                                       fresh=fresh) for _ in range(2)]
    assert gather_mod.synaptic_gather.launches == launches + 2
    plain = gather_mod.synaptic_gather_plain(*args, tt, max_delay=16, pb=64,
                                             fresh=fresh)
    for a, b in zip(*outs):
        assert torch.equal(a, b)  # no atomics: bitwise deterministic
    assert torch.equal(outs[0][2], plain[2])
    for k in (0, 1):  # summation order differs from index_add_'s
        torch.testing.assert_close(outs[0][k], plain[k], rtol=0, atol=1e-3)


def test_gather_kernel_checks_its_arguments(cuda):
    rng = np.random.default_rng(0)
    pre, post, w, delay, chan = sorted_blocked(rng, 1, 128, 32, 50, 4)
    args = [torch.from_numpy(x).to(cuda) for x in (pre, post, w, delay, chan)]
    ring = torch.zeros((4, 50), device=cuda)
    t = torch.tensor(0, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="weight has dtype"):
        gather_mod.synaptic_gather(*args[:2], args[2].double(), *args[3:],
                                   ring, t, max_delay=4, pb=32)
    with pytest.raises(ValueError, match="ring is on"):
        gather_mod.synaptic_gather(*args, ring.cpu(), t, max_delay=4, pb=32)


def _lif_inputs(rng, n, groups, cuda):
    gs = [snn.LIFParams(tau_m=10.0 + 5 * i, t_ref=0.5 + i,
                        tau_syn_ex=0.5 + 0.2 * i) for i in range(groups)]
    f32 = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    arrays = [f32(-52, -48), f32(0, 100), f32(-100, 100),
              rng.integers(0, 4, n).astype(np.int32),
              rng.integers(0, groups, n).astype(np.int32),
              f32(0, 500), f32(-50, 0)]
    return ([torch.from_numpy(a).to(cuda) for a in arrays],
            snn.make_param_table(gs, 0.1, device=cuda))


@pytest.mark.parametrize("cond", [False, True])
def test_lif_kernel_matches_plain(cuda, cond):
    args, table = _lif_inputs(np.random.default_rng(3), 1000, 3, cuda)
    out_k = lif_mod.lif_step(*args, table, cond=cond)
    out_p = lif_mod.lif_step_plain(*args, table, cond=cond)
    assert out_k[4].any(), "no spikes - vacuous"
    for k, p in zip(out_k, out_p):
        # the same op order, no FMA contraction on either side: bitwise
        assert torch.equal(k, p)


@pytest.mark.parametrize("pb", [0, 64])
def test_stdp_kernel_matches_plain(cuda, pb):
    rng = np.random.default_rng(9)
    eb, nb, m = 256, 3, 200
    e, nl = eb * nb, nb * 64
    post = rng.integers(0, pb if pb else nl, e).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (
        rng.uniform(1, 100, e).astype(np.float32),
        rng.integers(0, m, e).astype(np.int32), post,
        rng.uniform(size=e) < 0.7,
        (rng.uniform(size=e) < 0.3).astype(np.float32),
        (rng.uniform(size=nl) < 0.3).astype(np.float32),
        rng.uniform(0, 3, m).astype(np.float32),
        rng.uniform(0, 3, nl).astype(np.float32))]
    w_k = stdp_mod.stdp_update(*args, params=STDP_PARAMS, eb=eb, pb=pb)
    w_p = stdp_mod.stdp_update_plain(*args, params=STDP_PARAMS, eb=eb,
                                     pb=pb)
    assert not torch.equal(w_k, args[0]), "no update - vacuous"
    # expf/logf against torch's exp/log kernels: a few ulps
    torch.testing.assert_close(w_k, w_p, rtol=2e-6, atol=0)


def test_cuda_backend_steps_through_the_kernels(cuda):
    """hpc_benchmark(0.02) on the card: the kernel backend and the flat
    backend give the same spikes over 200 steps of one injected drive, and
    each kernel launches once per step."""
    spec, stdp = models.hpc_benchmark(0.02, stdp=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(cuda)
    table = snn.make_param_table(list(spec.groups), 0.1, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    lam = (g.ext_rate * 1e-4).expand(200, -1)
    drive = g.ext_weight * torch.poisson(lam * 1.5, generator=gen)
    runs = {}
    for sweep in ("cuda", "flat"):
        before = [f.launches for f in (gather_mod.synaptic_gather,
                                       lif_mod.lif_step,
                                       stdp_mod.stdp_update)]
        st = engine.init_state(g, list(spec.groups), 0, device=cuda)
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep)
        runs[sweep] = engine.run(st, g, table, cfg, 200, drive=drive,
                                 device=cuda)
        after = [f.launches for f in (gather_mod.synaptic_gather,
                                      lif_mod.lif_step,
                                      stdp_mod.stdp_update)]
        want = 200 if sweep == "cuda" else 0
        assert [a - b for a, b in zip(after, before)] == [want] * 3
    (fc, sc), (ff, sf) = runs["cuda"], runs["flat"]
    assert sf.sum() > 0, "no spikes - vacuous"
    assert torch.equal(sc, sf)
    torch.testing.assert_close(fc.weights, ff.weights, rtol=0, atol=1e-4)
