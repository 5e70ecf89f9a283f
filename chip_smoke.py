"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the paper's verification case (§IV.A): NEST's
``hpc_benchmark`` with pl-STDP at scale 1 (11 250 neurons, 12.66 M
synapses), built on one shard and stepped by ``engine.run`` through the
``"cuda"`` backend, whose kernels are hand-written CUDA C++ for Hopper
(``src/repro_torch/kernels/csrc/``): K1 with the LIF step as its epilogue
(K1 + K2 in one launch) and K3.  Phases, one JSON line each:

1. device   - the card (``nvidia-smi``), the kernels' build time and the
              registers and spills of K1's four instantiations (``ptxas``:
              K1 alone and with the LIF, Izhikevich and AdEx epilogues);
2. kernel   - K1, K2, K3 and K1 + K2 fused at the main path's shapes on
              seeded random inputs: each against its plain-torch twin
              (tolerance printed), the fused kernel also bitwise against
              K1 -> add -> K2 with the drive on and off, twice for bitwise
              determinism, timed with CUDA events (one call, and per launch
              over many; the fused kernel against K1 alone in turns);
3. lockstep - 120 steps of scale 1 where the ``"cuda"`` and ``"flat"``
              backends start every step from the same state and drive;
4. mixed    - 120 free-running steps of a small mixed network, drive off:
              identical spike rasters on both backends;
5. main     - 2000 steps of scale 1 through ``engine.run``: the fused
              kernel and K3 launched once per step and no other kernel,
              weights bounded, state finite, rate in the
              asynchronous-irregular band; then a profiled window.

The neuron-model zoo, on the same card (``python3 chip_smoke.py`` runs
every phase; each path's launch counts are set to 0 just before it and
read just after):

6. kernel       - K4 ``izhikevich_step`` and K5 ``adex_step`` at 10 000
                  neurons, the ``model_demo`` tables: against their plain
                  twins, deterministic, timed; then K1 + K4 and K1 + K5
                  fused at ``model_demo("izhikevich"|"adex", 1.0)``'s
                  shapes, as K1 + K2 above;
7. zoo_lockstep - ``model_demo("izhikevich"|"adex", 1.0, stdp=True)``, 120
                  steps where the ``"cuda"`` and ``"flat"`` backends start
                  every step from the same state: identical spikes away
                  from ``v_peak``;
8. zoo_main     - the same two networks, 2000 steps each through
                  ``engine.run``: K1 + K4 or K1 + K5 fused, and K3, once
                  per step, state finite, the rate per 250 steps inside a
                  band around the JAX reference's own CPU run
                  (``scripts/reference_zoo_rates.json``, written by
                  ``scripts/reference_zoo_rates.py``, which also sets each
                  network's scale and length here); then each network
                  through ``"cuda:sparse"`` (``zoo_gate``: K6, the
                  standalone K4 or K5, K3 or K7), bitwise equal to the
                  fused run;
9. composite    - ``brunel(1.0, poisson_input=True)`` ("lif+poisson"),
                  2000 steps on the port's own emitter draws: K1 and K2
                  once per step, the emitter rate within 4 sigma, E and I
                  rates inside a band around the reference's, emitter
                  state frozen.

The activity gate (``"cuda:sparse"``, kernels K6 and K7):

10. kernel        - K6 ``blocked_reduce_sweep`` and K7
                    ``stdp_update_worklist`` at the main path's shapes, on
                    a worklist of 8 random blocks of 44 with sentinel
                    padding, the empty list, the identity list, a saturated
                    list and (K6) no list: each against its plain twin,
                    twice for bitwise determinism, K6 bitwise equal to K1's
                    sums and K7 to K3's weights on the listed blocks,
                    timed;
11. gate_main     - ``hpc_benchmark(1.0, stdp=True)``, 2000 steps of
                    ``engine.run`` with ``"cuda:sparse"`` (capacity 44: the
                    dense reduce, no branch) and with
                    ``"cuda:sparse:1e-7"`` (capacity 8), from the ``main``
                    phase's seed: spikes, ``v_m`` and weights bitwise equal
                    to the ``main`` run; ``gate_overflow`` equal to the
                    saturated steps recomputed from the raster, with steps
                    on both branches and K7 updating live blocks;
12. gate_activity - the reference's area-localized gate geometry
                    (``benchmarks/bench_snn.py::_area_localized_layout``)
                    widened to NB 64 x EB 196 608 (12.58 M slots): dense
                    ``"cuda"`` (K1 + K3) against ``"cuda:sparse"`` (pre-pass
                    + K6 + K7) at active fractions 1 to 1/32, bitwise
                    equal, timed.

The LM face's serving path (dense GQA, kernel K8), after the zoo:

13. kernel   - K8 ``flash_attention``: first the built library's SASS,
               counted for HGMMA (``wgmma``) instructions; then qwen2.5-3b's
               prefill shape (q (4, 512, 16, 128), k / v (4, 512, 2, 128),
               bf16, causal), the four fp32 cases of
               ``tests/test_flash_attention.py`` and six bf16 cases (ragged,
               internvl2-1b's heads, cross, dv < dh, no grouping, S = T =
               4096): each through the route its dtype must take (bf16 on
               the tensor cores, fp32 on the CUDA cores), against its plain
               twin (tolerance printed), twice for bitwise determinism,
               timed, beside one call of PyTorch's
               ``scaled_dot_product_attention`` (a yardstick the port never
               calls);
14. lm_serve - ``qwen2.5-3b`` at its full published config (36 layers, no
               cut), weights drawn on the card in bf16 from the seed:
               ``BatchServer(slots=4, max_len=1024)`` serves one wave of
               prompts of 512, 448, 320 and 200 seeded tokens, 32 new tokens
               each.  K8 launches once per layer in the prefill, all on the
               tensor-core route, and never in decode; logits finite; the prefill's logits against the same
               model with K8's plain twin swapped in; a 4-token decode chain
               against ``forward`` over prompt + tokens at those positions;
               a second wave gives the same tokens.  Prints prefill and
               decode times, peak memory and two profiled windows.

Then one line with every kernel's numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero without that last line.  Without a CUDA device
it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
             "is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import backends, builder, engine, models, snn  # noqa: E402
from repro_torch.core import neuron_models  # noqa: E402
from repro_torch.core import stdp as stdp_mod_core  # noqa: E402
from repro_torch.core.decomposition import AreaSpec  # noqa: E402
from repro_torch.core.layout import BlockedGraph  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import adex_step as adex_mod  # noqa: E402
from repro_torch.kernels import izhikevich_step as izh_mod  # noqa: E402
from repro_torch.kernels import lif_step as lif_mod  # noqa: E402
from repro_torch.kernels import stdp_update as stdp_mod  # noqa: E402
from repro_torch.kernels import synaptic_gather as gather_mod  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.models import attention as lm_attn  # noqa: E402
from repro_torch.models import transformer as lm_tr  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import BatchServer  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16, dense tensor cores
SEED = 0
SLEEP_CYCLES = 10_000_000      # ~5 ms at H100 clocks: covers one enqueue
#: each kernel wrapper, counting its launches in ``.launches``
KERNEL_FNS = {"synaptic_gather": gather_mod.synaptic_gather,
              "lif_step": lif_mod.lif_step,
              "stdp_update": stdp_mod.stdp_update,
              "izhikevich_step": izh_mod.izhikevich_step,
              "adex_step": adex_mod.adex_step,
              "blocked_reduce_sweep": gather_mod.blocked_reduce_sweep,
              "stdp_update_worklist": stdp_mod.stdp_update_worklist,
              "flash_attention": fa_mod.flash_attention}
#: K1 with a neuron epilogue: one wrapper, its launches counted by epilogue
FUSED = gather_mod.synaptic_gather_update
FUSED_KERNELS = {"synaptic_gather_lif": "lif",
                 "synaptic_gather_izhikevich": "izhikevich",
                 "synaptic_gather_adex": "adex"}
REPLACES = {"synaptic_gather": "src/repro/kernels/synaptic_gather.py:106",
            "lif_step": "src/repro/kernels/lif_step.py:71",
            "stdp_update": "src/repro/kernels/stdp_update.py:66",
            "izhikevich_step": "src/repro/kernels/izhikevich_step.py:101",
            "adex_step": "src/repro/kernels/adex_step.py:108",
            "blocked_reduce_sweep":
                "src/repro/kernels/synaptic_gather.py:195",
            "stdp_update_worklist": "src/repro/kernels/stdp_update.py:137",
            "flash_attention": "src/repro/kernels/flash_attention.py:80",
            "synaptic_gather_lif": "src/repro/kernels/synaptic_gather.py:106"
                                   " + src/repro/kernels/lif_step.py:71",
            "synaptic_gather_izhikevich":
                "src/repro/kernels/synaptic_gather.py:106"
                " + src/repro/kernels/izhikevich_step.py:101",
            "synaptic_gather_adex": "src/repro/kernels/synaptic_gather.py:106"
                                    " + src/repro/kernels/adex_step.py:108"}
#: the fields a fused kernel must equal its plain twin in bitwise, by
#: epilogue (the membrane, and u, do not depend on this step's sums; AdEx's
#: expf may differ from torch's exp by ulps)
EXACT_FIELDS = {"lif": ("v", "ref_count", "spike"),
                "izhikevich": ("v", "u", "ref_count", "spike"),
                "adex": ("ref_count", "spike")}
#: the kernels of the hpc_benchmark main path (phase 5)
MAIN_KERNELS = ("synaptic_gather_lif", "stdp_update")
#: the counted run whose launches the kernels line reports for a kernel:
#: a path that runs it once per step (K1, K2, K4 and K5 standalone are off
#: the fused main paths: K1 stays before K2 in the composite, K2, K4 and
#: K5 run after K6)
LAUNCHES_FROM = {"synaptic_gather": "composite",
                 "lif_step": "gate_main cuda:sparse:1e-7",
                 "stdp_update": "main",
                 "izhikevich_step": "zoo_gate izhikevich",
                 "adex_step": "zoo_gate adex",
                 "blocked_reduce_sweep": "gate_main cuda:sparse:1e-7",
                 "stdp_update_worklist": "gate_main cuda:sparse:1e-7",
                 "flash_attention": "lm_serve",
                 "synaptic_gather_lif": "main",
                 "synaptic_gather_izhikevich": "zoo_main izhikevich",
                 "synaptic_gather_adex": "zoo_main adex"}
#: the kernels of the gated main path (phase 11), by backend: the
#: full-capacity gate reduces densely through K6 and updates through K3,
#: the forced gate (capacity 8 of 44) runs K6 and K7 on every step
GATE_KERNELS = {"cuda:sparse": ("blocked_reduce_sweep", "lif_step",
                                "stdp_update"),
                "cuda:sparse:1e-7": ("blocked_reduce_sweep", "lif_step",
                                     "stdp_update_worklist")}
#: the zoo's two-variable kernels: model -> (kernel module, its wrapper)
ZOO_KERNELS = {"izhikevich": (izh_mod, izh_mod.izhikevich_step),
               "adex": (adex_mod, adex_mod.adex_step)}
#: the kernels of each zoo network's main path (phase 8): K1 + K4 or
#: K1 + K5 in one launch, then K3
ZOO_MAIN_KERNELS = {"izhikevich": ("synaptic_gather_izhikevich",
                                   "stdp_update"),
                    "adex": ("synaptic_gather_adex", "stdp_update")}
#: launches a run of many launches times, per kernel (``loop_ms``)
LOOP_LAUNCHES = 1000
#: SM clock the sleep ahead of a timed run is sized with (H100 SXM boost);
#: ``loop_ms`` checks that the sleep outlasted the host's enqueue anyway
SLEEP_HZ = 2.0e9
#: the JAX reference's own run of each zoo network on the CPU, by network:
#: its scale, steps, rate window, and per population the rate [Hz] per
#: window and from ``mean_from_step`` on (written by
#: ``scripts/reference_zoo_rates.py``: flat backend, jax.random.key(0),
#: drive off)
with open(os.path.join(ROOT, "scripts", "reference_zoo_rates.json")) as f:
    ZOO_REFERENCE = json.load(f)
#: the card's rates against the reference's: each 250-step window within
#: [0.5, 2] x the reference's (the first windows are transients whose
#: timing may shift by a few steps), the mean rate within 10 % for the
#: deterministic model_demo networks and 15 % for the composite, whose
#: emitters draw other random numbers than the reference's
WINDOW_BAND = (0.5, 2.0)
MEAN_BAND = {"izhikevich": 0.10, "adex": 0.10, "lif+poisson": 0.15}
#: K8's cases (phase 13): (b, s, t, h, hk, dh, dv, causal, dtype); the
#: first is qwen2.5-3b's prefill of the lm_serve wave, then the four fp32
#: cases of tests/test_flash_attention.py (the SIMT route), then bf16 cases
#: of the tensor-core route: qwen2.5-3b's heads at a ragged length (masks
#: in the tail tile), internvl2-1b's LLM heads (14 over 2, dh 64), cross
#: attention with S != T, dh 64 against dv 32, no grouping, and a long
#: causal prefill whose 64 key tiles pass many times through the ring
FLASH_CASES = {
    "qwen2.5-3b_prefill": (4, 512, 512, 16, 2, 128, 128, True,
                           torch.bfloat16),
    "gqa_ragged": (2, 300, 300, 8, 2, 32, 32, True, torch.float32),
    "mha": (1, 128, 128, 4, 4, 16, 16, True, torch.float32),
    "cross": (2, 100, 150, 4, 4, 16, 16, False, torch.float32),
    "dv_ne_dh": (1, 257, 257, 2, 1, 64, 32, True, torch.float32),
    "qwen_heads_ragged": (2, 300, 300, 16, 2, 128, 128, True,
                          torch.bfloat16),
    "internvl2-1b_heads": (2, 333, 333, 14, 2, 64, 64, True,
                           torch.bfloat16),
    "cross_bf16": (2, 100, 150, 4, 4, 64, 64, False, torch.bfloat16),
    "dv_lt_dh_bf16": (1, 257, 257, 2, 1, 64, 32, True, torch.bfloat16),
    "mha_bf16": (1, 200, 200, 8, 8, 128, 128, True, torch.bfloat16),
    "long_causal": (1, 4096, 4096, 16, 2, 128, 128, True, torch.bfloat16),
}
#: the route each dtype's cases must take (``flash_attention._route``)
FLASH_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "simt"}
#: K8 against its twin: fp32 sums in another order; bf16 adds the output's
#: one rounding (one ulp, 2^-7 relative at most)
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
#: the lm_serve cell (phase 14): qwen2.5-3b at its full published config
LM_ARCH = "qwen2.5-3b"
LM_SLOTS, LM_MAX_LEN, LM_NEW_TOKENS = 4, 1024, 32
LM_PROMPT_LENS = (512, 448, 320, 200)
LM_CHAIN = 4
#: bf16 logits (of order 1) of two orders of the same sums through 36
#: layers: the K8/twin swap and the decode chain against forward
LM_LOGIT_ATOL = 0.1
#: the K8/twin swap with the model in fp32: fp32 sums in another order
LM_LOGIT_ATOL_F32 = 1e-3


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls.

    CUDA events bracket each call; a sleep kernel ahead of them keeps the
    stream busy while the host validates and enqueues the call, so the
    events time the device work and not the Python in front of it.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(fn, count: int = LOOP_LAUNCHES, batch: int = 500,
            warmup: int = 3) -> float:
    """Device time per launch of ``fn`` over ``count`` back-to-back
    launches (a small kernel is timed this way because one launch alone is
    shorter than the host's launch overhead): in batches, CUDA events around each batch, and a sleep kernel
    ahead of it sized to outlast the host's enqueue of the whole batch, so
    that the events see the launches run back to back and not the host's
    pace.  A batch whose sleep ended before the host had enqueued it (the
    host was slower than estimated, or the launch queue filled) is not
    counted: it is run again at half the size, down to 50 launches, and
    then the call raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    per_call_s = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    total, left = 0.0, count
    while left > 0:
        k = min(batch, left)
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(int(3 * k * per_call_s * SLEEP_HZ))
        a.record()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if enqueue_ms >= e0.elapsed_time(a):
            check(batch > 50, f"loop_ms: the host took {enqueue_ms} ms to "
                  f"enqueue {k} launches, longer than the sleep of "
                  f"{e0.elapsed_time(a)} ms ahead of them")
            batch //= 2
            continue
        total += a.elapsed_time(b)
        left -= k
    return total / count


def in_turns(fns: dict, rounds: int = 2, count: int = 200) -> dict:
    """``loop_ms`` of each of ``fns`` (two), in turns A B B A per round;
    returns each one's median per-launch ms over its runs."""
    (na, fa), (nb_, fb) = fns.items()
    got = {na: [], nb_: []}
    for _ in range(rounds):
        for name, fn in ((na, fa), (nb_, fb), (nb_, fb), (na, fa)):
            got[name].append(loop_ms(fn, count=count))
    return {k: statistics.median(v) for k, v in got.items()}


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    for fn in (*KERNEL_FNS.values(), FUSED):
        fn.launches = 0
    FUSED.launches_by_neuron.update(dict.fromkeys(FUSED.launches_by_neuron,
                                                  0))


def read_launches() -> dict:
    """Every kernel's launch count, the fused kernel's by epilogue."""
    out = {k: fn.launches for k, fn in KERNEL_FNS.items()}
    out.update({k: FUSED.launches_by_neuron[v]
                for k, v in FUSED_KERNELS.items()})
    return out


def check_launches(what: str, launches: dict, want: dict) -> None:
    """Each kernel of ``want`` launched exactly that often, every other
    kernel never."""
    for k, c in launches.items():
        check(c == want.get(k, 0), f"{what}: {k} launched {c} times, "
              f"expected {want.get(k, 0)}")


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = _build.build_all()
    # registers and spills of K1's four instantiations (none, LIF,
    # Izhikevich, AdEx epilogue): an epilogue's registers can cost K1
    # occupancy
    regs = k1_registers(built["ptxas"]["synaptic_gather"])
    check(sorted(regs) == sorted((*FUSED_KERNELS, "synaptic_gather")),
          f"ptxas reported K1's entry functions as {sorted(regs)}")
    emit({"phase": "device", "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": built["seconds"], "synaptic_gather_ptxas": regs})
    return smi


def k1_registers(log: str) -> dict:
    """Registers and spill bytes of each of K1's entry functions in its
    ``nvcc -Xptxas -v`` log, by ``read_launches`` name: the epilogue's
    struct names the fused instantiation."""
    by_struct = {"LifStep": "synaptic_gather_lif",
                 "IzhikevichStep": "synaptic_gather_izhikevich",
                 "AdexStep": "synaptic_gather_adex"}
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = next((v for k, v in by_struct.items() if k in m.group(1)),
                        "synaptic_gather")
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[name]["spill_store_bytes"] = int(m.group(1))
                out[name]["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


# --------------------------------------------------------------------------
# phase 2: each kernel at the main path's shapes
# --------------------------------------------------------------------------

def phase_kernels(g) -> dict:
    rng = np.random.default_rng(SEED)
    bg = g.blocked
    nb, eb, pb, d, m = bg.nb, bg.eb, bg.pb, g.max_delay, g.n_mirror
    out = {}
    live = int((bg.delay > 0).sum())

    # K1: the edge pass on the built layout, random weights/ring/fresh
    bounds = gather_mod.segment_bounds(bg.post_rel, bg.delay, pb=pb,
                                       max_delay=d)
    w = torch.from_numpy(rng.normal(0, 50, (nb, eb)).astype(np.float32)
                         ).to(DEV)
    ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.05)
                            .astype(np.float32)).to(DEV)
    fresh = torch.from_numpy((rng.uniform(size=m) < 0.05)
                             .astype(np.float32)).to(DEV)
    t = torch.tensor(7, dtype=torch.int32, device=DEV)   # t < D: floor-mod
    args = (bg.pre_idx, bg.post_rel, w, bg.delay, bg.channel, ring, t)
    errs = {}
    for name, fr in (("no_fresh", None), ("fresh", fresh)):
        k1 = gather_mod.synaptic_gather(*args, max_delay=d, pb=pb, fresh=fr,
                                        bounds=bounds)
        k2 = gather_mod.synaptic_gather(*args, max_delay=d, pb=pb, fresh=fr,
                                        bounds=bounds)
        pl = gather_mod.synaptic_gather_plain(*args, max_delay=d, pb=pb,
                                              fresh=fr)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"K1 ({name}) not bitwise deterministic")
        check(torch.equal(k1[2], pl[2]), f"K1 ({name}) arrivals differ")
        errs[name] = max(max_abs(k1[0], pl[0]), max_abs(k1[1], pl[1]))
        check(errs[name] <= 1e-2, f"K1 ({name}) sums differ by "
              f"{errs[name]}")
    k_ms = median_ms(lambda: gather_mod.synaptic_gather(
        *args, max_delay=d, pb=pb, bounds=bounds))
    p_ms = median_ms(lambda: gather_mod.synaptic_gather_plain(
        *args, max_delay=d, pb=pb))
    nbytes = (live * 12 + bounds.numel() * 4 + d * m * 4 + 4
              + 2 * nb * pb * 4 + nb * eb * 4)
    b_ms, b_by = bound(nbytes, 2 * live)
    out["synaptic_gather"] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                                  plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, bytes=nbytes,
                                  ms_per_launch=None)
    emit({"phase": "kernel", "name": "synaptic_gather", "nb": nb, "eb": eb,
          "pb": pb, "d": d, "m": m, "live_slots": live,
          "max_abs_err": errs, "tolerance": "arrivals exact; sums atol 1e-2",
          "deterministic": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})

    # K2: the LIF update over the main path's n_local neurons
    n = g.n_local
    f32 = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, n).astype(np.float32)).to(DEV)
    table = snn.make_param_table([snn.LIFParams(t_ref=0.5),
                                  snn.LIFParams(tau_m=8.0)], models.DT_MS,
                                 device=DEV)
    largs = (f32(-52, -48), f32(0, 100), f32(0, 100),
             torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(DEV),
             torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(DEV),
             f32(0, 500), f32(0, 50), table)
    errs = {}
    for cond in (False, True):
        k1 = lif_mod.lif_step(*largs, cond=cond)
        k2 = lif_mod.lif_step(*largs, cond=cond)
        pl = lif_mod.lif_step_plain(*largs, cond=cond)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              "K2 not bitwise deterministic")
        check(k1[4].any(), "K2 inputs spiked nowhere - vacuous")
        check(all(torch.equal(a, b) for a, b in zip(k1, pl)),
              f"K2 (cond={cond}) differs from its twin")
        errs[f"cond={cond}"] = max(max_abs(a.float(), b.float())
                                   for a, b in zip(k1, pl))
    k_ms = median_ms(lambda: lif_mod.lif_step(*largs))
    l_ms = loop_ms(lambda: lif_mod.lif_step(*largs))
    p_ms = median_ms(lambda: lif_mod.lif_step_plain(*largs))
    nbytes = n * (5 * 4 + 2 * 4) + table.numel() * 4 + n * (4 * 4 + 1)
    b_ms, b_by = bound(nbytes, 15 * n)
    out["lif_step"] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                           plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           bytes=nbytes, ms_per_launch=l_ms)
    emit({"phase": "kernel", "name": "lif_step", "n": n,
          "max_abs_err": errs, "tolerance": "bitwise equal",
          "deterministic": True, "kernel_ms": k_ms,
          "kernel_ms_per_launch_over_many": l_ms,
          "launches_timed": LOOP_LAUNCHES, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})

    # K3: the blocked pl-STDP update over every slot
    e = nb * eb
    n_plastic = int(bg.plastic.sum())
    sargs = (torch.from_numpy(rng.uniform(1, 100, e).astype(np.float32)
                              ).to(DEV),
             bg.pre_idx.reshape(-1), bg.post_rel.reshape(-1),
             bg.plastic.reshape(-1),
             torch.from_numpy((rng.uniform(size=e) < 0.05)
                              .astype(np.float32)).to(DEV),
             (torch.rand(n, device=DEV) < 0.05).float(),
             torch.rand(m, device=DEV) * 3, torch.rand(n, device=DEV) * 3)
    params = (models.HPC_STDP.lam, models.HPC_STDP.alpha, models.HPC_STDP.mu,
              models.HPC_STDP.w0, models.HPC_STDP.w_min,
              models.HPC_STDP.w_max)
    k1 = stdp_mod.stdp_update(*sargs, params=params, eb=eb, pb=pb)
    k2 = stdp_mod.stdp_update(*sargs, params=params, eb=eb, pb=pb)
    pl = stdp_mod.stdp_update_plain(*sargs, params=params, eb=eb, pb=pb)
    check(torch.equal(k1, k2), "K3 not bitwise deterministic")
    check(not torch.equal(k1, sargs[0]), "K3 changed nothing - vacuous")
    err = max_abs(k1, pl)
    check(torch.allclose(k1, pl, rtol=2e-6, atol=0),
          f"K3 differs from its twin by {err}")
    k_ms = median_ms(lambda: stdp_mod.stdp_update(*sargs, params=params,
                                                  eb=eb, pb=pb))
    p_ms = median_ms(lambda: stdp_mod.stdp_update_plain(
        *sargs, params=params, eb=eb, pb=pb))
    nbytes = (n_plastic * 17 + (e - n_plastic) * 5 + e * 4
              + (2 * n + m) * 4)
    b_ms, b_by = bound(nbytes, 20 * n_plastic)
    out["stdp_update"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    emit({"phase": "kernel", "name": "stdp_update", "slots": e,
          "plastic_slots": n_plastic, "max_abs_err": err,
          "tolerance": "rtol 2e-6 (expf/logf vs torch exp/log)",
          "deterministic": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})

    # K1 + K2: the main path's fused kernel, on the same layout
    table = snn.make_param_table([snn.LIFParams(t_ref=0.5),
                                  snn.LIFParams(tau_m=8.0)], models.DT_MS,
                                 device=DEV)
    out.update(phase_fused_kernel("lif", g, table, rng, drive_on=True))
    out["synaptic_gather"]["ms_per_launch"] = out.pop("_k1_ms_per_launch")
    return out


def phase_fused_kernel(neuron: str, g, table, rng, *, drive_on: bool):
    """K1 with the ``neuron`` epilogue at network ``g``'s shapes (its
    layout, ``n_local`` and group ids, with ``table``) on seeded inputs.
    Each case (LIF: current and conductance; drive off and on) bitwise
    against K1 -> add -> the standalone K2, K4 or K5 on the card and twice
    for determinism, and against the plain twin: arrivals, spikes and
    ref_count exact, the membrane (and u, w_ad) as the standalone kernel's
    own check holds it, the synaptic state within K1's sums tolerance.
    Timed in the path's case (``drive_on``: the drive as the path has it)
    alone and in turns with K1 alone, per launch over many:
    ``epilogue_ms`` = fused - K1.
    Returns the kernels-line record, and K1's per-launch time under
    ``_k1_ms_per_launch``."""
    bg = g.blocked
    nb, eb, pb, d, m, n = bg.nb, bg.eb, bg.pb, g.max_delay, g.n_mirror, \
        g.n_local
    bounds = gather_mod.segment_bounds(bg.post_rel, bg.delay, pb=pb,
                                       max_delay=d)
    w = torch.from_numpy(rng.normal(0, 50, (nb, eb)).astype(np.float32)
                         ).to(DEV)
    ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.05)
                            .astype(np.float32)).to(DEV)
    t = torch.tensor(7, dtype=torch.int32, device=DEV)
    edge = (bg.pre_idx, bg.post_rel, w, bg.delay, bg.channel, ring, t)
    f32 = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, n).astype(np.float32)).to(DEV)
    rc = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(DEV)
    if neuron == "lif":
        state = (f32(-52, -48), f32(0, 100), f32(0, 100), rc)
        standalone, conds, ops = lif_mod.lif_step, (False, True), 15
    elif neuron == "izhikevich":
        # up to v_peak
        state = (f32(-70, 30), f32(-16, 0), f32(0, 30), f32(-30, 0), rc)
        standalone, conds, ops = izh_mod.izhikevich_step, (False,), 25
    else:
        # up to the exponential's clamp, v_t + 10 delta_t
        state = (f32(-60, -30), f32(0, 100), f32(0, 300), f32(-300, 0), rc)
        standalone, conds, ops = adex_mod.adex_step, (False,), 35
    gid = g.group_id
    drive = f32(0, 500)
    name = f"synaptic_gather_{neuron}"
    errs = {}
    for cond in conds:
        for drv in (None, drive):
            case = f"cond={cond},drive={drv is not None}"
            kw = dict(neuron=neuron, cond=cond, max_delay=d, pb=pb,
                      drive=drv)
            (a1, o1), (a2, o2) = (FUSED(*edge, state, gid, table,
                                        bounds=bounds, **kw)
                                  for _ in range(2))
            check(torch.equal(a1, a2)
                  and all(torch.equal(x, y) for x, y in zip(o1, o2)),
                  f"{name} ({case}) not bitwise deterministic")
            ex, inh, ak = gather_mod.synaptic_gather(
                *edge, max_delay=d, pb=pb, bounds=bounds)
            ex = ex[:n] if drv is None else ex[:n] + drv
            comp = standalone(*state, gid, ex, inh[:n], table,
                              **({"cond": cond} if neuron == "lif" else {}))
            check(torch.equal(a1, ak)
                  and all(torch.equal(x, y) for x, y in zip(o1, comp)),
                  f"{name} ({case}) differs from K1 -> add -> "
                  f"{standalone.__name__}")
            check(bool(o1[-1].any()) and bool((rc > 0).any()),
                  f"{name} ({case}): vacuous inputs")
            ap, op = gather_mod.synaptic_gather_update_plain(
                *edge, state, gid, table, **kw)
            check(torch.equal(a1, ap), f"{name} ({case}) arrivals differ")
            names = gather_mod.NEURON_STATE[neuron][0] + ("spike",)
            errs[case] = {}
            for field, x, y in zip(names, o1, op):
                errs[case][field] = max_abs(x.float(), y.float())
                ulps = (8 * 2.0 ** -23 * float(y.abs().max())
                        if y.is_floating_point() else 0.0)
                if field in EXACT_FIELDS[neuron]:
                    ok = torch.equal(x, y)
                else:
                    lim = ulps + (1e-2 if field.startswith("syn") else 0)
                    ok = errs[case][field] <= lim
                check(ok, f"{name} ({case}) {field} differs from the twin "
                      f"by {errs[case][field]}")
    kw = dict(neuron=neuron, max_delay=d, pb=pb,
              drive=drive if drive_on else None)
    fused = lambda: FUSED(*edge, state, gid, table, bounds=bounds, **kw)
    k1 = lambda: gather_mod.synaptic_gather(*edge, max_delay=d, pb=pb,
                                            bounds=bounds)
    k_ms = median_ms(fused)
    p_ms = median_ms(lambda: gather_mod.synaptic_gather_update_plain(
        *edge, state, gid, table, **kw))
    turns = in_turns({"synaptic_gather": k1, name: fused})
    live = int((bg.delay > 0).sum())
    n_state = len(state)
    nbytes = (live * 12 + bounds.numel() * 4 + d * m * 4 + 4 + nb * eb * 4
              + table.numel() * 4
              + n * (n_state * 4 + 4 + (4 if drive_on else 0))
              + n * (n_state * 4 + 1))
    b_ms, b_by = bound(nbytes, 2 * live + ops * n)
    worst = max(max(e.values()) for e in errs.values())
    emit({"phase": "kernel", "name": name, "nb": nb, "eb": eb, "pb": pb,
          "d": d, "m": m, "n_local": n, "live_slots": live,
          "max_abs_err": errs,
          "tolerance": "bitwise equal to K1 -> add -> "
                       f"{standalone.__name__}; against the twin: arrivals "
                       "and "
                       + ", ".join(EXACT_FIELDS[neuron])
                       + " exact, other floats within 8 ulp of max |x|, "
                       "syn also within K1's atol 1e-2",
          "deterministic": True, "timed_drive": drive_on,
          "kernel_ms": k_ms, "plain_ms": p_ms,
          "in_turns_ms_per_launch": turns,
          "epilogue_ms": turns[name] - turns["synaptic_gather"],
          "bound_ms": b_ms, "bytes": nbytes})
    return {name: dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                       ms_per_launch=turns[name],
                       epilogue_ms=turns[name] - turns["synaptic_gather"]),
            "_k1_ms_per_launch": turns["synaptic_gather"]}


# --------------------------------------------------------------------------
# phase 3: lockstep parity of the two backends at scale 1
# --------------------------------------------------------------------------

def phase_lockstep(spec, stdp, g, table, n_steps: int = 120) -> None:
    cb, fb = backends.get_backend("cuda"), backends.get_backend("flat")
    lc, lf = cb.prepare(g), fb.prepare(g)
    cfg_c = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    cfg_f = dataclasses.replace(cfg_c, sweep="flat")
    st = engine.init_state(g, list(spec.groups), SEED, sweep="cuda",
                           device=DEV)
    # from rest the network is nearly silent for ~250 steps: start from a
    # seeded random membrane state around threshold instead
    v0 = np.random.default_rng(SEED + 1).uniform(-56.0, -49.5, g.n_local)
    st = dataclasses.replace(st, neurons=dataclasses.replace(
        st.neurons, v_m=torch.from_numpy(v0.astype(np.float32)).to(DEV)))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 1)
    col = lambda name: table[0, snn.COL[name]]
    v_tol, n_near, n_flip, n_spk = 1e-3, 0, 0, 0
    worst = dict(i_ex=0.0, i_in=0.0, v_m=0.0, weights=0.0, k_pre=0.0,
                 k_post=0.0)
    real = g.delay > 0
    reset_launches()
    for _ in range(n_steps):
        stf = engine.state_with_weights_layout(st, g, "flat")
        drive = g.ext_weight * torch.poisson(g.ext_rate * (models.DT_MS
                                                           * 1e-3),
                                             generator=gen)
        ex_c, in_c, _ = cb.sweep(lc, st.weights, st.ring, st.t)
        ex_f, in_f, _ = fb.sweep(lf, stf.weights, stf.ring, stf.t)
        new_c, sp_c = engine.engine_step(st, g, table, cfg_c, drive=drive)
        new_f, sp_f = engine.engine_step(stf, g, table, cfg_f, drive=drive)
        nv = st.neurons
        v_prop = (nv.v_m * col("p_vv") + nv.syn_ex * col("p_ve")
                  + nv.syn_in * col("p_vi") + col("p_vconst"))
        near = ((v_prop - col("v_th")).abs() < v_tol) & (nv.ref_count == 0)
        flip = sp_c != sp_f
        check(not bool((flip & ~near).any()),
              "lockstep: spikes differ away from the threshold")
        n_near += int(near.sum())
        n_flip += int(flip.sum())
        n_spk += int(sp_c.sum())
        same = ~flip
        wc = engine.state_with_weights_layout(new_c, g, "flat").weights
        for key, a, b in (
                ("i_ex", ex_c, ex_f), ("i_in", in_c, in_f),
                ("v_m", new_c.neurons.v_m[same], new_f.neurons.v_m[same]),
                ("weights", wc[real], new_f.weights[real]),
                ("k_pre", new_c.traces.k_pre, new_f.traces.k_pre),
                ("k_post", new_c.traces.k_post, new_f.traces.k_post)):
            worst[key] = max(worst[key], max_abs(a, b))
        st = new_c          # continue from the kernel path's state
    # the kernel backend's steps took the fused route; the plain K1 ran
    # only for the comparison sums above
    launches = read_launches()
    check_launches("lockstep", launches,
                   {"synaptic_gather_lif": n_steps, "synaptic_gather": n_steps,
                    "stdp_update": n_steps})
    tol = dict(i_ex=1e-2, i_in=1e-2, v_m=1e-4, weights=1e-4, k_pre=1e-5,
               k_post=1e-5)
    for key, lim in tol.items():
        check(worst[key] <= lim, f"lockstep: {key} differs by {worst[key]}"
              f" > {lim}")
    check(n_spk > 0, "lockstep: nothing spiked - vacuous")
    emit({"phase": "lockstep", "steps": n_steps, "spikes": n_spk,
          "near_threshold": n_near, "flipped": n_flip,
          "v_threshold_tol_mV": v_tol, "max_abs_err": worst,
          "tolerance": tol,
          "launches": {k: v for k, v in launches.items() if v}})


# --------------------------------------------------------------------------
# phase 4: free-running parity on a small mixed network
# --------------------------------------------------------------------------

def mixed_backend_spec():
    """Copy of tests/test_snn_engine.py::mixed_backend_spec: two groups,
    mixed channels, heterogeneous delays, plastic E->E edges, padding."""
    ne, ni = 24, 9
    area = AreaSpec("a", ne + ni, positions=np.zeros((ne + ni, 3)))
    exc = snn.LIFParams(i_e=800.0, t_ref=1.0)
    inh = snn.LIFParams(i_e=800.0, t_ref=1.0, tau_m=8.0)
    pops = [builder.Population("E", 0, 0, ne),
            builder.Population("I", 0, 1, ni)]
    projections = [
        builder.Projection(0, 0, 5, 45.0, 5.0, 1, 5, channel=0,
                           plastic=True),
        builder.Projection(0, 1, 3, 45.0, 5.0, 1, 3, channel=0),
        builder.Projection(1, 0, 4, -200.0, 10.0, 2, 6, channel=1),
        builder.Projection(1, 1, 2, -200.0, 10.0, 1, 2, channel=1),
    ]
    return builder.NetworkSpec(areas=[area], groups=[exc, inh],
                               populations=pops, projections=projections,
                               max_delay=8, seed=3)


def phase_mixed(n_steps: int = 120) -> None:
    spec = mixed_backend_spec()
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(DEV)
    table = snn.make_param_table(list(spec.groups), models.DT_MS,
                                 device=DEV)
    res = {}
    for sweep in ("cuda", "flat"):
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=models.HPC_STDP,
                                  sweep=sweep, external_drive=False)
        st = engine.init_state(g, list(spec.groups), SEED, device=DEV)
        res[sweep] = engine.run(st, g, table, cfg, n_steps, device=DEV)
    (fc, sc), (ff, sf) = res["cuda"], res["flat"]
    check(int(sf.sum()) > 10, "mixed: nothing spiked - vacuous")
    check(bool((g.delay == 0).any()), "mixed: no padding edges - vacuous")
    check(torch.equal(sc, sf), "mixed: spike rasters differ")
    err = max_abs(fc.weights, ff.weights)
    check(err <= 1e-4, f"mixed: weights differ by {err}")
    emit({"phase": "mixed", "steps": n_steps, "spikes": int(sc.sum()),
          "rasters_identical": True, "weights_max_abs_err": err,
          "tolerance": 1e-4})


# --------------------------------------------------------------------------
# phase 5: the main path
# --------------------------------------------------------------------------

def _profile(g, table, cfg, spec, n_steps: int = 50) -> dict:
    """Device time by kernel over a short steady window."""
    from torch.profiler import ProfilerActivity, profile
    st = engine.init_state(g, list(spec.groups), SEED + 2, sweep=cfg.sweep,
                           neuron_model=cfg.neuron_model, device=DEV)
    st, _ = engine.run(st, g, table, cfg, 5, device=DEV)   # warm
    st = engine.state_with_weights_layout(
        st, g, "blocked", backend=backends.get_backend(cfg.sweep))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st, _ = engine.engine_step(st, g, table, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue     # CPU ops: their kernels are listed on their own
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        name = ev.key.replace("(anonymous namespace)::", "")[:60]
        by_name[name] = by_name.get(name, 0.0) + dt / 1e3
    busy = sum(by_name.values())
    check(busy > 0, "profile: no device time traced")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps,
            "wall_ms_per_step_profiled": wall * 1e3 / n_steps,
            "device_ms_per_step": busy / n_steps,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "kernels_per_step": sum(
                e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")) / n_steps,
            "ms_per_step_by_kernel": {k: v / n_steps for k, v in top}}


def run_counted(what, spec, g, table, cfg, n_steps, kernels):
    """``engine.run`` of ``cfg`` (the kernel backend) from a fresh state,
    with every launch count set to 0 just before and read just after: each
    kernel of ``kernels`` (``read_launches`` names, the fused kernel by
    epilogue) must have launched once per step and every other kernel
    never.  Plastic weights must stay in [w_min, w_max], every other
    weight unchanged, and the state finite.  Returns the initial neurons,
    the final state, the spikes and the run's numbers."""
    st = engine.init_state(g, list(spec.groups), SEED,
                           neuron_model=cfg.neuron_model, device=DEV)
    init = st.neurons
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fin, spikes = engine.run(st, g, table, cfg, n_steps, device=DEV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check_launches(what, launches, dict.fromkeys(kernels, n_steps))
    real, w = g.delay > 0, fin.weights
    fixed = real & ~g.plastic if cfg.stdp is not None else real
    check(torch.equal(w[fixed], g.weight_init[fixed]),
          f"{what}: a non-plastic weight changed")
    leaves = [("v_m", fin.neurons.v_m), ("syn_ex", fin.neurons.syn_ex),
              ("syn_in", fin.neurons.syn_in), ("weights", w),
              ("ring", fin.ring), *fin.neurons.extra.items()]
    if cfg.stdp is not None:
        plastic = real & g.plastic
        check(bool(((w[plastic] >= cfg.stdp.w_min)
                    & (w[plastic] <= cfg.stdp.w_max)).all()),
              f"{what}: plastic weights left [w_min, w_max]")
        leaves += [("k_pre", fin.traces.k_pre), ("k_post", fin.traces.k_post)]
    for name, x in leaves:
        check(bool(torch.isfinite(x).all()), f"{what}: {name} not finite")
    return init, fin, spikes, dict(
        steps=n_steps, wall_s=wall, steps_per_s=n_steps / wall,
        peak_device_mem_bytes=peak, launches=launches)


def phase_main(spec, stdp, g, table, n_steps: int = 2000):
    """Returns the launches, and on the host the spikes, final ``v_m`` and
    final weights (the gated runs of phase 11 must reproduce them
    bitwise; kept off the card so as not to count in their peak memory)."""
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    _, fin, spikes, rec = run_counted("main", spec, g, table, cfg, n_steps,
                                      MAIN_KERNELS)
    w = fin.weights
    plastic = g.plastic & (g.delay > 0)
    fixed = ~g.plastic & (g.delay > 0)
    rate = models.firing_rate_hz(spikes[500:], spec.n_neurons)
    check(3.0 <= rate <= 15.0, f"main: rate {rate} Hz outside [3, 15]")
    windows = [models.firing_rate_hz(spikes[i:i + 250], spec.n_neurons)
               for i in range(0, n_steps, 250)]
    prof = _profile(g, table, cfg, spec)
    emit({"phase": "main", "neurons": spec.n_neurons,
          "synapses": int((g.delay > 0).sum()),
          "plastic_synapses": int(plastic.sum()),
          "rate_hz_500_2000": rate, "rate_hz_per_250_steps": windows,
          "plastic_w_min": float(w[plastic].min()),
          "plastic_w_max": float(w[plastic].max()),
          "inhibitory_w": float(w[fixed].min()), **rec, "profile": prof})
    return rec["launches"], {"spikes": spikes.cpu(),
                             "v_m": fin.neurons.v_m.cpu(),
                             "weights": fin.weights.cpu()}


# --------------------------------------------------------------------------
# phases 6-9: the neuron-model zoo
# --------------------------------------------------------------------------

def phase_zoo_kernels(n: int = 10_000) -> dict:
    """K4 and K5 at a zoo network's width, on the model_demo tables."""
    rng = np.random.default_rng(SEED + 3)
    ranges = {"izhikevich": ((-70, 25), (-16, 0), (0, 30), (-30, 0),
                             (0, 20), (-20, 0)),
              "adex": ((-75, -35), (0, 100), (0, 300), (-300, 0), (0, 50),
                       (-50, 0))}
    out = {}
    for model, (mod, kernel) in ZOO_KERNELS.items():
        spec, _ = models.model_demo(model, 1.0)
        table = neuron_models.get_model(model).make_param_table(
            list(spec.groups), models.DT_MS, device=DEV)
        f32 = [torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))
               .to(DEV) for lo, hi in ranges[model]]
        rc = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(DEV)
        gid = torch.from_numpy(rng.integers(0, table.shape[0], n)
                               .astype(np.int32)).to(DEV)
        args = (*f32[:4], rc, gid, *f32[4:], table)
        plain = getattr(mod, f"{model}_step_plain")
        k1, k2, pl = kernel(*args), kernel(*args), plain(*args)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"{model}: kernel not bitwise deterministic")
        check(k1[5].any() and (rc > 0).any(), f"{model}: vacuous inputs")
        check(torch.equal(k1[4], pl[4]) and torch.equal(k1[5], pl[5]),
              f"{model}: ref_count or spikes differ from the twin")
        errs = {name: max_abs(a, b) for name, a, b in zip(
            ("v", "x", "syn_ex", "syn_in"), k1[:4], pl[:4])}
        if model == "izhikevich":
            tol = "bitwise equal"
            check(all(torch.equal(a, b) for a, b in zip(k1, pl)),
                  f"izhikevich differs from its twin: {errs}")
        else:
            tol = "spikes, ref_count exact; floats within 8 ulp of max |x|"
            for a, b in zip(k1[:4], pl[:4]):
                lim = 8 * 2.0 ** -23 * float(b.abs().max())
                check(max_abs(a, b) <= lim, f"adex differs from its twin: "
                      f"{errs}")
        k_ms = median_ms(lambda: kernel(*args))
        l_ms = loop_ms(lambda: kernel(*args))
        p_ms = median_ms(lambda: plain(*args))
        nbytes = n * (6 * 4 + 2 * 4) + table.numel() * 4 + n * (4 * 4 + 5)
        b_ms, b_by = bound(nbytes, (25 if model == "izhikevich" else 35) * n)
        name = f"{model}_step"
        out[name] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ms_per_launch=l_ms)
        emit({"phase": "kernel", "name": name, "n": n,
              "groups": table.shape[0], "max_abs_err": errs,
              "tolerance": tol, "deterministic": True, "kernel_ms": k_ms,
              "kernel_ms_per_launch_over_many": l_ms,
              "launches_timed": LOOP_LAUNCHES, "plain_ms": p_ms,
              "bound_ms": b_ms, "bytes": nbytes})
    return out


def build_network(spec, what: str, ref: dict):
    """One shard of ``spec`` on the card and its model's table; ``spec``
    must be the network of the reference record ``ref``."""
    t0 = time.perf_counter()
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(DEV)
    check(spec.neuron_model == ref["network"]
          and spec.n_neurons == ref["neurons"]
          and int((g.delay > 0).sum()) == ref["synapses"],
          f"{what}: not the network of the reference record")
    table = neuron_models.get_model(spec.neuron_model).make_param_table(
        list(spec.groups), models.DT_MS, device=DEV)
    emit({"phase": "build", "network": what, "neurons": spec.n_neurons,
          "n_local": g.n_local, "edges": int((g.delay > 0).sum()),
          "nb": g.blocked.nb, "eb": g.blocked.eb, "max_delay": g.max_delay,
          "host_build_s": time.perf_counter() - t0})
    return g, table


def phase_zoo_lockstep(model, spec, stdp, g, table, n_steps: int = 120):
    """The kernel and flat backends step from one state every step: the
    same spikes except within ``v_tol`` of ``v_peak``."""
    mod, _ = ZOO_KERNELS[model]
    (x_name,) = neuron_models.get_model(model).extra_fields
    cb, fb = backends.get_backend("cuda"), backends.get_backend("flat")
    lc, lf = cb.prepare(g), fb.prepare(g)
    cfg_c = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda",
                                external_drive=False, neuron_model=model)
    cfg_f = dataclasses.replace(cfg_c, sweep="flat")
    st = engine.init_state(g, list(spec.groups), SEED, sweep="cuda",
                           neuron_model=model, device=DEV)
    # the proposed membrane (before threshold and reset) is what the twin
    # returns when nothing can spike: v_peak at infinity, ref_count 0
    no_peak = table.clone()
    no_peak[:, mod.COL["v_peak"]] = float("inf")
    v_peak = table[g.group_id.long(), mod.COL["v_peak"]]
    plain = getattr(mod, f"{model}_step_plain")
    v_tol, n_near, n_flip, n_spk = 1e-3, 0, 0, 0
    worst = dict(i_ex=0.0, i_in=0.0, v_m=0.0, x=0.0, weights=0.0,
                 k_pre=0.0, k_post=0.0)
    real = g.delay > 0
    reset_launches()
    for _ in range(n_steps):
        stf = engine.state_with_weights_layout(st, g, "flat")
        ex_c, in_c, _ = cb.sweep(lc, st.weights, st.ring, st.t)
        ex_f, in_f, _ = fb.sweep(lf, stf.weights, stf.ring, stf.t)
        new_c, sp_c = engine.engine_step(st, g, table, cfg_c)
        new_f, sp_f = engine.engine_step(stf, g, table, cfg_f)
        nv = st.neurons
        v_prop = plain(nv.v_m, nv.extra[x_name], nv.syn_ex, nv.syn_in,
                       torch.zeros_like(nv.ref_count), nv.group_id, ex_c,
                       in_c, no_peak)[0]
        near = ((v_prop - v_peak).abs() < v_tol) & (nv.ref_count == 0)
        flip = sp_c != sp_f
        check(not bool((flip & ~near).any()),
              f"zoo_lockstep {model}: spikes differ away from v_peak")
        n_near += int(near.sum())
        n_flip += int(flip.sum())
        n_spk += int(sp_c.sum())
        same = ~flip
        wc = engine.state_with_weights_layout(new_c, g, "flat").weights
        # a row sums hundreds of same-signed inputs in another order on
        # each backend: its error scales with the sum, so it is relative
        for key, a, b in (("i_ex", ex_c, ex_f), ("i_in", in_c, in_f)):
            rel = max_abs(a, b) / max(1.0, float(b.abs().max()))
            worst[key] = max(worst[key], rel)
        for key, a, b in (
                ("v_m", new_c.neurons.v_m[same], new_f.neurons.v_m[same]),
                ("x", new_c.neurons.extra[x_name][same],
                 new_f.neurons.extra[x_name][same]),
                ("weights", wc[real], new_f.weights[real]),
                ("k_pre", new_c.traces.k_pre, new_f.traces.k_pre),
                ("k_post", new_c.traces.k_post, new_f.traces.k_post)):
            worst[key] = max(worst[key], max_abs(a, b))
        st = new_c
    # the kernel backend's steps (ZOO_MAIN_KERNELS) beside the plain K1 of
    # the comparison sums above
    launches = read_launches()
    want = dict.fromkeys(ZOO_MAIN_KERNELS[model], n_steps)
    want["synaptic_gather"] = want.get("synaptic_gather", 0) + n_steps
    check_launches(f"zoo_lockstep {model}", launches, want)
    tol = dict(i_ex=1e-5, i_in=1e-5, v_m=1e-4, x=1e-4, weights=1e-4,
               k_pre=1e-5, k_post=1e-5)
    for key, lim in tol.items():
        check(worst[key] <= lim, f"zoo_lockstep {model}: {key} differs by "
              f"{worst[key]} > {lim}")
    check(n_spk > 0, f"zoo_lockstep {model}: nothing spiked - vacuous")
    emit({"phase": "zoo_lockstep", "model": model, "steps": n_steps,
          "spikes": n_spk, "near_v_peak": n_near, "flipped": n_flip,
          "v_peak_tol_mV": v_tol, "extra_variable": x_name,
          "max_err": worst, "tolerance": tol,
          "relative": ["i_ex", "i_in"],
          "launches": {k: v for k, v in launches.items() if v}})


def population_rates(spec, spikes, ref: dict) -> dict:
    """Per population, in the reference record's windows: the rate per
    window and from ``mean_from_step`` on."""
    sp, win, start = spikes.cpu(), ref["window_steps"], ref["mean_from_step"]
    off = spec.pop_offsets()
    out = {}
    for i, pop in enumerate(spec.populations):
        s = sp[:, off[i]:off[i + 1]]
        out[pop.name] = {"per_window_hz": [
            models.firing_rate_hz(s[j:j + win])
            for j in range(0, s.shape[0], win)],
            "mean_hz": models.firing_rate_hz(s[start:])}
    return out


def check_rates(what: str, rates: dict, ref: dict, mean_band: float) -> None:
    lo, hi = WINDOW_BAND
    for pop, want in ref["populations"].items():
        got = rates[pop]
        for i, (a, b) in enumerate(zip(got["per_window_hz"],
                                       want["per_window_hz"])):
            check(lo * b <= a <= hi * b, f"{what}: {pop} rate {a} Hz in "
                  f"window {i} outside [{lo}, {hi}] x the reference's {b}")
        a, b = got["mean_hz"], want["mean_hz"]
        check(abs(a - b) <= mean_band * b, f"{what}: {pop} mean rate {a} Hz "
              f"is not within {mean_band:.0%} of the reference's {b}")


def phase_zoo_main(model, spec, stdp, g, table, ref: dict):
    """Returns the run's launches, and on the host its spikes and final
    state (the network's gated run must reproduce them bitwise)."""
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda",
                              external_drive=False, neuron_model=model)
    _, fin, spikes, rec = run_counted(
        f"zoo_main {model}", spec, g, table, cfg, ref["steps"],
        ZOO_MAIN_KERNELS[model])
    rates = population_rates(spec, spikes, ref)
    check_rates(f"zoo_main {model}", rates, ref, MEAN_BAND[model])
    emit({"phase": "zoo_main", "model": model, "neurons": spec.n_neurons,
          "synapses": int((g.delay > 0).sum()),
          "mean_from_step": ref["mean_from_step"],
          "mean_rate_hz": models.firing_rate_hz(
              spikes[ref["mean_from_step"]:], spec.n_neurons),
          "rates_hz": rates,
          "rate_band": {"window": WINDOW_BAND, "mean": MEAN_BAND[model]},
          **rec, "profile": _profile(g, table, cfg, spec)})
    return rec["launches"], {"spikes": spikes.cpu(),
                             "weights": fin.weights.cpu(),
                             **{k: x.cpu() for k, x in (
                                 ("v_m", fin.neurons.v_m),
                                 *fin.neurons.extra.items())}}


def phase_zoo_gate(model, spec, stdp, g, table, ref: dict,
                   main_out: dict) -> dict:
    """The ``model`` network through the activity gate (``"cuda:sparse"``):
    K6, then the standalone K4 or K5 (the gated backend keeps the composed
    route), then K3 or K7.  Spikes, ``v_m``, the model's extra variable
    (``u``, ``w_ad``) and weights must equal the fused ``zoo_main`` run's
    bitwise: K6 sums as K1 does, and the standalone kernel and K1's
    epilogue share one source.  Returns the run's launches."""
    sweep = "cuda:sparse"
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=sweep,
                              external_drive=False, neuron_model=model)
    backend = backends.get_backend(sweep)
    cap = backend.gate_capacity(backend.prepare(g))
    kernels = ("blocked_reduce_sweep", f"{model}_step",
               "stdp_update" if cap >= g.blocked.nb
               else "stdp_update_worklist")
    _, fin, spikes, rec = run_counted(f"zoo_gate {model} {sweep}", spec, g,
                                      table, cfg, ref["steps"], kernels)
    (x_name,) = neuron_models.get_model(model).extra_fields
    for name, a in (("spikes", spikes), ("weights", fin.weights),
                    ("v_m", fin.neurons.v_m),
                    (x_name, fin.neurons.extra[x_name])):
        check(torch.equal(a.cpu(), main_out[name]),
              f"zoo_gate {model}: {name} differ from the fused run's")
    emit({"phase": "zoo_gate", "model": model, "sweep": sweep,
          "capacity": cap, "nb": g.blocked.nb,
          "bitwise_equal_to_zoo_main": True, **rec,
          "profile": _profile(g, table, cfg, spec)})
    return rec["launches"]


def phase_composite(spec, g, table, ref: dict) -> dict:
    """brunel + Poisson emitter population on the port's own draws; returns
    the run's launches."""
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=None, sweep="cuda",
                              external_drive=False,
                              neuron_model=spec.neuron_model)
    # "lif+poisson" keeps the composed route: K1, then the standalone K2
    init, fin, spikes, rec = run_counted(
        "composite", spec, g, table, cfg, ref["steps"],
        ("synaptic_gather", "lif_step"))
    n_steps = ref["steps"]
    off = spec.pop_offsets()
    emit_rows = slice(off[2], off[3])
    p = float(table[spec.populations[2].group, -1])
    n = spikes[:, emit_rows].numel()
    got = int(spikes[:, emit_rows].sum())
    sigma = float(np.sqrt(n * p * (1 - p)))
    check(abs(got - n * p) <= 4 * sigma, f"composite: {got} emitter "
          f"spikes, expected {n * p} +- 4 x {sigma}")
    for name in ("v_m", "syn_ex", "syn_in", "ref_count"):
        check(torch.equal(getattr(fin.neurons, name)[emit_rows],
                          getattr(init, name)[emit_rows]),
              f"composite: emitter {name} changed")
    rates = population_rates(spec, spikes, ref)
    check_rates("composite", rates, ref, MEAN_BAND[spec.neuron_model])
    emit({"phase": "composite", "model": spec.neuron_model,
          "neurons": spec.n_neurons, "synapses": int((g.delay > 0).sum()),
          "emitters": n // n_steps, "emitter_spikes": got,
          "emitter_expected": n * p, "emitter_sigma": sigma,
          "mean_from_step": ref["mean_from_step"], "rates_hz": rates,
          "rate_band": {"window": WINDOW_BAND,
                        "mean": MEAN_BAND[spec.neuron_model]},
          **rec, "profile": _profile(g, table, cfg, spec)})
    return rec["launches"]


def zoo():
    """Phases 6-9, each network at the scale and length of the reference's
    record; returns (kernel numbers, launches by path)."""
    kern = phase_zoo_kernels()
    launches = {}
    for model in ZOO_KERNELS:
        ref = ZOO_REFERENCE[model]
        spec, stdp = models.model_demo(model, ref["scale"], stdp=True)
        g, table = build_network(spec, f"model_demo {model}", ref)
        kern.update(phase_fused_kernel(
            model, g, table, np.random.default_rng(SEED + 4),
            drive_on=False))      # zoo_main runs without a drive
        del kern["_k1_ms_per_launch"]
        phase_zoo_lockstep(model, spec, stdp, g, table)
        launches[f"zoo_main {model}"], main_out = phase_zoo_main(
            model, spec, stdp, g, table, ref)
        launches[f"zoo_gate {model}"] = phase_zoo_gate(
            model, spec, stdp, g, table, ref, main_out)
        del g, table, main_out
    ref = ZOO_REFERENCE["lif+poisson"]
    spec, _ = models.brunel(ref["scale"], poisson_input=True)
    g, table = build_network(spec, "brunel poisson_input", ref)
    launches["composite"] = phase_composite(spec, g, table, ref)
    return kern, launches


# --------------------------------------------------------------------------
# phases 10-12: the activity gate (K6, K7)
# --------------------------------------------------------------------------

def _lists(nb: int, rng) -> dict:
    """The worklists of phase 10, each ``(worklist, n_active)``: 8 random
    blocks of ``nb`` with sentinel padding (capacity 12), the empty list,
    the identity list, and a saturated list (n_active > capacity: every
    block is walked)."""
    cap = 12
    wl8 = np.full(cap, nb, np.int32)
    wl8[:8] = np.sort(rng.choice(nb, 8, replace=False))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    return {"worklist_8": (i32(wl8), i32(8)),
            "empty": (i32(np.full(cap, nb)), i32(0)),
            "identity": (i32(np.arange(nb)), i32(nb)),
            "saturated": (i32(wl8), i32(max(nb, cap + 1)))}


def phase_gate_kernels(g) -> dict:
    """K6 and K7 at the main path's shapes against their twins, K1 and
    K3."""
    rng = np.random.default_rng(SEED + 5)
    bg = g.blocked
    nb, eb, pb, d, m, n = bg.nb, bg.eb, bg.pb, g.max_delay, g.n_mirror, \
        g.n_local
    bounds = gather_mod.segment_bounds(bg.post_rel, bg.delay, pb=pb,
                                       max_delay=d)
    w = torch.from_numpy(rng.normal(0, 50, (nb, eb)).astype(np.float32)
                         ).to(DEV)
    ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.05)
                            .astype(np.float32)).to(DEV)
    t = torch.tensor(7, dtype=torch.int32, device=DEV)
    # K1's sums and arrivals: the arrivals are what the gate's pre-pass
    # hands K6, and K6 must reproduce K1's sums bitwise
    ex1, in1, arrived = gather_mod.synaptic_gather(
        bg.pre_idx, bg.post_rel, w, bg.delay, bg.channel, ring, t,
        max_delay=d, pb=pb, bounds=bounds)
    live_per_block = (bg.delay > 0).sum(dim=1)
    plastic_per_block = (bg.plastic & (bg.delay > 0)).sum(dim=1)
    lists = _lists(nb, rng)
    out, lines = {}, {}

    # K6
    rargs = (bg.post_rel, bg.delay, w, arrived, bg.channel)
    for name, (wl, na) in [("no_list", (None, None)), *lists.items()]:
        kw = dict(max_delay=d, pb=pb, worklist=wl, n_active=na,
                  bounds=bounds)
        k1, k2 = (gather_mod.blocked_reduce_sweep(*rargs, **kw)
                  for _ in range(2))
        pl = gather_mod.blocked_reduce_sweep_plain(
            bg.post_rel, w, arrived, bg.channel, pb=pb, worklist=wl,
            n_active=na)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"K6 ({name}) not bitwise deterministic")
        err = max(max_abs(k1[0], pl[0]), max_abs(k1[1], pl[1]))
        check(err <= 1e-2, f"K6 ({name}) differs from its twin by {err}")
        listed = (torch.ones(nb, dtype=torch.bool, device=DEV) if wl is None
                  else gather_mod.listed_blocks(wl, na, nb))
        rows = listed.repeat_interleave(pb)
        check(torch.equal(k1[0][rows], ex1[rows])
              and torch.equal(k1[1][rows], in1[rows]),
              f"K6 ({name}) sums differ from K1's")
        check(not bool(k1[0][~rows].any() or k1[1][~rows].any()),
              f"K6 ({name}) wrote an unlisted block")
        k_ms = median_ms(lambda: gather_mod.blocked_reduce_sweep(*rargs,
                                                                 **kw))
        p_ms = median_ms(lambda: gather_mod.blocked_reduce_sweep_plain(
            bg.post_rel, w, arrived, bg.channel, pb=pb, worklist=wl,
            n_active=na))
        live = int(live_per_block[listed].sum())
        n_listed = int(listed.sum())
        nbytes = (live * 12 + n_listed * (d * pb + 1) * 4 + 2 * nb * pb * 4
                  + (0 if wl is None else wl.numel() * 4 + 4))
        b_ms, b_by = bound(nbytes, 2 * live)
        lines[name] = dict(blocks_walked=n_listed, live_slots=live,
                           max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms,
                           bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        if name == "no_list":   # the full-capacity gate's shape
            out["blocked_reduce_sweep"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes)
    emit({"phase": "kernel", "name": "blocked_reduce_sweep", "nb": nb,
          "eb": eb, "pb": pb, "d": d, "capacity": 12,
          "tolerance": "twin atol 1e-2; K1's sums bitwise; unlisted rows 0",
          "deterministic": True, "lists": lines})

    # K7
    e = nb * eb
    w0 = torch.from_numpy(rng.uniform(1, 100, e).astype(np.float32)).to(DEV)
    sargs = (bg.pre_idx.reshape(-1), bg.post_rel.reshape(-1),
             bg.plastic.reshape(-1), arrived.reshape(-1))
    sp = (torch.rand(n, device=DEV) < 0.05).float()
    k_pre, k_post = torch.rand(m, device=DEV) * 3, torch.rand(n, device=DEV) * 3
    params = (models.HPC_STDP.lam, models.HPC_STDP.alpha, models.HPC_STDP.mu,
              models.HPC_STDP.w0, models.HPC_STDP.w_min,
              models.HPC_STDP.w_max)
    kw = dict(params=params, eb=eb, pb=pb)
    w3 = stdp_mod.stdp_update(w0, *sargs, sp, k_pre, k_post, **kw)
    lines = {}
    for name, (wl, na) in lists.items():
        ka, kb, wp = w0.clone(), w0.clone(), w0.clone()
        for x in (ka, kb):
            check(stdp_mod.stdp_update_worklist(x, *sargs, wl, na, sp, k_pre,
                                                k_post, **kw) is x,
                  "K7 did not update in place")
        stdp_mod.stdp_update_worklist_plain(wp, *sargs, wl, na, sp, k_pre,
                                            k_post, **kw)
        check(torch.equal(ka, kb), f"K7 ({name}) not bitwise deterministic")
        err = max_abs(ka, wp)
        check(torch.allclose(ka, wp, rtol=2e-6, atol=0),
              f"K7 ({name}) differs from its twin by {err}")
        listed = gather_mod.listed_blocks(wl, na, nb)
        slots = listed.repeat_interleave(eb)
        check(torch.equal(ka[slots], w3[slots]),
              f"K7 ({name}) weights differ from K3's on listed blocks")
        check(torch.equal(ka[~slots], w0[~slots]),
              f"K7 ({name}) touched an unlisted block")
        check(name == "empty" or not torch.equal(ka, w0),
              f"K7 ({name}) changed nothing - vacuous")
        scratch = w0.clone()
        k_ms = median_ms(lambda: stdp_mod.stdp_update_worklist(
            scratch, *sargs, wl, na, sp, k_pre, k_post, **kw))
        p_ms = median_ms(lambda: stdp_mod.stdp_update_worklist_plain(
            scratch, *sargs, wl, na, sp, k_pre, k_post, **kw))
        n_listed = int(listed.sum())
        n_slots = n_listed * eb
        n_plastic = int(plastic_per_block[listed].sum())
        nbytes = (n_slots + n_plastic * 20 + (2 * n + m) * 4
                  + wl.numel() * 4 + 4)
        b_ms, b_by = bound(nbytes, 20 * n_plastic)
        lines[name] = dict(blocks_walked=n_listed,
                           plastic_slots=n_plastic, max_abs_err=err,
                           kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes)
        if name == "saturated":   # the forced gate's step once ignited
            out["stdp_update_worklist"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes)
    emit({"phase": "kernel", "name": "stdp_update_worklist", "nb": nb,
          "eb": eb, "pb": pb, "capacity": 12,
          "tolerance": "twin rtol 2e-6; K3's weights bitwise on listed "
                       "blocks; others untouched",
          "deterministic": True, "in_place": True, "lists": lines})
    return out


def gate_branches(g, spikes, cap: int) -> dict:
    """The gate's decisions of a run, recomputed on the host from its
    raster: per step the blocks with an arrival (a pre spike ``delay``
    steps earlier, read through the blocked layout) and, for plasticity,
    also those with a post spike; a step saturates when more blocks than
    ``cap`` are active.  (On the host, so that the check's matrix product
    leaves no cuBLAS workspace on the card to count in later phases' peak
    memory.)"""
    bg = g.blocked
    delay, pre = bg.delay.cpu(), bg.pre_idx.cpu().long()
    spikes = spikes.cpu()
    nb, pb, n_steps = bg.nb, bg.pb, spikes.shape[0]
    bits = spikes[:, g.mirror_src_idx.cpu().long()].float()     # (T, M)
    hits = torch.zeros(n_steps, nb)
    blk = torch.arange(nb)[:, None].expand(nb, bg.eb)
    for dly in torch.unique(delay[delay > 0]).tolist():
        sel = delay == dly
        a = torch.zeros(nb, g.n_mirror)
        a[blk[sel], pre[sel]] = 1.0
        if dly < n_steps:
            hits[dly:] += bits[:-dly] @ a.t()
    arr = hits > 0
    post = torch.nn.functional.pad(spikes, (0, nb * pb - g.n_local)
                                   ).reshape(n_steps, nb, pb).any(dim=2)
    n_sweep, n_stdp = arr.sum(dim=1), (arr | post).sum(dim=1)
    return {"sweep_saturated": int((n_sweep > cap).sum()),
            "sweep_gated": int((n_sweep <= cap).sum()),
            "sweep_gated_live": int(((n_sweep > 0) & (n_sweep <= cap)).sum()),
            "stdp_saturated": int((n_stdp > cap).sum()),
            "stdp_gated_live": int(((n_stdp > 0) & (n_stdp <= cap)).sum())}


def phase_gate_main(spec, stdp, g, table, main_out: dict,
                    n_steps: int = 2000) -> dict:
    """The gate on the main path: both runs must give the ``main`` run's
    spikes, voltages and weights (``main_out``, on the host) bitwise.
    Returns the forced run's launches."""
    launches = {}
    for sweep, kernels in GATE_KERNELS.items():
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=sweep)
        backend = backends.get_backend(sweep)
        cap = backend.gate_capacity(backend.prepare(g))
        _, fin, spikes, rec = run_counted(f"gate_main {sweep}", spec, g,
                                          table, cfg, n_steps, kernels)
        for name, a in (("spikes", spikes), ("v_m", fin.neurons.v_m),
                        ("weights", fin.weights)):
            check(torch.equal(a.cpu(), main_out[name]),
                  f"gate_main {sweep}: {name} differ from the cuda run's")
        branches = gate_branches(g, spikes, cap)
        overflow = int(fin.gate_overflow)
        if cap >= g.blocked.nb:
            check(overflow == 0, f"gate_main {sweep}: overflow {overflow} "
                  "at full capacity")
        else:
            check(overflow == branches["sweep_saturated"],
                  f"gate_main {sweep}: gate_overflow {overflow} != "
                  f"{branches['sweep_saturated']} saturated steps in the "
                  "raster")
            check(overflow > 0 and branches["sweep_gated"] > 0,
                  f"gate_main {sweep}: a branch never ran: {branches}")
            check(branches["stdp_gated_live"] > 0,
                  f"gate_main {sweep}: K7 never updated a live block on "
                  f"the gated branch: {branches}")
        rec["launches_per_step"] = {k: v / n_steps
                                    for k, v in rec["launches"].items() if v}
        emit({"phase": "gate_main", "sweep": sweep, "capacity": cap,
              "nb": g.blocked.nb, "gate_overflow": overflow,
              "steps_by_branch": branches, "bitwise_equal_to_main": True,
              **rec, "profile": _profile(g, table, cfg, spec)})
        launches = rec["launches"]
    return launches


def area_localized_graph(nb=64, pb=256, eb=196_608, *, max_delay=8,
                         pres_per_block=32, seed=0):
    """The reference's gate geometry (``benchmarks/bench_snn.py::
    _area_localized_layout``, same draws): block b's edges come only from
    its own area's ``pres_per_block`` mirrors, a ragged tail block, 16
    padding slots a block.  Each block's slots are then sorted by
    (delay, post), padding at the tail, weights alongside, so that the run
    table of K1 and K6 applies.  Returns a one-shard graph on the card."""
    rng = np.random.default_rng(seed)
    n_local = nb * pb - pb // 2
    names = ("pre", "post", "delay", "channel", "plastic", "weight")
    a = {k: np.zeros((nb, eb), dt) for k, dt in zip(
        names, (np.int32, np.int32, np.int32, np.int32, bool, np.float32))}
    for b in range(nb):
        ne = eb - 16
        a["pre"][b, :ne] = rng.integers(b * pres_per_block,
                                        (b + 1) * pres_per_block, ne)
        hi = pb if (b + 1) * pb <= n_local else n_local - b * pb
        a["post"][b, :ne] = rng.integers(0, hi, ne)
        a["delay"][b, :ne] = rng.integers(1, max_delay + 1, ne)
        a["channel"][b, :ne] = rng.integers(0, 2, ne)
        a["plastic"][b, :ne] = rng.uniform(size=ne) < 0.7
        a["weight"][b, :ne] = rng.uniform(1.0, 50.0, ne)
    t = {k: torch.from_numpy(v).to(DEV) for k, v in a.items()}
    key = torch.where(t["delay"] > 0, t["delay"] * pb + t["post"],
                      (max_delay + 1) * pb)
    order = torch.sort(key, dim=1, stable=True).indices
    t = {k: torch.gather(v, 1, order) for k, v in t.items()}
    bg = BlockedGraph(nb=nb, eb=eb, pb=pb, n_local=n_local,
                      pre_idx=t["pre"], post_rel=t["post"],
                      delay=t["delay"], channel=t["channel"],
                      plastic=t["plastic"],
                      edge_perm=torch.arange(nb * eb, dtype=torch.int32,
                                             device=DEV).reshape(nb, eb),
                      weight=None)
    flat = lambda k: t[k].reshape(-1)
    return engine.ShardGraph(
        n_local=n_local, n_mirror=nb * pres_per_block, max_delay=max_delay,
        pre_idx=flat("pre"), post_idx=flat("post"), delay=flat("delay"),
        channel=flat("channel"), plastic=flat("plastic"),
        weight_init=flat("weight"), bucket_ptr=None, mirror_src_shard=None,
        mirror_src_idx=None, group_id=None, blocked=bg)


def phase_gate_activity(nb=64, pb=256, eb=196_608,
                        fracs=(1.0, 0.25, 0.0625, 0.03125)) -> None:
    """Dense against gated sweep + STDP where the gate has leverage, at the
    reference's active fractions (``bench_snn.py::bench_gate_activity``:
    ~3 % of an active area's neurons fire per step, 5 % of its post rows
    spike, capacity ~1.5x the active blocks, floor 2)."""
    t0 = time.perf_counter()
    g = area_localized_graph(nb, pb, eb)
    bg = g.blocked
    nb, pb, eb, d, m, n = bg.nb, bg.pb, bg.eb, g.max_delay, g.n_mirror, \
        g.n_local
    dense = backends.get_backend("cuda")
    ld = dense.prepare(g)
    w = g.weight_init
    params = models.HPC_STDP
    rng = np.random.default_rng(3)
    traces = stdp_mod_core.TraceState(
        k_pre=torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32)
                               ).to(DEV),
        k_post=torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)
                                ).to(DEV))
    t5 = torch.tensor(5, dtype=torch.int32, device=DEV)
    ppb = m // nb
    build_s = time.perf_counter() - t0
    rows = []
    for frac in fracs:
        n_act = max(int(np.ceil(frac * nb)), 1)
        act = rng.choice(nb, size=n_act, replace=False)
        pre_mask = np.zeros(m, np.float32)
        post_mask = np.zeros(n, np.float32)
        for b in act:
            pre_mask[b * ppb:(b + 1) * ppb] = 1.0
            post_mask[b * pb:min((b + 1) * pb, n)] = 1.0
        ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.03)
                                .astype(np.float32) * pre_mask).to(DEV)
        spk = torch.from_numpy((rng.uniform(size=n) < 0.05)
                               .astype(np.float32) * post_mask).to(DEV)
        cap_target = min(max(int(np.ceil(1.5 * frac * nb)), 2), nb)
        k = (nb * eb) / nb
        rate = float(1.0 - (1.0 - min(cap_target / nb, 1.0 - 1e-9))
                     ** (1.0 / k))
        gated = backends.CudaSparseBackend(gate_rate=max(rate, 1e-9),
                                           min_capacity=2)
        lg = gated.prepare(g)
        cap = gated.gate_capacity(lg)
        ex_d, in_d, ar_d = dense.sweep(ld, w, ring, t5)
        ex_s, in_s, ar_s, ovf = gated.sweep_with_stats(lg, w, ring, t5)
        _, n_active, _ = gated.gate_stats(lg, ring, t5)
        check(torch.equal(ex_d, ex_s) and torch.equal(in_d, in_s)
              and torch.equal(ar_d, ar_s),
              f"gate_activity {frac}: gated sweep differs from dense")
        w_d = dense.stdp_update(ld, w, ar_d, spk, traces, params)
        w_s = gated.stdp_update(lg, w.clone(), ar_s, spk, traces, params)
        check(torch.equal(w_d, w_s),
              f"gate_activity {frac}: gated STDP differs from dense")
        check(not torch.equal(w_d, w), f"gate_activity {frac}: STDP "
              "changed nothing - vacuous")
        # the oracle: blocks with a slot whose pre fired ``delay`` steps
        # ago (an active area may draw no spike at all)
        fired = ring[torch.remainder(5 - bg.delay.long(), d),
                     bg.pre_idx.long()] > 0
        want = int((fired & (bg.delay > 0)).any(dim=1).sum())
        n_active, ovf = int(n_active), int(ovf)
        check(n_active == want and 0 < want <= n_act and ovf == 0,
              f"gate_activity {frac}: n_active {n_active} (want {want} of "
              f"{n_act} active areas), overflow {ovf}")
        scratch = w.clone()
        ms = {}
        for name, be, lay in (("dense", dense, ld), ("gated", gated, lg)):
            sweep = lambda: be.sweep(lay, w, ring, t5)
            stdp_ = lambda: be.stdp_update(lay, scratch, ar_d, spk, traces,
                                           params)

            def both():
                arr = be.sweep(lay, w, ring, t5)[2]
                be.stdp_update(lay, scratch, arr, spk, traces, params)
            ms[name] = {"sweep": median_ms(sweep), "stdp": median_ms(stdp_),
                        "sweep_plus_stdp": median_ms(both)}
        rows.append(dict(active_fraction=frac, active_areas=n_act,
                         n_active=n_active,
                         capacity=cap, overflow=ovf, ms=ms,
                         gated_over_dense=ms["gated"]["sweep_plus_stdp"]
                         / ms["dense"]["sweep_plus_stdp"]))
    emit({"phase": "gate_activity", "nb": nb, "pb": pb, "eb": eb,
          "slots": nb * eb, "live_slots": int((bg.delay > 0).sum()),
          "n_local": n, "n_mirror": m, "max_delay": d,
          "host_build_s": build_s, "bitwise_equal": True,
          "fractions": rows})


# --------------------------------------------------------------------------
# phases 13-14: the LM face's serving path (K8)
# --------------------------------------------------------------------------

def _flash_work(b, s, t, h, hk, dh, dv, causal, dtype):
    """Bytes (each input read once, the output written once) and
    operations (both products over the unmasked pairs) of one call."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (b * s * h * dh + b * t * hk * (dh + dv) + b * s * h * dv)
    pairs = (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
    ops = 2 * b * h * pairs * (dh + dv)
    return nbytes, ops, (BF16_OPS_PER_S if dtype == torch.bfloat16
                         else F32_OPS_PER_S)


def _sass_hgmma() -> int:
    """HGMMA instructions (``wgmma`` in SASS) in the built K8 library."""
    tool = next((c for c in (shutil.which("cuobjdump"),
                             "/usr/local/cuda/bin/cuobjdump")
                 if c and os.path.exists(c)), None)
    check(tool is not None, "cuobjdump not found")
    sass = subprocess.run(
        [tool, "--dump-sass", str(_build.BUILD_DIR / "libflash_attention.so")],
        capture_output=True, text=True, timeout=120, check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def phase_flash_kernels() -> dict:
    """K8 on every case of FLASH_CASES against its twin, each through the
    route its dtype must take; the prefill case's numbers go into the
    kernels line."""
    hgmma = _sass_hgmma()
    emit({"phase": "sass", "library": "build/libflash_attention.so",
          "hgmma_instructions": hgmma, "holds_hgmma": hgmma > 0})
    check(hgmma > 0, "K8's library holds no HGMMA instruction")
    rng = np.random.default_rng(SEED + 9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lines, out = {}, {}
    for name, (b, s, t, h, hk, dh, dv, causal, dtype) in FLASH_CASES.items():
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(DEV, dtype) for shape in
            ((b, s, h, dh), (b, t, hk, dh), (b, t, hk, dv)))
        route = fa_mod._route(q, k, v)
        check(route == FLASH_ROUTE[dtype], f"K8 ({name}) routed to {route}")
        before = dict(fa_mod.flash_attention.launches_by_route)
        k1 = fa_mod.flash_attention(q, k, v, causal=causal)
        k2 = fa_mod.flash_attention(q, k, v, causal=causal)
        check(fa_mod.flash_attention.launches_by_route[route]
              == before[route] + 2, f"K8 ({name}) did not launch {route}")
        pl = fa_mod.flash_attention_plain(q, k, v, causal=causal)
        check(torch.equal(k1, k2), f"K8 ({name}) not bitwise deterministic")
        check(k1.shape == (b, s, h * dv) and k1.dtype == dtype,
              f"K8 ({name}) returned {tuple(k1.shape)} {k1.dtype}")
        err = max_abs(k1, pl)
        check(torch.allclose(k1.float(), pl.float(), **FLASH_TOL[dtype]),
              f"K8 ({name}) differs from its twin by {err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_err = max_abs(lib().transpose(1, 2).reshape(b, s, h * dv), pl)
        k_ms = median_ms(lambda: fa_mod.flash_attention(q, k, v,
                                                        causal=causal))
        p_ms = median_ms(lambda: fa_mod.flash_attention_plain(
            q, k, v, causal=causal))
        l_ms = median_ms(lib)
        nbytes, ops, rate = _flash_work(b, s, t, h, hk, dh, dv, causal,
                                        dtype)
        b_ms, b_by = bound(nbytes, ops, rate)
        lines[name] = dict(shape=dict(b=b, s=s, t=t, h=h, hk=hk, dh=dh,
                                      dv=dv, causal=causal,
                                      dtype=str(dtype)),
                           route=route,
                           max_abs_err=err, tolerance=FLASH_TOL[dtype],
                           kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                           library_max_abs_err=lib_err, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, ops=ops,
                           kernel_over_library=k_ms / l_ms)
        if name == "qwen2.5-3b_prefill":
            out["flash_attention"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=l_ms, bytes=nbytes)
    emit({"phase": "kernel", "name": "flash_attention",
          "library": "torch.nn.functional.scaled_dot_product_attention "
                     "(is_causal, enable_gqa), timed only",
          "deterministic": True, "hgmma_instructions": hgmma,
          "cases": lines})
    return out


def _lm_profile(fn, n_steps: int = 1) -> dict:
    """Device time of ``fn`` by kernel class (K8, GEMMs, the rest), kernel
    launches per step and the device's idle share over the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, launches = {}, 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        by_name[ev.key] = by_name.get(ev.key, 0.0) + dt / 1e3
        launches += ev.count
    busy = sum(by_name.values())
    check(busy > 0, "lm profile: no device time traced")
    gemm_words = ("gemm", "xmma", "nvjet", "cutlass", "cublas", "splitk")
    classes = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for key, ms in by_name.items():
        low = key.lower()
        cls = ("flash_attention" if "flash_attention_kernel" in low
               else "gemm" if any(w in low for w in gemm_words) else "other")
        classes[cls] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": n_steps, "wall_ms": wall * 1e3, "device_ms": busy,
            "device_ms_by_class": classes,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "launches_per_step": launches / n_steps,
            "top_kernels_ms": {k.replace("(anonymous namespace)::", "")[:70]:
                               v for k, v in top}}


def _clear_margin(ref, tol: float):
    """Rows whose top-2 logits are further apart than twice ``tol``: there
    two sides within ``tol`` of each other must pick the same token."""
    top2 = torch.topk(ref, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 2 * tol


def phase_lm_serve() -> int:
    """qwen2.5-3b at full width and depth through ``BatchServer``; returns
    K8's launches in the counted wave."""
    cfg = lm_configs.get(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype)
          == (36, 2048, 16, 2, 128, 11008, 151_936, "bfloat16"),
          f"lm_serve: {LM_ARCH} is not the published config")
    m = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = m.init(SEED, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    srv = BatchServer(m, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      eos_id=-1, device=DEV)
    rng = np.random.default_rng(SEED + 11)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in LM_PROMPT_LENS]
    srv.serve(reqs, max_new_tokens=2)          # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, stats = srv.serve(reqs, max_new_tokens=LM_NEW_TOKENS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for k, c in launches.items():
        want = cfg.n_layers if k == "flash_attention" else 0
        check(c == want, f"lm_serve: {k} launched {c} times in one wave")
    check(all(len(o) == LM_NEW_TOKENS for o in outs)
          and stats.tokens_out == LM_SLOTS * LM_NEW_TOKENS,
          f"lm_serve: {stats.tokens_out} tokens out")
    again, _ = srv.serve(reqs, max_new_tokens=LM_NEW_TOKENS)
    check(again == outs, "lm_serve: a second wave gave other tokens")

    # the wave by hand: prefill counted alone, then the decode chain
    tokens = srv._pad_batch(reqs)
    cache = m.init_cache(LM_SLOTS, LM_MAX_LEN, dtype=torch.bfloat16,
                         device=DEV)
    fa_mod.flash_attention.launches = 0
    by_route = fa_mod.flash_attention.launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    logits, cache = m.prefill(params, {"tokens": tokens}, cache)
    check(fa_mod.flash_attention.launches == cfg.n_layers,
          f"lm_serve: prefill launched K8 "
          f"{fa_mod.flash_attention.launches} times")
    prefill_routes = dict(by_route)
    check(prefill_routes == {"wgmma": cfg.n_layers, "simt": 0},
          f"lm_serve: prefill took K8's routes {prefill_routes}")
    last = logits[:, -1]
    check(bool(torch.isfinite(last).all()), "lm_serve: prefill logits")
    lm_attn.flash_attention = fa_mod.flash_attention_plain
    try:
        plain_last = m.prefill(params, {"tokens": tokens}, m.init_cache(
            LM_SLOTS, LM_MAX_LEN, dtype=torch.bfloat16,
            device=DEV))[0][:, -1]
    finally:
        lm_attn.flash_attention = fa_mod.flash_attention
    swap_err = max_abs(last, plain_last)
    check(swap_err <= LM_LOGIT_ATOL, f"lm_serve: prefill logits with K8 "
          f"differ from the plain twin's by {swap_err}")
    clear = _clear_margin(plain_last, LM_LOGIT_ATOL)
    check(torch.equal(last.argmax(-1)[clear], plain_last.argmax(-1)[clear]),
          "lm_serve: K8 and its twin pick other tokens")
    tok = last.argmax(-1)
    pos = torch.full((LM_SLOTS,), tokens.shape[1], dtype=torch.int64,
                     device=DEV)
    fed, dec_logits = [], [last]
    fa_mod.flash_attention.launches = 0
    for i in range(LM_CHAIN):
        fed.append(tok)
        lg, cache = m.decode(params, cache, tok, pos + i)
        check(bool(torch.isfinite(lg).all()), "lm_serve: decode logits")
        dec_logits.append(lg)
        tok = lg.argmax(-1)
    check(fa_mod.flash_attention.launches == 0,
          "lm_serve: decode launched K8")
    check(torch.stack(fed + [tok], 1).tolist()
          == [o[:LM_CHAIN + 1] for o in outs], "lm_serve: the hand-driven "
          "chain left the served tokens")
    slot = LM_SLOTS - 1                          # the shortest prompt
    seq = torch.cat([tokens[slot], torch.stack(fed)[:, slot]])[None]
    s0 = tokens.shape[1] - 1
    hid = lm_tr.hidden_states(params, cfg, seq)[:, s0:s0 + LM_CHAIN + 1]
    fwd = lm_tr._unembed(params, cfg, hid)[0]    # (LM_CHAIN + 1, vocab)
    chain = torch.stack([x[slot] for x in dec_logits])
    chain_err = max_abs(chain, fwd)
    check(chain_err <= LM_LOGIT_ATOL, f"lm_serve: decode chain differs "
          f"from forward by {chain_err}")
    clear_f = _clear_margin(fwd, LM_LOGIT_ATOL)
    check(torch.equal(chain.argmax(-1)[clear_f], fwd.argmax(-1)[clear_f]),
          "lm_serve: decode chain and forward pick other tokens")

    # the same swap in fp32 at full depth: K8 and its twin then differ by
    # fp32 summation order alone, so a fault in K8 would show here above
    # bf16's rounding noise
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    params32 = m32.init(SEED, device=DEV)
    lm_attn.flash_attention = fa_mod.flash_attention_plain
    try:
        want32 = m32.prefill(params32, {"tokens": tokens}, m32.init_cache(
            LM_SLOTS, LM_MAX_LEN, dtype=torch.float32, device=DEV))[0]
    finally:
        lm_attn.flash_attention = fa_mod.flash_attention
    got32 = m32.prefill(params32, {"tokens": tokens}, m32.init_cache(
        LM_SLOTS, LM_MAX_LEN, dtype=torch.float32, device=DEV))[0]
    swap_err32 = max_abs(got32, want32)
    check(swap_err32 <= LM_LOGIT_ATOL_F32, f"lm_serve: fp32 prefill logits "
          f"with K8 differ from the plain twin's by {swap_err32}")
    del m32, params32, got32, want32

    def decode_steps(n=4):
        t, c, p = last.argmax(-1), cache, pos + LM_CHAIN
        for i in range(n):
            lg, c = m.decode(params, c, t, p + i)
            t = lg.argmax(-1)
            t.cpu()
    prof_prefill = _lm_profile(lambda: m.prefill(params, {"tokens": tokens},
                                                 cache))
    prof_decode = _lm_profile(decode_steps, n_steps=4)
    n_pad = LM_SLOTS * tokens.shape[1]
    emit({"phase": "lm_serve", "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s,
          "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
          "prompt_lens": list(LM_PROMPT_LENS), "new_tokens": LM_NEW_TOKENS,
          "launches": {k: v for k, v in launches.items() if v},
          "prefill_k8_routes": prefill_routes,
          "prefill_ms": stats.prefill_s * 1e3,
          "prefill_tok_per_s_padded": n_pad / stats.prefill_s,
          "prefill_tok_per_s_real": sum(LM_PROMPT_LENS) / stats.prefill_s,
          "decode_ms_per_step": stats.decode_s * 1e3 / LM_NEW_TOKENS,
          "decode_tok_per_s": stats.decode_tok_per_s,
          "peak_device_mem_bytes": peak,
          "k8_vs_twin_logits_max_abs_err": swap_err,
          "k8_vs_twin_rows_argmax_checked": int(clear.sum()),
          "k8_vs_twin_logits_max_abs_err_fp32": swap_err32,
          "logit_tolerance_fp32": LM_LOGIT_ATOL_F32,
          "chain_vs_forward_logits_max_abs_err": chain_err,
          "chain_vs_forward_positions_argmax_checked": int(clear_f.sum()),
          "logit_tolerance": LM_LOGIT_ATOL,
          "logit_abs_max": float(last.abs().max()),
          "logit_std": float(last.std()),
          "second_wave_identical": True,
          "first_tokens": [o[:8] for o in outs],
          "profile_prefill": prof_prefill, "profile_decode": prof_decode})
    return launches["flash_attention"]


def main() -> None:
    smi = phase_device()
    t0 = time.perf_counter()
    spec, stdp = models.hpc_benchmark(1.0, stdp=True)
    g_host = builder.build_shards(spec, builder.decompose(spec, 1))[0]
    g = g_host.to(DEV)
    del g_host
    table = snn.make_param_table(list(spec.groups), models.DT_MS, device=DEV)
    emit({"phase": "build", "neurons": spec.n_neurons, "n_local": g.n_local,
          "edges": int((g.delay > 0).sum()), "nb": g.blocked.nb,
          "eb": g.blocked.eb, "pb": g.blocked.pb, "max_delay": g.max_delay,
          "host_build_s": time.perf_counter() - t0})
    kern = phase_kernels(g)
    phase_lockstep(spec, stdp, g, table)
    phase_mixed()
    runs = {}
    runs["main"], main_out = phase_main(spec, stdp, g, table)
    kern.update(phase_gate_kernels(g))
    runs["gate_main cuda:sparse:1e-7"] = phase_gate_main(spec, stdp, g,
                                                         table, main_out)
    del g, table, main_out
    phase_gate_activity()
    zoo_kern, zoo_runs = zoo()
    kern.update(zoo_kern)
    runs.update(zoo_runs)
    kern.update(phase_flash_kernels())
    runs["lm_serve"] = {"flash_attention": phase_lm_serve()}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/"
                   f"{'synaptic_gather' if name in FUSED_KERNELS else name}"
                   ".cu",
         "replaces": REPLACES[name],
         "launches": runs[LAUNCHES_FROM[name]][name],
         "launches_from": LAUNCHES_FROM[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "ms_per_launch": kern[name].get("ms_per_launch"),
         "epilogue_ms": kern[name].get("epilogue_ms"),
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name].get("library_ms")}
        for name in (*KERNEL_FNS, *FUSED_KERNELS)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
