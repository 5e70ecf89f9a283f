"""Production-scale dry run of the SNN engine, on the ``meta`` device.

The paper's workload at the paper's scale: the marmoset benchmark's
"normalized problem size 1" (1 M neurons, 3.8 G synapses) and 4x that,
decomposed onto the production meshes (:mod:`repro_torch.launch.mesh`,
256 and 512 devices).  No graph is built: the per-shard shapes come from
the decomposition arithmetic (:func:`shard_dims`), and one shard's step is
run through the raw distributed step
(:func:`repro_torch.core.distributed.make_raw_distributed_step`) on
``meta`` tensors, with the other shards' payloads made up by
:class:`~repro_torch.core.distributed.StandInExchange`.  An op counter
(:class:`repro_torch.utils.op_costs.OpCounter`) reads the step's FLOPs and
bytes off the aten ops it dispatches; the exchange's gathered bytes come
from the stand-in.  A step that waited on the host (``.item()``,
``nonzero``, a branch on a device value) could not run on ``meta``.

Reports per (scale x mesh x wire): the step's FLOPs, traffic and gathered
bytes per shard, the three roofline terms at an H100 SXM's rates, and the
wire model's bytes (which the gathered bytes must equal).  Then a firing
probe on the card (:func:`measure_firing_rates`) measures the per-row
firing the sparse wire and the activity gate must be provisioned for.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_snn

writes ``experiments/dryrun_snn_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import autotune, builder, engine, models, snn
from repro_torch.core import distributed as dist
from repro_torch.core.layout import DEFAULT_PB, blocked_layout_streamed
from repro_torch.core.wire import get_wire, sparse_packed_crossover_fraction
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW
from repro_torch.utils.op_costs import OpCounter

__all__ = ["shard_dims", "state_and_consts_meta", "blocked_consts",
           "argument_bytes", "run_cell", "measure_firing_rates",
           "card_line", "cell_line", "VARIANTS", "main"]

# An H100 SXM's published rates (NVIDIA H100 Tensor Core GPU datasheet):
# the SNN step's FP32 outside the tensor cores, 67 TFLOP/s; HBM3 and
# NVLink as the LM roofline defines them.  The model takes every gather
# at the NVLink rate (an NVLink Switch System spans 256 H100s; between two
# such pods a gather would be slower).
PEAK_FLOPS = 67e12

#: (wire, wire_remote, compact, overlap) of each cell, as the reference's
#: main: the f32 baseline, the packed wire, compact dtypes, overlap off,
#: the sparse id wire, packed intra + sparse remote
VARIANTS = (("f32", None, False, True), ("packed", None, False, True),
            ("packed", None, True, True), ("packed", None, True, False),
            ("sparse", None, True, True), ("packed", "sparse", True, True))
GROUPS = (snn.LIFParams(), snn.LIFParams(t_ref=1.0))


def shard_dims(n_neurons: int, n_edges: int, n_shards: int,
               row_width: int, *, max_delay: int = 64,
               remote_frac: float = 0.25, boundary_frac: float = 0.15):
    """Decomposition arithmetic -> per-shard static shapes (padded)."""
    pad = lambda n, m=128: ((n + m - 1) // m) * m
    n_local = pad(-(-n_neurons // n_shards))
    e = pad(-(-n_edges // n_shards))
    n_mirror = pad(int(n_local * (1.0 + remote_frac)))
    b_pad = pad(max(int(n_local * boundary_frac), 8))
    return dict(n_local=n_local, n_edges=e, n_mirror=n_mirror, b_pad=b_pad,
                max_delay=max_delay)


def _const_dtypes(dims, compact: bool) -> dict:
    """Each const's dtype: the reference's, ``compact`` storing ids in
    uint16 where ``n_mirror`` allows and delays and channels in int8."""
    idx_t = (torch.uint16 if compact and dims["n_mirror"] <= 65535
             else torch.int32)
    small_t = torch.int8 if compact else torch.int32
    return dict(pre_idx=idx_t, post_idx=idx_t, delay=small_t,
                channel=small_t, plastic=torch.bool,
                weight_init=torch.float32, group_id=torch.int32,
                ext_rate=torch.float32, ext_weight=torch.float32,
                mirror_src_idx=idx_t, boundary_slots=idx_t,
                mirror_is_intra=torch.bool, mirror_row_gather=torch.int32,
                mirror_remote_gather=torch.int32,
                mirror_src_flat=torch.int32)


def _const_shapes(dims) -> dict:
    nl, nm, e, b = (dims["n_local"], dims["n_mirror"], dims["n_edges"],
                    dims["b_pad"])
    shapes = dict(pre_idx=e, post_idx=e, delay=e, channel=e, plastic=e,
                  weight_init=e, group_id=nl, ext_rate=nl, ext_weight=nl,
                  mirror_src_idx=nm, boundary_slots=b, mirror_is_intra=nm,
                  mirror_row_gather=nm, mirror_remote_gather=nm,
                  mirror_src_flat=nm)
    return {k: (1, n) for k, n in shapes.items()}


def _shard_state(dims, device, *, seed: int,
                 weights=None) -> dist.DistState:
    """Shard 0's state: zeros (``meta``: no values at all), ``v_m`` at
    the groups' rest, drive generators off ``meta``."""
    nl, nm, e, D = (dims["n_local"], dims["n_mirror"], dims["n_edges"],
                    dims["max_delay"])
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt,
                                                     device=device)
    meta = torch.device(device).type == "meta"
    return dist.DistState(
        v_m=z(1, nl) + GROUPS[0].e_l, syn_ex=z(1, nl), syn_in=z(1, nl),
        ref_count=z(1, nl, dt=torch.int32), ring=z(1, D, nm),
        weights=z(1, e) if weights is None else weights.clone(),
        k_pre=z(1, nm), k_post=z(1, nl), prev_bits=z(1, nl),
        t=z(1, dt=torch.int32), wire_overflow=z(1, dt=torch.int32),
        gate_overflow=z(1, dt=torch.int32),
        generators=([] if meta
                    else dist.shard_generators(seed, (0,), device)),
        shards=(0,))


def state_and_consts_meta(dims, mesh, *, compact: bool = False,
                          device="meta", seed: int = 0):
    """Shard 0's :class:`~repro_torch.core.distributed.DistState` and
    consts, (1, ...) each, in the reference's shapes and dtypes (its
    ``state_and_consts_sds``).  On ``meta`` nothing is allocated; on
    another device the consts are :func:`_host_consts` from ``seed``
    (compact where asked) and the weights their ``weight_init``."""
    dev = torch.device(device)
    dtypes = _const_dtypes(dims, compact)
    if dev.type == "meta":
        consts = {k: torch.empty(shape, dtype=dtypes[k], device=dev)
                  for k, shape in _const_shapes(dims).items()}
        return _shard_state(dims, dev, seed=seed), consts
    consts = {k: torch.from_numpy(v).to(dtypes[k]).to(dev)
              for k, v in _host_consts(dims, mesh, seed=seed).items()}
    st = _shard_state(dims, dev, seed=seed, weights=consts["weight_init"])
    return st, consts


def _host_consts(dims, mesh, *, seed: int) -> dict:
    """Shard 0's consts as int32 numpy arrays drawn from ``seed``, every
    id in range: edges in the builder's (delay, post) order, delays 1 to
    ``max_delay`` and each delay's posts uniform; 80 % excitatory
    (plastic, J = 45.61 pA) and 20 % inhibitory (-5 J) edges, as
    hpc_benchmark's, and a Poisson drive of J at 32 kHz; mirrors drawn
    from the whole grid, intra where their source is in shard 0's row;
    ``b_pad`` boundary neurons."""
    rng = np.random.default_rng(seed)
    nl, nm, e, b, D = (dims["n_local"], dims["n_mirror"], dims["n_edges"],
                       dims["b_pad"], dims["max_delay"])
    S = mesh.size
    rw = mesh.shape[mesh.axis_names[-1]]
    per_delay = rng.multinomial(e, np.full(D, 1.0 / D))
    post = np.concatenate([
        np.repeat(np.arange(nl, dtype=np.int32),
                  rng.multinomial(n, np.full(nl, 1.0 / nl)))
        for n in per_delay])
    delay = np.repeat(np.arange(1, D + 1, dtype=np.int32), per_delay)
    channel = (rng.random(e) < 0.2).astype(np.int32)
    src = rng.integers(0, S, nm, dtype=np.int32)
    idx = rng.integers(0, nl, nm, dtype=np.int32)
    arr = lambda a: np.ascontiguousarray(a)[None]
    return dict(
        pre_idx=arr(rng.integers(0, nm, e, dtype=np.int32)),
        post_idx=arr(post), delay=arr(delay), channel=arr(channel),
        plastic=arr(channel == 0),
        weight_init=arr(np.where(channel == 0, 45.61, -228.05)
                        .astype(np.float32)),
        group_id=arr((rng.random(nl) < 0.2).astype(np.int32)),
        # about twice the Poisson rate whose mean drive reaches threshold
        ext_rate=arr(np.full(nl, 32_000.0, np.float32)),
        ext_weight=arr(np.full(nl, 45.61, np.float32)),
        mirror_src_idx=arr(idx),
        boundary_slots=arr(np.sort(rng.choice(nl, b, replace=False))
                           .astype(np.int32)),
        mirror_is_intra=arr(src // rw == 0),
        mirror_row_gather=arr((src % rw) * nl + idx),
        mirror_remote_gather=arr(src * b + rng.integers(0, b, nm,
                                                        dtype=np.int32)),
        mirror_src_flat=arr(src))


def blocked_consts(consts: dict, dims):
    """The ``blk_*`` consts of shard 0's int32 consts
    (:func:`state_and_consts_meta` off ``meta``), laid out on the host by
    the port's own layout code
    (:func:`~repro_torch.core.layout.blocked_layout_streamed`, the edges
    being in (delay, post) order) and put on the consts' device.  Returns
    ``(blk, blocked_meta (nb, eb, pb), seconds)``, the seconds those of
    the copies to and from the host and the relayout."""
    t0 = time.perf_counter()
    a = {k: consts[k][0].cpu().numpy() for k in (
        "pre_idx", "post_idx", "delay", "channel", "plastic", "weight_init",
        "mirror_src_idx", "group_id", "mirror_src_flat")}
    g = engine.ShardGraph(
        n_local=dims["n_local"], n_mirror=dims["n_mirror"],
        max_delay=dims["max_delay"],
        bucket_ptr=np.concatenate([[0], np.searchsorted(
            a["delay"], np.arange(1, dims["max_delay"] + 2))])
        .astype(np.int64),
        mirror_src_shard=a.pop("mirror_src_flat"), **a)
    bg = blocked_layout_streamed(g)
    dev = consts["delay"].device
    blk = {f"blk_{k}": torch.from_numpy(getattr(bg, k)[None]).to(dev)
           for k in ("pre_idx", "post_rel", "delay", "channel", "plastic",
                     "edge_perm")}
    return blk, (bg.nb, bg.eb, bg.pb), time.perf_counter() - t0


#: the DistState tensors a step reads
_STATE_FIELDS = ("v_m", "syn_ex", "syn_in", "ref_count", "ring", "weights",
                 "k_pre", "k_post", "prev_bits", "t", "wire_overflow",
                 "gate_overflow")


def argument_bytes(state: dist.DistState, consts: dict) -> int:
    """The bytes of a step's arguments: the state's tensors and the
    consts (counted from shapes: on ``meta`` too)."""
    tensors = [*consts.values(), *(getattr(state, k)
                                   for k in _STATE_FIELDS)]
    return sum(x.numel() * x.element_size() for x in tensors)


def run_cell(scale: float, multi_pod: bool, wire: str, *, stdp: bool = True,
             compact: bool = False, overlap: bool = True,
             wire_remote: str | None = None) -> dict:
    """One shard's step of the cell on ``meta``, counted: the reference's
    record, with ``lower_s`` (the step's wall time on ``meta``, binding
    included) for its ``compile_s`` and ``argument_gib`` (the bytes of the
    state and consts) for its ``peak_gib``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    S = mesh.size
    row_width = mesh.shape["model"]
    n_neurons = int(1_000_000 * scale)
    n_edges = int(3_800_000_000 * scale)   # paper: 3.8 G synapses at size 1
    dims = shard_dims(n_neurons, n_edges, S, row_width)
    cfg = dist.DistributedConfig(
        engine=engine.EngineConfig(
            dt=0.1, stdp=models.HPC_STDP if stdp else None, sweep="flat"),
        comm_mode="area", overlap=overlap, spike_wire=wire,
        spike_wire_remote=wire_remote)
    step = dist.make_raw_distributed_step(
        mesh, GROUPS, cfg, max_delay=dims["max_delay"],
        n_local=dims["n_local"], n_mirror=dims["n_mirror"], shards=(0,),
        exchange=dist.StandInExchange, device="meta")
    state, consts = state_and_consts_meta(dims, mesh, compact=compact)
    drive = torch.empty((1, dims["n_local"]), device="meta")
    t0 = time.perf_counter()
    bound = step.bind(consts)
    with OpCounter() as costs:
        bound(state, drive)
    lower_s = time.perf_counter() - t0
    gathered = bound.exchange.gathered_bytes
    split = dist.wire_bytes_split(
        cfg.comm_mode, wire, wire_remote, n_shards=S, row_width=row_width,
        n_local=dims["n_local"], b_pad=dims["b_pad"])
    model_bytes = split["intra"] + split["inter"]
    packed_bytes = dist.wire_bytes_for_dims(
        cfg.comm_mode, "packed", n_shards=S, row_width=row_width,
        n_local=dims["n_local"], b_pad=dims["b_pad"])
    arg_bytes = argument_bytes(state, consts)
    collective = sum(gathered.values())
    rec = dict(
        scale=scale, mesh="2x16x16" if multi_pod else "16x16", wire=wire,
        wire_remote=wire_remote or wire, compact=compact, overlap=overlap,
        n_neurons=n_neurons, n_edges_global=n_edges, **dims,
        wire_model_bytes=model_bytes,
        wire_bytes_intra=split["intra"], wire_bytes_inter=split["inter"],
        wire_vs_packed=round(model_bytes / packed_bytes, 3),
        crossover_frac=round(
            sparse_packed_crossover_fraction(dims["n_local"]), 5),
        lower_s=round(lower_s, 3),
        argument_gib=round(arg_bytes / 2**30, 3),
        flops_per_chip=costs.flops,
        traffic_bytes=costs.traffic_bytes,
        collective_bytes=collective,
        compute_s=costs.flops / PEAK_FLOPS,
        memory_s=costs.traffic_bytes / HBM_BW,
        collective_s=collective / NVLINK_BW)
    terms = {k: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    rec["dominant"] = max(terms, key=terms.get)
    return rec


def measure_firing_rates(*, scale: float = 0.02, steps: int = 400,
                         n_rows: int = 4, row_width: int = 2,
                         seed: int = 0, device="cuda") -> dict:
    """MEASURED per-row firing fractions from a materialized probe run.

    The dry-run cells never build a graph, so their sparse-wire capacity
    is a guess; this probe runs hpc_benchmark at ``scale`` through the
    single-shard engine (``"cuda"``: K1 + K2 in one launch a step, on
    ``device``, the card unless ``device="cpu"``), partitions the neurons
    with the mesh decomposition the cells assume
    (:func:`~repro_torch.core.distributed.mesh_decompose`) and reports
    each row's per-step firing fractions.  The recommended
    ``"sparse:<rate>"`` is the worst row's peak fraction with 2x headroom;
    the same peak provisions the activity gate (``"cuda:sparse:<rate>"``,
    :func:`~repro_torch.core.autotune.recommend_gate_rate`)."""
    spec, _ = models.hpc_benchmark(scale=scale, stdp=False)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(device)
    table = snn.make_param_table(list(spec.groups), 0.1, device=device)
    st = engine.init_state(g, list(spec.groups), seed, device=device)
    _, spikes = engine.run(st, g, table, engine.EngineConfig(dt=0.1),
                           steps, device=device)
    s = spikes[:, :spec.n_neurons].cpu().numpy()
    dec = dist.mesh_decompose(spec, n_rows, row_width)
    row_of = np.asarray(dec.owner) // row_width
    rows = []
    for r in range(n_rows):
        sel = s[:, row_of == r]
        frac = sel.mean(axis=1) if sel.shape[1] else np.zeros(s.shape[0])
        rows.append(dict(
            row=r, n=int(sel.shape[1]),
            rate_hz=round(float(sel.mean() / (0.1e-3)), 2),
            frac_mean=round(float(frac.mean()), 6),
            frac_peak=round(float(frac.max()), 6)))
    peak = max(r["frac_peak"] for r in rows)
    recommended = round(min(max(2.0 * peak, 1e-4), 1.0), 5)
    gate_rate = autotune.recommend_gate_rate(peak)
    nb = max(-(-g.n_local // DEFAULT_PB), 1)
    cap = autotune.gate_capacity(nb, g.n_edges, gate_rate)
    return dict(probe_scale=scale, probe_steps=steps, n_rows=n_rows,
                rows=rows, frac_peak=peak,
                recommended_sparse=f"sparse:{recommended}",
                recommended_gate=f"cuda:sparse:{gate_rate:g}",
                gate_rate=gate_rate,
                gate_capacity_blocks=cap, gate_blocks_total=nb)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a
    note that there is none (the rates are then an H100 SXM's on paper)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "no card (H100 SXM datasheet rates)"


def cell_line(rec: dict, card: str) -> str:
    wtag = (rec["wire"] if rec["wire_remote"] == rec["wire"]
            else f"{rec['wire']}+{rec['wire_remote']}")
    return (f"[{rec['mesh']}] scale={rec['scale']} wire={wtag:13s} "
            f"compact={int(rec['compact'])} overlap={int(rec['overlap'])} "
            f"args={rec['argument_gib']:.2f}GiB "
            f"c={rec['compute_s'] * 1e6:8.1f}us "
            f"m={rec['memory_s'] * 1e6:8.1f}us "
            f"n={rec['collective_s'] * 1e6:8.1f}us "
            f"wire_model={rec['wire_model_bytes']}B "
            f"gathered={rec['collective_bytes']}B "
            f"(intra={rec['wire_bytes_intra']}/"
            f"inter={rec['wire_bytes_inter']}, "
            f"{rec['wire_vs_packed']:.2f}x packed) "
            f"dom={rec['dominant']} [rates of {card}]")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_snn_torch.json")
    ap.add_argument("--probe-scale", type=float, default=1.0,
                    help="hpc_benchmark scale of the measured firing probe")
    ap.add_argument("--probe-steps", type=int, default=400)
    args = ap.parse_args(argv)
    card = card_line()
    results = []
    for multi_pod in (False, True):
        for scale in (1.0, 4.0):
            for wire, wire_remote, compact, overlap in VARIANTS:
                rec = run_cell(scale, multi_pod, wire, compact=compact,
                               overlap=overlap, wire_remote=wire_remote)
                rec["card"] = card
                results.append(rec)
                print(cell_line(rec, card), flush=True)
    dt_ms = 0.1
    for rec in results:
        if rec["scale"] == 1.0 and rec["wire"] == "sparse":
            frac = rec["crossover_frac"]
            print(f"[{rec['mesh']}] packed<->sparse crossover @ "
                  f"n_local={rec['n_local']}: firing fraction {frac:.4f}"
                  f"/step = {frac / (dt_ms * 1e-3):.0f} Hz at dt={dt_ms}ms "
                  f"(sparse capacity must stay below this to win)",
                  flush=True)
    probe = measure_firing_rates(scale=args.probe_scale,
                                 steps=args.probe_steps)
    for r in probe["rows"]:
        print(f"[probe] row {r['row']}: n={r['n']} rate={r['rate_hz']}Hz "
              f"frac mean={r['frac_mean']:.5f}/step "
              f"peak={r['frac_peak']:.5f}/step", flush=True)
    print(f"[probe] measured peak firing fraction {probe['frac_peak']:.5f}"
          f"/step -> recommended wire '{probe['recommended_sparse']}' "
          f"(2x headroom; default 'sparse' provisions "
          f"{get_wire('sparse').max_rate:g})", flush=True)
    print(f"[probe] same peak -> recommended sweep backend "
          f"'{probe['recommended_gate']}' (gate worklist "
          f"{probe['gate_capacity_blocks']}/{probe['gate_blocks_total']} "
          f"post blocks on the probe geometry; saturation falls back to "
          f"the dense pass and counts in gate_overflow)", flush=True)
    results.append(dict(name="firing_probe", card=card, **probe))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
