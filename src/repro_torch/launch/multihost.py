"""Local multi-process launcher and worker of the multi-host SNN path.

One file, two roles:

* **Launcher** (no ``--process-id``): spawns ``--processes`` copies of
  itself on this host, on a shared coordinator, waits for them, fails as
  soon as any fails, and returns the record process 0 wrote.
* **Worker** (``--process-id`` set): joins the process group
  (:func:`repro_torch.core.multihost.initialize`: ``gloo`` on the CPU or
  when processes share a card, ``nccl`` when each has its own), builds its
  own rows of the network (:func:`~repro_torch.core.multihost.
  prepare_stacked_local` for a procedural spec; a materialized spec is
  built whole and keeps its rows), steps them for ``--steps`` through
  :class:`~repro_torch.core.distributed.HostExchange`, and process 0
  writes the record: sha256 of the global spike raster, of the final
  ``v_m`` and of the final weights (each post neuron's incoming edges in
  builder order), spikes, wire overflow, the intra/inter wire bytes, the
  backend, and per process its device, host build seconds, host RSS
  before the build and its peak during the build (sampled, ``PeakRss``),
  and kernel launches.  The arrays hashed go to ``<out>.npz`` beside the
  record, so that two runs can be compared step by step.  ``--bench``
  adds the remote tier alone, timed by CUDA events on the card.

``--save-every N`` runs the gang under supervision (the reference's
supervised runtime): each worker checkpoints every N steps, heartbeats and
fires ``--fault-inject`` faults; the launcher restarts a gang whose worker
died or hung from the newest committed checkpoint, after a capped
exponential backoff, on the same grid or (``--elastic``) on the surviving
processes' smaller grid.  The record then hashes global-order arrays
(``hash_order: "global"``) and carries ``resumed_from``, ``ckpt_events``
and a ``supervision`` block.

``--devices-per-process`` is the number of shards (whole grid rows of
``--row-width``) each process steps.  A worker runs on
``cuda:{local rank % device count}`` (the local rank is ``LOCAL_RANK``,
``SLURM_LOCALID`` or the process id) unless ``--device cpu`` is given;
without a card it raises.  The backend counts ``LOCAL_WORLD_SIZE``
processes on a host (default: all of them).

On a cluster no CLI plumbing is needed: when ``--process-id`` is absent
and SLURM or k8s-style variables name more than one process
(:func:`repro_torch.core.multihost.detect_cluster_env`), every rank runs
this same command line as a worker.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.multihost --processes 2 \\
        --devices-per-process 4 --device cpu --sweep flat --steps 40 \\
        --out experiments/mh.json
    PYTHONPATH=src python -m repro_torch.launch.multihost --processes 2 \\
        --devices-per-process 2 --scale 1.0 --connectivity procedural \\
        --wire packed --wire-remote sparse --bench
    PYTHONPATH=src python -m repro_torch.launch.multihost --processes 2 \\
        --devices-per-process 2 --steps 120 --model lif --no-stdp \\
        --connectivity procedural --device cpu --save-every 30 \\
        --fault-inject 'kill@70#1' --elastic --out experiments/ft.json
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

__all__ = ["build_parser", "run_launcher", "run_worker", "main",
           "net_field_hashes", "global_raster", "global_state_order",
           "global_order", "PeakRss"]

#: calls of the remote tier alone that ``--bench`` times, after warm-up
#: calls
REMOTE_TIER_REPS = 25
WARMUP_REPS = 3
#: seconds between two samples of the host RSS during the build
RSS_PERIOD_S = 0.005


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="multi-host SNN path: local multi-process launcher")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=4,
                    help="shards each process steps (whole grid rows)")
    ap.add_argument("--row-width", type=int, default=2,
                    help="multisection cells per Area-Processes row; must "
                         "divide devices-per-process (host alignment)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--scale", type=float, default=0.02,
                    help="scenario scale")
    ap.add_argument("--scenario", default="hpc_benchmark",
                    help="scenario-zoo network (hpc_benchmark|brunel|"
                         "microcircuit|marmoset; repro_torch.core.models)")
    ap.add_argument("--model", default=None,
                    help="run the cross-model demo network for this "
                         "NeuronModel (lif|izhikevich|adex|poisson) "
                         "instead of --scenario")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drive-boost", type=float, default=None,
                    help="multiplier on the external Poisson rates; "
                         "default 3.0 for the hpc_benchmark smoke (keeps "
                         "tiny nets actually firing) and 1.0 for every "
                         "other scenario/model - a zoo network's "
                         "(g, eta)-style operating point must not be "
                         "silently rescaled")
    ap.add_argument("--sweep", default="cuda",
                    help="execution backend (cuda|cuda:sparse|flat)")
    ap.add_argument("--wire", default="packed",
                    help="intra-host spike wire codec")
    ap.add_argument("--wire-remote", default=None,
                    help="inter-host (boundary) wire codec; default = --wire")
    ap.add_argument("--connectivity", default=None,
                    choices=("materialized", "procedural"),
                    help="override the spec's connectivity mode; "
                         "'procedural' makes every worker build ONLY its "
                         "own rows")
    ap.add_argument("--comm-mode", default="area", choices=("area", "global"))
    ap.add_argument("--no-stdp", action="store_true")
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default; raises without one) or the CPU")
    ap.add_argument("--bench", action="store_true",
                    help="also time the remote tier alone")
    ap.add_argument("--out", default="experiments/multihost.json")
    ap.add_argument("--timeout", type=float, default=900.0)
    # --- fault-tolerant supervised runtime ---------------------------------
    ap.add_argument("--save-every", type=int, default=None,
                    help="checkpoint every N steps and run under gang "
                         "supervision: dead/hung workers are detected, the "
                         "gang is torn down and relaunched from the latest "
                         "committed checkpoint (enables the fault-tolerant "
                         "supervised runtime)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: <out>.ckpt)")
    ap.add_argument("--keep-ckpts", type=int, default=3,
                    help="checkpoints retained by the manager's GC")
    ap.add_argument("--fault-inject", default=None,
                    help="deterministic fault specs "
                         "kind@step[:factor][#rank], comma-separated; "
                         "kinds: kill|hang|slow|ckpt-corrupt (e.g. "
                         "'kill@70#1'); $REPRO_FAULT_INJECT works too")
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0,
                    help="seconds without a worker heartbeat before the "
                         "gang is declared hung and restarted")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="gang restarts before the supervisor aborts")
    ap.add_argument("--backoff", type=float, default=0.25,
                    help="initial gang-restart backoff seconds (doubles "
                         "per restart)")
    ap.add_argument("--backoff-cap", type=float, default=30.0,
                    help="ceiling on the exponential restart backoff")
    ap.add_argument("--elastic", action="store_true",
                    help="on worker loss, restart the gang on the "
                         "SURVIVING process count (elastic shrink-restart "
                         "from the same procedural checkpoint)")
    # worker-only (set by the launcher when spawning children)
    ap.add_argument("--process-id", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--heartbeat-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--incarnation", type=int, default=0,
                    help=argparse.SUPPRESS)
    return ap


# --------------------------------------------------------------------------
# launcher role
# --------------------------------------------------------------------------

def _child_env() -> dict:
    src = os.path.join(os.path.dirname(__file__), "..", "..")
    return dict(
        os.environ,
        PYTHONPATH=os.pathsep.join(
            p for p in (os.path.abspath(src),
                        os.environ.get("PYTHONPATH")) if p),
    )


def _spawn_gang(args, coordinator: str, env: dict) -> list:
    base = [sys.executable, "-m", "repro_torch.launch.multihost",
            "--coordinator", coordinator]
    for k, v in vars(args).items():
        if k in ("process_id", "coordinator") or v is None or v is False:
            continue
        flag = "--" + k.replace("_", "-")
        base += [flag] if v is True else [flag, str(v)]
    return [subprocess.Popen(base + ["--process-id", str(i)], env=env)
            for i in range(args.processes)]


def run_launcher(args: argparse.Namespace) -> dict:
    """Spawn the worker processes, wait, return process 0's record."""
    if args.devices_per_process % args.row_width:
        raise SystemExit(
            f"--row-width {args.row_width} must divide "
            f"--devices-per-process {args.devices_per_process} so grid rows "
            "align to hosts")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.save_every:
        return _run_launcher_supervised(args)
    procs = _spawn_gang(args, f"127.0.0.1:{_free_port()}", _child_env())
    # poll ALL workers: one that fails must fail the launch at once, not
    # after its peers time out waiting for it in a collective
    deadline = time.time() + args.timeout
    pending = dict(enumerate(procs))
    failed: list[tuple[int, object]] = []
    while pending and not failed and time.time() < deadline:
        for i, p in list(pending.items()):
            rc = p.poll()
            if rc is not None:
                del pending[i]
                if rc != 0:
                    failed.append((i, rc))
        if pending and not failed:
            time.sleep(0.2)
    for i, p in pending.items():
        p.kill()
        p.wait()
        failed.append((i, "killed"))
    if failed:
        raise SystemExit(f"worker processes failed: {failed}")
    with open(args.out) as f:
        return json.load(f)


def _run_gang(args, deadline: float) -> list[tuple[int, object]]:
    """One gang incarnation: spawn, watch exits AND heartbeats.

    Returns [] on success or [(rank, why), ...] on failure, with every
    worker reaped - the caller decides restart vs abort.  Heartbeat files
    (written per step by the workers' SimulationSupervisor into this
    incarnation's own --heartbeat-dir) catch the failure mode exit codes
    cannot: a HUNG worker that never dies.  A worker blocked in a
    collective on a dead peer is killed here too.
    """
    from repro_torch.runtime.supervisor import HeartbeatFile
    procs = _spawn_gang(args, f"127.0.0.1:{_free_port()}", _child_env())
    spawn_t = time.time()
    pending = dict(enumerate(procs))
    failed: list[tuple[int, object]] = []
    while pending and not failed and time.time() < deadline:
        for i, p in list(pending.items()):
            rc = p.poll()
            if rc is not None:
                del pending[i]
                if rc != 0:
                    failed.append((i, rc))
        if pending and not failed and args.heartbeat_timeout:
            now = time.time()
            ages = HeartbeatFile.ages(args.heartbeat_dir, now)
            for i in pending:
                # a worker that never beat is aged from gang spawn time
                if ages.get(i, now - spawn_t) > args.heartbeat_timeout:
                    failed.append((i, "hung"))
        if pending and not failed:
            time.sleep(0.2)
    if pending and not failed:   # overall deadline hit
        failed = [(i, "timeout") for i in pending]
    # tear down the REMAINING gang: a half-dead gang cannot make progress
    # (the collectives block), so recovery is all-or-nothing
    for i, p in pending.items():
        p.kill()
        p.wait()
    return failed


def _incarnation_info(directory: str) -> dict:
    """rank -> what each worker of an incarnation wrote about itself
    (``info_<rank>.json`` beside its heartbeat: build and restore
    seconds)."""
    out = {}
    if os.path.isdir(directory):
        for n in sorted(os.listdir(directory)):
            if n.startswith("info_") and n.endswith(".json"):
                with open(os.path.join(directory, n)) as f:
                    out[int(n[5:-5])] = json.load(f)
    return out


def _run_launcher_supervised(args) -> dict:
    """Gang supervision: relaunch from the latest committed checkpoint.

    Detects dead (exit code) and hung (heartbeat timeout) workers, tears
    the gang down, backs off per RestartPolicy (real capped-exponential
    delays) and relaunches; workers resume from the newest readable
    checkpoint on their own.  With ``--elastic`` a lost worker shrinks the
    next incarnation to the surviving process count - the workers re-run
    the Area-Processes decomposition for the smaller grid and remap the
    checkpoint onto it (repro_torch.runtime.elastic.shrink_remap_state).
    The record gains a ``supervision`` block: restart events, per-tier
    retry counts, the actual backoff delays, and each incarnation's wall
    seconds, processes, failures and its workers' build and restore
    seconds.
    """
    from repro_torch.runtime import elastic
    from repro_torch.runtime.fault import RestartPolicy
    args.ckpt_dir = args.ckpt_dir or args.out + ".ckpt"
    os.makedirs(args.ckpt_dir, exist_ok=True)
    policy = RestartPolicy(max_restarts=args.max_restarts,
                           backoff_s=args.backoff, backoff_mult=2.0,
                           backoff_cap_s=args.backoff_cap)
    events: list[str] = []
    delays: list[float] = []
    tiers = {"same": 0, "shrink": 0}
    incarnations: list[dict] = []
    deadline = time.time() + args.timeout
    incarnation = 0
    while True:
        args.incarnation = incarnation
        # per-incarnation heartbeat dir: a dead gang's last beats must not
        # read as liveness for the next one
        args.heartbeat_dir = os.path.join(args.ckpt_dir,
                                          f"hb_{incarnation:03d}")
        t0 = time.perf_counter()
        failed = _run_gang(args, deadline)
        incarnations.append(dict(
            processes=args.processes, wall_s=time.perf_counter() - t0,
            failed=[[r, str(c)] for r, c in sorted(failed)],
            workers=_incarnation_info(args.heartbeat_dir)))
        if not failed:
            break
        events.append(
            f"fail@inc{incarnation}:"
            + ",".join(f"{r}={c}" for r, c in sorted(failed)))
        if time.time() >= deadline:
            raise SystemExit(
                f"supervised launch timed out; events={events}")
        action, delay = policy.next_action()
        if action == "abort":
            raise SystemExit(
                f"gang exceeded max restarts ({policy.max_restarts}); "
                f"events={events}")
        delays.append(delay)
        events.append(f"backoff:{delay:.6g}")
        time.sleep(delay)
        lost = {r for r, _ in failed}
        if args.elastic and args.processes > 1:
            new_p = max(args.processes - len(lost), 1)
            plan = elastic.plan_mesh(new_p * args.devices_per_process,
                                     model_width=args.row_width,
                                     prefer_pods=False)
            events.append(f"shrink:{args.processes}->{new_p}"
                          f"(mesh {plan.shape[0]}x{plan.shape[1]})")
            args.processes = new_p
            tiers["shrink"] += 1
        else:
            tiers["same"] += 1
        incarnation += 1
    with open(args.out) as f:
        rec = json.load(f)
    rec["supervision"] = dict(
        restarts=policy.restarts, incarnations=incarnation + 1,
        tiers=tiers, events=events, delays=delays,
        processes_final=args.processes, elastic=bool(args.elastic),
        per_incarnation=incarnations)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


# --------------------------------------------------------------------------
# worker role
# --------------------------------------------------------------------------

def _build_spec(args):
    """Deterministic (spec, stdp, drive_boost) every rank agrees on."""
    from repro_torch.core import models

    if args.model:
        spec, stdp = models.model_demo(args.model, scale=args.scale,
                                       stdp=True)
    else:
        spec, stdp = models.get_scenario(args.scenario, scale=args.scale)
    drive_boost = args.drive_boost
    if drive_boost is None:
        drive_boost = (3.0 if not args.model
                       and args.scenario == "hpc_benchmark" else 1.0)
    if drive_boost != 1.0:
        pops = [dataclasses.replace(p, ext_rate_hz=p.ext_rate_hz
                                    * drive_boost)
                for p in spec.populations]
        spec = dataclasses.replace(spec, populations=pops)
    if args.connectivity:
        spec = dataclasses.replace(spec, connectivity=args.connectivity)
    return spec, stdp, drive_boost


def _worker_device(args):
    """This worker's device: the CPU if asked for, else its local rank's
    card; raises without a card."""
    import torch

    from repro_torch.core.device import resolve_device
    if args.device == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK",
                               os.environ.get("SLURM_LOCALID",
                                              args.process_id)))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def net_field_hashes(net) -> dict:
    """sha256 of each (S, ...) array of a host-side StackedNetwork (its
    dtype and shape included): two nets hold the same rows iff these
    agree."""
    from repro_torch.core import distributed as dist
    arrays = dict(net.graph)
    arrays.update({k: getattr(net, k) for k in dist._META_FIELDS})
    out = {}
    for k, a in sorted(arrays.items()):
        a = np.asarray(a)
        h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
        out[k] = h.hexdigest()
    return out


def global_raster(spikes, global_id, n_neurons: int) -> np.ndarray:
    """(T, S, n_local) spikes of every shard -> (T, N) bool by global id
    (``global_id`` (S, n_local), -1 on padding rows)."""
    gid = np.asarray(global_id)
    live = gid >= 0
    raster = np.zeros((spikes.shape[0], n_neurons), dtype=bool)
    raster[:, gid[live]] = spikes[:, live]
    return raster


def global_state_order(v_m, weights, graph: dict, n_neurons: int,
                       max_delay: int) -> dict:
    """The final state in an order that does not depend on the grid or the
    process count: ``v_m`` (N,) by global id, and the final flat
    ``weights`` of the live edges ordered by (global post id, delay),
    stable (each post neuron's incoming edges in builder order).  ``v_m``
    (S, n_local), ``weights`` (S, E) and ``graph``'s ``global_id``,
    ``post_idx`` and ``delay`` are numpy over all S shards."""
    gid = np.asarray(graph["global_id"])
    live = gid >= 0
    v = np.zeros(n_neurons, dtype=v_m.dtype)
    v[gid[live]] = v_m[live]
    delay = np.asarray(graph["delay"])
    post = np.take_along_axis(gid, np.asarray(graph["post_idx"]), 1)
    edges = delay > 0
    key = post.astype(np.int64) * (max_delay + 1) + delay
    order = np.argsort(key[edges], kind="stable")
    return {"v_m": v, "weights": weights[edges][order]}


def global_order(spikes, v_m, weights, graph: dict, n_neurons: int,
                 max_delay: int) -> dict:
    """Every shard's results in an order that does not depend on the grid
    or the process count: ``raster`` (T, N) bool by global id
    (:func:`global_raster`) and :func:`global_state_order`'s ``v_m`` and
    ``weights``.  ``spikes`` is (T, S, n_local) numpy over all S shards."""
    return {"raster": global_raster(spikes, graph["global_id"], n_neurons),
            **global_state_order(v_m, weights, graph, n_neurons, max_delay)}


def _rss_bytes() -> int:
    """Resident host memory of this process now (``/proc/self/statm``,
    Linux), bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class PeakRss:
    """Host RSS before a block (``before``) and its peak while the block
    runs (``peak``), sampled every RSS_PERIOD_S by a thread: the build's
    own peak, whatever peak torch and the card's context set before it."""

    def __enter__(self):
        self.before = self.peak = _rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(RSS_PERIOD_S):
            self.peak = max(self.peak, _rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


def _gather_objects(obj) -> list:
    import torch.distributed as tdist
    if not tdist.is_initialized():
        return [obj]
    out = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, obj)
    return out


def _remote_route(backend: str | None, dev) -> str:
    if backend is None:
        return "none (one process: the world gather is the stacked payload)"
    if backend == "nccl":
        return "nccl all_gather of device tensors"
    if dev.type == "cuda":
        return ("gloo all_gather of CUDA tensors, staged through pinned "
                "host memory by gloo")
    return "gloo all_gather of host tensors"


def _bench(step, state, dev) -> dict:
    """The remote tier alone (encode, world gather, wait, decode) on the
    spikes of ``state``'s last step, REMOTE_TIER_REPS times after
    WARMUP_REPS: CUDA events on the card, the host clock on the CPU.
    Collective: every process runs the same count."""
    import torch

    from repro_torch.core import distributed as dist
    ex, bits = step.exchange, state.prev_bits
    remote = lambda: dist._finish_remote(dist._issue_remote(bits, ex)[0],
                                         ex, bits.dtype)
    for _ in range(WARMUP_REPS):
        remote()
    times = []
    for _ in range(REMOTE_TIER_REPS):
        if dev.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            remote()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            remote()
            times.append((time.perf_counter() - t0) * 1e3)
    return {"remote_tier_ms": statistics.median(times),
            "remote_tier_timer": ("cuda events" if dev.type == "cuda"
                                  else "host clock")}


def _join(args):
    """This worker's device, and the process group joined on it:
    ``(device, backend or None, rank)``."""
    import torch.distributed as tdist

    from repro_torch.core import multihost

    dev = _worker_device(args)
    backend = multihost.initialize(
        coordinator_address=args.coordinator, num_processes=args.processes,
        process_id=args.process_id,
        backend=multihost.default_backend(
            dev, int(os.environ.get("LOCAL_WORLD_SIZE", args.processes))))
    return dev, backend, tdist.get_rank() if backend else 0


def _config(args, spec, stdp):
    """The distributed step's configuration from the command line."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine

    return dist.DistributedConfig(
        engine=engine.EngineConfig(dt=0.1,
                                   stdp=None if args.no_stdp else stdp,
                                   sweep=args.sweep,
                                   neuron_model=spec.neuron_model),
        comm_mode=args.comm_mode, overlap=not args.no_overlap,
        spike_wire=args.wire, spike_wire_remote=args.wire_remote)


def _build_rows(args, spec, mesh):
    """This process's rows of ``spec`` on ``mesh``'s grid (host arrays):
    ``(decomposition, host_net, build seconds, PeakRss)``."""
    from repro_torch.core import backends as backends_mod
    from repro_torch.core import distributed as dist
    from repro_torch.core import multihost

    n_rows, row_width = mesh.grid.shape
    sl = multihost.local_shard_slice(mesh)
    with_blocked = backends_mod.get_backend(
        args.sweep).weights_layout == "blocked"
    with PeakRss() as rss:
        t0 = time.perf_counter()
        dec = dist.mesh_decompose(spec, n_rows, row_width)
        if spec.connectivity == "procedural":
            # O(owned rows): each worker generates only its own shards;
            # peers exchange nothing but mirror-gid tables
            host_net = multihost.prepare_stacked_local(
                spec, dec, n_rows, row_width, mesh,
                with_blocked=with_blocked)
        else:
            host_net = dist.prepare_stacked(
                spec, dec, n_rows, row_width,
                with_blocked=with_blocked).select_shards(sl.start, sl.stop)
        build_s = time.perf_counter() - t0
    return dec, host_net, build_s, rss


def run_worker(args: argparse.Namespace) -> dict | None:
    """One process of the gang: returns the record on process 0, else
    None."""
    if args.save_every:
        return _run_worker_supervised(args)
    import torch
    import torch.distributed as tdist

    from repro_torch import kernels
    from repro_torch.core import distributed as dist
    from repro_torch.core import multihost

    dev, backend, rank = _join(args)
    try:
        if args.devices_per_process % args.row_width:
            raise ValueError(f"--row-width {args.row_width} must divide "
                             f"--devices-per-process "
                             f"{args.devices_per_process}")
        n_rows = args.processes * args.devices_per_process // args.row_width
        spec, stdp, drive_boost = _build_spec(args)
        mesh = multihost.make_host_mesh(n_rows, args.row_width, device=dev)
        sl = multihost.local_shard_slice(mesh)
        _, host_net, build_s, rss = _build_rows(args, spec, mesh)
        net_hashes = net_field_hashes(host_net)
        net = host_net.to(dev)
        cfg = _config(args, spec, stdp)
        step = multihost.make_multihost_step(net, list(spec.groups), cfg,
                                             device=dev)
        state = multihost.init_multihost_state(
            net, list(spec.groups), args.seed, sweep=args.sweep,
            neuron_model=spec.neuron_model, device=dev)

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        final, spikes = step.run(state, args.steps)
        elapsed = time.perf_counter() - t0
        launches = {k: c for k, c in kernels.launch_counts().items() if c}
        bench = _bench(step, final, dev) if args.bench else None

        # every shard's results on every process (collective)
        host = multihost.replicate_to_host
        spikes_all = host(spikes.transpose(0, 1).to(torch.uint8))
        v_m, weights = host(final.v_m), host(final.weights)
        graph = {k: host(host_net.graph[k])
                 for k in ("global_id", "post_idx", "delay")}
        overflow = int(host(final.wire_overflow).sum())
        procs = _gather_objects(dict(
            process_id=rank,
            device=str(dev), shards=[sl.start, sl.stop],
            host_build_s=build_s, rss_before_build_bytes=rss.before,
            peak_rss_during_build_bytes=rss.peak,
            launches=launches, net_sha256=net_hashes, bench=bench))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    if rank != 0:
        return None
    arrays = global_order(spikes_all.transpose(1, 0, 2).astype(bool), v_m,
                          weights, graph, spec.n_neurons, spec.max_delay)
    split = dist.wire_bytes_split(
        args.comm_mode, args.wire, args.wire_remote, n_shards=net.n_shards,
        row_width=net.row_width, n_local=net.n_local, b_pad=net.b_pad)
    stem = os.path.splitext(args.out)[0]
    np.savez(stem + ".npz", **arrays)
    rec = dict(
        processes=args.processes, shards=net.n_shards,
        shards_per_process=args.devices_per_process, n_rows=n_rows,
        row_width=args.row_width, steps=args.steps, scale=args.scale,
        seed=args.seed, sweep=args.sweep,
        scenario=None if args.model else args.scenario,
        model=spec.neuron_model, drive_boost=drive_boost,
        wire=args.wire, wire_remote=args.wire_remote or args.wire,
        comm_mode=args.comm_mode, overlap=not args.no_overlap,
        stdp=not args.no_stdp, connectivity=spec.connectivity,
        dist_backend=backend or "none", remote_route=_remote_route(backend,
                                                                   dev),
        bits_sha256=_sha(arrays["raster"]), vm_sha256=_sha(arrays["v_m"]),
        weights_sha256=_sha(arrays["weights"]),
        spiked=int(arrays["raster"].sum()), overflow=overflow,
        wire_bytes_intra=split["intra"], wire_bytes_inter=split["inter"],
        elapsed_s=elapsed, steps_per_s=args.steps / elapsed,
        arrays=stem + ".npz", per_process=procs)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "per_process"}))
    return rec


def _run_worker_supervised(args: argparse.Namespace) -> dict | None:
    """Checkpointed, fault-injected worker under gang supervision.

    Differences from the plain worker:

    * the grid comes from :func:`repro_torch.core.multihost.
      plan_elastic_mesh` (this incarnation's world size times
      ``--devices-per-process``), so a shrunken gang lands on the smaller
      Area-Processes decomposition;
    * the loop runs under :class:`repro_torch.runtime.supervisor.
      SimulationSupervisor`: a heartbeat and fault injection per step, and
      every ``--save-every`` steps a full host snapshot
      (``snapshot_host_state``, collective, every shard's generator
      included) committed by process 0 with ``network_metadata``;
    * on restart the worker resumes from the newest readable checkpoint:
      same grid -> its rows of the snapshot; another grid ->
      ``elastic.shrink_remap_state``;
    * each process keeps its spike rows on the device and the processes
      gather them at each save (which every rank reaches anyway), not
      every step; process 0 writes the global-order prefix
      (``traj_<step>.npy``, (step, N) uint8) right before the checkpoint
      commit, so a resumed run still reports the FULL trajectory;
    * hashes are over global-order arrays (``hash_order: "global"``), as
      the plain worker's: comparable across process counts and grids.
    """
    import torch
    import torch.distributed as tdist

    from repro_torch import kernels
    from repro_torch.checkpoint.manager import (CheckpointManager,
                                                network_metadata)
    from repro_torch.core import distributed as dist
    from repro_torch.core import multihost
    from repro_torch.runtime import elastic, inject
    from repro_torch.runtime.supervisor import (HeartbeatFile,
                                                SimulationSupervisor)

    dev, backend, rank = _join(args)
    host = multihost.replicate_to_host
    try:
        spec, stdp, drive_boost = _build_spec(args)
        groups = list(spec.groups)
        mesh = multihost.plan_elastic_mesh(
            args.row_width, args.devices_per_process, device=dev)
        n_rows, row_width = mesh.grid.shape
        sl = multihost.local_shard_slice(mesh)
        dec, host_net, build_s, rss = _build_rows(args, spec, mesh)
        net = host_net.to(dev)
        cfg = _config(args, spec, stdp)
        step = multihost.make_multihost_step(net, groups, cfg, device=dev)

        ckpt_dir = args.ckpt_dir or args.out + ".ckpt"
        mgr = CheckpointManager(ckpt_dir, keep=args.keep_ckpts)
        base = multihost.init_multihost_state(
            net, groups, args.seed, sweep=args.sweep,
            neuron_model=spec.neuron_model, device=dev)
        carried = {"wire_overflow": 0, "gate_overflow": 0}
        resumed_from = None
        start = 0
        t0 = time.perf_counter()
        state = base
        if mgr.latest_step() is not None:
            got, snap, md = mgr.load_host()
            for key, mine in (("sweep", args.sweep), ("device", dev.type)):
                if md.get(key, mine) != mine:
                    raise SystemExit(
                        f"checkpoint at step {got} was written with "
                        f"{key}={md[key]}, cannot resume with {mine}")
            old = (int(md.get("n_rows", n_rows)),
                   int(md.get("row_width", row_width)))
            if old == (n_rows, row_width):
                fields = snap
            else:
                fields, carried = elastic.shrink_remap_state(
                    spec, args.seed, snap, step=got, old_n_rows=old[0],
                    old_row_width=old[1], new_dec=dec, new_net=net,
                    groups=groups, sweep=args.sweep,
                    neuron_model=spec.neuron_model,
                    stdp_active=not args.no_stdp, dt=cfg.engine.dt,
                    external_drive=cfg.engine.external_drive, device=dev)
            state = multihost.state_from_fields(
                fields, net, weights_layout=base.weights_layout,
                neuron_model=base.neuron_model, model_seed=base.model_seed,
                device=dev)
            del snap, fields
            start = resumed_from = got
        restore_s = time.perf_counter() - t0
        if args.heartbeat_dir:
            os.makedirs(args.heartbeat_dir, exist_ok=True)
            with open(os.path.join(args.heartbeat_dir,
                                   f"info_{rank:05d}.json"), "w") as f:
                json.dump({"host_build_s": build_s, "restore_s": restore_s,
                           "resumed_from": resumed_from}, f)

        # the global-order spike trajectory: the committed prefix (rank 0)
        # and this incarnation's rows, kept on the device until a save
        traj_path = lambda s: os.path.join(ckpt_dir, f"traj_{s:09d}.npy")
        gid = host(host_net.graph["global_id"])
        rows: list[np.ndarray] = []
        if resumed_from and rank == 0:
            prefix = np.load(traj_path(resumed_from))
            if prefix.shape != (resumed_from, spec.n_neurons):
                raise SystemExit(
                    f"trajectory prefix {traj_path(resumed_from)} is "
                    f"{prefix.shape}, checkpoint says {resumed_from} steps "
                    f"of {spec.n_neurons} neurons")
            rows.append(prefix.astype(bool))
        spikes = torch.empty((args.steps - start, *state.v_m.shape),
                             dtype=torch.bool, device=dev)
        gathered = [start]

        def gather_rows(upto: int) -> None:
            """Rows gathered[0]..upto of every shard, to process 0 in
            global order (collective)."""
            part = spikes[gathered[0] - start:upto - start]
            allp = host(part.transpose(0, 1).contiguous())  # (S, T', n)
            gathered[0] = upto
            if rank == 0:
                rows.append(global_raster(allp.transpose(1, 0, 2), gid,
                                          spec.n_neurons))

        def step_fn(carry, i):
            step.advance(carry, out=spikes[i - start])
            return carry, None

        def snapshot_fn(carry):
            return multihost.snapshot_host_state(step.state_from(carry,
                                                                 state))

        def pre_save(s, _carry):
            gather_rows(s)
            if rank == 0:
                tmp = traj_path(s) + ".tmp"
                with open(tmp, "wb") as f:   # no np.save ".npy" suffix
                    np.save(f, np.concatenate(rows).astype(np.uint8))
                os.replace(tmp, traj_path(s))

        def metadata_fn(s, _carry):
            return network_metadata(spec, seed=args.seed, extra=dict(
                step=s, n_rows=n_rows, row_width=row_width,
                sweep=args.sweep, device=dev.type,
                neuron_model=spec.neuron_model, stdp=not args.no_stdp,
                connectivity=spec.connectivity))

        hb = (HeartbeatFile(args.heartbeat_dir, rank)
              if args.heartbeat_dir else None)
        injector = inject.FaultInjector.from_args(
            args.fault_inject, rank=rank, mode="process",
            state_dir=os.path.join(ckpt_dir, "faults"), ckpt_dir=ckpt_dir)
        sup = SimulationSupervisor(
            mgr if rank == 0 else None, save_every=args.save_every,
            heartbeat=hb, injector=injector, snapshot_fn=snapshot_fn,
            metadata_fn=metadata_fn, pre_save=pre_save, restore_fn=None)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        carry, _ = sup.run(step.carry_from(state), step_fn, args.steps,
                           start_step=start)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        launches = {k: c for k, c in kernels.launch_counts().items() if c}
        gather_rows(args.steps)
        final = step.state_from(carry, state, "flat")
        v_m, weights = host(final.v_m), host(final.weights)
        graph = {k: host(host_net.graph[k]) for k in ("post_idx", "delay")}
        graph["global_id"] = gid
        overflow = carried["wire_overflow"] + int(
            host(final.wire_overflow).sum())
        gate = carried["gate_overflow"] + int(
            host(final.gate_overflow).sum())
        procs = _gather_objects(dict(
            process_id=rank, device=str(dev), shards=[sl.start, sl.stop],
            host_build_s=build_s, rss_before_build_bytes=rss.before,
            peak_rss_during_build_bytes=rss.peak, restore_s=restore_s,
            launches=launches, steps_run=args.steps - start))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    if rank != 0:
        return None
    arrays = {"raster": np.concatenate(rows),
              **global_state_order(v_m, weights, graph, spec.n_neurons,
                                   spec.max_delay)}
    split = dist.wire_bytes_split(
        args.comm_mode, args.wire, args.wire_remote, n_shards=net.n_shards,
        row_width=net.row_width, n_local=net.n_local, b_pad=net.b_pad)
    stem = os.path.splitext(args.out)[0]
    np.savez(stem + ".npz", **arrays)
    rec = dict(
        processes=args.processes, shards=net.n_shards,
        shards_per_process=args.devices_per_process, n_rows=n_rows,
        row_width=row_width, steps=args.steps, scale=args.scale,
        seed=args.seed, sweep=args.sweep,
        scenario=None if args.model else args.scenario,
        model=spec.neuron_model, drive_boost=drive_boost,
        wire=args.wire, wire_remote=args.wire_remote or args.wire,
        comm_mode=args.comm_mode, overlap=not args.no_overlap,
        stdp=not args.no_stdp, connectivity=spec.connectivity,
        dist_backend=backend or "none",
        remote_route=_remote_route(backend, dev),
        bits_sha256=_sha(arrays["raster"]), vm_sha256=_sha(arrays["v_m"]),
        weights_sha256=_sha(arrays["weights"]),
        spiked=int(arrays["raster"].sum()), overflow=overflow,
        gate_overflow=gate,
        wire_bytes_intra=split["intra"], wire_bytes_inter=split["inter"],
        elapsed_s=elapsed, steps_per_s=(args.steps - start) / elapsed,
        arrays=stem + ".npz", per_process=procs,
        # supervised-runtime extras
        hash_order="global", supervised=True, save_every=args.save_every,
        resumed_from=resumed_from, incarnation=args.incarnation,
        ckpt_events=sup.events, ckpt_timings=mgr.timings)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("per_process", "ckpt_timings")}))
    return rec


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.process_id is None:
        # cluster launches (SLURM / k8s-style variables) need no CLI
        # plumbing: every rank runs the same command line and takes its
        # identity from the environment; a single-task allocation keeps
        # the local launcher role
        from repro_torch.core.multihost import detect_cluster_env
        env = detect_cluster_env()
        if env is not None and env["num_processes"] > 1:
            args.process_id = env["process_id"]
            args.processes = env["num_processes"]
            args.coordinator = args.coordinator or env["coordinator_address"]
    if args.process_id is not None:
        run_worker(args)
        return
    rec = run_launcher(args)
    print(f"[multihost] {args.processes} process(es) ok: "
          f"spiked={rec['spiked']} overflow={rec['overflow']} "
          f"bits={rec['bits_sha256'][:12]}... -> {args.out}")


if __name__ == "__main__":
    main()
