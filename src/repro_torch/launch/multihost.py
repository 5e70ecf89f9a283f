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
           "net_field_hashes", "global_order", "PeakRss"]

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
    ap.add_argument("--save-every", type=int, default=None,
                    help="supervised mode (checkpoints, gang supervision); "
                         "not ported yet: raises")
    # worker-only (set by the launcher when spawning children)
    ap.add_argument("--process-id", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    return ap


def _refuse_supervised(args) -> None:
    if args.save_every:
        raise NotImplementedError(
            "supervised mode (--save-every: checkpoints, gang supervision, "
            "elastic restarts) waits for the port of the checkpoint and "
            "runtime modules (ROADMAP Queue 1 item 4)")


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
    _refuse_supervised(args)
    if args.devices_per_process % args.row_width:
        raise SystemExit(
            f"--row-width {args.row_width} must divide "
            f"--devices-per-process {args.devices_per_process} so grid rows "
            "align to hosts")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
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


def global_order(spikes, v_m, weights, graph: dict, n_neurons: int,
                 max_delay: int) -> dict:
    """Every shard's results in an order that does not depend on the grid
    or the process count: ``raster`` (T, N) bool by global id, ``v_m``
    (N,) by global id, and the final flat ``weights`` of the live edges
    ordered by (global post id, delay), stable (each post neuron's
    incoming edges in builder order).  ``spikes`` (T, S, n_local), ``v_m``
    (S, n_local), ``weights`` (S, E) and ``graph``'s ``global_id``,
    ``post_idx`` and ``delay`` are numpy over all S shards."""
    gid = np.asarray(graph["global_id"])
    live = gid >= 0
    raster = np.zeros((spikes.shape[0], n_neurons), dtype=bool)
    raster[:, gid[live]] = spikes[:, live]
    v = np.zeros(n_neurons, dtype=v_m.dtype)
    v[gid[live]] = v_m[live]
    delay = np.asarray(graph["delay"])
    post = np.take_along_axis(gid, np.asarray(graph["post_idx"]), 1)
    edges = delay > 0
    key = post.astype(np.int64) * (max_delay + 1) + delay
    order = np.argsort(key[edges], kind="stable")
    return {"raster": raster, "v_m": v, "weights": weights[edges][order]}


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


def run_worker(args: argparse.Namespace) -> dict | None:
    """One process of the gang: returns the record on process 0, else
    None."""
    _refuse_supervised(args)
    import torch
    import torch.distributed as tdist

    from repro_torch import kernels
    from repro_torch.core import backends as backends_mod
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine, multihost

    dev = _worker_device(args)
    backend = multihost.initialize(
        coordinator_address=args.coordinator, num_processes=args.processes,
        process_id=args.process_id,
        backend=multihost.default_backend(
            dev, int(os.environ.get("LOCAL_WORLD_SIZE", args.processes))))
    rank = tdist.get_rank() if backend else 0
    try:
        if args.devices_per_process % args.row_width:
            raise ValueError(f"--row-width {args.row_width} must divide "
                             f"--devices-per-process "
                             f"{args.devices_per_process}")
        n_rows = args.processes * args.devices_per_process // args.row_width
        spec, stdp, drive_boost = _build_spec(args)
        with_blocked = backends_mod.get_backend(
            args.sweep).weights_layout == "blocked"
        mesh = multihost.make_host_mesh(n_rows, args.row_width, device=dev)
        sl = multihost.local_shard_slice(mesh)
        with PeakRss() as rss:
            t0 = time.perf_counter()
            dec = dist.mesh_decompose(spec, n_rows, args.row_width)
            if spec.connectivity == "procedural":
                # O(owned rows): each worker generates only its own
                # shards; peers exchange nothing but mirror-gid tables
                host_net = multihost.prepare_stacked_local(
                    spec, dec, n_rows, args.row_width, mesh,
                    with_blocked=with_blocked)
            else:
                host_net = dist.prepare_stacked(
                    spec, dec, n_rows, args.row_width,
                    with_blocked=with_blocked).select_shards(sl.start,
                                                             sl.stop)
            build_s = time.perf_counter() - t0
        net_hashes = net_field_hashes(host_net)
        net = host_net.to(dev)
        cfg = dist.DistributedConfig(
            engine=engine.EngineConfig(dt=0.1,
                                       stdp=None if args.no_stdp else stdp,
                                       sweep=args.sweep,
                                       neuron_model=spec.neuron_model),
            comm_mode=args.comm_mode, overlap=not args.no_overlap,
            spike_wire=args.wire, spike_wire_remote=args.wire_remote)
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
