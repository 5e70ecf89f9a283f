"""Multi-host SNN path: the two-level decomposition across processes.

The port of the reference package's ``core/multihost.py``: the layer that
makes problem size scale with process count (paper §III).  The reference
places the stacked (S, ...) arrays on a multi-process jax mesh; here each
process holds the rows of its own shards and steps them through
:class:`repro_torch.core.distributed.HostExchange`, over a
``torch.distributed`` process group.

Host-aware mapping: the (rows, row_width) shard grid is laid out
process-major, whole rows per process (:func:`make_host_mesh` refuses a
row that would span processes).  So

* the intra-row tier never leaves a process: it is the stacked payload of
  the process's own rows;
* only the boundary tier (``n(boundary) << n_local`` under area mapping)
  crosses processes, on its own wire if ``spike_wire_remote`` says so,
  as one all-gather issued before the sweep and waited on where the
  delay-1 arrivals are read.

Build: :func:`prepare_stacked_local` builds only the process's own shards
of a procedural spec; the processes agree on pads analytically and
exchange only their remote-mirror gid tables.  Launch and identity:
:func:`detect_cluster_env` (SLURM or k8s-style variables) and
:func:`initialize`, which joins a process group on an explicit backend:
``nccl`` when every process has a card of its own, ``gloo`` on the CPU or
when processes share a card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from repro_torch.core import builder as builder_mod
from repro_torch.core import distributed as dist
from repro_torch.core import neuron_models as neuron_models_mod
from repro_torch.core.device import resolve_device

__all__ = ["initialize", "detect_cluster_env", "default_backend",
           "HostTopology", "HostMesh", "make_host_mesh", "plan_elastic_mesh",
           "host_topology",
           "local_shard_slice", "replicate_to_host", "make_multihost_step",
           "init_multihost_state", "prepare_stacked_local",
           "state_from_fields", "snapshot_host_state"]

#: default coordinator port when only a nodelist is known (SLURM);
#: override with REPRO_COORD_PORT
DEFAULT_COORD_PORT = 12321


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist expression.

    Handles the common compact forms: ``node[003-008,010],other[1-2]`` ->
    ``node003``, plain comma lists (``login1,nid[001-002]`` -> ``login1``),
    and bare hostnames.  The prefix match excludes commas so a plain first
    element never swallows a later bracketed group.  (Only rank 0's host
    serves as the coordinator.)
    """
    m = re.match(r"^([^\[,]+)\[([^\]\-,]+)", nodelist.strip())
    if m:
        return m.group(1) + m.group(2)
    return nodelist.split(",")[0].strip()


def detect_cluster_env(environ=None) -> dict | None:
    """Cluster launch parameters from the environment, or None.

    * **k8s-style explicit vars** (checked first - they are opt-in):
      ``REPRO_COORD_ADDR`` (host:port), ``REPRO_NUM_PROC``,
      ``REPRO_PROC_ID``;
    * **SLURM**: ``SLURM_PROCID`` / ``SLURM_NTASKS`` /
      ``SLURM_STEP_NODELIST`` (falling back to ``SLURM_JOB_NODELIST``);
      the coordinator is the nodelist's first host on
      ``REPRO_COORD_PORT`` (default 12321).

    Returns ``dict(coordinator_address=..., num_processes=...,
    process_id=...)`` ready to splat into :func:`initialize`.
    """
    env = os.environ if environ is None else environ
    if env.get("REPRO_COORD_ADDR"):
        return dict(coordinator_address=env["REPRO_COORD_ADDR"],
                    num_processes=int(env.get("REPRO_NUM_PROC", "1")),
                    process_id=int(env.get("REPRO_PROC_ID", "0")))
    if env.get("SLURM_PROCID") is not None and env.get("SLURM_NTASKS"):
        nodelist = (env.get("SLURM_STEP_NODELIST")
                    or env.get("SLURM_JOB_NODELIST"))
        if not nodelist:
            return None
        port = env.get("REPRO_COORD_PORT", str(DEFAULT_COORD_PORT))
        return dict(
            coordinator_address=f"{_first_slurm_host(nodelist)}:{port}",
            num_processes=int(env["SLURM_NTASKS"]),
            process_id=int(env["SLURM_PROCID"]))
    return None


def default_backend(device, local_processes: int) -> str:
    """The process group backend for ``local_processes`` processes on one
    host, each on ``device``: ``nccl`` when every one has a card of its
    own, else ``gloo`` (the CPU, or processes sharing a card, which NCCL
    refuses)."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(*, coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> str | None:
    """Join (or skip) the multi-process runtime: returns the backend of the
    process group joined, or None when there is nothing to join.

    With no process count or id the launch parameters come from the
    environment (:func:`detect_cluster_env`); outside any cluster that is
    a no-op.  ``num_processes <= 1`` is a no-op too, so callers can be
    launcher-agnostic.  Beyond one process ``backend`` (``"gloo"`` or
    ``"nccl"``, :func:`default_backend`) must be given: it is never chosen
    here.  The group is ``torch.distributed.init_process_group`` with
    ``init_method=f"tcp://{coordinator_address}"``.
    """
    if num_processes is None and process_id is None:
        detected = detect_cluster_env()
        if detected is None:
            return None
        if coordinator_address is not None:
            detected["coordinator_address"] = coordinator_address
        coordinator_address = detected["coordinator_address"]
        num_processes = detected["num_processes"]
        process_id = detected["process_id"]
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if num_processes <= 1:
        return None
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r} "
                         "(default_backend picks one for a device)")
    import torch.distributed as tdist
    tdist.init_process_group(backend,
                             init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id)
    return backend


def _world() -> tuple[int, int]:
    """(process count, this process's index) of the process group; (1, 0)
    outside one."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """How the (rows, row_width) decomposition grid maps onto processes."""

    num_processes: int
    process_id: int
    n_rows: int
    row_width: int
    row_process: tuple[int, ...]   # owning process per grid row

    @property
    def rows_per_host(self) -> int:
        return self.n_rows // max(self.num_processes, 1)

    @property
    def n_shards(self) -> int:
        return self.n_rows * self.row_width


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The (n_rows, row_width) shard grid over the processes: the global
    shard ids, the owning process of each row, and this process's
    device."""

    grid: np.ndarray               # (n_rows, row_width) global shard ids
    row_process: tuple[int, ...]
    num_processes: int
    process_id: int
    device: torch.device


def make_host_mesh(n_rows: int, row_width: int, *,
                   device="cuda") -> HostMesh:
    """Host-aligned (n_rows, row_width) grid over the process group (one
    process without one): rows are dealt out process-major, whole rows per
    process, so the intra-row tier never crosses a process.  Raises when
    ``n_rows`` is not a multiple of the process count, since a row would
    then span processes.  ``device`` is this process's (the card unless
    ``device="cpu"``; raises without one)."""
    n_proc, pid = _world()
    if n_rows % n_proc:
        raise ValueError(
            f"{n_rows} rows over {n_proc} processes: a row would span "
            "processes; pick n_rows a multiple of the process count so that "
            "Area-Processes rows align to hosts")
    rph = n_rows // n_proc
    return HostMesh(grid=np.arange(n_rows * row_width).reshape(n_rows,
                                                                row_width),
                    row_process=tuple(r // rph for r in range(n_rows)),
                    num_processes=n_proc, process_id=pid,
                    device=resolve_device(device))


def plan_elastic_mesh(row_width: int, shards_per_process: int, *,
                      device="cuda") -> HostMesh:
    """Host-aligned grid for WHATEVER processes this incarnation has.

    The elastic-restart entry point: the caller states the row width and
    the shards each process steps, and the elastic row plan
    (:func:`repro_torch.runtime.elastic.plan_mesh`) runs for the process
    group's world size times ``shards_per_process`` (the port's devices
    are shards, not ``jax.device_count()``) - so a gang restarted on
    fewer processes lands on the correspondingly smaller Area-Processes
    decomposition.  Degrades the row width (halving) only when fewer
    shards than one row survive.
    """
    from repro_torch.runtime.elastic import plan_mesh
    n_proc, _ = _world()
    plan = plan_mesh(n_proc * shards_per_process, model_width=row_width,
                     prefer_pods=False)
    n_rows, width = plan.shape
    return make_host_mesh(n_rows, width, device=device)


def host_topology(mesh: HostMesh) -> HostTopology:
    """Topology record of a host mesh."""
    n_rows, row_width = mesh.grid.shape
    return HostTopology(num_processes=mesh.num_processes,
                        process_id=mesh.process_id, n_rows=n_rows,
                        row_width=row_width, row_process=mesh.row_process)


def local_shard_slice(mesh: HostMesh) -> slice:
    """The contiguous range of global shards this process owns."""
    rows = [r for r, p in enumerate(mesh.row_process)
            if p == mesh.process_id]
    if not rows:
        return slice(0, 0)
    if rows != list(range(rows[0], rows[-1] + 1)):
        raise ValueError(
            f"process {mesh.process_id} owns rows {rows}, which are not "
            "contiguous along the shard axis; build the grid with "
            "make_host_mesh")
    row_width = mesh.grid.shape[1]
    return slice(rows[0] * row_width, (rows[-1] + 1) * row_width)


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """All-gather of ``t`` over the process group, concatenated along dim
    0 in rank order, on the host.  Collective: every process calls it with
    the same shape.  One process: ``t`` itself."""
    import torch.distributed as tdist
    if not tdist.is_initialized():
        return t.cpu()
    x = t.contiguous()
    if tdist.get_backend() == "nccl":
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(x) for _ in range(tdist.get_world_size())]
    tdist.all_gather(parts, x)
    return torch.cat(parts).cpu()


def _allgather_host(a: np.ndarray) -> np.ndarray:
    """Host-side all-gather: (``local...``) -> (P, ``local...``) numpy.
    One process adds the P = 1 axis locally, so the local build is
    testable without a process group."""
    return _all_gather(torch.from_numpy(np.ascontiguousarray(a))[None]
                       ).numpy()


def replicate_to_host(x) -> np.ndarray:
    """This process's (S_loc, ...) rows -> the full (S, ...) numpy on EVERY
    process, in global shard order (the processes hold process-major
    blocks).  Collective."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return _all_gather(t.detach()).numpy()


def prepare_stacked_local(spec, dec, n_rows: int, row_width: int,
                          mesh: HostMesh, *, pad_to_multiple: int = 8,
                          with_blocked: bool = True,
                          block_shapes=None) -> dist.StackedNetwork:
    """The O(owned rows) multi-process twin of
    :func:`repro_torch.core.distributed.prepare_stacked` for procedural
    specs.

    Every process builds only the shards it owns; nothing proportional to
    the global edge count is ever held or exchanged.  The processes still
    agree on the stacked geometry and the exchange tables:

    * per-shard edge counts, row degrees (hence the shared blocked
      (PB, EB) shape, tuned from them when ``block_shapes`` asks) and
      local sizes are analytic under the fixed-indegree rule: every
      process derives them for all shards with no RNG and no
      communication;
    * only the remote-mirror tables need real draws: each process runs
      the counting pass (pass A) over its own shards and all-gathers the
      padded remote gid sets;
    * every remote mirror of a procedural shard is referenced by a
      generated edge, so the boundary lists derived from those tables
      equal the ``used``-filtered ones of ``prepare_stacked``.

    Returns a StackedNetwork whose (S, ...) arrays hold only this
    process's rows, ``local_slice`` the owned range.
    """
    if spec.connectivity != "procedural":
        raise ValueError(
            "prepare_stacked_local needs connectivity='procedural' - a "
            "materialized spec has a global edge list anyway, use "
            "prepare_stacked")
    S = n_rows * row_width
    if S != dec.n_devices:
        raise ValueError(f"a {n_rows}x{row_width} grid has {S} shards but "
                         f"the decomposition has {dec.n_devices}")
    sl = local_shard_slice(mesh)
    lo, hi = sl.start, sl.stop
    row_of = np.arange(S) // row_width

    # --- analytic dims for ALL shards (no RNG, no comms) -------------------
    e_all = builder_mod.shard_edge_counts(spec, dec)
    degrees = [builder_mod.shard_row_degrees(spec, dec, s)
               for s in range(S)]
    n_local_all = [int(p.size) for p in dec.parts]

    # --- pass A on OWNED shards: remote-mirror gid sets --------------------
    own_remotes = []
    for s in range(lo, hi):
        d = builder_mod.procedural_shard_raw(spec, dec, s, dims_only=True)
        own_remotes.append(d["mirror_gids"][d["owned"].size:])
        if d["e"] != int(e_all[s]) or not np.array_equal(
                d["row_degree"], degrees[s]):
            raise AssertionError(
                f"shard {s}: generated dims disagree with the analytic "
                "fixed-indegree counts")

    # --- two small all-gathers: counts, then padded gid tables -------------
    counts_local = np.asarray([r.size for r in own_remotes], np.int64)
    counts_all = _allgather_host(counts_local).reshape(-1)
    if counts_all.size != S:
        raise ValueError(
            f"processes own unequal shard counts ({counts_all.size} "
            f"gathered entries for {S} shards); align the grid to hosts "
            "with make_host_mesh")
    r_pad = max(int(counts_all.max()), 1)
    table_local = np.full((hi - lo, r_pad), -1, np.int64)
    for i, r in enumerate(own_remotes):
        table_local[i, :r.size] = r
    tables = _allgather_host(table_local).reshape(S, r_pad)

    # --- agreed pads + boundary lists (identical on every process) ---------
    plan = dict(e=[int(e) for e in e_all],
                n_local=n_local_all,
                n_mirror=[n_local_all[s] + int(counts_all[s])
                          for s in range(S)],
                row_degree=degrees)
    pads = dist.resolve_stack_pads(plan, spec,
                                   pad_to_multiple=pad_to_multiple,
                                   with_blocked=with_blocked,
                                   block_shapes=block_shapes)
    consumers: list[list[np.ndarray]] = [[] for _ in range(S)]
    for s in range(S):
        rg = tables[s, :int(counts_all[s])]
        src = dec.owner[rg]
        for src_shard in np.unique(src):
            if row_of[src_shard] != row_of[s]:
                sel = src == src_shard
                consumers[int(src_shard)].append(np.unique(
                    np.searchsorted(dec.parts[int(src_shard)], rg[sel])))
    boundary = [np.unique(np.concatenate(c)) if c else np.zeros(0, np.int64)
                for c in consumers]
    b_pad, boundary_slots = dist._boundary_slots_from_lists(
        boundary, pads["n_local_pad"], pad_to_multiple)

    # --- full build of OWNED shards, streamed into local stacked arrays ---
    Sl = hi - lo
    nm = pads["n_mirror_pad"]
    graph = dist._alloc_stacked_graph(Sl, pads["e_pad"],
                                      pads["n_local_pad"], nm,
                                      pads["blocked_meta"])
    src_all = np.zeros((Sl, nm), np.int32)
    idx_all = np.zeros((Sl, nm), np.int32)
    mirror_is_intra = np.zeros((Sl, nm), dtype=bool)
    mirror_row_gather = np.zeros((Sl, nm), dtype=np.int32)
    mirror_remote_gather = np.zeros((Sl, nm), dtype=np.int32)
    shard_iter = dist.procedural_shard_graphs(
        spec, dec, range(lo, hi), pads, pad_to_multiple=pad_to_multiple,
        with_blocked=with_blocked)
    for i, g in enumerate(shard_iter):
        dist._fill_stacked_row(graph, i, g, pads["blocked_meta"])
        src_all[i] = np.asarray(g.mirror_src_shard)
        idx_all[i] = np.asarray(g.mirror_src_idx)
        (mirror_is_intra[i], mirror_row_gather[i],
         mirror_remote_gather[i]) = dist._mirror_meta_row(
            src_all[i], idx_all[i], lo + i, row_of, boundary, b_pad,
            pads["n_local_pad"], row_width)

    return dist.StackedNetwork(
        n_shards=S, row_width=row_width, n_local=pads["n_local_pad"],
        n_mirror=nm, n_edges=pads["e_pad"], b_pad=b_pad,
        max_delay=spec.max_delay, graph=graph,
        blocked_meta=pads["blocked_meta"], block_shapes_spec=block_shapes,
        local_slice=(lo, hi),
        boundary_slots=boundary_slots[lo:hi],
        mirror_is_intra=mirror_is_intra,
        mirror_row_gather=mirror_row_gather,
        mirror_remote_gather=mirror_remote_gather,
        mirror_src_flat=src_all)


def make_multihost_step(net: dist.StackedNetwork, groups,
                        cfg: dist.DistributedConfig, *,
                        device="cuda") -> dist.DistributedStep:
    """The distributed step over this process's shards of ``net`` (on
    ``device``, the card unless ``device="cpu"``), bound to a
    :class:`~repro_torch.core.distributed.HostExchange`; the neuron
    parameter table is built from ``groups`` for ``cfg``'s model."""
    dev = resolve_device(device)
    table = neuron_models_mod.get_model(cfg.neuron_model).make_param_table(
        list(groups), cfg.engine.dt, device=dev)
    return dist.make_distributed_step(net, table, cfg,
                                      exchange=dist.HostExchange(net, cfg),
                                      device=dev)


def init_multihost_state(net: dist.StackedNetwork, groups, seed: int = 0, *,
                         dtype=torch.float32, sweep: str | None = None,
                         neuron_model: str = "lif",
                         device="cuda") -> dist.DistState:
    """Fresh state of the shards this process holds: only its rows are
    built, and each shard's drive generator is seeded from its global
    index, so a shard draws one stream whatever the process count."""
    return dist.init_stacked_state(net, list(groups), seed, dtype=dtype,
                                   sweep=sweep, neuron_model=neuron_model,
                                   shards=range(*net.shard_range),
                                   device=device)


#: DistState fields that are static markers, not per-shard leaves
_META = ("weights_layout", "neuron_model", "model_seed", "shards")


def snapshot_host_state(state: dist.DistState) -> dict:
    """Full host-side field dict of a multi-process DistState: every
    tensor leaf (``aux`` as a dict) and each shard's generator state
    (``generators``, (S, L) uint8), as (S, ...) numpy in global shard
    order.

    One all-gather per leaf, so EVERY process must call this at the same
    step, and every process gets the full value.  The static markers
    (``weights_layout``, ``neuron_model``, ``model_seed``) are not
    captured: the restoring run states them.
    """
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name in _META:
            continue
        if f.name == "aux":
            out["aux"] = {k: replicate_to_host(a) for k, a in v.items()}
        elif f.name == "generators":
            out["generators"] = replicate_to_host(
                torch.stack([g.get_state() for g in v]))
        else:
            out[f.name] = replicate_to_host(v)
    return out


def state_from_fields(fields: dict, net: dist.StackedNetwork, *,
                      weights_layout: str = "flat",
                      neuron_model: str = "lif",
                      model_seed: int | None = None,
                      device="cuda") -> dist.DistState:
    """A DistState of the shards ``net`` holds from a host-side field dict
    (:func:`snapshot_host_state`'s): each leaf is either the full (S, ...)
    value, whose rows of this process are taken, or this process's
    (S_loc, ...) rows already.  The generators resume from their saved
    states."""
    dev = resolve_device(device)
    lo, hi = net.shard_range

    def rows(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.shape[0] == net.n_shards:
            a = a[lo:hi]
        elif a.shape[0] != hi - lo:
            raise ValueError(f"a leaf of {a.shape[0]} rows fits neither "
                             f"{net.n_shards} shards nor this process's "
                             f"{hi - lo}")
        return torch.from_numpy(np.ascontiguousarray(a))

    gens = []
    for st in rows(fields["generators"]):
        g = torch.Generator(device=dev)
        g.set_state(st.clone())
        gens.append(g)
    leaves = {f.name: rows(fields[f.name]).to(dev)
              for f in dataclasses.fields(dist.DistState)
              if f.name not in (*_META, "aux", "generators")}
    return dist.DistState(
        **leaves, generators=gens,
        aux={k: rows(a).to(dev) for k, a in fields.get("aux", {}).items()},
        weights_layout=weights_layout, neuron_model=neuron_model,
        model_seed=model_seed, shards=tuple(range(lo, hi)))
