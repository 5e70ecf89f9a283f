"""Elastic re-meshing: pick a new grid for the surviving processes.

The port of the reference package's ``runtime/elastic.py``.  When a
process is lost, the run resumes on fewer shards: the checkpoint holds
every leaf whole, so the only decision is the new grid.  Policy: keep the
row width (the multisection cells per Area-Processes row) fixed when
possible and shrink the rows - lose rows, keep the within-row topology.

For the SNN engine the same plan re-runs the two-level decomposition for
the new row count.  :func:`shrink_remap_state` takes a full host-side
state snapshot written under ONE decomposition and re-expresses it under
ANOTHER (fewer rows): per-neuron state gathered to global order and
re-scattered, the delay ring rebuilt per shard from the global ring via
the new mirror tables, and the per-shard drive generators re-derived for
the new shard count and advanced to the checkpoint step
(:func:`repro_torch.core.distributed.advance_generators`).

The port's devices are shards on one card (or one a card), so the grid is
the world size times the shards per process
(:func:`repro_torch.core.multihost.plan_elastic_mesh`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ElasticPlan", "plan_mesh", "shrink_remap_state"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    n_devices: int
    dropped: int

    def make_mesh(self, device="cuda"):
        """The plan's host grid over the process group: the outer axes
        flattened into rows (:func:`repro_torch.core.multihost.
        make_host_mesh`)."""
        from repro_torch.core import multihost
        return multihost.make_host_mesh(int(np.prod(self.shape[:-1])),
                                        self.shape[-1], device=device)


def plan_mesh(available_devices: int, *, model_width: int = 16,
              prefer_pods: bool = True) -> ElasticPlan:
    """Largest mesh (rows x model_width) <= available, rows maximal."""
    if available_devices < model_width:
        # degrade the width as last resort (halving keeps divisibility)
        width = model_width
        while width > 1 and available_devices < width:
            width //= 2
        model_width = max(width, 1)
    rows = available_devices // model_width
    if rows == 0:
        raise ValueError("no usable devices")
    used = rows * model_width
    if prefer_pods and rows % 2 == 0 and rows >= 4:
        shape = (2, rows // 2, model_width)
        axes = ("pod", "data", "model")
    else:
        shape = (rows, model_width)
        axes = ("data", "model")
    return ElasticPlan(shape=shape, axes=axes, n_devices=used,
                       dropped=available_devices - used)


def shrink_remap_state(spec, seed: int, host: dict, *, step: int,
                       old_n_rows: int, old_row_width: int,
                       new_dec, new_net, groups,
                       sweep: str | None = None,
                       neuron_model: str = "lif",
                       stdp_active: bool = False,
                       dt: float = 0.1, external_drive: bool = True,
                       device="cuda"):
    """Re-express a checkpointed DistState snapshot on a NEW decomposition.

    ``host`` is the full host-side field dict written by
    :func:`repro_torch.core.multihost.snapshot_host_state` under the
    ``(old_n_rows, old_row_width)`` decomposition; ``new_dec`` /
    ``new_net`` describe the surviving topology (``mesh_decompose`` +
    ``prepare_stacked_local``, the net already on ``device``).  Returns
    ``(fields, carried)``:

    * ``fields`` - host-side DistState fields for THIS process's new rows
      (``new_net.shard_range``), ``generators`` as their state bytes,
      ready for :func:`repro_torch.core.multihost.state_from_fields`;
    * ``carried`` - overflow totals accumulated before the shrink (the
      per-shard counters cannot be re-scattered across a different shard
      count, so they restart at zero and the totals ride the telemetry).

    Topology and initial weights regenerate procedurally from
    ``spec`` + ``seed`` (decomposition-invariant per edge); plastic
    weights and STDP traces are per-EDGE-SET state that has no
    decomposition-independent global form, so shrink-restart requires STDP
    off.

    The generators of the new shards are seeded for their new global
    indices and advanced by ``step`` drive draws of their own rates
    (``dt``; not at all when ``external_drive`` is off): the stream an
    uninterrupted run on the NEW grid would hold.  The drive itself is not
    decomposition-invariant (each shard draws its own stream), so the
    continued trajectory is bitwise the old grid's only on a net with no
    Poisson drive (zero rates, as ``model_demo("lif")``'s constant
    ``i_e``).
    """
    import torch

    from repro_torch.core import builder as builder_mod
    from repro_torch.core import distributed as dist

    if stdp_active:
        raise ValueError(
            "elastic shrink-restart needs stdp disabled: plastic weights "
            "and traces live per edge set, which changes with the "
            "decomposition - run with --no-stdp (same-topology restarts "
            "restore plastic state exactly)")
    if spec.connectivity != "procedural":
        raise ValueError(
            "elastic shrink-restart needs connectivity='procedural' - the "
            "new processes must regenerate their own rows' topology from "
            "spec+seed (network_metadata), not reload a materialized one")

    old_dec = dist.mesh_decompose(spec, old_n_rows, old_row_width)
    li_old = old_dec.local_index()
    N = old_dec.n_neurons
    lo, hi = new_net.shard_range
    parts_new = [new_dec.parts[s] for s in range(lo, hi)]
    mirror_new = [
        builder_mod.procedural_shard_raw(spec, new_dec, s,
                                         dims_only=True)["mirror_gids"]
        for s in range(lo, hi)]

    # fresh state on the NEW topology: regenerated weights/layout, fresh
    # per-shard generators for the new shard ids, model aux structure
    fresh = dist.init_stacked_state(new_net, list(groups), seed, sweep=sweep,
                                    neuron_model=neuron_model,
                                    shards=range(lo, hi), device=device)
    fields = {}
    for f in dataclasses.fields(fresh):
        v = getattr(fresh, f.name)
        if isinstance(v, torch.Tensor):
            fields[f.name] = v.cpu().numpy().copy()
    fields["aux"] = {k: a.cpu().numpy().copy() for k, a in fresh.aux.items()}

    def to_global(a):
        """(S_old, n_local_old_pad, ...) -> (N, ...) per-neuron gather."""
        return np.asarray(a)[old_dec.owner, li_old]

    def scatter(global_vals, tgt):
        for i, part in enumerate(parts_new):
            tgt[i, :part.size] = global_vals[part]

    for name in ("v_m", "syn_ex", "syn_in", "ref_count", "k_post",
                 "prev_bits"):
        scatter(to_global(host[name]), fields[name])
    for k, tgt in fields["aux"].items():
        scatter(to_global(host["aux"][k]), tgt)

    # delay ring: mirror rows hold the PRE neuron's delayed spike bits, so
    # the global (D, N) ring rebuilt from each old shard's OWNED section
    # re-gathers through the new mirror tables bit-exactly
    ring_old = np.asarray(host["ring"])
    D = ring_old.shape[1]
    ring_g = np.zeros((D, N), ring_old.dtype)
    for s, part in enumerate(old_dec.parts):
        ring_g[:, part] = ring_old[s][:, :part.size]
    for i, mg in enumerate(mirror_new):
        fields["ring"][i] = 0
        fields["ring"][i][:, :mg.size] = ring_g[:, mg]

    fields["t"][:] = step
    # per-shard streams are shard-count-specific: the new shards' own
    # generators, advanced by the steps already run
    gens = fresh.generators
    if external_drive:
        graphs = [new_net.shard_graphs[r] for r in new_net.rows_of(
            range(lo, hi))]
        dist.advance_generators(gens, graphs, step, dt)
    fields["generators"] = torch.stack([g.get_state() for g in gens]
                                       ).numpy()

    carried = {
        "wire_overflow": int(np.asarray(host["wire_overflow"]).sum()),
        "gate_overflow": int(np.asarray(host.get(
            "gate_overflow", np.zeros(1, np.int32))).sum()),
    }
    fields["wire_overflow"][:] = 0
    fields["gate_overflow"][:] = 0
    return fields, carried
