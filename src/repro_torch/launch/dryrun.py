"""Multi-pod dry run of the LM face: every (arch x shape x mesh) cell on
``meta``.

The reference (``src/repro/launch/dryrun.py``) lowers and compiles each
cell's step on 256 or 512 placeholder devices and reads XLA's
``memory_analysis()``, ``cost_analysis()`` and the partitioned HLO's
collectives.  The port has no partitioner and one card, so it models the
same record from the sharding rules (:mod:`repro_torch.sharding.rules`)
and one device's share of the step, run on ``meta`` (nothing allocated),
as the SNN dry run does (:mod:`repro_torch.launch.dryrun_snn`).  For every
cell this module:

  1. builds the step (train / prefill / decode per the shape kind) with
     the module and optimizer state on ``meta`` at their global shapes,
     and the batch and cache at one device's data-parallel share (the
     global batch divided by the ``batch`` axes, as ``batch_spec`` divides
     it);
  2. gives each argument its spec (params and optimizer state by
     ``param_specs``, the batch by ``batch_spec``, caches by
     ``cache_specs``);
  3. records ``memory``: the argument, output and donated (alias) bytes
     one device holds, exact arithmetic on the local shapes the specs
     give, set against the card's 80 GB.  ``temp_bytes`` is None: with no
     partitioner, activations under tensor parallelism are not modelled;
  4. records ``cost``: the share's FLOPs and traffic counted per aten op
     (:class:`repro_torch.utils.op_costs.OpCounter`; K8 charged its own
     work), split evenly over the ``model`` axis, with ``by_op`` and K8's
     calls;
  5. records ``collectives``: the collectives one device's share of the
     cell's mesh program calls, counted from the program itself
     (:func:`count_collectives`), as the reference reads them off its
     partitioned HLO: the port's mesh code (``DecoderLM`` /
     ``EncDecLM(mesh=)``, the batch block, the ``cache_blocks`` cache, the
     mesh train step) run on ``meta`` under ``rules.use_mesh`` of a
     :class:`~repro_torch.launch.mesh.StandInMesh` (device 0 of the
     grid), whose collectives only tally
     (:func:`repro_torch.sharding.collectives.tally`): each kind's calls
     and the bytes the device sends (the byte convention is that
     module's).  So it holds what the port calls - the FSDP gathers at
     every use (once a step where ``TrainConfig.gather_once`` is set) and
     their reduce-scatters, the tensor-parallel ``psum`` and
     ``sum_grad`` all-reduces, the MoE all-to-alls, Mamba's
     ``all_to_all_v``, the sequence-cut decode's ``pmax``, ``psum`` and
     query gathers, the gradient reductions over the batch axes - and
     ``collective_model`` is ``"program"``.  Beside the bytes the port
     sends it keeps their ring volume (``ring_total_bytes``): the same
     but for the all-reduces, which the port sums by gathering every
     part (``(n - 1) |x|``, deterministic on gloo) where a ring sends
     ``2 (n - 1) / n |x|``.  The cost record of step 4 is still the
     whole share's count split evenly over ``model``, not the mesh
     program's;
  6. adds the roofline terms at an H100 SXM's rates
     (:func:`repro_torch.launch.roofline.roofline_terms`), the
     collective term from the ring volume (``roofline_bytes``): what a
     card-side collective library would move for the same program.

Counting by trip count.  A cell's count (of ops and of collectives) is
affine in the number of identical periods of its layers (after a dense
prefix), and affine in the number of microbatches of a train step (the
accumulation branch; one microbatch takes another branch), jointly
bilinear.  So the step is
counted at 0 and 1 periods (1 and 2 with MoE layers) and at 2 and 3
microbatches, and each op's calls, FLOPs and bytes are solved for the
cell's (:func:`count_share`), exact when the layers of a period have one
shape, as they do in every config.  The count runs under
:class:`~repro_torch.utils.op_costs.MetaOpCounter`, which makes a
repeated call's outputs from a cache of their shapes.  What is left is
the period's own ops: the Mamba and RWKV mixers step a Python loop over
time, so their cells dispatch an op or more per token and layer of a
period, and take minutes (twice: once for the ops, once for the
collectives).

Results go to ``experiments/dryrun_torch_<mesh>.json``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both-meshes] [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
from typing import Any, Callable

import torch
from torch import nn

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (MeshShape, StandInMesh,
                                     make_production_mesh)
from repro_torch.models import encdec, transformer
from repro_torch.models.model import build_model
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules
from repro_torch.train.loop import make_train_step, param_tree
from repro_torch.train.optimizer import init_opt_state, torch_dtype
from repro_torch.utils.op_costs import DOT_OPS, MetaOpCounter

__all__ = ["input_specs", "build_cell", "run_cell", "train_config_for",
           "count_share", "count_collectives", "memory_record", "ArgSpec",
           "Cell", "DEFAULT_RESULT_DIR", "CARD_BYTES", "main"]

DEFAULT_RESULT_DIR = "experiments"
#: one H100 SXM's device memory (80 GB)
CARD_BYTES = 80 * 10**9
_META = torch.device("meta")
_ONE = MeshShape(("data", "model"), (1, 1))


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """An argument's global shape, dtype and spec: the reference's
    ``ShapeDtypeStruct`` with a sharding."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: rules.PartitionSpec

    def local_bytes(self, mesh) -> int:
        """The bytes one device holds."""
        return (math.prod(rules.shard_shape(self.shape, self.spec, mesh))
                * self.dtype.itemsize)


def train_config_for(cfg: ModelConfig) -> TrainConfig:
    """Per-arch optimizer policy, the reference's: AdamW fp32 everywhere
    except MoE archs (Adafactor + bf16 params: expert weights are
    expert-resident, replicated over the axes E does not cover, so fp32
    AdamW state would replicate too; deepseek also needs bf16 grad
    accumulation)."""
    if cfg.moe is not None:
        return TrainConfig(optimizer="adafactor", param_dtype="bfloat16",
                           acc_dtype="bfloat16")
    # XLA already hoists the loop-invariant parameter all-gathers out of
    # the microbatch scan (the reference's note on gather_once)
    return TrainConfig(optimizer="adamw", param_dtype="float32")


def _batch_divides(shape: ShapeConfig, mesh) -> bool:
    return shape.global_batch % max(
        rules.MeshCtx(mesh).axis_size("batch"), 1) == 0


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh) -> dict[str, ArgSpec]:
    """Global shape, dtype and spec of every model input of this cell."""
    b = shape.global_batch
    bs = rules.batch_spec(mesh) if _batch_divides(shape, mesh) else rules.P()
    out: dict[str, ArgSpec] = {}
    if shape.kind == "train":
        out["tokens"] = ArgSpec((b, shape.seq_len + 1), torch.int32, bs)
    elif shape.kind == "prefill":
        out["tokens"] = ArgSpec((b, shape.seq_len), torch.int32, bs)
    elif shape.kind == "decode":
        out["token"] = ArgSpec((b,), torch.int32, bs)
        out["pos"] = ArgSpec((b,), torch.int32, bs)
    act = getattr(torch, cfg.dtype)
    if cfg.family == "audio" and shape.kind in ("train", "prefill"):
        out["frames"] = ArgSpec((b, cfg.encoder_seq, cfg.d_model), act, bs)
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        out["patches"] = ArgSpec((b, cfg.n_prefix_embeds, cfg.d_model), act,
                                 bs)
    return out


def _microbatches(shape: ShapeConfig, mesh) -> int:
    bsz = rules.MeshCtx(mesh).axis_size("batch")
    return max(1, min(shape.microbatches, shape.global_batch // bsz))


def share_batch(shape: ShapeConfig, mesh) -> int:
    """Rows of the global batch one device holds."""
    if not _batch_divides(shape, mesh):
        return shape.global_batch
    return shape.global_batch // rules.MeshCtx(mesh).axis_size("batch")


def _arg_specs(tree, specs) -> Any:
    """A tree of tensors (a module: its named parameters) zipped with its
    spec tree into :class:`ArgSpec` leaves."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _arg_specs(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_arg_specs(v, s) for v, s in zip(tree, specs))
    return ArgSpec(tuple(tree.shape), tree.dtype, specs)


@dataclasses.dataclass
class Cell:
    """One cell's step at one device's share: ``run()`` takes the step
    and returns its outputs; ``args`` holds every argument
    as a tree of :class:`ArgSpec` (global shapes) by role (``params``,
    ``opt_state``, ``batch``, ``step``, ``cache``) and ``donated`` the
    roles whose buffers the step's outputs reuse."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    microbatches: int
    share_batch: int
    args: dict
    donated: tuple[str, ...]
    run: Callable[[], Any]


def _share_inputs(cfg, shape, mesh, rows: int, device, seed: int) -> dict:
    """The share's inputs, ``rows`` rows of each: empty on ``meta``; on
    another device drawn from ``seed`` (tokens uniform over the
    vocabulary, the stub embeddings N(0, 0.02^2)), a decode's positions
    at the cache's last row."""
    specs = input_specs(cfg, shape, mesh)
    shapes = {k: (rows,) + a.shape[1:] for k, a in specs.items()}
    if device.type == "meta":
        return {k: torch.empty(shapes[k], dtype=a.dtype, device=device)
                for k, a in specs.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for k, a in specs.items():
        if k == "pos":
            out[k] = torch.full(shapes[k], shape.seq_len - 1,
                                dtype=a.dtype, device=device)
        elif a.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, shapes[k],
                                   generator=gen, dtype=a.dtype,
                                   device=device)
        else:
            out[k] = (0.02 * torch.randn(shapes[k], generator=gen,
                                         device=device)).to(a.dtype)
    return out


def _ctor(cfg: ModelConfig):
    return encdec.EncDecLM if cfg.family == "audio" else transformer.DecoderLM


@functools.lru_cache(maxsize=16)
def _meta_module(cfg: ModelConfig, dtype):
    """The model of ``cfg`` on ``meta`` in ``dtype``, built once: it holds
    no values, so the cells of a sweep share it."""
    return _ctor(cfg)(cfg, device=_META, dtype=dtype)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               microbatches: int | None = None, device="meta",
               seed: int = 0, tcfg: TrainConfig | None = None,
               program: bool = False) -> Cell:
    """The cell's step, on ``meta`` unless ``device`` is given (the card:
    parameters and inputs drawn from ``seed``, the optimizer state and
    the cache zeroed), at one device's share.  ``microbatches`` (train)
    takes the step with that many microbatches of the cell's microbatch
    rows in place of the cell's own (:func:`count_share`); ``tcfg`` a
    train step's policy in place of :func:`train_config_for`'s.

    ``program`` (on ``meta``): the step is one device's share of the
    cell's mesh program (:func:`count_collectives`): the model built on
    a :class:`~repro_torch.launch.mesh.StandInMesh` of ``mesh`` (every
    leaf its block), the batch block (the whole batch on every device
    where it does not split, as ``replicated_batch``) and the
    ``cache_blocks`` cache, built and run under ``rules.use_mesh``.
    ``args`` are the cell's global arguments either way."""
    device = torch.device(device)
    if program and device.type != "meta":
        raise ValueError("a cell's mesh program is run on meta")
    model = build_model(cfg)
    rows = share_batch(shape, mesh)
    tcfg = tcfg or train_config_for(cfg)
    scope = contextlib.nullcontext
    if program:
        stand = StandInMesh(mesh.axis_names, mesh.dims)
        scope = functools.partial(
            rules.use_mesh, stand,
            replicated_batch=not _batch_divides(shape, mesh))

    def make_params(dtype):
        if program:
            return _ctor(cfg)(cfg, device=_META, mesh=stand, dtype=dtype)
        if device.type == "meta":
            return _meta_module(cfg, dtype)
        return model.init(seed, device=device, dtype=dtype)

    def scoped(step):
        def run():
            with scope():
                return step()
        return run

    dtype = (torch_dtype(tcfg.param_dtype) if shape.kind == "train"
             else None)
    params_g = _meta_module(cfg, dtype)
    args = {"params": _arg_specs(params_g, rules.param_specs(mesh,
                                                             params_g)),
            "batch": input_specs(cfg, shape, mesh)}
    if shape.kind == "train":
        opt_g = init_opt_state(tcfg, params_g)
        args.update(opt_state=_arg_specs(opt_g,
                                         rules.param_specs(mesh, opt_g)),
                    step=ArgSpec((), torch.int32, rules.P()))
        mbs = _microbatches(shape, mesh)
        n_mb = mbs if microbatches is None else microbatches
        with scope():
            params = make_params(dtype)
            opt = (opt_g if params is params_g
                   else init_opt_state(tcfg, params))
            step_fn = make_train_step(model, tcfg, microbatches=n_mb)
            batch = _share_inputs(cfg, shape, mesh, n_mb * (rows // mbs),
                                  device, seed)
        return Cell(cfg, shape, mesh, mbs, rows, args,
                    ("params", "opt_state"),
                    scoped(lambda: step_fn(params, opt, batch, 0)))

    seq = shape.seq_len
    if cfg.family == "vlm":
        seq += cfg.n_prefix_embeds  # prefix patch embeds occupy cache slots
    cache_g = model.init_cache(shape.global_batch, seq, device=_META)
    args["cache"] = _arg_specs(cache_g, rules.cache_specs(
        mesh, cache_g, seq_shard=shape.global_batch == 1))
    with scope():
        params = make_params(dtype)
        cache = model.init_cache(rows, seq, device=device)
        batch = _share_inputs(cfg, shape, mesh, rows, device, seed)
    if shape.kind == "prefill":
        run = lambda: model.prefill(params, batch, cache)
    else:
        run = lambda: model.decode(params, cache, batch["token"],
                                   batch["pos"])
    return Cell(cfg, shape, mesh, 1, rows, args, ("cache",), scoped(run))


# --------------------------------------------------------------------------
# the count, by trip count
# --------------------------------------------------------------------------

def _periods(cfg: ModelConfig) -> int | None:
    """The number of identical periods of the decoder's layers (None for
    the encoder-decoder, counted whole)."""
    if cfg.family == "audio":
        return None
    return transformer.period_structure(cfg)[2]


def _with_periods(cfg: ModelConfig, n: int) -> ModelConfig:
    prefix, period, _ = transformer.period_structure(cfg)
    return dataclasses.replace(cfg, n_layers=len(prefix) + n * len(period))


def _count(cfg, shape, mesh, microbatches) -> tuple[dict, Any]:
    cell = build_cell(cfg, shape, mesh, microbatches=microbatches)
    with MetaOpCounter() as c:
        out = cell.run()
    return {k: list(v) for k, v in c.by_op.items()}, out


def _warm(cfg: ModelConfig) -> None:
    """One uncounted prefill of a period at 8 tokens on ``meta``: what a
    model caches on a device at its first call (RoPE's inverse
    frequencies) is then in place, as on a card that has served."""
    n_p = _periods(cfg)
    if n_p is not None and n_p > 1:
        cfg = _with_periods(cfg, 1)
    build_cell(cfg, ShapeConfig("warm", "prefill", 8, 1), _ONE).run()


def _points(n: int | None, first: int) -> list:
    """The trip counts a count is taken at for a cell's ``n``: ``n``
    itself when it is at most ``first + 1``, else ``first`` and
    ``first + 1``."""
    return [n] if n is None or n <= first + 1 else [first, first + 1]


def _solve(counts: dict, ps: list, ms: list, n_p, n_m) -> dict:
    """Each name's numbers at the cell's ``n_p`` periods and ``n_m``
    microbatches, solved bilinearly from ``counts`` ((periods,
    microbatches) -> name -> numbers) taken at the trip counts ``ps`` x
    ``ms`` (:func:`_points`; a name missing from a count is 0 there)."""
    p0, p1, m0, m1 = ps[0], ps[-1], ms[0], ms[-1]
    dp = 0 if len(ps) == 1 else n_p - p0
    dm = 0 if len(ms) == 1 else n_m - m0
    out = {}
    for name in sorted(set().union(*counts.values())):
        width = next(len(c[name]) for c in counts.values() if name in c)
        f = {k: c.get(name, [0] * width) for k, c in counts.items()}
        out[name] = [f[p0, m0][i]
                     + dp * (f[p1, m0][i] - f[p0, m0][i])
                     + dm * (f[p0, m1][i] - f[p0, m0][i])
                     + dp * dm * (f[p1, m1][i] - f[p1, m0][i]
                                  - f[p0, m1][i] + f[p0, m0][i])
                     for i in range(len(f[p0, m0]))]
    return out


def count_share(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                shortcut: bool = True) -> tuple[dict, dict]:
    """``(by_op, info)``: op name -> ``[calls, flops, bytes]`` of one
    device's share of the cell's step, and how it was counted.  With
    ``shortcut`` the step is counted at 0 and 1 periods after the dense
    prefix (1 and 2 for a MoE arch) and, for a train step of more than 3
    microbatches, at 2 and 3 microbatches, and each number solved
    bilinearly for the cell's; else counted whole."""
    n_p = _periods(cfg)
    n_m = _microbatches(shape, mesh) if shape.kind == "train" else None
    # a MoE arch's loss carries its aux loss's gradient only once a MoE
    # layer exists: its counts start at one period
    ps = _points(n_p, int(cfg.moe is not None)) if shortcut else [n_p]
    ms = _points(n_m, 2) if shortcut else [n_m]
    _warm(cfg)
    counts, out = {}, None
    for p in ps:
        cfg_p = cfg if p == n_p else _with_periods(cfg, p)
        for m in ms:
            counts[p, m], out = _count(cfg_p, shape, mesh, m)
    by_op = {name: row for name, row in _solve(counts, ps, ms, n_p,
                                                n_m).items() if any(row)}
    info = {"periods": n_p, "microbatches": n_m,
            "counted_at": [list(k) for k in counts],
            "metric_leaves": (len(out[2]) if shape.kind == "train"
                              else 0)}
    return by_op, info


def _tally_share(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 microbatches: int | None, tcfg: TrainConfig | None) -> dict:
    """The collectives of one device's share of the cell's mesh program
    (:func:`build_cell` with ``program``), run inside
    ``collectives.tally``: ``{kind: [calls, bytes, ring bytes]}``."""
    cell = build_cell(cfg, shape, mesh, microbatches=microbatches,
                      tcfg=tcfg, program=True)
    with coll.tally() as t:
        cell.run()
    return {k: [t.calls[k], t.bytes[k], t.ring[k]] for k in t.calls}


def count_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      tcfg: TrainConfig | None = None) -> dict:
    """The ``collectives`` record of one device's share of the cell's
    mesh program (module docstring, step 5): ``by_kind`` bytes sent,
    ``calls_by_kind``, ``total_bytes``, their ring volumes
    ``ring_by_kind`` and ``ring_total_bytes`` (which the roofline
    prices: ``roofline_bytes``), ``collective_model`` ``"program"``.
    Counted as :func:`count_share` counts the ops: at two
    period counts (1 and 2: a mesh train step reads the stacked slots of
    a first period) and two microbatch counts, each kind's calls and
    bytes solved bilinearly for the cell's.
    ``tcfg``: a train step's policy in place of
    :func:`train_config_for`'s."""
    n_p = _periods(cfg)
    n_m = _microbatches(shape, mesh) if shape.kind == "train" else None
    ps, ms = _points(n_p, 1), _points(n_m, 2)
    counts = {}
    for p in ps:
        cfg_p = cfg if p == n_p else _with_periods(cfg, p)
        for m in ms:
            counts[p, m] = _tally_share(cfg_p, shape, mesh, m, tcfg)
    by_kind = {k: v for k, v in _solve(counts, ps, ms, n_p, n_m).items()
               if any(v)}
    return {"collective_model": "program",
            "by_kind": {k: v[1] for k, v in by_kind.items()},
            "calls_by_kind": {k: v[0] for k, v in by_kind.items()},
            "total_bytes": sum(v[1] for v in by_kind.values()),
            "ring_by_kind": {k: v[2] for k, v in by_kind.items()},
            "ring_total_bytes": sum(v[2] for v in by_kind.values()),
            "roofline_bytes": "ring_total_bytes",
            "counted_at": [list(k) for k in counts]}


# --------------------------------------------------------------------------
# memory, from the specs
# --------------------------------------------------------------------------

def _leaves(tree) -> list:
    out = []
    rules.tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _role_bytes(cell: Cell, role: str) -> int:
    return sum(a.local_bytes(cell.mesh) for _, a in _leaves(cell.args[role]))


def memory_record(cell: Cell, metric_leaves: int = 0) -> dict:
    """Per-device argument, output and donated bytes of the cell: exact
    arithmetic on the local shapes the specs give."""
    roles = {r: _role_bytes(cell, r) for r in cell.args}
    arg = sum(roles.values())
    alias = sum(roles[r] for r in cell.donated)
    if cell.shape.kind == "train":
        # the updated params and optimizer state, and 0-d fp32 metrics
        out = alias + 4 * metric_leaves
    else:
        b = cell.shape.global_batch
        logits = (b, 1, cell.cfg.vocab_size) if cell.shape.kind == "prefill" \
            else (b, cell.cfg.vocab_size)
        spec = (rules.batch_spec(cell.mesh)
                if _batch_divides(cell.shape, cell.mesh) else rules.P())
        out = ArgSpec(logits, torch.float32, spec).local_bytes(cell.mesh) \
            + roles["cache"]
    resident = arg + out - alias
    return {"argument_bytes": arg, "output_bytes": out,
            "alias_bytes": alias, "temp_bytes": None,
            "temp_reason": "no partitioner: activations under tensor "
                           "parallelism are not modelled",
            "argument_bytes_by_role": roles,
            "resident_bytes": resident, "card_bytes": CARD_BYTES,
            "fits_card": resident <= CARD_BYTES}


# --------------------------------------------------------------------------
# one cell, and the sweep
# --------------------------------------------------------------------------

def _mesh_name(mesh) -> str:
    return "x".join(str(d) for d in mesh.dims)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, reduced: bool = False) -> dict[str, Any]:
    """Build and count one cell on ``meta``; returns its record."""
    cfg = configs.get_smoke(arch) if reduced else configs.get(arch)
    shape = SHAPES[shape_name]
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    if not shape_applicable(cfg.family, shape_name):
        rec["status"] = "skipped"
        rec["reason"] = (f"{cfg.family} family: full attention is "
                         "quadratic at 500k; sub-quadratic archs only "
                         "(DESIGN.md §4)")
        return rec
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    rec["mesh"] = _mesh_name(mesh)
    try:
        t0 = time.time()
        cell = build_cell(cfg, shape, mesh)
        rec["build_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        by_op, info = count_share(cfg, shape, mesh)
        rec["count_s"] = round(time.time() - t0, 2)
        tp = mesh.shape.get("model", 1)
        share_flops = sum(v[1] for v in by_op.values())
        share_bytes = sum(v[2] for v in by_op.values())
        dot = sum(v[1] for k, v in by_op.items() if k in DOT_OPS)
        rec["share"] = {"batch_rows": cell.share_batch,
                        "microbatches": cell.microbatches, **info}
        rec["memory"] = memory_record(cell, info["metric_leaves"])
        rec["cost"] = {
            "flops": share_flops / tp, "bytes_accessed": share_bytes / tp,
            "dot_flops": dot / tp,
            "share_flops": share_flops, "share_bytes": share_bytes,
            "tensor_parallel": tp,
            "split": "even: the share's count divided by the model axis",
            "flash_attention_calls": by_op.get(
                "repro_torch::flash_attention", [0])[0],
            "by_op": by_op}
        t0 = time.time()
        rec["collectives"] = count_collectives(cfg, shape, mesh)
        rec["tally_s"] = round(time.time() - t0, 2)
        rec.update(roofline.roofline_terms(
            rec["cost"]["flops"], rec["cost"]["bytes_accessed"],
            rec["collectives"]["ring_total_bytes"],
            roofline.model_flops(cfg, shape), mesh.size))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(configs.ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    t_sweep = time.time()
    for mp in meshes:
        mesh = make_production_mesh(multi_pod=mp)
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi_pod=mp, mesh=mesh)
                results.append(rec)
                mem = rec.get("memory", {}).get("resident_bytes", 0) / 2**30
                print(f"[{rec['mesh']}] {arch:22s} {shape:12s} "
                      f"{rec['status']:8s} count={rec.get('count_s', '-')}s "
                      f"resident/dev={mem:.2f}GiB "
                      f"{rec.get('reason', rec.get('error', ''))[:60]}",
                      flush=True)

    os.makedirs(DEFAULT_RESULT_DIR, exist_ok=True)
    out = args.out or os.path.join(
        DEFAULT_RESULT_DIR,
        f"dryrun_torch_{'multi' if meshes[-1] else 'single'}.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\nDRY-RUN: ok={n_ok} skipped={n_skip} error={n_err} "
          f"in {time.time() - t_sweep:.1f}s -> {out}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
