"""Sharded, async, elastic checkpointing (no external deps).

The port of the reference package's ``checkpoint/manager.py``, on the same
on-disk format::

    <dir>/step_000000123.tmp/...   (in-flight write)
    <dir>/step_000000123/
        manifest.json              leaf keys, shapes, dtypes, metadata
        arr_00000.npy ...          one file per leaf
    <dir>/LATEST                   text file: committed step number

Leaf keys are the reference's key strings (``['a']['b']`` for dict keys,
``.name`` for dataclass fields, ``[i]`` for list items), so a dict-saved
checkpoint written by either package loads in the other
(:meth:`CheckpointManager.load_host`).

The port has no pytree registry, so the manager flattens these itself:
dataclasses (``EngineState``, ``NeuronState``, ``TraceState``,
``DistState``), dicts (keys sorted, as jax flattens them), lists and
tuples, tensors, numpy arrays and scalars, and ``torch.Generator``.  A
dataclass field holding a string, a python scalar, None or a tuple of
those is a static marker (``weights_layout``, ``neuron_model``,
``model_seed``, ``shards``): it writes no leaf and comes from the target
on restore, as the reference's static fields do.  A generator is saved as
its ``get_state()`` bytes, in a leaf flagged ``"generator": "<device
type>"`` (the reference flags its key data ``"prng": true``);
:meth:`CheckpointManager.restore` calls ``set_state`` on the target's
generator and refuses one of another device type (a CPU mt19937 state and
a CUDA Philox state do not mix).

Guarantees:

* **Atomic commit** - writes land in a ``.tmp`` directory that is renamed
  only after every array and the manifest are written; a crash mid-write
  never corrupts the previous checkpoint, and LATEST is updated last.
* **Async save** - ``save(..., blocking=False)`` copies every tensor to
  the host synchronously (the port's steps advance their state in place,
  so the copy must be taken before the next step runs), then writes on a
  background thread that touches only numpy, so the loop loses only the
  device-to-host copy.  A background write that FAILS never advances
  ``LATEST`` and its error is re-raised by the next :meth:`wait` /
  :meth:`save`.
* **Crash consistency** - ``latest_step`` verifies the manifest behind
  ``LATEST`` and falls back to scanning committed ``step_*`` dirs;
  ``restore``/``load_host`` with no explicit step walk backwards past
  corrupted checkpoints (truncated ``.npy``, missing manifest, garbage
  json) to the newest fully readable one.  An EXPLICIT ``step=`` never
  falls back: :class:`CorruptCheckpointError`.
* **Elastic restore** - arrays are stored whole; ``restore`` places every
  leaf on the target leaf's device and dtype, and ``load_host`` returns the
  host dict for a state that will be re-shaped first
  (:func:`repro_torch.runtime.elastic.shrink_remap_state`).  On a process
  mesh the saved leaves are global (a mesh run gathers its blocks and one
  process writes them) and ``restore(..., shardings=)`` cuts each one to
  the block this process holds on whatever mesh it is given, as the
  reference's ``restore(target, shardings=)`` re-shards for the current
  mesh.
* **Retention** - ``keep`` newest checkpoints are retained, older ones
  garbage-collected after a successful commit.

Each save appends ``{"step", "bytes", "snapshot_s", "write_s"}`` to
:attr:`CheckpointManager.timings`: the blocking host copy and the
background write (set when the write ends).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "CorruptCheckpointError",
           "network_metadata", "restore_spec", "session_metadata"]


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory exists but cannot be read back (missing or
    truncated manifest, unreadable ``.npy``, ...)."""


# --------------------------------------------------------------------------
# procedural network checkpoints: spec + seed + state (no topology files)
# --------------------------------------------------------------------------

def network_metadata(spec, *, seed: int, extra: dict | None = None) -> dict:
    """Checkpoint metadata embedding the FULL network identity.

    With procedural connectivity the spec + seed ARE the topology
    (regenerated on restore, never stored), so a checkpoint of just the
    engine state plus this metadata is a complete network snapshot - pass
    the result as ``CheckpointManager.save(..., metadata=...)``.
    """
    from repro_torch.core.builder import spec_to_dict
    md = dict(extra or {})
    md["network"] = {"spec": spec_to_dict(spec), "seed": int(seed)}
    return md


def session_metadata(spec, *, seed: int, session_id: int, step: int,
                     extra: dict | None = None) -> dict:
    """:func:`network_metadata` plus a serving-session identity: which
    session the snapshot belongs to and at what step it resumes."""
    md = network_metadata(spec, seed=seed, extra=extra)
    md["session"] = {"id": int(session_id), "step": int(step)}
    return md


def restore_spec(metadata: dict):
    """Inverse of :func:`network_metadata`: ``(NetworkSpec, seed)``.

    Feed the spec back through ``build_shards`` / ``prepare_stacked`` /
    ``prepare_stacked_local`` to regenerate the topology on the restoring
    grid, then ``CheckpointManager.restore`` the state.
    """
    from repro_torch.core.builder import spec_from_dict
    net = metadata.get("network")
    if net is None:
        raise KeyError(
            "checkpoint metadata carries no 'network' entry - it was not "
            "written via network_metadata()")
    return spec_from_dict(net["spec"]), int(net["seed"])


# --------------------------------------------------------------------------
# flattening (the reference's key strings)
# --------------------------------------------------------------------------

_SCALARS = (str, bytes, bool, int, float, type(None))


def _static(v) -> bool:
    """A dataclass field that writes no leaf: a string, python scalar,
    None, or a tuple of those."""
    return isinstance(v, _SCALARS) or (
        isinstance(v, tuple) and all(isinstance(x, _SCALARS) for x in v))


def _children(node):
    """``[(key segment, child), ...]`` of a container, or None for a leaf.
    Dict keys are sorted, dataclass fields in order, None has no leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)
                if not _static(getattr(node, f.name))]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def _tree_paths(tree, prefix: str = "") -> list:
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for seg, child in kids:
        out += _tree_paths(child, prefix + seg)
    return out


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_tree_paths` order,
    from the iterator ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return tree if tree is None else next(leaves)
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return dataclasses.replace(tree, **{
        seg[1:]: _rebuild(child, leaves) for seg, child in kids})


def _to_host(v) -> tuple[np.ndarray, str | None]:
    """A host COPY of one leaf, and its generator device type (None for
    data)."""
    if isinstance(v, torch.Generator):
        return v.get_state().numpy().copy(), v.device.type
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy(), None
    return np.array(v, copy=True), None


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else ()


def _place(tgt, rec: dict, arr: np.ndarray):
    """One saved leaf ``arr`` in the target leaf's kind, dtype and device
    (never its value)."""
    gen = rec.get("generator")
    if isinstance(tgt, torch.Generator) or gen is not None:
        if not isinstance(tgt, torch.Generator) or gen is None:
            raise ValueError(f"{rec['key']}: a generator leaf and a data "
                             "leaf do not mix")
        if gen != tgt.device.type:
            raise ValueError(
                f"{rec['key']}: the checkpoint holds a {gen} generator's "
                f"state but the target's generator is on "
                f"{tgt.device.type}; a CPU mt19937 state and a CUDA Philox "
                "state do not mix - restore onto the device it was saved "
                "from")
        tgt.set_state(torch.from_numpy(np.ascontiguousarray(arr, np.uint8)))
        return tgt
    if tuple(arr.shape) != _shape(tgt):
        raise ValueError(f"{rec['key']}: shape {arr.shape} != {_shape(tgt)}")
    if isinstance(tgt, torch.Tensor):
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=tgt.device, dtype=tgt.dtype)
    if isinstance(tgt, np.ndarray):
        return arr.astype(tgt.dtype, copy=False)
    if isinstance(tgt, np.generic):
        return tgt.dtype.type(arr)
    return type(tgt)(arr.item())


# dict-key segments of a key string: "['a']['b']" -> ["a", "b"]
_KEYSTR_SEG = re.compile(r"\['([^']*)'\]")


@dataclasses.dataclass
class _Pending:
    thread: threading.Thread
    step: int
    error: BaseException | None = None


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: _Pending | None = None
        self.timings: list[dict] = []

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, *, metadata: dict | None = None,
             blocking: bool = True) -> None:
        """Snapshot ``state`` (a tree of tensors, arrays and generators) at
        ``step``; returns once every leaf is copied to the host."""
        self.wait()  # one in-flight save at a time (re-raises its failure)
        t0 = time.perf_counter()
        host = [(k,) + _to_host(v) for k, v in _tree_paths(state)]
        timing = {"step": int(step),
                  "bytes": int(sum(v.nbytes for _, v, _ in host)),
                  "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.timings.append(timing)
        meta = {
            "step": int(step),
            "created": time.time(),
            "metadata": metadata or {},
            "leaves": [
                {"key": k, "file": f"arr_{i:05d}.npy",
                 "shape": list(v.shape), "dtype": str(v.dtype),
                 "prng": False,
                 **({"generator": gen} if gen is not None else {})}
                for i, (k, v, gen) in enumerate(host)
            ],
        }
        host = [(k, v) for k, v, _ in host]

        def write():
            t1 = time.perf_counter()
            final = os.path.join(self.dir, f"step_{step:09d}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, (_, v) in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), v)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            # LATEST commits atomically (readers may race the async
            # writer) and LAST, so a failed write above leaves it on the
            # previous good checkpoint
            latest_tmp = os.path.join(self.dir, "LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(str(step))
                f.flush()
                os.fsync(f.fileno())
            os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()
            timing["write_s"] = time.perf_counter() - t1

        if blocking:
            write()
        else:
            pending = _Pending(thread=None, step=step)  # type: ignore

            def guarded():
                try:
                    write()
                except BaseException as e:  # surfaced by the next wait()
                    pending.error = e

            pending.thread = threading.Thread(target=guarded, daemon=True)
            self._pending = pending
            pending.thread.start()

    def wait(self) -> None:
        """Join any in-flight async save and RE-RAISE its failure (once).

        A failed background write never advanced ``LATEST``, so after the
        raise the manager still points at the last good checkpoint; the
        caller decides whether to retry the save or restore.
        """
        p = self._pending
        if p is None:
            return
        p.thread.join()
        self._pending = None
        if p.error is not None:
            raise RuntimeError(
                f"async checkpoint save at step {p.step} failed "
                f"(LATEST still points at the previous committed step)"
            ) from p.error

    def _drain(self) -> None:
        """Settle the writer WITHOUT consuming a captured failure: it stays
        pending for the next :meth:`wait`/:meth:`save` to surface."""
        if self._pending is not None:
            self._pending.thread.join()

    # --------------------------------------------------------------- restore
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _committed_steps(self) -> list[int]:
        """Step numbers with a committed (non-``.tmp``) directory, sorted."""
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                try:
                    out.append(int(n.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def _manifest_ok(self, step: int) -> bool:
        try:
            with open(os.path.join(self._step_dir(step),
                                   "manifest.json")) as f:
                json.load(f)
            return True
        except (OSError, ValueError):
            return False

    def latest_step(self) -> int | None:
        """Newest committed checkpoint step, or None.

        ``LATEST`` is a hint, not an authority: if it is unreadable, or the
        step directory it names is missing or has an unreadable manifest,
        fall back to the newest committed ``step_*`` dir whose manifest
        parses.
        """
        cand = None
        p = os.path.join(self.dir, "LATEST")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    cand = int(f.read().strip())
            except (OSError, ValueError):
                cand = None
        if cand is not None and self._manifest_ok(cand):
            return cand
        for s in reversed(self._committed_steps()):
            if self._manifest_ok(s):
                return s
        return None

    def _read_step(self, step: int, *, with_arrays: bool = True):
        """(manifest, arrays|None) for one step; CorruptCheckpointError on
        ANY read/parse failure so callers can fall back to an older step."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                meta = json.load(f)
            arrs = None
            if with_arrays:
                arrs = [np.load(os.path.join(d, rec["file"]),
                                allow_pickle=False)
                        for rec in meta["leaves"]]
        except (OSError, EOFError, KeyError, ValueError) as e:
            raise CorruptCheckpointError(
                f"checkpoint step {step} in {self.dir} is unreadable: "
                f"{e}") from e
        return meta, arrs

    def _resolve(self, step: int | None, *, with_arrays: bool = True):
        """(step, manifest, arrays).  Explicit ``step`` reads exactly that
        checkpoint (corruption raises); ``step=None`` walks backwards from
        the newest committed step past corrupted ones."""
        if step is not None:
            meta, arrs = self._read_step(step, with_arrays=with_arrays)
            return step, meta, arrs
        tried: list[int] = []
        cand = self.latest_step()
        committed = self._committed_steps()
        while cand is not None:
            try:
                meta, arrs = self._read_step(cand, with_arrays=with_arrays)
                return cand, meta, arrs
            except CorruptCheckpointError:
                tried.append(cand)
                older = [s for s in committed if s < cand]
                cand = older[-1] if older else None
        if tried:
            raise CorruptCheckpointError(
                f"no readable checkpoint in {self.dir}; tried steps "
                f"{tried}")
        raise FileNotFoundError(f"no checkpoint in {self.dir}")

    def load_metadata(self, step: int | None = None) -> dict:
        """A checkpoint's metadata WITHOUT loading any arrays: a procedural
        restart needs the spec (``restore_spec``) before it can rebuild the
        network and allocate the target state."""
        self._drain()
        _, meta, _ = self._resolve(step, with_arrays=False)
        return meta["metadata"]

    def load_host(self, step: int | None = None
                  ) -> tuple[int, dict, dict]:
        """Load a checkpoint as a nested host-side dict of numpy arrays.

        Returns ``(step, tree, metadata)`` where ``tree`` rebuilds the saved
        dict nesting from the manifest's key paths; generator leaves come
        back as their raw state bytes.  The restart path for a state that
        will be RE-SHAPED before placement (elastic shrink-restart), where
        no target of matching structure exists yet.  ``step=None`` falls
        back past corrupted checkpoints like :meth:`restore`.
        """
        self._drain()
        step, meta, arrs = self._resolve(step, with_arrays=True)
        tree: dict = {}
        for rec, arr in zip(meta["leaves"], arrs):
            segs = _KEYSTR_SEG.findall(rec["key"])
            if not segs:
                raise CorruptCheckpointError(
                    f"step {step}: leaf key {rec['key']!r} is not a dict "
                    "path - load_host needs a dict-saved state")
            node = tree
            for s in segs[:-1]:
                node = node.setdefault(s, {})
            node[segs[-1]] = arr
        return step, tree, meta["metadata"]

    def restore(self, target_tree: Any, step: int | None = None, *,
                shardings: Any = None) -> tuple[Any, dict]:
        """Load into the structure of ``target_tree``: ``(state,
        metadata)``.

        Structure, dtypes and devices come from the target, never its
        values (the port's steps may have overwritten them); a target
        generator is set to the saved state in place and returned.
        ``shardings`` (optional, the target's structure with a
        ``sharding.rules.NamedSharding`` at every leaf) cuts each saved
        (global) leaf to this process's block on its mesh, on every dim
        its spec cuts (FSDP over ``data``, tensor parallelism over
        ``model``, experts) - the elastic restart; the target then holds
        the blocks' shapes.
        ``step=None`` restores the newest READABLE checkpoint (walking past
        corrupted ones); a shape mismatch against the target is a caller
        error and raises ValueError without falling back.
        """
        self._drain()
        step, meta, arrs = self._resolve(step, with_arrays=True)
        leaves = _tree_paths(target_tree)
        if len(leaves) != len(meta["leaves"]):
            raise ValueError(
                f"checkpoint has {len(meta['leaves'])} leaves, target has "
                f"{len(leaves)} - structure mismatch")
        if shardings is not None:
            shs = [sh for _, sh in _tree_paths(shardings)]
            if len(shs) != len(leaves):
                raise ValueError(f"{len(shs)} shardings for {len(leaves)} "
                                 "leaves")
            arrs = [sh.shard(arr) for sh, arr in zip(shs, arrs)]
        out = [_place(tgt, rec, arr) for (_, tgt), rec, arr
               in zip(leaves, meta["leaves"], arrs)]
        return _rebuild(target_tree, iter(out)), meta["metadata"]

    # ------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self._committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
