"""Build, load and feed the hand-written CUDA kernels of ``kernels/csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use, by itself, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o build/lib<name>.so
         csrc/<name>.cu

into ``build/`` at the repository root, then loaded with ``ctypes``.  A
plain C interface keeps a build to seconds; including PyTorch's headers
would take minutes.  ``--fmad=false`` keeps every multiply and add rounded
on its own, as the reference's XLA ops are, so that contraction cannot move
a membrane potential across the threshold (K2) or a weight by an ulp
(K1, K3).

:func:`load` rebuilds a library when its source, or any ``csrc/*.cuh``
header, is newer.  :func:`build_all` starts one ``nvcc`` per source, all
at once, and waits for them.  The wrappers
validate every tensor with :func:`check_tensor` (a parameter table with
:func:`check_table`) before its pointer goes to C, and raise on the error code each entry point returns (:func:`check`).

A kernel called through ``ctypes`` is invisible to autograd: its outputs
would come back cut from the graph, and a loss through them would get zero
gradients without an error.  So every wrapper first calls
:func:`require_no_grad`, on the CPU twin's route too: with grad mode on,
an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["load", "build_all", "check", "check_tensor", "check_table",
           "dispatch_device", "require_no_grad", "KERNELS", "BUILD_DIR",
           "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
#: sources under csrc/ (one shared library each)
KERNELS = ("synaptic_gather", "lif_step", "stdp_update", "izhikevich_step",
           "adex_step", "blocked_reduce_sweep", "stdp_update_worklist",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _paths(name: str) -> tuple[Path, Path]:
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True iff ``name``'s library is missing or older than its source or
    than any header in ``csrc/`` (a source may include any of them)."""
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)   # atomic: a reader never sees half a library
    return out


def build_all(names=KERNELS) -> dict:
    """Compile the kernels ``names``, one ``nvcc`` each, in parallel, stale
    or not (:func:`load` builds a kernel only when it is stale).

    Returns ``{"seconds": wall time, "ptxas": {name: nvcc output}}``;
    the ptxas lines give registers, shared memory and spills per kernel.
    """
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    logs = {}
    try:
        for n, (proc, tmp, lib) in started.items():
            logs[n] = _finish(n, proc, tmp, lib)
    finally:
        for proc, tmp, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return {"seconds": time.perf_counter() - t0, "ptxas": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(_paths(name)[1]))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_tensor(x, name: str, dtype, shape, device) -> None:
    """Validate one kernel argument before its pointer goes to C: a CUDA
    tensor on ``device``, of ``dtype`` and ``shape``, contiguous."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_table(table, ncol: int, device) -> int:
    """Validate a (G, ``ncol``) float32 parameter table on ``device`` whose
    rows may lie further apart than ``ncol`` (a composite model's base
    columns, ``table[:, :-1]``); returns the row stride the kernel takes."""
    if not isinstance(table, torch.Tensor):
        raise TypeError(f"table must be a tensor, got {type(table).__name__}")
    if table.device != device:
        raise ValueError(f"table is on {table.device}, expected {device}")
    if table.dtype != torch.float32:
        raise TypeError(f"table has dtype {table.dtype}, expected "
                        f"{torch.float32}")
    if table.dim() != 2 or table.shape[0] < 1 or table.shape[1] != ncol:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected "
                         f"(G, {ncol})")
    if table.stride(1) != 1 or table.stride(0) < ncol:
        raise ValueError(f"table rows must be contiguous and not overlap, "
                         f"got strides {table.stride()}")
    return table.stride(0)


def dispatch_device(x):
    """Which path a wrapper takes for tensor ``x``: ``"cpu"`` (the plain
    version) or ``"cuda"`` (the kernel).  Anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernels run on cpu (plain version) or cuda, "
                         f"got a tensor on {x.device}")
    return x.device.type


def require_no_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and one of ``tensors`` (tensors or None)
    requires grad: kernel ``what`` has no backward."""
    if not torch.is_grad_enabled():
        return
    for x in tensors:
        if x is not None and x.requires_grad:
            raise RuntimeError(
                f"{what}: an input requires grad, but this CUDA kernel has "
                "no backward and would cut the gradient; run gradients on "
                "the plain backend (EngineConfig(sweep=\"flat\")) or the "
                "LM's train route, or call under torch.no_grad()")
