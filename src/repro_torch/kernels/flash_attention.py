"""K8: fused online-softmax attention - CUDA kernel and plain twin.

Ports ``src/repro/kernels/flash_attention.py::flash_attention`` (the Pallas
TPU kernel, body ``_kernel``): ``q (B, S, H, dh)`` against ``k / v (B, T,
Hk, dh | dv)``, causal or not, GQA through ``kv head = h // (H // Hk)``,
ragged tails masked by the true ``T``, returned as ``(B, S, H * dv)`` in
q's dtype.  The arithmetic is the reference kernel's:

* scores ``(q . k^T) * scale`` with q and k read as fp32 and ``scale =
  float32(1 / sqrt(dh))`` applied after the dot;
* invalid entries are ``NEG_INF = -1e30`` (not ``-inf``): ``kv_pos >= T``
  and, if causal, ``q_pos < kv_pos``, both counted from 0 (no query
  offset, so the causal case is prefill's and the full forward's, where S
  == T and both start at position 0 - never decode's);
* a running max ``m``, sum ``l`` and fp32 accumulator, ``corr = exp(m_prev
  - m_new)``; ``p`` is multiplied with v in fp32, since the reference has
  cast v to fp32 before ``p.astype(v.dtype)``;
* ``acc / max(l, 1e-30)``, cast to q's dtype.

:func:`flash_attention_plain` repeats that loop chunk by chunk over
``kv_chunk``, padding the last chunk with zeros as the reference does; the
CPU path and the tests use it.  :func:`flash_attention` is the op
``repro_torch::flash_attention``: for CPU tensors it runs the twin, for
``meta`` tensors its fake gives the output's shape (a dry run counts the
call as one op, ``utils.op_costs``), and for CUDA tensors it launches one
of the two hand-written routes of ``csrc/flash_attention.cu`` or raises,
and never falls back:

* ``"wgmma"`` - bf16 on the tensor cores (``wgmma``, K/V by TMA into a
  ring of stages, a producer warpgroup and two consumers), for bf16 inputs
  whose ``dh`` and ``dv`` are multiples of 16 and whose base pointers and
  strides (of every dim longer than 1) are multiples of 16 bytes;
* ``"simt"`` - fp32 FMAs on the CUDA cores, for fp32 and the other bf16
  calls.

:func:`_route` makes that choice from dtypes, shapes, strides and
pointers alone.  Both routes tile 128 or 64 queries by 64 keys whatever
the chunk arguments say: those only shape the twin's loop, and the result
differs from the twin's by the fp32 rounding of another summation order
(and, on the tensor cores, p carried as two bf16 parts, 2^-17 relative).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF",
           "MAX_HEAD_DIM", "ROUTES"]

NEG_INF = -1e30
#: largest dh and dv the kernel takes (the SIMT route's Q/K/V/P tiles then
#: fill 209 KB of the 227 KB of shared memory a block may use, the
#: tensor-core route's Q tile and two K/V stages 194 KB)
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's two routes: bf16 on the tensor cores, and fp32 FMAs
ROUTES = ("wgmma", "simt")
#: TMA's alignment of base pointers and strides, in bytes
_TMA_ALIGN = 16


def _scale(dh: int) -> float:
    """The reference's ``1 / sqrt(dh)``, rounded to fp32 as its fp32
    multiply rounds it."""
    return float(np.float32(1.0 / np.sqrt(dh)))


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_chunk: int = 512, kv_chunk: int = 512):
    """Plain-torch twin; same arguments and result as
    :func:`flash_attention`.  Rows are independent, so ``q_chunk`` does
    not change the result and the twin processes every row at once."""
    del q_chunk
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // hk
    kc = min(kv_chunk, t)
    nk = -(-t // kc)
    pad = nk * kc - t
    qf = q.float().permute(0, 2, 1, 3)                         # (B, H, S, dh)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)  # (B,H,T',dh)
    vf = vf.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    scale = _scale(dh)
    dev = q.device
    q_pos = torch.arange(s, device=dev)[:, None]
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s, dv), dtype=torch.float32, device=dev)
    for ki in range(nk):
        kb = kf[:, :, ki * kc:(ki + 1) * kc]
        vb = vf[:, :, ki * kc:(ki + 1) * kc]
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        kv_pos = ki * kc + torch.arange(kc, device=dev)[None, :]
        valid = kv_pos < t
        if causal:
            valid = valid & (q_pos >= kv_pos)
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).reshape(b, s, h * dv).to(q.dtype)


def _check(q, k, v, q_chunk: int, kv_chunk: int) -> None:
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(x).__name__}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, q {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous, got "
                             f"strides {x.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes {_DTYPES}, got {q.dtype}")
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[3] != dh:
        raise ValueError(f"k's head dim {k.shape[3]} != q's {dh}")
    if min(b, s, t, h, hk) < 1 or h % hk:
        raise ValueError(f"need B, S, T >= 1 and H % Hk == 0, got B {b}, "
                         f"S {s}, T {t}, H {h}, Hk {hk}")
    dv = v.shape[3]
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must lie in [1, {MAX_HEAD_DIM}], got "
                         f"dh {dh}, dv {dv}")
    if b * h >= 2 ** 31 or -(-s // 64) > 65535:
        raise ValueError(f"grid too large: B*H {b * h}, S {s}")
    if q_chunk < 1 or kv_chunk < 1:
        raise ValueError("q_chunk and kv_chunk must be positive")


def _route(q, k, v) -> str:
    """The route a checked call takes: ``"wgmma"`` for bf16 with ``dh``
    and ``dv`` multiples of 16 and every base pointer and every stride of
    a dim longer than 1 a multiple of 16 bytes (what TMA takes), else
    ``"simt"``."""
    dh, dv = q.shape[3], v.shape[3]
    if q.dtype != torch.bfloat16 or dh % 16 or dv % 16:
        return "simt"
    for x in (q, k, v):
        size = x.element_size()
        if x.data_ptr() % _TMA_ALIGN or any(
                x.stride(i) * size % _TMA_ALIGN
                for i in range(3) if x.shape[i] > 1):
            return "simt"
    return "wgmma"


def _entry(route: str):
    """The C entry point of ``route``, its argument types set."""
    lib = _build.load("flash_attention")
    if route == "wgmma":
        fn = lib.flash_attention_wgmma_launch
        tail = [ctypes.c_void_p]
    else:
        fn = lib.flash_attention_launch
        tail = [ctypes.c_int, ctypes.c_void_p]
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
                       + tail)
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512):
    """q: (B, S, H, dh); k / v: (B, T, Hk, dh | dv), one dtype (fp32 or
    bf16 on the card), each with a contiguous last dim -> (B, S, H * dv)
    in q's dtype.  The kernel has no backward: an input that requires
    grad raises on every device (the LM's train route,
    ``models.attention._sdpa``, never calls it with one).

    The call is the op ``repro_torch::flash_attention``: on the card its
    body launches the kernel, on the CPU it runs the twin, and on
    ``meta`` its fake gives the output's shape and dtype after the
    kernel's own checks, so a count of a step on ``meta``
    (``utils.op_costs.OpCounter``) sees one op per call, as on the
    card."""
    _build.require_no_grad("flash_attention", q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"kernels run on cpu (plain version), cuda or "
                         f"meta (shapes only), got a tensor on {q.device}")
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, q_chunk,
                                                 kv_chunk)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, q_chunk: int,
                        kv_chunk: int) -> torch.Tensor:
    """The op's body on the CPU (the twin) and on the card (the launch of
    one of the two routes, counted)."""
    if _build.dispatch_device(q) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    _check(q, k, v, q_chunk, kv_chunk)
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    route = _route(q, k, v)
    fn = _entry(route)
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v)
                                        for i in range(3)))
    out = torch.empty((b, s, h * dv), dtype=q.dtype, device=q.device)
    tail = ([] if route == "wgmma"
            else [int(q.dtype == torch.bfloat16)])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, t, h, hk, dh, dv, ctypes.cast(strides,
                                                     ctypes.c_void_p),
                 _scale(dh), int(causal), *tail,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, q_chunk, kv_chunk):
    _check(q, k, v, q_chunk, kv_chunk)
    b, s, h, _ = q.shape
    return q.new_empty((b, s, h * v.shape[3]))


#: kernel launches so far (plain-version calls do not count), in all and
#: by route
flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
