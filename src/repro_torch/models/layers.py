"""Shared building blocks of the LM face: norms, linears, MLPs, RoPE.

Ports ``src/repro/models/layers.py``.  Parameters live in small
``nn.Module``s whose attribute names are the reference's pytree keys
(``Linear.w`` / ``.b``, ``Norm.scale`` / ``.bias``), so a reference tree
maps onto a port ``state_dict`` key for key (``repro_torch.convert.
lm_params_from_numpy``).  Every matrix is stored ``(d_in, d_out)``.

Dtypes follow the casts the reference applies at every use: a matrix and
the embedding are stored in the config's compute dtype (the reference keeps
fp32 masters and casts them first, ``linear``, ``jnp.take(...).astype``),
biases and norm scales in fp32.  Norm math runs in fp32 and rounds back to
the input's dtype; a matrix product accumulates in fp32 and rounds once to
the compute dtype, after the bias is added in fp32.

The ``init_*`` functions draw the reference's distributions (``N(0, 1) /
sqrt(d_in)`` matrices, ``N(0, 0.02)`` embedding, zero biases, unit scales)
from a ``torch.Generator`` on the parameters' device; the numbers differ
from ``jax.random``'s, so parity tests carry the reference's parameters
across instead.

On a process mesh (``sharding.rules``) a matrix may be this process's
block: :func:`linear` gathers its ``data`` (FSDP) cut at use and runs
column-parallel where its columns are cut over ``model`` or
row-parallel where its rows are; :func:`mlp_apply` is one
tensor-parallel region.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules

__all__ = ["Norm", "Linear", "MLP", "rms_norm", "layer_norm", "norm_apply",
           "linear", "row_parallel", "matmul_f32", "bmm_f32", "F32Product", "mlp_apply",
           "rope_freqs", "apply_rope", "init_norm", "init_linear",
           "mlp_init", "embed_init"]

_HALF = (torch.bfloat16, torch.float16)


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), fp32."""

    def __init__(self, d: int, kind: str = "rmsnorm", *, device):
        super().__init__()
        self.scale = _param(d, dtype=torch.float32, device=device)
        if kind == "layernorm":
            self.bias = _param(d, dtype=torch.float32, device=device)
        else:
            self.register_parameter("bias", None)


class Linear(nn.Module):
    """A ``(d_in, d_out)`` matrix ``w`` in ``dtype`` and an optional fp32
    bias ``b``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False, dtype,
                 device):
        super().__init__()
        self.w = _param(d_in, d_out, dtype=dtype, device=device)
        if bias:
            self.b = _param(d_out, dtype=torch.float32, device=device)
        else:
            self.register_parameter("b", None)


class MLP(nn.Module):
    """SwiGLU (``wi_gate``, ``wi_up``, ``wo``) or GELU (``wi``, ``wo``)."""

    def __init__(self, d: int, d_ff: int, kind: str, *, dtype, device):
        super().__init__()
        self.kind = kind
        kw = dict(dtype=dtype, device=device)
        if kind == "swiglu":
            self.wi_gate = Linear(d, d_ff, **kw)
            self.wi_up = Linear(d, d_ff, **kw)
        else:
            self.wi = Linear(d, d_ff, **kw)
        self.wo = Linear(d_ff, d, **kw)


# --------------------------------------------------------------------------
# math
# --------------------------------------------------------------------------

def rms_norm(p: Norm, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale
    return y.to(x.dtype)


def layer_norm(p: Norm, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    return y.to(x.dtype)


def norm_apply(p: Norm, x, kind: str):
    return rms_norm(p, x) if kind == "rmsnorm" else layer_norm(p, x)


def _col_major(x) -> bool:
    """A 2-d tensor laid out column by column (a transposed view), as
    ``mm``'s own backward tests it."""
    return x.stride(0) == 1 and x.stride(1) == x.shape[0]


class F32Product(torch.autograd.Function):
    """``a @ b`` of two compute-dtype operands with an fp32 result: ``mm``
    (2-d ``a``) or ``bmm`` (3-d, one product per leading index).

    The forward on the card is the GEMM that writes fp32 directly
    (``out_dtype=torch.float32``), which has no derivative of its own; on
    the CPU, which lacks that overload, it is the upcast product.  The
    backward is what autograd computes through the upcast product
    ``a.float() @ b.float()``: the fp32 cotangent times the other operand
    upcast to fp32 (``mm``'s backward rules, its column-major branch
    included), cast back to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":
            return (torch.mm if a.dim() == 2 else torch.bmm)(a.float(),
                                                             b.float())
        return (torch.mm if a.dim() == 2 else torch.bmm)(
            a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        af, bf = a.float(), b.float()
        ga = gb = None
        if a.dim() == 3:
            if ctx.needs_input_grad[0]:
                ga = g.bmm(bf.transpose(1, 2)).to(a.dtype)
            if ctx.needs_input_grad[1]:
                gb = af.transpose(1, 2).bmm(g).to(b.dtype)
            return ga, gb
        if ctx.needs_input_grad[0]:
            ga = (bf.mm(g.t()).t() if _col_major(a) else g.mm(bf.t()))
            ga = ga.to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (g.t().mm(af).t() if _col_major(b) else af.t().mm(g))
            gb = gb.to(b.dtype)
        return ga, gb


def matmul_f32(a, b):
    """``a @ b`` in fp32, unrounded, for operands already in the compute
    dtype: the reference's ``einsum(..., preferred_element_type=float32)``.
    A product of two bf16 (or fp16) values is exact in fp32, so the CPU
    path upcasts; on the card the GEMM writes fp32 directly, through
    :class:`F32Product`, which carries its gradient.  Every device but
    the CPU takes the card's route, so that a count on ``meta`` sees the
    card's ops."""
    if a.device.type != "cpu" and a.dtype in _HALF:
        y = F32Product.apply(a.reshape(-1, a.shape[-1]), b)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def bmm_f32(a, b):
    """The batched ``a @ b`` (``(E, M, K) @ (E, K, N)``) in fp32,
    unrounded, for operands already in the compute dtype: as
    :func:`matmul_f32`, one product per leading index."""
    if a.device.type != "cpu" and a.dtype in _HALF:
        return F32Product.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _affine(x, w, b, compute_dtype):
    """``x @ w (+ b)``, both in ``compute_dtype``: fp32 accumulation,
    rounded once; with a bias the product stays fp32 until it is added,
    as the reference adds it before its one rounding."""
    if b is None:
        return torch.matmul(x, w)
    return (matmul_f32(x, w) + b.float()).to(compute_dtype)


def linear(p: Linear, x, compute_dtype=torch.bfloat16):
    """``x @ w (+ b)`` with fp32 accumulation, rounded once to
    ``compute_dtype``.

    On a process mesh ``w`` is first gathered over ``data`` where its
    spec cuts it (FSDP).  Columns cut over ``model`` (``("fsdp",
    "tensor")``): column-parallel, ``x`` this process's whole input (the
    caller has entered it through ``collectives.sum_grad``), the result
    this process's columns, the bias its block.  Rows cut over ``model``
    (``("tensor", "fsdp")``): row-parallel, ``x`` the inputs of this
    process's rows; the fp32 partial product is summed over ``model`` in
    fp32 (``collectives.psum``), then the bias is added and the sum
    rounded once, as the single-device path rounds once."""
    x = x.to(compute_dtype)
    w, spec = rules.gather_fsdp(p.w, compute_dtype)
    if len(spec) and spec[0] == "model":
        y = coll.psum(matmul_f32(x, w), rules.process_mesh(), ("model",))
        if p.b is not None:
            y = y + p.b.float()
        return y.to(compute_dtype)
    return _affine(x, w, p.b, compute_dtype)


def row_parallel(p: Linear) -> bool:
    """Whether ``p``'s rows are cut over ``model`` (the output of a
    tensor-parallel region)."""
    spec = rules.spec_of(p.w)
    return len(spec) > 0 and spec[0] == "model"


def mlp_apply(p: MLP, x, kind: str, compute_dtype=torch.bfloat16):
    """The MLP; on a process mesh whose ``model`` cuts it, one
    tensor-parallel region: ``x`` enters through ``sum_grad`` (its
    cotangent summed over ``model``), ``wi*`` are column-parallel and
    ``wo`` row-parallel."""
    if row_parallel(p.wo):
        x = coll.sum_grad(x, rules.process_mesh(), ("model",))
    if kind == "swiglu":
        g = linear(p.wi_gate, x, compute_dtype)
        u = linear(p.wi_up, x, compute_dtype)
        return linear(p.wo, F.silu(g) * u, compute_dtype)
    h = F.gelu(linear(p.wi, x, compute_dtype), approximate="tanh")
    return linear(p.wo, h, compute_dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """(head_dim/2,) inverse frequencies, in float64."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float, device: torch.device):
    """:func:`rope_freqs` as fp32 on ``device``, copied there once: a copy
    from pageable host memory waits for the stream, so one per call
    would hold the host at every layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh) rotated in split halves; positions broadcastable
    to (..., S).  Angles in fp32, the result cast back to x's dtype."""
    dh = x.shape[-1]
    inv = _inv_freqs(dh, float(theta), x.device)
    ang = positions[..., :, None].float() * inv          # (..., S, dh/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# initialisation (in place, from a torch.Generator on the parameters' device)
# --------------------------------------------------------------------------

def init_norm(p: Norm) -> Norm:
    p.scale.fill_(1.0)
    if p.bias is not None:
        p.bias.zero_()
    return p


def init_linear(p: Linear, gen: torch.Generator,
                scale: float | None = None) -> Linear:
    scale = scale if scale is not None else 1.0 / np.sqrt(p.w.shape[0])
    p.w.normal_(0.0, float(scale), generator=gen)
    if p.b is not None:
        p.b.zero_()
    return p


def mlp_init(p: MLP, gen: torch.Generator) -> MLP:
    names = (("wi_gate", "wi_up", "wo") if p.kind == "swiglu"
             else ("wi", "wo"))
    for name in names:
        init_linear(getattr(p, name), gen)
    return p


def embed_init(table: nn.Parameter, gen: torch.Generator) -> nn.Parameter:
    table.normal_(0.0, 0.02, generator=gen)
    return table
