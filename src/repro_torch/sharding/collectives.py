"""The collectives of the LM face's mesh programs, each an
``autograd.Function`` over a :class:`~repro_torch.launch.mesh.ProcessMesh`.

The reference writes its mesh programs as ``shard_map`` bodies and lets
XLA transpose their collectives.  The port runs the same bodies in the
local view: every process runs its own share of a step and differentiates
its own copy of the loss.  The gradient contract of that view:

* each process differentiates the loss of the batch block it holds
  (the processes along ``model`` hold the same block and compute the same
  loss), with an unscaled cotangent;
* a replicated parameter's gradient on a process is then the full
  gradient of its block's loss, equal on every process of the block; the
  train step averages it over the batch axes (``pod``, ``data``);
* so where a body splits a replicated block's work over the processes of
  some axes (``models.moe_manual``'s token slices), each slice's
  cotangent is its own part, once (:func:`all_gather`'s backward takes
  its own rows, it does not sum the copies), and the parts are gathered
  back or summed where the block was split (:func:`own_slice`,
  :func:`sum_grad`);
* a parameter cut into blocks (FSDP over ``data``, tensor parallelism
  over ``model``: ``sharding.rules``) is put together where it is used
  by :func:`gather_blocks`, whose backward is the reduce-scatter
  (:func:`reduce_scatter`): each block's owner gets the sum of every
  process's cotangent of its block, which over ``data`` is the sum over
  the batch blocks' losses;
* tensor parallelism splits one block's work over ``model`` (Megatron's
  two operators): a column-parallel product's input enters through
  :func:`sum_grad` (identity, its cotangent summed over ``model``), a
  row-parallel product's partial sums leave through :func:`psum` (the
  sum over ``model``, its cotangent passed to every part as it is).

Axes are a tuple of mesh axis names, the first major
(``ProcessMesh.axis_index``); a group of one process is the identity.
A tensor is cut into equal blocks along dim 0 ("tiled"), block ``i``
belonging to the process of index ``i``.

The tally (:func:`tally`): every wire primitive - the all-to-alls
(:func:`all_to_all`, :func:`all_to_all_v`), the gathers
(:func:`gather_rows`, and :func:`gather_blocks` and :func:`all_gather`,
which it serves), the sums (:func:`all_reduce_sum`, which :func:`psum`,
:func:`sum_grad`'s backward and :func:`pmean` call; :func:`pmax`) and
:func:`reduce_scatter_sum` - adds one call and the bytes this process
sends to every tally open in the process, under the kind of the HLO
collective it stands for (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``; :func:`gather_to`, which only
checkpoints call, ``gather``), so that the record can be set beside the
reference's histogram of its partitioned program.  A group of one
process sends nothing and counts nothing.  The bytes, of ``x`` the
primitive's input on this process and ``n`` its group's size:

* ``all-gather``: ``(n - 1) |x|``, this process's block to each other
  member (a ring's volume as well);
* ``all-to-all``: ``(n - 1) / n |x|``, every block but its own
  (:func:`all_to_all_v`: the rows it sends to the others);
* ``reduce-scatter``: ``(n - 1) / n |x|``, the blocks it does not own
  (a ring's volume as well);
* ``all-reduce``: ``(n - 1) |x|``: the port gathers every member's
  part and adds them here in a fixed order (deterministic, the same
  bits everywhere), so it sends its part to each other member, not a
  ring's ``2 (n - 1) / n |x|``;
* ``gather``: ``|x|`` from every member but ``root``.

Beside those bytes a tally keeps each kind's ring volume (``ring``):
what a ring or a collective library's reduce-scatter-then-gather would
send for the same call, the bytes above for every kind but
``all-reduce``, whose ring volume is ``2 (n - 1) / n |x|`` (integer
bytes, rounded down).  The dry run's roofline prices the ring volume
(:mod:`repro_torch.launch.dryrun`); the bytes sent are what gloo moves.

On a :class:`~repro_torch.launch.mesh.StandInMesh` (the dry run's mesh
on ``meta``) every primitive tallies and returns a ``meta`` tensor of its
output's shape: nothing reaches ``torch.distributed``.

Routes: every collective moves bytes only (a tensor is viewed as rows of
``uint8``), and sums are done here, in a fixed order, so each is
deterministic and gives every process the same bits.  A CUDA tensor on a
gloo world (processes sharing one card) is staged through pinned host
memory on every call; on nccl, and for CPU tensors, the tensor itself is
sent.  The route is fixed by the backend and the device: nothing is tried
and retried.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as tdist

__all__ = ["all_to_all", "all_to_all_v", "all_gather", "own_slice",
           "sum_grad", "pmean", "gather_blocks", "reduce_scatter", "psum", "pmax",
           "gather_rows", "gather_to", "all_reduce_sum", "reduce_scatter_sum",
           "route", "Tally", "tally"]


_HALF = (torch.bfloat16, torch.float16)


class Tally:
    """Calls and bytes sent of the collectives a process calls, by kind
    (module docstring)."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.ring: dict[str, int] = {}

    def add(self, kind: str, nbytes: int, ring: int | None = None) -> None:
        """One call of ``kind`` sending ``nbytes``, of ring volume
        ``ring`` (``nbytes`` unless given)."""
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.ring[kind] = self.ring.get(kind, 0) + int(
            nbytes if ring is None else ring)

    def record(self) -> dict:
        """``by_kind`` bytes, ``calls_by_kind``, ``total_bytes``, and the
        ring volumes ``ring_by_kind`` and ``ring_total_bytes``."""
        return {"by_kind": dict(sorted(self.bytes.items())),
                "calls_by_kind": dict(sorted(self.calls.items())),
                "total_bytes": sum(self.bytes.values()),
                "ring_by_kind": dict(sorted(self.ring.items())),
                "ring_total_bytes": sum(self.ring.values())}


#: the tallies open in this process: a module global, as the autograd
#: engine runs a backward's collectives on its own device thread
_TALLIES: list[Tally] = []


@contextlib.contextmanager
def tally():
    """A :class:`Tally` of every collective this process calls inside
    the block (tallies nest: each open one counts)."""
    t = Tally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def _count(kind: str, nbytes: int, ring: int | None = None) -> None:
    for t in _TALLIES:
        t.add(kind, nbytes, ring)


def _count_sum(mesh, axes, x: torch.Tensor) -> None:
    """Tally an all-reduce of ``x`` over ``axes``: ``(n - 1) |x|`` sent,
    a ring's ``2 (n - 1) / n |x|``."""
    n = mesh.axis_size(axes)
    _count("all-reduce", (n - 1) * _nbytes(x), 2 * (n - 1) * _nbytes(x) // n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _stand_in(mesh) -> bool:
    """Whether ``mesh`` is a stand-in that runs nothing
    (:class:`~repro_torch.launch.mesh.StandInMesh`)."""
    return getattr(mesh, "stand_in", False)


def route(mesh, t: torch.Tensor) -> str:
    """``"host"``: a CUDA tensor on a gloo world, staged through pinned
    host memory; ``"direct"``: the tensor itself."""
    return "host" if (mesh.backend == "gloo" and t.is_cuda) else "direct"


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as flat uint8 (a view of a contiguous ``t``)."""
    return t.contiguous().view(-1).view(torch.uint8)


#: pinned host buffers of the host route, by (use, size): every copy
#: through one is synchronous and every collective blocking, so one
#: buffer a use and size serves every call of this process
_PINNED: dict[tuple, torch.Tensor] = {}


def _host(mesh, like: torch.Tensor, nbytes: int, use: str) -> torch.Tensor:
    """A flat uint8 buffer of ``nbytes`` for the collective to read or
    write: pinned host memory on the host route, else on ``like``'s
    device."""
    if route(mesh, like) == "host":
        buf = _PINNED.get((use, nbytes))
        if buf is None:
            buf = _PINNED[use, nbytes] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=True)
        return buf
    return torch.empty(nbytes, dtype=torch.uint8, device=like.device)


def _send(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes where the collective reads them."""
    flat = _bytes(t)
    if route(mesh, t) != "host":
        return flat
    buf = _host(mesh, t, flat.numel(), "send")
    buf.copy_(flat)
    return buf


def _back(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Received bytes as a tensor of ``like``'s dtype and device."""
    out = buf.to(like.device) if buf.device != like.device else buf.clone()
    return out.view(like.dtype).view(shape)


def _positions(mesh, axes) -> tuple[list[int], list[int], bool]:
    """``(pos, inv, identity)``: ``pos[k]`` is the group rank (the
    position among the group's sorted ranks) of the member of logical
    index ``k``, ``inv`` its inverse."""
    members = mesh.members(axes)
    order = sorted(members)
    pos = [order.index(r) for r in members]
    inv = [pos.index(q) for q in range(len(pos))]
    return pos, inv, pos == list(range(len(pos)))


# torch 2.13 names the tensor all-gather ``all_gather_single``; earlier
# releases ``all_gather_into_tensor`` (the same collective)
_all_gather_single = getattr(tdist, "all_gather_single", None) or \
    tdist.all_gather_into_tensor


def _a2a(x: torch.Tensor, mesh, axes, counted: bool = True) -> torch.Tensor:
    """Block ``k`` of ``x`` to the process of index ``k`` (no autograd),
    tallied unless it is a part of another primitive (``counted``)."""
    pg = mesh.group(axes)
    if pg is None:
        return x
    n = mesh.axis_size(axes)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split {n} "
                         "ways")
    if counted:
        _count("all-to-all", (n - 1) * _nbytes(x) // n)
    if _stand_in(mesh):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    pos, inv, ident = _positions(mesh, axes)
    blocks = x.contiguous().view(n, -1)
    if not ident:                 # logical block pos^-1[q] to group rank q
        blocks = blocks[inv]
    src = _send(mesh, blocks)
    dst = _host(mesh, x, src.numel(), "recv")
    tdist.all_to_all_single(dst, src, group=pg)
    out = _back(dst, x, (n, -1))
    if not ident:                 # back to logical order
        out = out[pos]
    return out.view(x.shape)


def _a2a_v(x: torch.Tensor, mesh, axes, send, recv) -> torch.Tensor:
    """:func:`all_to_all_v`'s exchange (no autograd)."""
    if mesh.group(axes) is None:
        return x
    row = math.prod(x.shape[1:]) * x.element_size()
    own = mesh.axis_index(axes)
    _count("all-to-all", row * sum(c for k, c in enumerate(send)
                                   if k != own))
    if _stand_in(mesh):
        return torch.empty((sum(recv),) + tuple(x.shape[1:]),
                           dtype=x.dtype, device="meta")
    pos, inv, ident = _positions(mesh, axes)
    x = x.contiguous()
    if not ident:                 # logical blocks in group-rank order
        blocks = x.split(list(send))
        x = torch.cat([blocks[k] for k in inv])
    src = _send(mesh, x)
    dst = _host(mesh, x, sum(recv) * row, "recv_v")
    tdist.all_to_all_single(dst, src, [recv[k] * row for k in inv],
                            [send[k] * row for k in inv],
                            group=mesh.group(axes))
    out = _back(dst, x, (sum(recv),) + tuple(x.shape[1:]))
    if not ident:                 # back to logical order
        parts = out.split([recv[k] for k in inv])
        out = torch.cat([parts[pos[k]] for k in range(len(pos))])
    return out


def gather_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every process's ``x`` over ``axes``, stacked on a new dim 0 in
    logical order (no autograd)."""
    return _gather(x, mesh, axes, True)


def _gather(x: torch.Tensor, mesh, axes, counted: bool) -> torch.Tensor:
    """:func:`gather_rows`, tallied unless it is a part of another
    primitive (``counted``)."""
    pg = mesh.group(axes)
    if pg is None:
        return x[None]
    n = mesh.axis_size(axes)
    if counted:
        _count("all-gather", (n - 1) * _nbytes(x))
    if _stand_in(mesh):
        return torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                           device="meta")
    pos, _, ident = _positions(mesh, axes)
    src = _send(mesh, x)
    dst = _host(mesh, x, n * src.numel(), "gather")
    _all_gather_single(dst, src, group=pg)
    out = _back(dst, x, (n,) + tuple(x.shape))
    return out if ident else out[pos]


def gather_to(x: torch.Tensor, mesh, axes, root: int):
    """Every process's ``x`` over ``axes`` to process ``root`` (a member
    of this process's group, which every member calls), in logical
    order: a list on ``root``, None on the others (no autograd).  One
    gather, so only ``root`` receives."""
    pg = mesh.group(axes)
    if pg is None:
        return [x]
    _count("gather", 0 if mesh.rank == root else _nbytes(x))
    if _stand_in(mesh):
        return ([torch.empty(x.shape, dtype=x.dtype, device="meta")
                 for _ in mesh.members(axes)] if mesh.rank == root
                else None)
    pos, _, _ = _positions(mesh, axes)
    x = x.contiguous()
    parts = ([torch.empty_like(x) for _ in pos] if mesh.rank == root
             else None)
    tdist.gather(x, parts, dst=root, group=pg)
    return None if parts is None else [parts[q] for q in pos]


#: the most bytes of one tensor gathered at a time by :func:`all_reduce_sum`
SUM_CHUNK_BYTES = 64 << 20


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of every process's ``x``, added in logical
    order (no autograd): the same bits on every process.  A large tensor
    goes in chunks of :data:`SUM_CHUNK_BYTES`."""
    if mesh.group(axes) is None:
        return x
    _count_sum(mesh, axes, x)
    if _stand_in(mesh):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    flat = x.contiguous().view(-1)
    step = max(1, SUM_CHUNK_BYTES // x.element_size())
    out = torch.empty_like(flat)
    for i in range(0, flat.numel(), step):
        parts = _gather(flat[i:i + step], mesh, axes, False)
        acc = out[i:i + step]
        acc.copy_(parts[0])
        for p in parts[1:]:
            acc += p
    return out.view(x.shape)


def reduce_scatter_sum(x: torch.Tensor, mesh, axes,
                       dim: int = 0) -> torch.Tensor:
    """This process's block (of index :meth:`~repro_torch.launch.mesh.
    ProcessMesh.axis_index` over ``axes``) of the sum over ``axes`` of
    every process's ``x``, cut into equal blocks on ``dim`` (no
    autograd).  An all-to-all sends each block to its owner, which adds
    the parts in logical order; a half-precision part is added in fp32
    and the sum rounded once."""
    if mesh.group(axes) is None:
        return x
    n = mesh.axis_size(axes)
    moved = x.movedim(dim, 0)
    if moved.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    _count("reduce-scatter", (n - 1) * _nbytes(x) // n)
    if _stand_in(mesh):
        shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
        return torch.empty(shape, dtype=x.dtype,
                           device="meta").movedim(0, dim)
    parts = _a2a(moved.contiguous(), mesh, axes, False).view(
        n, moved.shape[0] // n, *moved.shape[1:])
    acc = parts[0].float() if x.dtype in _HALF else parts[0].clone()
    for part in parts[1:]:
        acc += part
    return acc.to(x.dtype).movedim(0, dim)


def _gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every process's ``x`` over ``axes`` concatenated on ``dim`` in
    logical order (no autograd)."""
    if mesh.group(axes) is None:
        return x
    moved = x.movedim(dim, 0).contiguous()
    parts = gather_rows(moved, mesh, axes)
    return parts.reshape((-1,) + tuple(moved.shape[1:])).movedim(0, dim)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_sum(g, ctx.mesh, ctx.axes, ctx.dim), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter_sum(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _a2a(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.axes), None, None


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, send, recv):
        ctx.mesh, ctx.axes, ctx.send, ctx.recv = mesh, axes, send, recv
        return _a2a_v(x, mesh, axes, send, recv)

    @staticmethod
    def backward(ctx, g):
        return (_a2a_v(g, ctx.mesh, ctx.axes, ctx.recv, ctx.send), None,
                None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, x.shape[0]
        parts = gather_rows(x, mesh, axes)
        return parts.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axes)
        return g[i * ctx.n:(i + 1) * ctx.n], None, None


class _OwnSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        n = mesh.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"{n} ways")
        ctx.mesh, ctx.axes = mesh, axes
        m = x.shape[0] // n
        i = mesh.axis_index(axes)
        return x[i * m:(i + 1) * m].clone()

    @staticmethod
    def backward(ctx, g):
        parts = gather_rows(g.contiguous(), ctx.mesh, ctx.axes)
        return parts.reshape((-1,) + tuple(g.shape[1:])), None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, grad_axes):
        ctx.mesh, ctx.share = mesh, mesh.axis_size(grad_axes)
        axes = mesh.axis_names
        return all_reduce_sum(x.contiguous(), mesh, axes) / mesh.size

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = all_reduce_sum(g.contiguous(), mesh, mesh.axis_names) / mesh.size
        return g / ctx.share, None, None


def all_to_all(x, mesh, axes):
    """Block ``k`` of ``x`` (tiled on dim 0) to the process of index
    ``k`` over ``axes``; block ``k`` of the result came from it.  Its
    backward is the same exchange."""
    return _AllToAll.apply(x, mesh, tuple(axes))


def all_to_all_v(x, mesh, axes, send, recv):
    """Rows of ``x`` (dim 0, grouped by destination in logical order) to
    their owners over ``axes``: ``send[k]`` rows to the process of index
    ``k``; the result holds ``recv[k]`` rows from the process of index
    ``k``, in logical order (an exchange of blocks of unequal sizes, some
    of them empty).  Backward: the inverse exchange, each cotangent row
    back to the process that sent it."""
    return _AllToAllV.apply(x, mesh, tuple(axes), tuple(send), tuple(recv))


def all_gather(x, mesh, axes):
    """Every process's ``x`` over ``axes``, concatenated on dim 0 in
    logical order.  Backward: this process's own rows of the cotangent,
    once (the processes holding the result hold copies of one loss)."""
    return _AllGather.apply(x, mesh, tuple(axes))


def own_slice(x, mesh, axes):
    """This process's block of ``x`` (tiled on dim 0) over ``axes``, every
    process holding the same ``x``.  Backward: the blocks' cotangents
    gathered, so every process gets the whole of ``x``'s."""
    return _OwnSlice.apply(x, mesh, tuple(axes))


def sum_grad(x, mesh, axes):
    """``x`` itself; its cotangent is summed over ``axes`` (a replicated
    tensor used on one block of work per process of ``axes``)."""
    return _SumGrad.apply(x, mesh, tuple(axes))


def pmean(x, mesh, *, grad_axes=()):
    """The mean of ``x`` over every mesh axis.  Backward: the mean of the
    cotangents, divided by the size of ``grad_axes``, the axes whose
    processes later sum their parts of the same block's gradient
    (:func:`sum_grad`): with the batch average of the train step, the
    global loss's gradient, each process's term once."""
    return _PMean.apply(x, mesh, tuple(grad_axes))


def gather_blocks(x, mesh, axes, dim: int = 0):
    """The whole of a tensor cut into blocks on ``dim`` over ``axes``
    (``x`` this process's block): every process's block, concatenated in
    logical order.  Backward: :func:`reduce_scatter_sum`, each block's
    owner gets the sum of every process's cotangent of it (not the
    token-slice contract of :func:`all_gather`)."""
    return _GatherBlocks.apply(x, mesh, tuple(axes), dim)


def reduce_scatter(x, mesh, axes, dim: int = 0):
    """:func:`reduce_scatter_sum` with a gradient: the cotangents of the
    blocks gathered, so every process gets the whole of ``x``'s."""
    return _ReduceScatter.apply(x, mesh, tuple(axes), dim)


def psum(x, mesh, axes):
    """The sum over ``axes`` of every process's ``x`` (added in logical
    order, the same bits on every process).  Backward: the cotangent as
    it is, to every process's part (a row-parallel product's partial sums,
    whose sum every process of ``axes`` then uses alike)."""
    return _PSum.apply(x, mesh, tuple(axes))


@torch.no_grad()
def pmax(x, mesh, axes):
    """The elementwise max over ``axes`` of every process's ``x``, no
    gradient (the shift of a log-sum-exp, whose value it does not
    change)."""
    if mesh.group(tuple(axes)) is None:
        return x.detach()
    _count_sum(mesh, tuple(axes), x)
    if _stand_in(mesh):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return _gather(x.detach().contiguous(), mesh, tuple(axes),
                   False).amax(0)
