"""Explicit collectives over one mesh axis, and the autograd functions that
carry gradients across them.

JAX's sharded programs get their collectives from GSPMD; the port writes
each one. A ``Comm`` is one process group (the ranks that share every mesh
coordinate but one) with out-of-place ``all_reduce``, ``all_gather``,
``reduce_scatter``, ``broadcast``, ``send`` and ``recv``.
A group of one rank returns its input and calls nothing.

Gloo takes some collectives on CUDA tensors and not others; where ranks share
one card they must run over gloo (NCCL refuses two ranks on one device).
``probe_op`` tries an operation once on a CUDA tensor (gloo may end the process
on one it refuses, so each is probed in a world of its own); the operations it
took go into ``GLOO_CUDA_NATIVE``, and every other one is staged explicitly
through pinned host memory (copy out, collective, copy back), on that backend
only. ``COUNTS`` counts every
collective by name and ``STAGED`` those that were staged.

The autograd functions are Megatron's pairs: ``copy_to`` (identity forward,
all-reduce backward) where a replicated activation enters a region split over
the axis, ``reduce_from`` (all-reduce forward, identity backward) where the
region's partial sums leave it, ``gather_from`` / ``split_to`` (all-gather one
way, the rank's own slice the other), ``psum`` (all-reduce both ways: a
sum that each rank reads in its own per-element work) and ``fsdp_gather`` (all-gather forward,
reduce-scatter backward: a leaf sharded over ``data`` whose gathered copy
every data rank used on its own rows).
"""

from __future__ import annotations

import warnings
from collections import Counter

import torch

warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*is deprecated")

# the collectives gloo takes on CUDA tensors, as probed on this host (``probe_op``, each in
# a world of its own); every other one is staged through pinned host memory
GLOO_CUDA_NATIVE: set = set()
COUNTS: Counter = Counter()   # collective name -> calls
STAGED: Counter = Counter()   # collective name -> calls staged through host memory
# dtypes gloo does not carry -> the type they cross as
_NARROW = {torch.bool: torch.int32, torch.uint8: torch.int32, torch.int8: torch.int32,
           torch.int16: torch.int32, torch.bfloat16: torch.float32,
           torch.float16: torch.float32}
_HALF = (torch.bfloat16, torch.float16)
OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast",
       "send_recv")


def reset_counts() -> None:
    COUNTS.clear()
    STAGED.clear()


class Comm:
    """One process group: ``ranks`` (global ranks in axis order), this
    process's ``index`` among them. ``native``: the operations the backend
    takes on CUDA tensors (every one for NCCL; probed for gloo)."""

    def __init__(self, group, ranks: list[int], index: int, backend: str):
        self.group, self.ranks, self.index = group, list(ranks), index
        self.size = len(ranks)
        self.backend = backend
        self.native = set(OPS) if backend != "gloo" else set(GLOO_CUDA_NATIVE)

    # -- staging ----------------------------------------------------------------

    def _stage(self, name: str, t: torch.Tensor) -> bool:
        """True when ``name`` on this tensor must go through host memory."""
        return t.is_cuda and name not in self.native

    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=torch.cuda.is_available())
        h.copy_(t)
        return h

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """Gloo carries 32- and 64-bit types only: narrower ones cross widened
        (exactly) and are narrowed back by the caller."""
        if self.backend == "gloo" and t.dtype in _NARROW:
            return t.to(_NARROW[t.dtype])
        return t

    def _pack(self, x: torch.Tensor):
        """A contiguous tensor as gloo moves it, and the function that gives it
        back: where a row (dim 0) holds a multiple of 4 bytes of a narrow
        type, its bytes cross as int32 words (data movement only: gathers,
        broadcasts, sends); otherwise the type is widened (``_wire``)."""
        if self.backend != "gloo" or x.dtype not in _NARROW:
            return x, lambda o: o
        if x.dim() and x[:1].numel() * x.element_size() % 4 == 0 and x.dtype != torch.bool:
            shape, dt = x.shape, x.dtype
            return (x.reshape(shape[0], -1).view(torch.int32),
                    lambda o: o.view(dt).reshape(o.shape[0], *shape[1:]))
        return self._wire(x), lambda o: o.to(x.dtype)

    def _gather_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of a bf16 / f16 tensor as an all-gather of its
        bytes and a sum in f32 in rank order, rounded once (gloo sums no
        16-bit float; the same order on every rank)."""
        g = self.all_gather(x.reshape(1, -1), 0, count=False).float()
        return g.sum(dim=0).to(x.dtype).reshape(x.shape)

    # -- collectives --------------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.size == 1:
            return t
        import torch.distributed as dist

        # a 16-bit sum is taken in f32 and rounded once, as one rank's product rounds its
        # sum once (NCCL would round each partial sum of its ring; gloo sums no 16-bit type)
        if op == "sum" and t.dtype in _HALF and self.backend != "gloo":
            return self.all_reduce(t.float()).to(t.dtype)
        COUNTS["all_reduce"] += 1
        if op == "sum" and t.dtype in _HALF:
            return self._gather_sum(t)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        staged = self._stage("all_reduce", t)
        if staged:
            STAGED["all_reduce"] += 1
            out = self._wire(self._host(t.contiguous()))
        else:
            out = self._wire(t.contiguous()).clone()
        dist.all_reduce(out, op=rop, group=self.group)
        return out.to(device=t.device, dtype=t.dtype)

    def all_gather(self, t: torch.Tensor, dim: int = 0, count: bool = True) -> torch.Tensor:
        """The ranks' tensors concatenated along ``dim`` in axis order."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        if count:
            COUNTS["all_gather_into_tensor"] += 1
        x = t.movedim(dim, 0).contiguous()
        staged = self._stage("all_gather_into_tensor", x)
        if staged:
            STAGED["all_gather_into_tensor"] += 1
            x = self._host(x)
        w, unpack = self._pack(x)
        out = w.new_empty((self.size * w.shape[0], *w.shape[1:]))
        dist.all_gather_into_tensor(out, w, group=self.group)
        out = unpack(out).to(device=t.device)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Sum over the ranks, then this rank's chunk of ``dim``."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        if t.dtype in _HALF and self.backend != "gloo":
            return self.reduce_scatter(t.float(), dim).to(t.dtype)
        COUNTS["reduce_scatter_tensor"] += 1
        x = t.movedim(dim, 0).contiguous()
        n = x.shape[0] // self.size
        if x.dtype in _HALF:
            out = self._gather_sum(x)[self.index * n:(self.index + 1) * n]
        elif self._stage("reduce_scatter_tensor", x) or self.backend == "gloo":
            # gloo has no reduce_scatter_tensor: an all-reduce and the own chunk
            if x.is_cuda:
                STAGED["reduce_scatter_tensor"] += 1
                x = self._wire(self._host(x))
            else:
                x = self._wire(x).clone()
            dist.all_reduce(x, group=self.group)
            out = x[self.index * n:(self.index + 1) * n].to(device=t.device, dtype=t.dtype)
        else:
            out = x.new_empty((n, *x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, group=self.group)
        return out.movedim(0, dim).contiguous()

    def broadcast(self, t: torch.Tensor, src_index: int) -> torch.Tensor:
        """``t`` of the rank at ``src_index`` on every rank (same shape everywhere)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        COUNTS["broadcast"] += 1
        src = self.ranks[src_index]
        if self._stage("broadcast", t):
            STAGED["broadcast"] += 1
            out = self._host(t.contiguous())
        else:
            out = t.contiguous().clone()
        out, unpack = self._pack(out)
        dist.broadcast(out, src=src, group=self.group)
        return unpack(out).to(device=t.device)

    def send(self, t: torch.Tensor, to_index: int) -> None:
        import torch.distributed as dist

        COUNTS["send_recv"] += 1
        x = t.contiguous()
        if self._stage("send_recv", x):
            STAGED["send_recv"] += 1
            x = self._host(x)
        dist.send(self._pack(x)[0], self.ranks[to_index], group=self.group)

    def recv(self, like: torch.Tensor, from_index: int) -> torch.Tensor:
        import torch.distributed as dist

        staged = self._stage("send_recv", like)
        out, unpack = self._pack(torch.empty(like.shape, dtype=like.dtype,
                                             device="cpu" if staged else like.device))
        dist.recv(out, self.ranks[from_index], group=self.group)
        return unpack(out).to(device=like.device)

def probe_op(comm: Comm, name: str, device) -> bool:
    """Run the collective ``name`` once on a CUDA tensor of ``comm``'s backend.
    Every rank of the group calls it together; where the backend refuses the
    operation it raises, or, as gloo does with a CUDA pointer it writes to a
    socket, ends the process: probe each operation in a world of its own."""
    import torch.distributed as dist

    x = torch.full((4,), float(comm.index + 1), device=device)
    nxt = comm.ranks[(comm.index + 1) % comm.size]
    prv = comm.ranks[(comm.index - 1) % comm.size]
    if name == "all_reduce":
        dist.all_reduce(x, group=comm.group)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(x.new_empty(4 * comm.size), x, group=comm.group)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(x.new_empty(4), x.repeat(comm.size), group=comm.group)
    elif name == "broadcast":
        dist.broadcast(x, src=comm.ranks[0], group=comm.group)
    elif name == "send_recv":
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x.clone(), nxt, comm.group),
                                        dist.P2POp(dist.irecv, x, prv, comm.group)]):
            r.wait()
    else:
        raise ValueError(f"unknown collective {name}")
    torch.cuda.synchronize(device)
    return True


# -- autograd across the collectives ------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.comm.index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        n = x.shape[dim] // comm.size
        return x.narrow(dim, comm.index * n, n)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g.contiguous(), ctx.dim), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, summed):
        ctx.comm, ctx.dim, ctx.summed = comm, dim, summed
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return ctx.comm.reduce_scatter(g, ctx.dim), None, None, None
        n = g.shape[ctx.dim] // ctx.comm.size
        return g.narrow(ctx.dim, ctx.comm.index * n, n).contiguous(), None, None, None


def _grad(x) -> bool:
    return torch.is_grad_enabled() and isinstance(x, torch.Tensor) and x.requires_grad


def copy_to(x, comm: Comm | None):
    """Identity forward; the gradient all-reduced over ``comm``."""
    if comm is None or comm.size == 1 or not _grad(x):
        return x
    return _CopyTo.apply(x, comm)


def reduce_from(x, comm: Comm | None):
    """All-reduce (sum) forward; the gradient passed through."""
    if comm is None or comm.size == 1:
        return x
    return _ReduceFrom.apply(x, comm) if _grad(x) else comm.all_reduce(x)


def psum(x, comm: Comm | None):
    """All-reduce (sum) forward and backward: a sum each rank then reads in
    its own per-element work, so each rank's cotangent of it is partial."""
    if comm is None or comm.size == 1:
        return x
    return _Psum.apply(x, comm) if _grad(x) else comm.all_reduce(x)


def gather_from(x, comm: Comm | None, dim: int):
    """All-gather along ``dim``; the gradient's own slice."""
    if comm is None or comm.size == 1:
        return x
    return _GatherFrom.apply(x, comm, dim) if _grad(x) else comm.all_gather(x, dim)


def split_to(x, comm: Comm | None, dim: int):
    """This rank's chunk of ``dim``; the gradient all-gathered."""
    if comm is None or comm.size == 1:
        return x
    if _grad(x):
        return _SplitTo.apply(x, comm, dim)
    n = x.shape[dim] // comm.size
    return x.narrow(dim, comm.index * n, n)


def fsdp_gather(x, comm: Comm | None, dim: int, summed: bool = True):
    """All-gather along ``dim``; the gradient reduce-scattered (summed over the
    ranks that each used the gathered copy on their own rows), or with
    ``summed=False`` (every rank ran the same rows, so each holds the whole
    gradient already) this rank's chunk of it."""
    if comm is None or comm.size == 1:
        return x
    return (_FsdpGather.apply(x, comm, dim, summed) if _grad(x)
            else comm.all_gather(x, dim))
