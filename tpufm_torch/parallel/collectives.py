"""The collectives of the mesh engines, in one process or across processes.

Counterparts of the ``jax.lax`` collectives that tpufm's ``shard_map``
programs use (tpufm/parallel/search.py: ``all_gather`` and ``psum`` in
``_sharded_lf_step``, ``ppermute`` in the ring, ``all_to_all`` and ``pmax``
in the a2a routing; tpufm/index/sa_sharded.py and builder_sharded.py:
``ppermute`` of pairs and shifts, ``all_gather`` and ``psum`` in the
sharded sort and table build; ``axis_index`` is the shard's place in the
mesh), and ``relayout``, the move of a row-sharded array between two row
splits that a jit with other ``out_shardings`` makes there. Each op takes a
list with one tensor for each shard this process owns, ``xs[i]`` on
``mesh.devices[i]`` (global shard ``mesh.local_shards[i]``; every shard in
one process), and returns a list of new tensors, one per owned shard on
that shard's device: a result never aliases an input, so that a shard's
later in-place update cannot reach another shard's copy. ``mesh`` None is
one process owning every shard of the list.

Within a process a transfer is ``Tensor.to(dst, non_blocking=True)``:
between two cards a peer copy, which PyTorch orders after the work that
made its source on the source's current stream and before later work on
the destination's; between shards on one card a copy in that card's memory
(see mesh.py: no NVLink traffic, no transport time). Across processes
(a mesh of ``initialize_distributed``) the ops go through
``torch.distributed`` on ``mesh.transport``: ``all_gather`` for
``all_gather`` and ``gather``, ``all_reduce`` (SUM, MAX) of each process's
partial for ``psum`` and ``pmax``, ``all_to_all_single`` for
``all_to_all``, and tagged ``isend``/``irecv`` pairs for ``ppermute`` and
``relayout``. Under gloo the transport is the CPU: CUDA shards are copied
to the host and back. ``gather`` is the engines' exit merge: every process
gets the whole result, on its first shard's device (tpufm's replicated
out-sharding; in one process that is shard 0's copy).

While ``recording()`` is open, every op on a mesh of more than one shard
appends a ``Collective`` to its log: kind as XLA names it, the per-shard
result shape, dtype, the bytes that cross between distinct shards in the
op (summed over the mesh, the same on every process and in one process),
and ``cross``, the part of those bytes whose two shards lie in different
processes (0 in one process). tpufm_torch.parallel.traffic checks the log
against the traffic model. On one shard an op logs nothing, as XLA elides
a one-device collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Collective:
    """One logged op: ``kind`` ("all-gather", "all-reduce",
    "collective-permute", "all-to-all", "gather"), ``shape`` of each shard's
    result, ``dtype``, ``bytes`` moved between distinct shards and, of
    those, the ``cross`` bytes between shards of different processes."""

    kind: str
    shape: tuple
    dtype: torch.dtype
    bytes: int
    cross: int = 0


_log: list | None = None


@contextlib.contextmanager
def recording():
    """Log every collective in the block; yields the list it fills."""
    global _log
    prev, _log = _log, []
    try:
        yield _log
    finally:
        _log = prev


def _record(kind: str, out: torch.Tensor, nbytes: int, D: int, cross: int = 0) -> None:
    # a mesh of one shard has no collectives (XLA elides them there too)
    if _log is not None and D > 1:
        _log.append(Collective(kind, tuple(out.shape), out.dtype, int(nbytes), int(cross)))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _across(mesh) -> bool:
    """Whether ``mesh`` spans more than one process."""
    return mesh is not None and mesh.process_count > 1


def _size(xs: list, mesh) -> tuple:
    """(D, L): the mesh's shards and this process's."""
    if mesh is None:
        return len(xs), len(xs)
    if len(xs) != mesh.local_count:
        raise ValueError(f"{len(xs)} tensors for the {mesh.local_count} shards this process owns")
    return mesh.size, mesh.local_count


def _exchange(stack: torch.Tensor, mesh) -> torch.Tensor:
    """Every process's ``stack`` [L, ...] (the same shape on each),
    concatenated in process order: [D, ...] on the transport device."""
    import torch.distributed as dist

    parts = [torch.empty_like(stack) for _ in range(mesh.process_count)]
    dist.all_gather(parts, stack.contiguous())
    return torch.cat(parts)


def _wire(xs: list, mesh) -> torch.Tensor:
    """The local tensors stacked on the transport device."""
    return torch.stack([x.to(mesh.transport) for x in xs])


def _land(t: torch.Tensor, xs: list) -> list:
    """A copy of ``t`` for each shard of ``xs``, on its device: one
    transfer a device, a copy on the device for each further shard there."""
    first, out = {}, []
    for x in xs:
        if x.device in first:
            out.append(first[x.device].clone())
        else:
            first[x.device] = t.to(x.device, copy=True)
            out.append(first[x.device])
    return out


def all_gather(xs: list, mesh=None) -> list:
    """``jax.lax.all_gather``: every shard gets the stack of all shards'
    tensors, [D, *shape]."""
    D, L = _size(xs, mesh)
    if _across(mesh):
        out = _land(_exchange(_wire(xs, mesh), mesh), xs)
    else:
        out = [torch.stack([x.to(x0.device, non_blocking=True) for x in xs]) for x0 in xs]
    n = _nbytes(xs[0])
    _record("all-gather", out[0], D * (D - 1) * n, D, D * (D - L) * n)
    return out


def _reduce(xs: list, mesh, op: str) -> list:
    """The elementwise sum or maximum of every shard's tensor, on each."""
    import torch.distributed as dist

    x0 = xs[0]
    stack = _wire(xs, mesh)
    if op == "sum":
        # integers sum in int64 and wrap back to their own width afterwards
        # (uint32 words as int32 bits): the one-process sum, bit for bit
        wide = torch.int64 if not x0.dtype.is_floating_point else x0.dtype
        part = stack.sum(0, dtype=wide)
        dist.all_reduce(part, dist.ReduceOp.SUM)
    else:
        part = stack.amax(0) if x0.dtype != torch.bool else stack.to(torch.uint8).amax(0)
        dist.all_reduce(part, dist.ReduceOp.MAX)
    return _land(part.to(x0.dtype), xs)


def psum(xs: list, mesh=None) -> list:
    """``jax.lax.psum``: every shard gets the elementwise sum (in the
    tensors' own dtype, wrapping as uint32 arithmetic does)."""
    D, L = _size(xs, mesh)
    if _across(mesh):
        out = _reduce(xs, mesh, "sum")
    else:
        out = [torch.stack([x.to(x0.device, non_blocking=True) for x in xs]).sum(0, dtype=x0.dtype) for x0 in xs]
    n = _nbytes(xs[0])
    _record("all-reduce", out[0], D * (D - 1) * n, D, D * (D - L) * n)
    return out


def pmax(xs: list, mesh=None) -> list:
    """``jax.lax.pmax``: every shard gets the elementwise maximum."""
    D, L = _size(xs, mesh)
    if _across(mesh):
        out = _reduce(xs, mesh, "max")
    else:
        out = [torch.stack([x.to(x0.device, non_blocking=True) for x in xs]).amax(0) for x0 in xs]
    n = _nbytes(xs[0])
    _record("all-reduce", out[0], D * (D - 1) * n, D, D * (D - L) * n)
    return out


def _point_to_point(mesh, sends: list, recvs: list) -> None:
    """Run ``sends`` [(tensor, process, tag)] and ``recvs`` [(buffer,
    process, tag)] at once. Every process lists its moves in one global
    order, so the pairs of two processes meet in the same order (NCCL
    matches by order, gloo by tag)."""
    import torch.distributed as dist

    ops = [dist.P2POp(dist.isend, t, p, tag=tag) for t, p, tag in sends]
    ops += [dist.P2POp(dist.irecv, b, p, tag=tag) for b, p, tag in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def ppermute(xs: list, perm=1, mesh=None) -> list:
    """``jax.lax.ppermute``. ``perm`` is a list of (src, dst) pairs of
    global shards, no src and no dst twice: shard dst gets a copy of shard
    src's tensor, and a shard that no pair reaches gets zeros of its own
    tensor's shape and dtype (every shard's tensor has one shape, as in
    SPMD). An int ``perm`` is the ring ``[(i, (i + perm) % D)]`` of the
    engines. The bytes logged are those of the pairs whose src and dst
    differ."""
    D, L = _size(xs, mesh)
    if isinstance(perm, int):
        perm = [(i, (i + perm) % D) for i in range(D)]
    src_of = {}
    for src, dst in perm:
        if not (0 <= src < D and 0 <= dst < D) or dst in src_of or src in src_of.values():
            raise ValueError(f"ppermute: {perm} is not a partial permutation of {D} shards")
        src_of[dst] = src
    nbytes = _nbytes(xs[0])
    moved = sum(nbytes for src, dst in perm if src != dst)
    if not _across(mesh):
        devs = [x.device for x in xs]
        out = [xs[src_of[s]].to(devs[s], non_blocking=True, copy=True) if s in src_of else torch.zeros_like(xs[s])
               for s in range(D)]
        _record("collective-permute", out[0], moved, D)
        return out
    me, first = mesh.process_index, mesh.local_shards[0]
    out = [torch.zeros_like(x) for x in xs]
    sends, recvs, landed = [], [], []
    for src, dst in sorted(perm):
        so, do = mesh.owner(src), mesh.owner(dst)
        if so == me and do == me:
            out[dst - first] = xs[src - first].to(xs[dst - first].device, non_blocking=True, copy=True)
        elif so == me:
            sends.append((xs[src - first].to(mesh.transport).contiguous(), do, dst))
        elif do == me:
            buf = torch.empty(xs[0].shape, dtype=xs[0].dtype, device=mesh.transport)
            recvs.append((buf, so, dst))
            landed.append((dst - first, buf))
    _point_to_point(mesh, sends, recvs)
    for i, buf in landed:
        out[i] = buf.to(xs[i].device, copy=True)
    cross = sum(nbytes for src, dst in perm if mesh.owner(src) != mesh.owner(dst))
    _record("collective-permute", out[0], moved, D, cross)
    return out


def all_to_all(xs: list, mesh=None) -> list:
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`` on
    [D, ...] tensors: shard s gets row s of every shard's tensor, in shard
    order (``out[s][j] = xs[j][s]``)."""
    D, L = _size(xs, mesh)
    if _across(mesh):
        import torch.distributed as dist

        P, rest = mesh.process_count, tuple(xs[0].shape[1:])
        # [L senders, D receivers, ...] -> [P receiving processes, L senders, L receivers, ...]
        send = _wire(xs, mesh).view(L, P, L, *rest).transpose(0, 1).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send)
        # got[p, j, i]: sender p*L + j's row for this process's i-th shard
        out = [got[:, :, i].reshape(D, *rest).to(x.device, copy=True) for i, x in enumerate(xs)]
    else:
        out = [torch.stack([x[s].to(xs[s].device, non_blocking=True) for x in xs]) for s in range(D)]
    n = _nbytes(xs[0])
    _record("all-to-all", out[0], (D - 1) * n, D, (D - L) * n)
    return out


def relayout(xs: list, total: int, rows: int, mesh=None) -> list:
    """Rows moved from one row sharding to another: ``xs[s]`` holds global
    rows s*r .. (s+1)*r - 1 (r = ``xs[0].shape[0]``, the same on every
    shard); shard t gets rows t*rows .. (t+1)*rows - 1 of the first
    ``total``, zeros past them (the reshard of an array between two
    ``PartitionSpec`` row splits of different lengths). Logged as one
    all-to-all with the bytes of the rows that change shard."""
    D, L = _size(xs, mesh)
    r = xs[0].shape[0]
    first = 0 if mesh is None else mesh.local_shards[0]
    owner = (lambda s: 0) if mesh is None else mesh.owner
    me = 0 if mesh is None else mesh.process_index
    # the plan: (destination t, source s, offset in s, rows) of every piece
    plan = []
    for t in range(D):
        g, end = t * rows, min((t + 1) * rows, total)
        while g < end:
            s, off = divmod(g, r)
            n = min(end - g, r - off)
            plan.append((t, s, off, n))
            g += n
    row_bytes = xs[0].element_size() * math.prod(xs[0].shape[1:])
    parts = {t: [] for t in range(first, first + L)}
    sends, recvs = [], []
    for t, s, off, n in plan:
        if owner(t) == me and owner(s) == me:
            parts[t].append(xs[s - first][off:off + n].to(xs[t - first].device, non_blocking=True))
        elif owner(s) == me:
            sends.append((xs[s - first][off:off + n].to(mesh.transport).contiguous(), owner(t), s * D + t))
        elif owner(t) == me:
            buf = torch.empty((n, *xs[0].shape[1:]), dtype=xs[0].dtype, device=mesh.transport)
            recvs.append((buf, owner(s), s * D + t))
            parts[t].append(buf)
    if sends or recvs:
        _point_to_point(mesh, sends, recvs)
    out = []
    for t, x in zip(range(first, first + L), xs):
        got = [p.to(x.device) for p in parts[t]]
        got.append(x.new_zeros((rows - sum(p.shape[0] for p in got), *x.shape[1:])))
        out.append(torch.cat(got))
    moved = sum(n for t, s, _, n in plan if s != t) * row_bytes
    cross = sum(n for t, s, _, n in plan if owner(s) != owner(t)) * row_bytes
    _record("all-to-all", out[0], moved, D, cross)
    return out


def gather(xs: list, mesh=None) -> torch.Tensor:
    """The exit merge: every shard's tensor concatenated along axis 0, in
    shard order (the shards' lengths may differ), on this process's first
    shard's device, every process getting the whole (tpufm replicates it on
    every chip; one copy a process is what its host reads). Logged with the
    bytes of every shard but shard 0 (the merge onto one shard)."""
    D, L = _size(xs, mesh)
    dev = xs[0].device
    if _across(mesh):
        rest = tuple(xs[0].shape[1:])
        sizes = _exchange(torch.tensor([[x.shape[0] for x in xs]], device=mesh.transport), mesh).view(-1).tolist()
        most = max(sizes)
        pad = torch.stack([torch.cat([x.to(mesh.transport), x.new_zeros((most - x.shape[0], *rest),
                                                                       device=mesh.transport)]) for x in xs])
        full = _exchange(pad, mesh)  # [D, most, ...]
        out = torch.cat([full[s][:sizes[s]] for s in range(D)]).to(dev, copy=True)
        row = xs[0].element_size() * math.prod(rest)
        moved = sum(sizes[1:]) * row
        cross = sum(sizes[s] for s in range(D) if mesh.owner(s) != 0) * row
        _record("gather", out, moved, D, cross)
        return out
    out = torch.cat([x.to(dev, non_blocking=True) for x in xs])
    _record("gather", out, sum(_nbytes(x) for x in xs[1:]), D)
    return out
