"""The collectives of the mesh engines, one process driving every shard.

Counterparts of the ``jax.lax`` collectives that tpufm's ``shard_map``
programs use (tpufm/parallel/search.py: ``all_gather`` and ``psum`` in
``_sharded_lf_step``, ``ppermute`` in the ring, ``all_to_all`` and ``pmax``
in the a2a routing; tpufm/index/sa_sharded.py and builder_sharded.py:
``ppermute`` of pairs and shifts, ``all_gather`` and ``psum`` in the
sharded sort and table build; ``axis_index`` is the shard's place in the
list), and ``relayout``, the move of a row-sharded array between two row
splits that a jit with other ``out_shardings`` makes there. Each
op takes a list with one tensor per shard, ``xs[s]`` on ``mesh.devices[s]``,
and returns a list of new tensors, one per shard on that shard's device: a
result never aliases an input, so that a shard's later in-place update
cannot reach another shard's copy. A transfer is ``Tensor.to(dst,
non_blocking=True)``: between two cards a peer copy, which PyTorch orders
after the work that made its source on the source's current stream and
before later work on the destination's; between shards on one card a copy
in that card's memory (see mesh.py: no NVLink traffic, no transport time).
``gather`` is the engines' exit merge onto shard 0.

While ``recording()`` is open, every op on a mesh of more than one shard
appends a ``Collective`` to its log (kind as XLA names it, the per-shard
result shape, dtype, and the bytes that cross between shards in the op),
which tpufm_torch.parallel.traffic checks against the traffic model; on one
shard an op logs nothing, as XLA elides a one-device collective. This
interface, a list of per-shard tensors, is where a torch.distributed backend
will plug in for multi-host meshes (ROADMAP Queue 1 item 6d).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Collective:
    """One logged op: ``kind`` ("all-gather", "all-reduce",
    "collective-permute", "all-to-all", "gather"), ``shape`` of each shard's
    result, ``dtype`` and ``bytes`` moved between distinct shards."""

    kind: str
    shape: tuple
    dtype: torch.dtype
    bytes: int


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


def _record(kind: str, out: torch.Tensor, nbytes: int, D: int) -> None:
    # a mesh of one shard has no collectives (XLA elides them there too)
    if _log is not None and D > 1:
        _log.append(Collective(kind, tuple(out.shape), out.dtype, int(nbytes)))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather(xs: list) -> list:
    """``jax.lax.all_gather``: every shard gets the stack of all shards'
    tensors, [D, *shape]."""
    D = len(xs)
    out = [torch.stack([x.to(x0.device, non_blocking=True) for x in xs]) for x0 in xs]
    _record("all-gather", out[0], D * (D - 1) * _nbytes(xs[0]), D)
    return out


def psum(xs: list) -> list:
    """``jax.lax.psum``: every shard gets the elementwise sum (in the
    tensors' own dtype, wrapping as uint32 arithmetic does)."""
    D = len(xs)
    out = [torch.stack([x.to(x0.device, non_blocking=True) for x in xs]).sum(0, dtype=x0.dtype) for x0 in xs]
    _record("all-reduce", out[0], D * (D - 1) * _nbytes(xs[0]), D)
    return out


def pmax(xs: list) -> list:
    """``jax.lax.pmax``: every shard gets the elementwise maximum."""
    D = len(xs)
    out = [torch.stack([x.to(x0.device, non_blocking=True) for x in xs]).amax(0) for x0 in xs]
    _record("all-reduce", out[0], D * (D - 1) * _nbytes(xs[0]), D)
    return out


def ppermute(xs: list, perm=1) -> list:
    """``jax.lax.ppermute``. ``perm`` is a list of (src, dst) pairs, no src
    and no dst twice: shard dst gets a copy of shard src's tensor, and a
    shard that no pair reaches gets zeros of its own tensor's shape and
    dtype. An int ``perm`` is the ring ``[(i, (i + perm) % D)]`` of the
    engines. The bytes logged are those of the pairs whose src and dst
    differ."""
    D = len(xs)
    if isinstance(perm, int):
        perm = [(i, (i + perm) % D) for i in range(D)]
    src_of = {}
    for src, dst in perm:
        if not (0 <= src < D and 0 <= dst < D) or dst in src_of or src in src_of.values():
            raise ValueError(f"ppermute: {perm} is not a partial permutation of {D} shards")
        src_of[dst] = src
    devs = [x.device for x in xs]
    out = [xs[src_of[s]].to(devs[s], non_blocking=True, copy=True) if s in src_of else torch.zeros_like(xs[s])
           for s in range(D)]
    _record("collective-permute", out[0], sum(_nbytes(xs[src]) for src, dst in perm if src != dst), D)
    return out


def all_to_all(xs: list) -> list:
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`` on
    [D, ...] tensors: shard s gets row s of every shard's tensor, in shard
    order (``out[s][j] = xs[j][s]``)."""
    D = len(xs)
    out = [torch.stack([x[s].to(xs[s].device, non_blocking=True) for x in xs]) for s in range(D)]
    _record("all-to-all", out[0], (D - 1) * _nbytes(xs[0]), D)
    return out


def relayout(xs: list, total: int, rows: int) -> list:
    """Rows moved from one row sharding to another: ``xs[s]`` holds global
    rows s*r .. (s+1)*r - 1 (r = ``xs[0].shape[0]``, the same on every
    shard); shard t gets rows t*rows .. (t+1)*rows - 1 of the first
    ``total``, zeros past them (the reshard of an array between two
    ``PartitionSpec`` row splits of different lengths). Logged as one
    all-to-all with the bytes of the rows that change shard."""
    D, r = len(xs), xs[0].shape[0]
    out, moved = [], 0
    for t, x in enumerate(xs):
        parts, g, end = [], t * rows, min((t + 1) * rows, total)
        while g < end:
            s, off = divmod(g, r)
            part = xs[s][off:off + min(end - g, r - off)]
            parts.append(part.to(x.device, non_blocking=True))
            moved += _nbytes(part) if s != t else 0
            g += part.shape[0]
        parts.append(x.new_zeros((rows - max(end - t * rows, 0), *x.shape[1:])))
        out.append(torch.cat(parts))
    _record("all-to-all", out[0], moved, D)
    return out


def gather(xs: list) -> torch.Tensor:
    """The exit merge: every shard's tensor concatenated along axis 0, in
    shard order, on shard 0's device (tpufm replicates it on every chip;
    one copy is what the host reads)."""
    dev = xs[0].device
    out = torch.cat([x.to(dev, non_blocking=True) for x in xs])
    _record("gather", out, sum(_nbytes(x) for x in xs[1:]), len(xs))
    return out
