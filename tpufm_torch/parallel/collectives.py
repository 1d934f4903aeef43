"""The collectives of the mesh engines, one process driving every shard.

Counterparts of the ``jax.lax`` collectives that tpufm's ``shard_map``
programs use (tpufm/parallel/search.py: ``all_gather`` and ``psum`` in
``_sharded_lf_step``, ``ppermute`` in the ring, ``all_to_all`` and ``pmax``
in the a2a routing; ``axis_index`` is the shard's place in the list). Each
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


def ppermute(xs: list, shift: int = 1) -> list:
    """``jax.lax.ppermute`` with the ring permutation ``[(i, (i + shift) %
    D)]``: shard (i + shift) % D gets shard i's tensor, as a copy."""
    D = len(xs)
    devs = [x.device for x in xs]
    out = [xs[(s - shift) % D].to(devs[s], non_blocking=True, copy=True) for s in range(D)]
    _record("collective-permute", out[0], D * _nbytes(xs[0]), D)
    return out


def all_to_all(xs: list) -> list:
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`` on
    [D, ...] tensors: shard s gets row s of every shard's tensor, in shard
    order (``out[s][j] = xs[j][s]``)."""
    D = len(xs)
    out = [torch.stack([x[s].to(xs[s].device, non_blocking=True) for x in xs]) for s in range(D)]
    _record("all-to-all", out[0], (D - 1) * _nbytes(xs[0]), D)
    return out


def gather(xs: list) -> torch.Tensor:
    """The exit merge: every shard's tensor concatenated along axis 0, in
    shard order, on shard 0's device (tpufm replicates it on every chip;
    one copy is what the host reads)."""
    dev = xs[0].device
    out = torch.cat([x.to(dev, non_blocking=True) for x in xs])
    _record("gather", out, sum(_nbytes(x) for x in xs[1:]), len(xs))
    return out
