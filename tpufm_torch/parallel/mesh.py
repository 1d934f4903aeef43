"""The device mesh of the multi-device engines, in one process or across many.

Counterpart of tpufm/parallel/mesh.py: ``make_mesh`` (:19) builds the 1-D
mesh that ``jax.sharding.Mesh(np.asarray(devs), ("data",))`` is there, and
``initialize_distributed`` (:30) the multi-host bring-up that
``jax.distributed.initialize`` is. A ``Mesh`` is an ordered list of torch
devices, one a shard, with an axis name. The query batch is split along it
(``DataParallelEngine``), and the entry table too where it does not fit one
device (``ShardedIndexEngine``).

One process drives every shard of a mesh built directly or by
``make_mesh`` before ``initialize_distributed``, as tpufm's jit drives every
local chip. After ``initialize_distributed``, ``make_mesh()`` spans every
process of the group, as tpufm's does after ``jax.distributed.initialize``:
each of the P processes owns L consecutive shards of the D = P * L
(process p shards p*L .. (p+1)*L - 1, every process the same L, as JAX
requires), ``devices`` are the devices of this process's shards, and the
engines run SPMD: every process runs the same program on its own shards,
and the collectives (tpufm_torch.parallel.collectives) cross processes
through ``torch.distributed``.

A shard is a device, not necessarily a card of its own: a ``Mesh`` built
directly may repeat one card (``Mesh([torch.device("cuda", 0)] * 4)``), and
so may a process's shards (``local_device_ids=[0, 0]``), so that one card
runs several shards and the routings leave their one-device branches. The
copies between such colocated shards are copies within one card's memory,
not NVLink traffic: they measure no transport. On the CPU,
``make_mesh(n, device="cpu")`` gives n CPU shards, the counterpart of
tpufm's virtual CPU devices (``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import datetime
import ipaddress
import os

import torch

from tpufm_torch.device import resolve_device

#: seconds a collective waits for a peer before the run fails
#: (``initialize_distributed``'s default ``timeout``)
DEFAULT_TIMEOUT_S = 300.0

#: what ``initialize_distributed`` set up: the backend it gave the group,
#: the card indices of this process's shards, and the processes on this
#: host (None where it cannot be known)
_group: dict = {}


class Mesh:
    """A 1-D mesh of ``size`` shards over ``process_count`` processes.

    ``devices[i]`` holds this process's i-th shard, global shard
    ``local_shards[i]``; in one process every shard is local. ``transport``
    is the device that cross-process collectives exchange tensors on: the
    CPU under gloo (CUDA shards are staged through the host) or the first
    local card under NCCL; None in one process."""

    def __init__(self, devices, axis_name: str = "data", *, process_count: int = 1, process_index: int = 0,
                 transport: torch.device | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.axis_names = (axis_name,)
        self.process_count, self.process_index = process_count, process_index
        self.local_count = len(self.devices)
        self.size = self.local_count * process_count
        first = process_index * self.local_count
        self.local_shards = tuple(range(first, first + self.local_count))
        self.transport = None if process_count == 1 else torch.device(transport or "cpu")

    def __repr__(self) -> str:
        procs = "" if self.process_count == 1 else f", process {self.process_index} of {self.process_count}"
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r}{procs})"

    def owner(self, shard: int) -> int:
        """The process that owns global shard ``shard``."""
        return shard // self.local_count


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (default: all of them),
    or, with ``device="cpu"``, over ``n_devices`` CPU shards (default 1).
    Raises tpufm's ValueError when the machine has fewer cards.

    After ``initialize_distributed`` the mesh spans every process:
    ``n_devices`` counts the shards of all of them (a multiple of the
    process count), each process owning n_devices / P; a process's cards
    are its ``local_device_ids`` (repeats allowed: colocated shards), else
    the card torchrun's LOCAL_RANK names, else every card it sees. The
    default is every process's cards, or one CPU shard a process."""
    dev = resolve_device(device)
    if _distributed():
        return _spanning(n_devices, axis_name, dev)
    if dev.type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), axis_name)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"need {n} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis_name)


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _local_cards() -> list:
    ids = _card_ids(_group.get("local_device_ids"))
    return [torch.device("cuda", i) for i in (range(torch.cuda.device_count()) if ids is None else ids)]


def _card_ids(local_device_ids) -> list | None:
    """This process's cards as the caller named them: ``local_device_ids``,
    else the card torchrun's LOCAL_RANK names, else None (every card)."""
    if local_device_ids is not None:
        return list(local_device_ids)
    return [int(os.environ["LOCAL_RANK"])] if "LOCAL_RANK" in os.environ else None


def _spanning(n_devices: int | None, axis_name: str, dev: torch.device) -> Mesh:
    """The mesh over every process of the initialized group; every process
    must call it with the same arguments (it exchanges the shard counts)."""
    import torch.distributed as dist

    P, rank = dist.get_world_size(), dist.get_rank()
    backend = _group.get("backend", str(dist.get_backend()))
    if dev.type == "cpu":
        per = 1 if n_devices is None else n_devices // P
        devices, transport = [torch.device("cpu")] * per, torch.device("cpu")
    else:
        cards = _local_cards()
        per = len(cards) if n_devices is None else n_devices // P
        if per > len(cards):
            raise ValueError(f"need {per} devices a process, have {len(cards)}")
        devices = cards[:per]
        nccl = "nccl" in backend
        if nccl:
            _check_nccl_cards(_group.get("ranks_on_host"), _group.get("local_device_ids"))
            torch.cuda.set_device(devices[0])
        transport = devices[0] if nccl else torch.device("cpu")
    if n_devices is not None and (n_devices % P or not per):
        raise ValueError(f"a mesh of {n_devices} shards over {P} processes: give each process the same "
                         "number of shards (a multiple of the process count)")
    counts = [torch.zeros(1, dtype=torch.int64, device=transport) for _ in range(P)]
    dist.all_gather(counts, torch.full((1,), per, dtype=torch.int64, device=transport))
    if len({int(c) for c in counts}) > 1:
        raise ValueError(f"processes own {[int(c) for c in counts]} shards: every process must own the same number")
    return Mesh(devices, axis_name, process_count=P, process_index=rank, transport=transport)


def _loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host.strip("[]")).is_loopback
    except ValueError:
        return False


def _check_nccl_cards(ranks_on_host: int | None, local_device_ids) -> int:
    """Raise where NCCL would find two ranks of this host on one card, or
    where every process would take every card of its host (no
    ``local_device_ids`` and no LOCAL_RANK, and more than one rank on the
    host or no way to know): the ranks would then all send through cuda:0.
    Returns the first card of this process, the one its NCCL traffic uses."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise ValueError("backend='nccl' needs CUDA cards; pass backend='gloo' for a CPU mesh")
    if ranks_on_host is not None and ranks_on_host > have:
        raise ValueError(
            f"backend='nccl' puts {ranks_on_host} ranks on this host's {have} card(s): NCCL refuses two ranks "
            "on one card (duplicate GPU); give each rank a card of its own, or pass backend='gloo', under "
            "which the collectives stage CUDA shards through the host")
    ids = _card_ids(local_device_ids)
    if ids is None and ranks_on_host != 1:
        host = "an unknown number of" if ranks_on_host is None else str(ranks_on_host)
        raise ValueError(
            f"backend='nccl' with no local_device_ids and no LOCAL_RANK: each of {host} ranks on this host would "
            "take every card, and all of them would send through cuda:0; pass local_device_ids (this process's "
            "cards), or start the processes with torchrun")
    return 0 if ids is None else ids[0]


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, local_device_ids=None, backend: str | None = None,
                           timeout: float | datetime.timedelta = DEFAULT_TIMEOUT_S) -> None:
    """Multi-host bring-up: join this process to a ``torch.distributed``
    group, so that ``make_mesh()`` then spans every process's shards.

    The keywords are tpufm's for ``jax.distributed.initialize``.
    ``coordinator`` "host:port" is process 0's address (a TCP rendezvous,
    ``init_method=f"tcp://{coordinator}"``), with ``num_processes`` and this
    process's ``process_id``; without it the group comes from torchrun's
    environment (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), as
    jax detects its cluster. ``local_device_ids``: the cards of this
    process's shards (a card may repeat). ``backend``: "gloo" or "nccl";
    None gives torch's own default, NCCL for CUDA tensors and gloo for CPU
    ones (gloo alone where there is no CUDA). Under gloo the collectives
    stage CUDA shards through the host. Under NCCL the process is bound to
    its first card (``torch.cuda.set_device``); NCCL with two ranks on one
    card raises, and so does NCCL where a process would take every card of
    a host that runs several ranks (name the cards with
    ``local_device_ids`` or LOCAL_RANK); nothing switches to gloo on its
    own. ``timeout`` (s): how long a collective waits for a peer before the
    run fails."""
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("initialize_distributed: this torch build has no torch.distributed")
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: this process has already joined a group")
    if coordinator is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK") if v not in os.environ]
        if missing:
            raise ValueError(
                f"initialize_distributed: no coordinator given and no torchrun environment ({', '.join(missing)} "
                "unset): pass coordinator='host:port', num_processes and process_id, or start the processes "
                "with torchrun")
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        rank = int(os.environ["RANK"]) if process_id is None else process_id
        local = os.environ.get("LOCAL_WORLD_SIZE")
        ranks_on_host = None if local is None else int(local)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize_distributed: a coordinator needs num_processes and process_id")
        init_method, world, rank = f"tcp://{coordinator}", num_processes, process_id
        # a loopback coordinator is reachable from this host only: every process runs here
        ranks_on_host = world if _loopback(coordinator.rsplit(":", 1)[0]) else None
    if not 0 <= rank < world:
        raise ValueError(f"initialize_distributed: process_id {rank} of {world} processes")
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    elif backend not in ("gloo", "nccl"):
        raise ValueError(f"initialize_distributed: backend {backend!r} (use 'gloo' or 'nccl')")
    if local_device_ids is not None:
        local_device_ids = [int(i) for i in local_device_ids]
        if not local_device_ids:
            raise ValueError("initialize_distributed: local_device_ids is empty")
    if backend == "nccl":
        torch.cuda.set_device(_check_nccl_cards(ranks_on_host, local_device_ids))
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    _group.clear()
    _group.update(backend=backend, local_device_ids=local_device_ids, ranks_on_host=ranks_on_host)


def shutdown_distributed() -> None:
    """Leave the group ``initialize_distributed`` joined (a no-op outside
    one); later meshes are one-process meshes again."""
    import torch.distributed as dist

    if _distributed():
        dist.destroy_process_group()
    _group.clear()
