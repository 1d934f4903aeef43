"""The device mesh of the multi-device engines.

Counterpart of tpufm/parallel/mesh.py: ``make_mesh`` (:19) builds the 1-D
mesh that ``jax.sharding.Mesh(np.asarray(devs), ("data",))`` is there. One
process drives every shard, as tpufm's jit drives every local chip: a
``Mesh`` is an ordered list of torch devices, one a shard, with an axis
name. The query batch is split along it (``DataParallelEngine``), and the
entry table too where it does not fit one device (``ShardedIndexEngine``).

A shard is a device, not necessarily a card of its own: a ``Mesh`` built
directly may repeat one card (``Mesh([torch.device("cuda", 0)] * 4)``), so
that one card runs D > 1 shards and the routings leave their one-device
branches. The copies between such colocated shards are copies within one
card's memory, not NVLink traffic: they measure no transport. ``make_mesh``
never repeats a card. On the CPU, ``make_mesh(n, device="cpu")`` gives n CPU
shards, the counterpart of tpufm's virtual CPU devices
(``--xla_force_host_platform_device_count``).

``initialize_distributed`` (tpufm's multi-host bring-up, :30) is not ported
yet: it raises, naming ROADMAP Queue 1 item 6d.
"""

from __future__ import annotations

import torch

from tpufm_torch.device import resolve_device


class Mesh:
    """A 1-D mesh: ``devices[s]`` holds shard s; ``axis_names`` as JAX's."""

    def __init__(self, devices, axis_name: str = "data"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis_name,)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (default: all of them),
    or, with ``device="cpu"``, over ``n_devices`` CPU shards (default 1).
    Raises tpufm's ValueError when the machine has fewer cards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), axis_name)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"need {n} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis_name)


def initialize_distributed(coordinator: str | None = None, **kwargs) -> None:
    """Multi-host bring-up (tpufm's ``jax.distributed.initialize``
    passthrough): not ported yet."""
    raise NotImplementedError(
        "initialize_distributed: multi-host search over torch.distributed is not "
        "ported yet (ROADMAP Queue 1 item 6d); one process drives every shard of a "
        "make_mesh() mesh"
    )
