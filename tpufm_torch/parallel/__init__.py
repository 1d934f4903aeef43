"""Multi-device search and locate (tpufm/parallel/): a 1-D mesh of shards
in one process or across the processes of a ``torch.distributed`` group
(``initialize_distributed``), the collectives of its programs, the data-parallel and the sharded-index
engines, the data-parallel locate engines, and the collective-traffic
model."""

from tpufm_torch.parallel.locate import DataParallelLocate, DataParallelSearchLocate
from tpufm_torch.parallel.mesh import Mesh, initialize_distributed, make_mesh, shutdown_distributed
from tpufm_torch.parallel.search import DataParallelEngine, ShardedIndexEngine
from tpufm_torch.parallel.traffic import assert_collective_model, collective_bytes_model

__all__ = [
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "shutdown_distributed",
    "DataParallelEngine",
    "ShardedIndexEngine",
    "DataParallelLocate",
    "DataParallelSearchLocate",
    "assert_collective_model",
    "collective_bytes_model",
]
