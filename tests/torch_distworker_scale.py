"""Chromosome-scale multi-process worker of the port, for
tests/test_torch_multiprocess.py (tpufm's tests/distworker_scale.py).

Opens a prebuilt 100 Mbase index from the mmap .tpufm store, joins a
2-process ``torch.distributed`` group (gloo) with 2 CPU shards a process,
and runs DataParallelEngine with its own prefix LUT (lut 9) over the global
4-shard mesh, streaming the read batch in waves of 2,048; every process
writes the whole result. It imports the port only. Run:

    python torch_distworker_scale.py COORDINATOR NPROC PID WORKDIR
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from tpufm_torch.engine.search import stream_waves  # noqa: E402
from tpufm_torch.host.formats import load_store  # noqa: E402
from tpufm_torch.parallel import DataParallelEngine, initialize_distributed, make_mesh  # noqa: E402

coordinator, nproc, pid, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
initialize_distributed(coordinator, num_processes=nproc, process_id=pid, backend="gloo", timeout=600)
mesh = make_mesh(2 * nproc, device="cpu")
assert mesh.process_count == nproc

index = load_store(os.path.join(workdir, "chrom.tpufm"))  # mmap open
queries = np.load(os.path.join(workdir, "queries.npy"))
eng = DataParallelEngine(index, mesh, lut_m=9)
out = stream_waves(queries, 2048, lambda q: eng.search_device(eng.shard_queries(q)), None, (2,))
np.save(os.path.join(workdir, f"chrom_result_{pid}.npy"), out)
print(f"scale worker {pid}: ok", flush=True)
