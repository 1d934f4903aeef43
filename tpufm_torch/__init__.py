"""tpufm_torch — the k-step FM-index search engine in PyTorch and CUDA.

The port of ``tpufm`` (JAX on a TPU) to one NVIDIA H100. ``tpufm`` stays
the reference: every result here must be bit-identical to its engines.
The package stands alone: it imports neither jax nor tpufm, and carries its
own host side (index construction, file formats, read I/O, numpy oracle).

Layers:
  tpufm_torch.cli               — ``python -m tpufm_torch.cli build|genreads|
                                  search|count|locate|align|bench|sweep ...``
  tpufm_torch.sweep             — tpufm's (refsize x k x d x engine x LUT)
                                  experiment matrix, one record a row
  tpufm_torch.bench             — tpufm's single-device bench records (search,
                                  genome, locate, fused locate, Hamming <= 1,
                                  seed-and-extend, edit distance, paired),
                                  timed by tpufm_torch.timer; (k, d, LUT) of
                                  ``build --auto`` and ``--genome`` from
                                  tpufm_torch.config
  tpufm_torch.engine.paired     — PairedEndEngine: FR pairs under an insert
                                  window from any of the position sources
  tpufm_torch.engine.seed       — SeedExtendEngine: Hamming distance m >= 1 by
                                  pigeonhole seeds, the walk and K5's verify
  tpufm_torch.engine.edit       — EditExtendEngine: edit distance E >= 1, the
                                  same seeds and K6's Myers verify
  tpufm_torch.engine.search_locate — SearchLocateEngine: reads to text
                                  positions in one pass, exact or within
                                  Hamming distance 1
  tpufm_torch.engine.search     — SearchEngine: tables on the device, waves,
                                  prefix LUT, k-step and k=1 tail rounds,
                                  fixed and variable length, gather "fused"
                                  or "dma"; the split, alternate-counters
                                  and paired layouts and pad_words; counts,
                                  exact or Hamming <= 1 (engine.mismatch:
                                  the 3L+1 variants)
  tpufm_torch.engine.locate     — LocateEngine: the sampled-SA walk (K4)
                                  from BWT rows to text positions
  tpufm_torch.engine.lf_round   — one LF round (K1): per read (both ends,
                                  the engine's), per end, on rows gathered
                                  beforehand, or on the paired table; of
                                  the split and alternate-counters tables
                                  (K8); the CUDA kernels on the card, their
                                  plain versions on the CPU
  tpufm_torch.engine.row_gather — the row gather (K3) of gather="dma"
  tpufm_torch.index             — the index built on the device: the suffix
                                  array by prefix doubling (torch.sort a
                                  round), the tables by K7, the locate
                                  tables (tpufm/index/*_device.py); and
                                  over a mesh of shards, K7 a shard
                                  (tpufm/index/*_sharded.py)
  tpufm_torch.parallel          — the mesh, its collectives, the mesh
                                  search and locate engines
  tpufm_torch.profiling         — a torch.profiler trace, the program's
                                  spans and counters on it, timed passes
  tpufm_torch.kernels           — nvcc build (one library per csrc/*.cu,
                                  all at once) + ctypes binding
  tpufm_torch.host              — index build (SA-IS in csrc/sais.cpp), index
                                  files, reads and results, the numpy oracle;
                                  the aligner's record map, re-alignment, SAM
                                  (record emitter csrc/samemit.cpp) and BAM
"""

from tpufm_torch.device import resolve_device
from tpufm_torch.engine.locate import (
    LocateEngine,
    LocateTables,
    locate_tables_from_index,
    locate_tables_from_jax,
)
from tpufm_torch.engine.search import SearchEngine
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.tables import Tables, tables_from_index, tables_from_jax

__all__ = [
    "LocateEngine",
    "LocateTables",
    "SearchEngine",
    "SearchLocateEngine",
    "Tables",
    "locate_tables_from_index",
    "locate_tables_from_jax",
    "resolve_device",
    "tables_from_index",
    "tables_from_jax",
]
