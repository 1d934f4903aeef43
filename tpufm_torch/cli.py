"""Command line of the port: exact search on one device.

    python -m tpufm_torch.cli search INDEX QUERIES L N [--lut M] [--tail PATH]
        [--rc] [--iterations I] [--output OUT] [--device cuda|cpu]
        [--engine xla|pallas]

Counterpart of ``tpufm search`` (``cmd_search``, tpufm/cli.py:338-387) with
its single-chip engines: ``--engine xla`` (the default; K1 loads its own
rows) and ``--engine pallas`` (``PallasEngine``, cli.py:444-447: torch
indexing gathers every end's row, then K1 computes on the gathered rows;
fixed lengths that k divides after the LUT only). It reads the same index files (.fmi, .npz,
.tpufm), derives the k=1 tail the same way, shares the ``<index>.lut<M>.npz``
LUT cache, prints the same ``TIME:`` line (mean seconds per pass after one
warm-up pass) and writes byte-identical ``.res`` files. ``--device`` defaults
to cuda and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from tpufm_torch.device import resolve_device
from tpufm_torch.engine.lf_round import lf_round_indexed
from tpufm_torch.engine.search import SearchEngine
from tpufm_torch.host.formats import load_npz, load_store, read_fmi
from tpufm_torch.host.index import AltCountersIndex, KStepFMIndex, derive_tail
from tpufm_torch.host.seqio import load_queries, reverse_complement, write_results


@dataclasses.dataclass
class SearchRun:
    """What ``search`` did, for callers that drive the CLI in process."""

    engine: SearchEngine
    results: np.ndarray  # uint32 [B, 2], or [2B, 2] with --rc
    seconds_per_pass: float


def load_index(path: str) -> KStepFMIndex | AltCountersIndex:
    """A search index from .tpufm, .npz or .fmi, as tpufm/cli.py:32 loads it."""
    if path.endswith(".tpufm"):
        return load_store(path)
    if path.endswith(".npz"):
        return load_npz(path)
    return read_fmi(path)[0]


def load_tail(index, index_path: str, qrysize: int, tail_path: str | None):
    """The k=1 tail index when the query length needs one (tpufm/cli.py:202):
    ``tail_path`` or ``<index>.tail.npz`` if present, else derived from the
    index itself."""
    k = index.config.k
    if qrysize % k == 0:
        return None
    if isinstance(index, AltCountersIndex):
        sys.exit(
            f"query length {qrysize} is not divisible by k={k} and the "
            "alt-counters layout cannot take k=1 tail rounds; use the "
            "baseline index (any-length) or pad reads to a multiple of k"
        )
    tpath = tail_path or f"{index_path}.tail.npz"
    if os.path.exists(tpath):
        return load_npz(tpath)
    print(
        f"note: query length {qrysize} % k={k} != 0 — deriving the "
        f"k=1 tail from the index (`tpufm build --tail` precomputes it)"
    )
    return derive_tail(index)


def cmd_search(args) -> SearchRun:
    device = resolve_device(args.device)
    index = load_index(args.index)
    # writable once here, so the timed passes copy nothing (SearchEngine.search)
    queries = np.require(
        load_queries(args.queries, args.qrysize, args.numqueries), np.uint8, ["C", "W"]
    )
    tail = load_tail(index, args.index, args.qrysize, args.tail)
    if tail is not None and args.engine == "pallas":
        sys.exit(
            "any-length queries (tail index) are supported by --engine "
            "xla/xla-paired (single-chip, --mesh N, or --sharded); pad "
            "reads to a multiple of k for pallas/xla-ac"
        )
    step = lf_round_indexed if args.engine == "pallas" else None
    engine = SearchEngine(
        index,
        device,
        lut_m=args.lut,
        lut_cache=f"{args.index}.lut{args.lut}.npz" if args.lut else None,
        tail_index=tail,
    )
    out = args.output or f"{args.index}.res.{'gpu' if device.type == 'cuda' else 'cpu'}"

    B = queries.shape[0]
    if args.rc:
        # both strands in one pass; minus-strand intervals go to <out>.rc
        queries = np.concatenate([queries, reverse_complement(queries)])
    res = engine.search(queries, step=step)  # warm-up
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        res = engine.search(queries, step=step)
    dt = (time.perf_counter() - t0) / args.iterations
    print(f"TIME: \t {dt}")

    write_results(out, res[:B])
    print(f"wrote {out}")
    if args.rc:
        write_results(f"{out}.rc", res[B:])
        print(f"wrote {out}.rc (minus strand)")
    return SearchRun(engine, res, dt)


def _positive(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpufm_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("search", help="batch exact backward search")
    s.add_argument("index")
    s.add_argument("queries")
    s.add_argument("qrysize", type=int)
    s.add_argument("numqueries", type=int)
    s.add_argument("--lut", type=int, default=0,
                   help="prefix-LUT length m (the first m characters of "
                        "every query in one lookup)")
    s.add_argument("--tail", default=None, metavar="PATH",
                   help="k=1 tail index enabling any query length "
                        "(default: <index>.tail.npz, else derived)")
    s.add_argument("--rc", action="store_true",
                   help="also search every read's reverse complement; "
                        "minus-strand intervals go to <out>.rc")
    s.add_argument("--iterations", type=_positive, default=5)
    s.add_argument("--output", default=None)
    s.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (the "
                        "plain PyTorch path)")
    s.add_argument("--engine", default="xla", choices=["xla", "pallas"],
                   help="xla: K1 loads its own rows; pallas: rows gathered "
                        "by torch indexing, then K1 on the gathered rows")
    s.set_defaults(fn=cmd_search)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
