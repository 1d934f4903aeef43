"""Command line of the port on one device: search, count and locate.

    python -m tpufm_torch.cli search INDEX QUERIES L N [--lut M] [--tail PATH]
        [--rc] [--iterations I] [--output OUT] [--device cuda|cpu]
        [--engine xla|pallas]
    python -m tpufm_torch.cli count INDEX QUERIES L N [--mismatches 0|1]
        [--lut M] [--tail PATH] [--rc] [--iterations I] [--output OUT]
        [--device cuda|cpu]
    python -m tpufm_torch.cli locate REF REFSIZE QUERIES L N [--k K] [--d D]
        [--sample-rate S] [--max-hits H] [--fused] [--lut M] [--rc]
        [--mismatches 0|1] [--store PREFIX] [--from-store PREFIX]
        [--output OUT] [--device cuda|cpu]

Counterparts of ``tpufm search`` (``cmd_search``, tpufm/cli.py:338-387) with
its single-chip engines: ``--engine xla`` (the default; K1 loads its own
rows) and ``--engine pallas`` (``PallasEngine``, cli.py:444-447: torch
indexing gathers every end's row, then K1 computes on the gathered rows;
fixed lengths that k divides after the LUT only); of ``tpufm count``
(``cmd_count``, :469-505); and of ``tpufm locate`` (``cmd_locate``,
``_locate_tables``, ``_locate_body``, :729-1154) in its exact two-pass,
``--fused``, ``--rc`` and ``--mismatches 1`` forms, whose parser defines no
other option. They read the same index files (.fmi, .npz, .tpufm), derive
the k=1 tail the same way, share the ``<index>.lut<M>.npz`` LUT cache,
print the same ``TIME:`` line (search and count: mean seconds per pass
after one warm-up pass) and write byte-identical ``.res``, ``.cnt`` and
``.pos`` files (minus-strand results of ``--rc`` in ``<out>.rc``).
``--device`` defaults to cuda and never falls back to the CPU.
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
from tpufm_torch.engine.locate import LocateEngine
from tpufm_torch.engine.search import SearchEngine
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.host.formats import load_npz, load_store, read_fmi, save_store
from tpufm_torch.host.index import AltCountersIndex, IndexConfig, KStepFMIndex, build_index, derive_tail
from tpufm_torch.host.locate import build_locate
from tpufm_torch.host.seqio import (
    load_queries,
    read_reference,
    reverse_complement,
    write_results,
)
from tpufm_torch.host.suffix_array import suffix_array


@dataclasses.dataclass
class SearchRun:
    """What ``search`` did, for callers that drive the CLI in process."""

    engine: SearchEngine
    results: np.ndarray  # uint32 [B, 2], or [2B, 2] with --rc
    seconds_per_pass: float


@dataclasses.dataclass
class CountRun:
    """What ``count`` did."""

    engine: SearchEngine
    counts: np.ndarray  # uint32 [B], or [2B] with --rc
    seconds_per_pass: float


@dataclasses.dataclass
class LocateRun:
    """What ``locate`` did."""

    positions: np.ndarray  # uint32 [B, max_hits], or [2B, max_hits] with --rc
    intervals: np.ndarray | None  # uint32 [B or 2B, 2]; None with --mismatches 1
    seconds: float  # the one pass, reads in host memory to positions in host memory


def load_index(path: str) -> KStepFMIndex | AltCountersIndex:
    """A search index from .tpufm, .npz or .fmi, as tpufm/cli.py:32 loads it."""
    if path.endswith(".tpufm"):
        index = load_store(path)
    elif path.endswith(".npz"):
        index = load_npz(path)
    else:
        index = read_fmi(path)[0]
    if not isinstance(index, (KStepFMIndex, AltCountersIndex)):
        sys.exit(
            f"{path} holds a {type(index).__name__}, not a search index; "
            "expected a k-step FM-index store (use `locate --from-store "
            "PREFIX` for locate stores)"
        )
    return index


def rc_expand(queries: np.ndarray) -> np.ndarray:
    """Append every read's reverse complement: both strands ride one pass
    (tpufm/cli.py:230); ``emit_strands`` splits the results back."""
    return np.concatenate([queries, reverse_complement(queries)])


def emit_strands(out: str, rows: np.ndarray, B: int, write_one) -> None:
    """``rows[:B]`` to ``out`` and, for a batch doubled by ``rc_expand``,
    ``rows[B:]`` to ``out``.rc (tpufm/cli.py:239)."""
    write_one(out, rows[:B])
    print(f"wrote {out}")
    if rows.shape[0] > B:
        write_one(f"{out}.rc", rows[B:])
        print(f"wrote {out}.rc (minus strand)")


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
        queries = rc_expand(queries)
    res, dt = _timed(lambda: engine.search(queries, step=step), args.iterations)
    emit_strands(out, res, B, write_results)
    return SearchRun(engine, res, dt)


def _timed(fn, iterations: int):
    """(result, mean seconds per pass) of ``fn`` after one warm-up pass,
    printed as the ``TIME:`` line of the reference protocol."""
    res = fn()
    t0 = time.perf_counter()
    for _ in range(iterations):
        res = fn()
    dt = (time.perf_counter() - t0) / iterations
    print(f"TIME: \t {dt}")
    return res, dt


def cmd_count(args) -> CountRun:
    """Occurrences of every read, exact (R - L) or within Hamming distance 1
    (``--mismatches 1``), one integer per line."""
    device = resolve_device(args.device)
    index = load_index(args.index)
    if not isinstance(index, KStepFMIndex):
        sys.exit("count needs a baseline-layout index (not alt-counters)")
    queries = np.require(
        load_queries(args.queries, args.qrysize, args.numqueries), np.uint8, ["C", "W"]
    )
    tail = load_tail(index, args.index, args.qrysize, args.tail)
    B = queries.shape[0]
    if args.rc:
        queries = rc_expand(queries)
    engine = SearchEngine(
        index, device, lut_m=args.lut,
        lut_cache=f"{args.index}.lut{args.lut}.npz" if args.lut else None,
        tail_index=tail,
    )
    cnt, dt = _timed(lambda: engine.count(queries, mismatches=args.mismatches), args.iterations)
    out = args.output or f"{args.queries}.cnt"
    emit_strands(out, cnt, B, lambda path, a: np.savetxt(path, a, fmt="%d"))
    return CountRun(engine, cnt, dt)


def locate_tables(args):
    """(index, locate tables): loaded from ``PREFIX.search.tpufm`` and
    ``PREFIX.locate.tpufm`` with --from-store, else built from the
    reference with one suffix sort, and stored under --store
    (tpufm/cli.py:744-807)."""
    if args.from_store:
        index = load_store(f"{args.from_store}.search.tpufm")
        loc = load_store(f"{args.from_store}.locate.tpufm")
    else:
        codes = read_reference(args.reference, args.refsize)
        sa = suffix_array(codes)
        index = build_index(codes, IndexConfig(k=args.k, d=args.d), sa=sa)
        loc = build_locate(codes, sample_rate=args.sample_rate, d=args.d, sa=sa)
        if args.store:
            save_store(f"{args.store}.search.tpufm", index)
            save_store(f"{args.store}.locate.tpufm", loc)
            print(f"stored {args.store}.search.tpufm + {args.store}.locate.tpufm")
    return index, loc


def write_positions(path: str, rows: np.ndarray) -> None:
    """One line per read: its positions, 0xFFFFFFFF (no hit) left out
    (tpufm/cli.py:1140-1150)."""
    with open(path, "w") as fp:
        for row in np.asarray(rows).tolist():
            fp.write(" ".join(str(x) for x in row if x != 0xFFFFFFFF) + "\n")


def cmd_locate(args) -> LocateRun:
    """Search, then the text positions of up to --max-hits occurrences per
    read: two passes (``SearchEngine.search``, then
    ``LocateEngine.locate_hits``), one fused pass (``--fused``,
    ``SearchLocateEngine.search_locate``), or within Hamming distance 1 in
    one pass (``--mismatches 1``, ``SearchLocateEngine.locate_mismatch``)."""
    device = resolve_device(args.device)
    index, loc = locate_tables(args)
    queries = np.require(
        load_queries(args.queries, args.qrysize, args.numqueries), np.uint8, ["C", "W"]
    )
    nq = queries.shape[0]
    if args.rc:
        queries = rc_expand(queries)
    intervals = None
    if args.mismatches or args.fused:
        engine = SearchLocateEngine(index, loc, device, max_hits=args.max_hits, lut_m=args.lut)
        t0 = time.perf_counter()
        if args.mismatches:
            pos = engine.locate_mismatch(queries)
        else:
            intervals, pos = engine.search_locate(queries)
    else:
        # any length: the locate tables' k=1 index is the search's tail
        tail = loc.lf1 if args.qrysize % index.config.k else None
        search = SearchEngine(index, device, lut_m=args.lut, tail_index=tail)
        walker = LocateEngine(loc, device)
        t0 = time.perf_counter()
        intervals = search.search(queries)
        pos = walker.locate_hits(intervals, max_hits=args.max_hits)
    seconds = time.perf_counter() - t0
    out = args.output or f"{args.queries}.pos"
    print(f"{nq} queries, max {args.max_hits} hits each")
    emit_strands(out, pos, nq, write_positions)
    return LocateRun(pos, intervals, seconds)


def _positive(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def _add_io(p, iterations: int) -> None:
    """The arguments search and count share."""
    p.add_argument("index")
    p.add_argument("queries")
    p.add_argument("qrysize", type=int)
    p.add_argument("numqueries", type=int)
    p.add_argument("--lut", type=int, default=0,
                   help="prefix-LUT length m (the first m characters of "
                        "every query in one lookup)")
    p.add_argument("--tail", default=None, metavar="PATH",
                   help="k=1 tail index enabling any query length "
                        "(default: <index>.tail.npz, else derived)")
    p.add_argument("--rc", action="store_true",
                   help="also run every read's reverse complement; "
                        "minus-strand results go to <out>.rc")
    p.add_argument("--iterations", type=_positive, default=iterations)
    p.add_argument("--output", default=None)
    _add_device(p)


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (the "
                        "plain PyTorch path)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpufm_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("search", help="batch exact backward search")
    _add_io(s, iterations=5)
    s.add_argument("--engine", default="xla", choices=["xla", "pallas"],
                   help="xla: K1 loads its own rows; pallas: rows gathered "
                        "by torch indexing, then K1 on the gathered rows")
    s.set_defaults(fn=cmd_search)

    c = sub.add_parser("count", help="occurrence counts per read (exact or <=1 mismatch)")
    _add_io(c, iterations=1)
    c.add_argument("--mismatches", type=int, default=0, choices=[0, 1],
                   help="1 = count occurrences within Hamming distance 1 "
                        "(each read's 3L+1 variants searched on the device)")
    c.set_defaults(fn=cmd_count)

    lc = sub.add_parser("locate", help="search + text positions")
    lc.add_argument("reference")
    lc.add_argument("refsize", type=int)
    lc.add_argument("queries")
    lc.add_argument("qrysize", type=int)
    lc.add_argument("numqueries", type=int)
    lc.add_argument("--k", type=int, default=2)
    lc.add_argument("--d", type=int, default=64)
    lc.add_argument("--sample-rate", type=_positive, default=32)
    lc.add_argument("--max-hits", type=_positive, default=16)
    lc.add_argument("--fused", action="store_true",
                    help="search + locate in one device pass (SearchLocateEngine)")
    lc.add_argument("--lut", type=int, default=0,
                    help="prefix LUT m-mer size for the search (as search --lut)")
    lc.add_argument("--rc", action="store_true",
                    help="also locate every read's reverse complement in the "
                         "same pass; minus-strand positions go to <out>.rc")
    lc.add_argument("--mismatches", type=int, default=0, choices=[0, 1],
                    help="1 = positions of occurrences within Hamming distance "
                         "1, in one device pass")
    lc.add_argument("--store", default=None, metavar="PREFIX",
                    help="persist PREFIX.search.tpufm + PREFIX.locate.tpufm")
    lc.add_argument("--from-store", default=None, metavar="PREFIX",
                    help="load prebuilt stores; reference/refsize are "
                         "ignored (pass '-' 0)")
    lc.add_argument("--output", default=None)
    _add_device(lc)
    lc.set_defaults(fn=cmd_locate)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
