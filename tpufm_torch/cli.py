"""Command line of the port: build, genreads, transform, search, count,
locate, align, bench, sweep, the host-only SAM/BAM tools and faidx
(tpufm_torch.tools) and the debug commands dumpentry, diff and dumpbwt; on
one device, and build, search, count, locate, align and bench also over a
mesh of devices.

    python -m tpufm_torch.cli build REF REFSIZE [--k K] [--d D] [--auto]
        [--output OUT.fmi|.npz|.tpufm] [--sa auto|native|doubling|device|sharded]
        [--on-device [--mesh N [--store-sharded]]] [--tail] [--save-ref]
        [--device cuda|cpu]
    python -m tpufm_torch.cli genreads REF REFSIZE LENGTH NUM [--seed S]
        [--output OUT] [--paired] [--insert-min A] [--insert-max B]
    python -m tpufm_torch.cli transform INDEX.fmi [--layouts L ...]
    python -m tpufm_torch.cli search INDEX QUERIES L N [--lut M] [--tail PATH]
        [--rc] [--iterations I] [--output OUT] [--device cuda|cpu]
        [--engine xla|xla-ac|xla-paired|pallas] [--pad-words W] [--resume]
        [--mesh N [--sharded [--routing allgather|ring|a2a]]]
    python -m tpufm_torch.cli count INDEX QUERIES L N [--mismatches 0|1]
        [--lut M] [--tail PATH] [--rc] [--iterations I] [--output OUT]
        [--mesh N] [--device cuda|cpu]
    python -m tpufm_torch.cli locate REF REFSIZE QUERIES L N [--k K] [--d D]
        [--sample-rate S] [--max-hits H] [--fused] [--lut M] [--rc]
        [--mismatches M | --edits E] [--seed-hits H] [--paired R2.qry
        [--insert-min A] [--insert-max B] [--max-pairs P]]
        [--sam | --bam | --contigs] [--store PREFIX] [--from-store PREFIX]
        [--on-device] [--resume] [--mesh N] [--output OUT] [--device cuda|cpu]
    python -m tpufm_torch.cli align REF READS [-2 R2] [-o OUT] [--bam]
        [--mismatches M | --edits E] [--store PREFIX | --from-store PREFIX]
        [--on-device] [--mesh N]
        [--max-hits H] [--seed-hits H] [--sample-rate S] [--lut M]
        [--insert-min A] [--insert-max B] [--max-pairs P] [--device cuda|cpu]
    python -m tpufm_torch.cli bench [--refsize N] [--k K] [--d D]
        [--numqueries N] [--length L] [--iterations I] [--seed S]
        [--engine xla|xla-split|xla-ac|xla-paired|pallas] [--lut M]
        [--mismatches M | --edits E]
        [--seed-hits H] [--paired [--insert-min A] [--insert-max B]]
        [--genome] [--locate [--fused]] [--max-hits H] [--sample-rate S]
        [--multichip | --sharded [--routing R]] [--mesh N] [--device cuda|cpu]
    python -m tpufm_torch.cli sweep [--refsizes N ...] [--ks K ...] [--ds D ...]
        [--engines E ...] [--luts M ...] [--numqueries N] [--length L]
        [--iterations I] [--output OUT] [--device cuda|cpu]
    python -m tpufm_torch.cli dumpentry INDEX ENTRY [--num N]
    python -m tpufm_torch.cli diff A.res B.res
    python -m tpufm_torch.cli dumpbwt REF REFSIZE [--k K]
    python -m tpufm_torch.cli --trace DIR <command> ...

Counterparts of ``tpufm build`` (``cmd_build``, tpufm/cli.py:54, on the
host or with --on-device on the card: one suffix sort serves the index and
its k=1 tail; files byte-identical), ``tpufm genreads`` (``cmd_genreads``,
:174; the same reads and files on the same seed), ``tpufm bench`` (``cmd_bench``, :508: the same
dispatch and argument checks, one JSON line of tpufm_torch.bench's record;
the modes not ported yet exit non-zero naming their ROADMAP item),
``tpufm search`` (``cmd_search``, tpufm/cli.py:338-387) with
its single-chip engines (``_make_engine``, :390-470): ``--engine xla`` (the
default; K1 loads its own rows, padded to ``--pad-words``; an
alternate-counters image is searched on its slim counters by K8, without
LUT or tail, as ``XLAEngine`` does), ``xla-ac`` (a baseline index made
alternate-counters), ``xla-paired`` (K1's paired entry after a LUT, the
wide reads searched again on the fused rows) and ``--engine pallas``
(``PallasEngine``, cli.py:444-447: torch indexing gathers every end's row
of the index's base, then K1 computes on the gathered rows; fixed lengths
that k divides after the LUT only), and with its mesh engines (:414-442,
tpufm_torch.parallel): ``--mesh N`` (``DataParallelEngine``; N = 0 every
card) and ``--sharded --routing R`` (``ShardedIndexEngine``); of ``tpufm sweep`` (``cmd_sweep``,
:683-705: tpufm_torch.sweep's matrix, ``SWEEP FAILED`` on a row that is
not bit-exact); of ``tpufm count``
(``cmd_count``, :469-505, also ``--mesh N``); of ``tpufm locate`` (``cmd_locate``,
``_locate_tables``, ``_locate_body``, :729-1154) in its exact two-pass,
``--fused``, ``--rc``, Hamming (``--mismatches 1``, and ``>= 2`` by seed-
and-extend), edit-distance (``--edits E``) and paired (``--paired R2``,
writing ``<queries>.pairs``) forms, the approximate ones verified against
the reference's text (read again from its FASTA with --from-store), with
``--contigs`` (``record:offset`` labels) and ``--sam`` / ``--bam``
(tpufm_torch.host.sam and .bam); and of ``tpufm align`` (``cmd_align``,
:1182-1478); ``locate`` and ``align`` also over a mesh (``--mesh N``,
tpufm_torch.parallel's locate engines). ``build``, ``locate`` and ``align``
with ``--on-device --mesh N`` build over N cards from one mesh suffix sort
(tpufm_torch.index.builder_sharded); ``build ... --store-sharded`` writes a
per-shard store, which ``search --sharded`` reads onto its mesh.
``locate`` and ``align`` with ``--on-device`` build the index and the
locate tables on the card from one device suffix sort (tpufm_torch.index).
They read the same index files (.fmi, .npz, .tpufm), derive the k=1 tail
the same way, share the ``<index>.lut<M>.npz`` LUT cache, print the same
``TIME:`` line (search and count: mean seconds per pass after one warm-up
pass) and write byte-identical ``.res``, ``.cnt``, ``.pos``, ``.pairs``,
SAM and BAM files (minus-strand results of ``--rc`` in ``<out>.rc``).
``search --resume`` and ``locate --resume`` (exact positions only) stream
the reads in waves checkpointed beside the output (tpufm_torch.host.stream,
tpufm/cli.py:365-376, :1071-1093), and continue a killed run, also one of
tpufm's. ``transform`` (:158) writes the interleaved and alternate-counters
images of a baseline .fmi; ``dumpentry`` (:707), ``diff`` (:1871) and
``dumpbwt`` (:1888) print as tpufm's do. ``--device`` defaults to cuda and
never falls back to the CPU; the host-only commands take no --device.
``--trace DIR`` before any command (the port's own) profiles it and writes
``DIR/trace.json`` (tpufm_torch.profiling.trace): its kernels and copies,
and the program's spans, the engines' ``tpufm.*`` and the stages'
``tpufm.cli.<stage>``, on one clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from tpufm_torch import bench, profiling, sweep, tools
from tpufm_torch.config import recommend_config
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.edit import EditExtendEngine
from tpufm_torch.engine.lf_round import lf_round_indexed
from tpufm_torch.engine.locate import LocateEngine
from tpufm_torch.engine.paired import PairedEndEngine
from tpufm_torch.engine.search import SearchEngine
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.seed import SeedExtendEngine
from tpufm_torch.engine.tables import ShardTables
from tpufm_torch.host.bam import bgzf_compress, read_sam_or_bam, sam_to_bam
from tpufm_torch.host.contigs import ContigMap, read_contigs
from tpufm_torch.host.formats import (
    load_npz,
    load_store,
    load_store_sharded,
    read_fmi,
    save_npz,
    save_store,
    save_store_sharded,
    write_fmi,
)
from tpufm_torch.host.index import (
    AltCountersIndex,
    IndexConfig,
    KStepFMIndex,
    Layout,
    build_index,
    derive_bwts,
    derive_tail,
)
from tpufm_torch.host.layouts import make_alt_counters
from tpufm_torch.host.locate import build_locate
from tpufm_torch.host.sam import sam_edit_records, sam_header, sam_paired_records, sam_single_records
from tpufm_torch.host.seqio import (
    VARLEN_PAD,
    decode_bases,
    fasta_num_bases,
    generate_read_pairs,
    generate_reads,
    load_queries,
    load_queries_varlen,
    load_results,
    load_query_names,
    load_query_names_packed,
    load_query_quals,
    load_query_quals_packed,
    read_reference,
    reverse_complement,
    reverse_complement_varlen,
    sniff_reads,
    write_reads_fasta,
    write_reference,
    write_results,
)
from tpufm_torch.host.stream import locate_resumable, search_resumable
from tpufm_torch.host.suffix_array import suffix_array
from tpufm_torch.index.builder_device import build_index_device, build_locate_device
from tpufm_torch.index.builder_sharded import build_index_sharded, build_locate_sharded
from tpufm_torch.index.sa_device import suffix_array_device_arr, upload_text
from tpufm_torch.index.sa_sharded import suffix_array_sharded_arr
from tpufm_torch.parallel import (
    DataParallelEngine,
    DataParallelLocate,
    DataParallelSearchLocate,
    ShardedIndexEngine,
    make_mesh,
)
from tpufm_torch.timer import Stages


@dataclasses.dataclass
class BuildRun:
    """What ``build`` did, for callers that drive the CLI in process."""

    index: KStepFMIndex
    tail: KStepFMIndex | None  # the k=1 tail index of --tail
    output: str  # the index file (the tail is <output>.tail.npz)


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
    intervals: np.ndarray | None  # uint32 [B or 2B, 2]; None when approximate
    seconds: float  # the one pass, reads in host memory to positions in host memory
    counts: np.ndarray | None = None  # uint32: sites found (--mismatches >= 2, --edits)
    overflow: np.ndarray | None = None  # bool: a seed interval past --seed-hits


@dataclasses.dataclass
class PairRun:
    """What ``locate --paired`` did."""

    pairs: np.ndarray  # uint32 [B, max_pairs, 2] (left, right) starts
    strand: np.ndarray  # uint8 [B, max_pairs]: 0 R1 plus, 1 R1 minus, 2 padding
    counts: np.ndarray  # uint32 [B] proper pairs found
    overflow: np.ndarray  # bool [B]: the pair list is a lower bound
    seconds: float  # the one pass, host reads to host pairs


@dataclasses.dataclass
class SamRun:
    """What ``align`` and ``locate --sam/--bam`` did."""

    output: str  # the SAM or BAM file
    #: host-clock seconds by stage: tables (built or loaded), reads (reads,
    #: names, qualities), reference (record map, text), setup (engine:
    #: tables to the device, LUT), engine (the passes, reads in host memory
    #: to positions in host memory), emit (SAM text), encode and bgzf (BAM),
    #: write
    stages: Stages
    #: reads of one length, and mixed lengths exact: uint32 [2B, max_hits],
    #: the B forward rows first (None where grouped by length)
    positions: np.ndarray | None = None
    overflow: np.ndarray | None = None  # bool [2B]: a seed interval past --seed-hits
    pairs: PairRun | None = None  # pairs of one mate length


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
    k = index.k if isinstance(index, ShardTables) else index.config.k
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
    return derive_tail(index.host_index() if isinstance(index, ShardTables) else index)


def search_engine(index, args, device, tail):
    """(engine, step) of ``search --engine`` on one device, as tpufm's
    ``_make_engine`` (tpufm/cli.py:390-470) builds it: xla (the fused layout,
    ``--pad-words``; an alternate-counters image searched on its slim
    counters), xla-ac (a baseline index made alternate-counters), xla-paired
    (needs ``--lut``), pallas (the fused layout of the index's base, rows
    gathered by torch indexing: ``step`` ``lf_round_indexed``)."""
    if tail is not None and args.engine in ("pallas", "xla-ac"):
        sys.exit(
            "any-length queries (tail index) are supported by --engine "
            "xla/xla-paired (single-chip, --mesh N, or --sharded); pad "
            "reads to a multiple of k for pallas/xla-ac"
        )
    lut_cache = f"{args.index}.lut{args.lut}.npz" if args.lut else None
    if args.mesh is not None or args.sharded:
        # the mesh engines (tpufm/cli.py:414-442): --mesh N splits the batch
        # over N devices, the index replicated; --sharded splits the entry
        # table over them, --routing picking the collective plan
        if args.engine == "pallas":
            sys.exit("--mesh/--sharded support engines xla and xla-ac only")
        mesh = make_mesh(args.mesh or None, device=device)  # 0 = every card
        if args.sharded:
            if args.engine == "xla-ac":
                sys.exit("--sharded uses the baseline layout; drop --engine xla-ac")
            return ShardedIndexEngine(index, mesh, routing=args.routing, lut_m=args.lut, tail_index=tail), None
        if args.engine == "xla-ac" and isinstance(index, KStepFMIndex):
            index = make_alt_counters(index)
        return DataParallelEngine(index, mesh, lut_m=args.lut, lut_cache=lut_cache, pad_words=args.pad_words,
                                  tail_index=tail), None
    if args.engine == "pallas":
        base = getattr(index, "base", index)
        return SearchEngine(base, device, lut_m=args.lut, lut_cache=lut_cache), lf_round_indexed
    if args.engine == "xla-ac" and isinstance(index, KStepFMIndex):
        index = make_alt_counters(index)
    if args.engine == "xla-paired":
        if not args.lut:
            sys.exit("--engine xla-paired requires --lut M (e.g. --lut 12)")
        return SearchEngine(index, device, layout="paired", lut_m=args.lut, lut_cache=lut_cache,
                            tail_index=tail), None
    return SearchEngine(index, device, lut_m=args.lut, lut_cache=lut_cache, pad_words=args.pad_words,
                        tail_index=tail), None


def sharded_store_meta(path: str) -> dict | None:
    """meta.json of a per-shard ``.tpufm`` store (tpufm's
    ``save_store_sharded``), or None (tpufm/cli.py:323)."""
    if not path.endswith(".tpufm"):
        return None
    try:
        with open(os.path.join(path, "meta.json")) as fp:
            meta = json.load(fp)
    except (OSError, ValueError):
        return None
    return meta if meta.get("kind") == "kstep_sharded" else None


def cmd_search(args) -> SearchRun:
    device = resolve_device(args.device)
    if sharded_store_meta(args.index):
        # a per-shard store: each shard's files onto its device, no whole-table copy
        if not args.sharded:
            sys.exit(f"{args.index} is a per-shard store; search it with "
                     "--sharded [--mesh N]")
        index = load_store_sharded(args.index, make_mesh(args.mesh or None, device=device))
    else:
        index = load_index(args.index)
    # writable once here, so the timed passes copy nothing (SearchEngine.search)
    queries = np.require(
        load_queries(args.queries, args.qrysize, args.numqueries), np.uint8, ["C", "W"]
    )
    tail = load_tail(index, args.index, args.qrysize, args.tail)
    engine, step = search_engine(index, args, device, tail)
    out = args.output or f"{args.index}.res.{'gpu' if device.type == 'cuda' else 'cpu'}"

    B = queries.shape[0]
    if args.rc:
        queries = rc_expand(queries)
    if args.resume:
        # checkpointed stream: a killed run re-invoked with the same
        # arguments continues after its last completed wave; TIME: is the
        # waves' search seconds, the checkpoint writes left out
        stats: dict = {}
        res = search_resumable(engine, queries, out, stats=stats, step=step)
        dt = stats["search_s"]
        print(f"TIME: \t {dt}")
    else:
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
    lut_cache = f"{args.index}.lut{args.lut}.npz" if args.lut else None
    if args.mesh is not None:
        engine = DataParallelEngine(index, make_mesh(args.mesh or None, device=device), lut_m=args.lut,
                                    lut_cache=lut_cache, tail_index=tail)
    else:
        engine = SearchEngine(index, device, lut_m=args.lut, lut_cache=lut_cache, tail_index=tail)
    cnt, dt = _timed(lambda: engine.count(queries, mismatches=args.mismatches), args.iterations)
    out = args.output or f"{args.queries}.cnt"
    emit_strands(out, cnt, B, lambda path, a: np.savetxt(path, a, fmt="%d"))
    return CountRun(engine, cnt, dt)


def device_sort(codes: np.ndarray, device):
    """(text, suffix array) on ``device``: one upload and one suffix sort
    for every table a command builds there."""
    codes_dev = upload_text(codes, device)
    return codes_dev, suffix_array_device_arr(codes_dev)


def locate_tables(args):
    """(index, locate tables, codes): loaded from ``PREFIX.search.tpufm`` and
    ``PREFIX.locate.tpufm`` with --from-store (codes None), else built from
    the reference with one suffix sort, on the host, with --on-device on
    the card, or with --on-device --mesh N over N cards, and stored under
    --store (tpufm/cli.py:744-807)."""
    codes = None
    if args.from_store:
        index = load_store(f"{args.from_store}.search.tpufm")
        loc = load_store(f"{args.from_store}.locate.tpufm")
    else:
        codes = read_reference(args.reference, args.refsize)
        if args.on_device and args.mesh:
            # the sharded build: one mesh suffix sort for both table sets
            mesh = make_mesh(args.mesh, device=args.device)
            order = suffix_array_sharded_arr(codes, mesh)
            index = build_index_sharded(codes, IndexConfig(k=args.k, d=args.d), mesh, sa_dev=order)
            loc = build_locate_sharded(codes, sample_rate=args.sample_rate, d=args.d, mesh=mesh, sa_dev=order)
            del order
        elif args.on_device:
            cd, order = device_sort(codes, args.device)
            index = build_index_device(codes, IndexConfig(k=args.k, d=args.d), sa_dev=order, codes_dev=cd)
            loc = build_locate_device(codes, sample_rate=args.sample_rate, d=args.d, sa_dev=order, codes_dev=cd)
            del cd, order
        else:
            sa = suffix_array(codes)
            index = build_index(codes, IndexConfig(k=args.k, d=args.d), sa=sa)
            loc = build_locate(codes, sample_rate=args.sample_rate, d=args.d, sa=sa)
        if args.store:
            save_store(f"{args.store}.search.tpufm", index)
            save_store(f"{args.store}.locate.tpufm", loc)
            print(f"stored {args.store}.search.tpufm + {args.store}.locate.tpufm")
    return index, loc, codes


def write_positions(path: str, rows: np.ndarray, cmap: ContigMap | None = None, span_len: int = 0) -> None:
    """One line per read: its positions, 0xFFFFFFFF (no hit) left out, or
    with ``cmap`` their ``record:offset`` labels (``:spans`` where a
    ``span_len``-long match crosses its record's end) (tpufm/cli.py:1140-1150)."""
    rows = np.asarray(rows)
    with open(path, "w") as fp:
        if cmap is None:
            for row in rows.tolist():
                fp.write(" ".join(str(x) for x in row if x != 0xFFFFFFFF) + "\n")
            return
        labels = cmap.format(rows, query_len=span_len)
        H = rows.shape[1]
        for i in range(rows.shape[0]):
            fp.write(" ".join(s for s in labels[i * H:(i + 1) * H] if s is not None) + "\n")


def contig_map(args) -> ContigMap:
    """The reference FASTA's record map, cut at --refsize, or exit where
    there is no FASTA (tpufm/cli.py:815)."""
    if not os.path.exists(args.reference):
        sys.exit("--sam/--contigs need the reference FASTA to map record boundaries "
                 "(pass its real path even with --from-store)")
    return read_contigs(args.reference, args.refsize or None)


def cmd_locate(args) -> LocateRun | PairRun | SamRun:
    """Search, then the text positions of up to --max-hits occurrences per
    read (tpufm/cli.py:729, ``_locate_body`` :810-1154): two passes
    (``SearchEngine.search``, then ``LocateEngine.locate_hits``), one fused
    pass (``--fused``, ``SearchLocateEngine.search_locate``), within Hamming
    distance 1 (``--mismatches 1``, ``locate_mismatch``), within Hamming
    distance m >= 2 (``SeedExtendEngine``), within edit distance E
    (``--edits``, ``EditExtendEngine``), or FR pairs (``--paired R2``,
    ``PairedEndEngine``, one ``left:right:strand`` token per pair, by
    default in ``<queries>.pairs``). --contigs writes ``record:offset``
    labels instead of absolute positions; --sam writes SAM records of both
    strands (``locate_sam``, or with --paired the pairs' records), and
    --bam the same records as BAM. ``--mesh N`` runs every form over N
    devices (0: every card; tpufm/cli.py:994-1114): ``DataParallelEngine``
    then ``DataParallelLocate`` (two passes), else ``DataParallelSearchLocate``."""
    if args.bam:
        args.sam = True  # BAM is the binary form of the SAM records
    if args.mismatches < 0 or args.edits < 0:
        sys.exit("--mismatches/--edits must be >= 0")
    if args.edits and args.mismatches:
        sys.exit("--edits (indel-aware) and --mismatches (substitutions "
                 "only) are different distance models; pass one")
    if args.sam and args.rc:
        sys.exit("--sam reports both strands by definition; drop --rc")
    if args.resume and (args.sam or args.paired or args.mismatches or args.edits):
        sys.exit("locate --resume covers exact position output; drop "
                 "--sam/--paired/--mismatches/--edits")
    device = resolve_device(args.device)
    stages = Stages()
    with stages("tables"):
        index, loc, codes = locate_tables(args)
    with stages("reads"):
        queries = np.require(load_queries(args.queries, args.qrysize, args.numqueries), np.uint8, ["C", "W"])
    nq = queries.shape[0]
    if args.paired:
        return locate_paired(args, index, loc, codes, queries, device, stages)
    if args.sam:
        return locate_sam(args, index, loc, codes, queries, device, stages)
    if args.rc:
        queries = rc_expand(queries)
    intervals = counts = overflow = None
    mesh = mesh_of(args, device)
    if args.edits or args.mismatches >= 2:
        what = "--edits" if args.edits else "--mismatches >= 2"
        codes = reference_text(args, codes, f"{what} needs the reference FASTA for the verify pass "
                                            "(pass its real path even with --from-store)")
        engine = position_engine(args, index, loc, codes, device, mesh)
        t0 = time.perf_counter()
        pos, counts, overflow = approx_positions(args, engine, queries, codes)
        seconds = time.perf_counter() - t0
        if overflow.any():
            kind = "site" if args.edits else "hit"
            print(f"warning: {int(overflow.sum())} reads hit the seed-hits={args.seed_hits} cap; "
                  f"their {kind} lists are lower bounds")
    elif args.mismatches or args.fused or args.resume:
        engine = position_engine(args, index, loc, codes, device, mesh)
        t0 = time.perf_counter()
        if args.mismatches:
            pos = engine.locate_mismatch(queries)
        elif args.resume:
            # wave-checkpointed exact locate on the fused engine
            pos = locate_resumable(engine, queries, args.output or f"{args.queries}.pos")
        else:
            intervals, pos = engine.search_locate(queries)
        seconds = time.perf_counter() - t0
    else:
        # any length: the locate tables' k=1 index is the search's tail
        tail = loc.lf1 if args.qrysize % index.config.k else None
        if mesh is not None:
            search = DataParallelEngine(index, mesh, lut_m=args.lut, tail_index=tail)
            walker = DataParallelLocate(loc, mesh)
        else:
            search = SearchEngine(index, device, lut_m=args.lut, tail_index=tail)
            walker = LocateEngine(loc, device)
        t0 = time.perf_counter()
        intervals = search.search(queries)
        pos = walker.locate_hits(intervals, max_hits=args.max_hits)
        seconds = time.perf_counter() - t0
    # an edit alignment consumes up to L + E reference bases: the :spans
    # label takes that bound (the SAM writers take each alignment's span)
    cmap = contig_map(args) if args.contigs else None
    out = args.output or f"{args.queries}.pos"
    print(f"{nq} queries, max {args.max_hits} hits each")
    emit_strands(out, pos, nq, lambda path, rows: write_positions(path, rows, cmap, args.qrysize + args.edits))
    return LocateRun(pos, intervals, seconds, counts, overflow)


def reference_text(args, codes, missing: str) -> np.ndarray:
    """The reference's 2-bit codes for a verify pass: ``codes`` when the
    tables were built from it, else read again from the FASTA (with
    --from-store), exiting with ``missing`` when there is none."""
    if codes is not None:
        return codes
    if not os.path.exists(args.reference):
        sys.exit(missing)
    return read_reference(args.reference, args.refsize or None)


def mesh_of(args, device):
    """The mesh of ``--mesh N`` (N = 0: every card), or None without it."""
    n = getattr(args, "mesh", None)
    return None if n is None else make_mesh(n or None, device=device)


def position_engine(args, index, loc, codes, device, mesh=None):
    """The engine of ``single_end_positions`` for ``args``' distance model:
    ``SeedExtendEngine`` (--mismatches >= 2), ``EditExtendEngine``
    (--edits) or ``SearchLocateEngine`` (exact and --mismatches 1), or over
    ``mesh`` one ``DataParallelSearchLocate`` for all of them (tpufm/cli.py:
    249). It takes no read length, so one engine serves every length of a
    run."""
    if mesh is not None:
        return DataParallelSearchLocate(index, loc, mesh, max_hits=args.max_hits, lut_m=args.lut)
    if args.mismatches >= 2:
        return SeedExtendEngine(index, loc, codes, mismatches=args.mismatches, seed_hits=args.seed_hits,
                                max_hits=args.max_hits, lut_m=args.lut, device=device)
    if args.edits:
        return EditExtendEngine(index, loc, codes, edits=args.edits, seed_hits=args.seed_hits,
                                max_hits=args.max_hits, lut_m=args.lut, device=device)
    return SearchLocateEngine(index, loc, device, max_hits=args.max_hits, lut_m=args.lut)


def approx_positions(args, engine, queries: np.ndarray, text, **plain):
    """(positions, counts, overflow) of ``queries`` within --edits or
    --mismatches (>= 2) from ``position_engine``'s engine; a
    ``DataParallelSearchLocate`` takes ``text`` (the reference's codes) and
    the distance with the call."""
    mesh = isinstance(engine, DataParallelSearchLocate)
    if args.edits:
        extra = (text, args.edits, args.seed_hits) if mesh else ()
        return engine.locate_edits(queries, *extra, **plain)
    extra = (text, args.mismatches, args.seed_hits) if mesh else ()
    return engine.locate_approx(queries, *extra, **plain)


def single_end_positions(args, engine, queries: np.ndarray, text=None, **plain):
    """Positions of both strands of a batch of reads of one length, in one
    pass (tpufm/cli.py:265): (uint32 [2B, max_hits], the B forward rows
    first, then their reverse complements; the seed overflow flags bool
    [2B], or None for the exact and Hamming <= 1 engines). ``text``: the
    reference's codes, which a mesh engine's verify pass takes with the
    call. ``plain`` passes ``step``, ``walk`` and ``verify`` on to the
    engine."""
    q2 = np.concatenate([queries, reverse_complement(queries)])
    if args.mismatches >= 2 or args.edits:
        pos, _, overflow = approx_positions(args, engine, q2, text, **plain)
        return pos, overflow
    if args.mismatches:
        return engine.locate_mismatch(q2, **plain), None
    return engine.search_locate(q2, **plain)[1], None


def write_sam_or_bam(path: str, sam_text: str, as_bam: bool, stages: Stages) -> None:
    """The SAM text written as it is, or encoded to BAM and bgzf-framed
    (tpufm/cli.py:1481); ``stages`` gets the encode, bgzf and write times."""
    if as_bam:
        with stages("encode"):
            raw = sam_to_bam(sam_text)
        with stages("bgzf"):
            data = bgzf_compress(raw)
        with stages("write"), open(path, "wb") as fp:
            fp.write(data)
    else:
        with stages("write"), open(path, "w") as fp:
            fp.write(sam_text)


def locate_sam(args, index, loc, codes, queries: np.ndarray, device, stages: Stages) -> SamRun:
    """``locate --sam`` of single reads: both strands in one pass, forward
    rows first, then one SAM block a read (tpufm/cli.py:838-882). The text
    comes from the reference FASTA only for NM (--mismatches) and the
    verify pass (--mismatches >= 2, --edits); exact records need only the
    record map."""
    nq = queries.shape[0]
    with stages("reference"):
        cmap = contig_map(args)
        if args.from_store and (args.mismatches or args.edits):
            codes = read_reference(args.reference, args.refsize or None)
    with stages("setup"):
        engine = position_engine(args, index, loc, codes, device, mesh_of(args, device))
    with stages("engine"):
        pos, overflow = single_end_positions(args, engine, queries, codes)
    with stages("reads"):
        names = load_query_names_packed(args.queries, nq)
        quals = load_query_quals_packed(args.queries, nq)
    out = args.output or f"{args.queries}." + ("bam" if args.bam else "sam")
    with stages("emit"):
        text = sam_header(cmap, extra_pg="tpufm locate --sam")
        if args.edits:
            text += sam_edit_records(names, queries, pos[:nq], pos[nq:], cmap, codes, args.edits, quals=quals)
        else:
            text += sam_single_records(names, queries, pos[:nq], pos[nq:], cmap,
                                       codes=codes if args.mismatches else None, quals=quals)
    write_sam_or_bam(out, text, args.bam, stages)
    if overflow is not None and overflow.any():
        print(f"warning: {int(overflow.sum())} read strands hit the seed-hits={args.seed_hits} cap; "
              "their SAM records are lower bounds")
    print(f"{nq} reads, both strands")
    print(f"wrote {out}")
    return SamRun(out, stages, positions=pos, overflow=overflow)


def locate_paired(args, index, loc, codes, queries: np.ndarray, device, stages: Stages) -> PairRun | SamRun:
    """``locate --paired R2``: FR pairs of R1 (``queries``) and R2 under the
    insert window (tpufm/cli.py:903-1000), written one ``left:right:strand``
    token a pair and one line a read pair (``record:offset`` with
    --contigs), or with --sam as SAM record pairs."""
    if args.rc:
        sys.exit("--paired covers both strands by definition; drop --rc")
    verify = args.mismatches >= 2 or args.edits
    with stages("reference"):
        sam_cmap = contig_map(args) if args.sam else None
        if verify or (args.sam and args.mismatches):
            # the verify pass and the NM of Hamming records read the text
            codes = reference_text(args, codes, "--paired approximate matching needs the reference "
                                                "FASTA for the verify pass")
    with stages("reads"):
        r2 = np.require(load_queries(args.paired, args.qrysize, args.numqueries), np.uint8, ["C", "W"])
    with stages("setup"):
        engine = PairedEndEngine(
            index, loc, args.insert_min, args.insert_max, max_hits=args.max_hits, max_pairs=args.max_pairs,
            lut_m=args.lut, mismatches=args.mismatches, edits=args.edits, seed_hits=args.seed_hits,
            text=codes if verify else None, device=device, mesh=mesh_of(args, device),
        )
    t0 = time.perf_counter()
    with stages("engine"):
        pairs, strand, counts, overflow = engine.pair(queries, r2)
    seconds = time.perf_counter() - t0
    run = PairRun(pairs, strand, counts, overflow, seconds)
    if overflow.any():
        print(f"warning: {int(overflow.sum())} read pairs have a mate in a repeat wider than "
              f"max-hits={args.max_hits}; their pair lists are lower bounds")
    nq = queries.shape[0]
    summary = (f"{nq} read pairs, {int((counts > 0).sum())} properly paired "
               f"(insert [{args.insert_min}, {args.insert_max}])")
    if args.sam:
        out = args.output or f"{args.queries}." + ("bam" if args.bam else "sam")
        with stages("reads"):
            names = load_query_names(args.queries, nq)
            quals1 = load_query_quals(args.queries, nq)
            quals2 = load_query_quals(args.paired, nq)
        with stages("emit"):
            text = sam_header(sam_cmap, extra_pg="tpufm locate --paired --sam") + sam_paired_records(
                names, queries, r2, pairs, strand, sam_cmap,
                codes=codes if (args.mismatches or args.edits) else None, edits=args.edits,
                quals1=quals1, quals2=quals2)
        write_sam_or_bam(out, text, args.bam, stages)
        print(summary)
        print(f"wrote {out}")
        return SamRun(out, stages, pairs=run)
    cmap = contig_map(args) if args.contigs else None
    out = args.output or f"{args.queries}.pairs"
    P = pairs.shape[1]
    signs = np.where(strand == 0, "+", "-").tolist()
    if cmap is not None:
        labels = cmap.format(pairs.reshape(-1), query_len=args.qrysize)
        tokens = [[f"{labels[2 * (i * P + j)]}:{labels[2 * (i * P + j) + 1]}:{signs[i][j]}"
                   for j in range(P) if labels[2 * (i * P + j)] is not None] for i in range(nq)]
    else:
        pl = pairs.tolist()
        tokens = [[f"{pl[i][j][0]}:{pl[i][j][1]}:{signs[i][j]}" for j in range(P) if pl[i][j][0] != 0xFFFFFFFF]
                  for i in range(nq)]
    with open(out, "w") as fp:
        fp.write("".join(" ".join(t) + "\n" for t in tokens))
    print(summary)
    print(f"wrote {out}")
    return run


def _sniff_reads(path: str):
    """(shortest, longest, count) of the reads of ``path``, or exit where
    it holds none (tpufm/cli.py:1170)."""
    lmin, lmax, count = sniff_reads(path)
    if not count:
        sys.exit(f"{path}: no reads found")
    return lmin, lmax, count


def cmd_align(args) -> SamRun:
    """Reference FASTA and FASTA/FASTQ reads to SAM v1.6 (or BAM) in one
    command (tpufm/cli.py:1182-1478): read lengths and counts sniffed from
    the files, k=3 and d from ``recommend_config``, the prefix LUT the
    largest m <= 12 that 3 divides, 4^m no larger than the reference and m
    no longer than the shortest read. Reads of one length run through
    ``locate --sam`` (exact, --mismatches N, --edits E, -2 R2); a
    mixed-length set runs ``search_varlen`` and the walk (exact), one group
    a length (approximate), or one group a pair of mate lengths (paired),
    with the engine built once for all groups, and the blocks written in
    input order."""
    device = resolve_device(args.device)
    qmin, qlen, nreads = _sniff_reads(args.reads)
    mixed = qmin != qlen
    if args.from_store:
        meta_path = os.path.join(f"{args.from_store}.search.tpufm", "meta.json")
        try:
            with open(meta_path) as fp:
                meta = json.load(fp)
        except OSError:
            sys.exit(f"--from-store: cannot read {meta_path}")
        k, d = int(meta["k"]), int(meta["d"])
        refsize = int(meta["bwtsize"]) - 1
    else:
        if not os.path.exists(args.reference):
            sys.exit(f"{args.reference}: no such reference FASTA")
        refsize = fasta_num_bases(args.reference)
        # k=3 at any length: the locate tables' k=1 index finishes the
        # L mod 3 leftover characters
        k, d = 3, recommend_config(refsize, query_len=qlen)["d"]
    pair_mixed = False
    if args.paired:
        qmin2, qlen2, nreads2 = _sniff_reads(args.paired)
        if nreads2 != nreads:
            sys.exit(f"mate files disagree: {args.reads} has {nreads} reads, {args.paired} has {nreads2}")
        pair_mixed = mixed or qmin2 != qlen2 or qlen2 != qlen
        qmin = min(qmin, qmin2)  # the LUT must fit the shortest mate
    if args.lut is not None:
        lut = args.lut
    elif qmin >= 24:
        lut = next((m for m in range(12 - (12 % k), 0, -k) if 4**m <= refsize and m <= qmin), 0)
    else:
        lut = 0
    print(f"align: {nreads} x " + (f"{qmin}-{qlen}" if mixed else f"{qlen}") + " bp"
          + (" pairs" if args.paired else " reads") + f", reference {refsize} bases, k={k} d={d} lut={lut}")
    ns = argparse.Namespace(
        reference=args.reference, refsize=refsize, queries=args.reads, qrysize=qlen, numqueries=nreads,
        k=k, d=d, sample_rate=args.sample_rate, max_hits=args.max_hits, fused=True, store=args.store,
        from_store=args.from_store, rc=False, mismatches=args.mismatches, edits=args.edits,
        seed_hits=args.seed_hits, paired=args.paired, insert_min=args.insert_min, insert_max=args.insert_max,
        max_pairs=args.max_pairs, lut=lut, sam=True, bam=args.bam, contigs=False, output=args.output,
        device=args.device, on_device=args.on_device, resume=False, mesh=args.mesh,
    )
    if args.paired and pair_mixed:
        return _align_paired_grouped(args, ns, device)
    if mixed and (args.mismatches or args.edits):
        return _align_grouped(args, ns, device)
    if mixed:
        return _align_varlen(args, ns, device)
    return cmd_locate(ns)


def _align_paired_grouped(args, ns, device) -> SamRun:
    """Mixed-length or unequal-length mates (tpufm/cli.py:1278-1354): one
    ``PairedEndEngine`` for the run, one pass a (L1, L2) pair of mate
    lengths, the record blocks back in input order."""
    stages = Stages()
    need_text = bool(args.mismatches or args.edits)
    with stages("tables"):
        index, loc, codes = locate_tables(ns)
    with stages("reference"):
        if need_text and codes is None:
            codes = read_reference(args.reference, ns.refsize or None)
        cmap = read_contigs(args.reference, ns.refsize or None)
    with stages("reads"):
        b1 = load_queries_varlen(args.reads, ns.numqueries)
        b2 = load_queries_varlen(args.paired, ns.numqueries)
        names = load_query_names(args.reads, ns.numqueries)
        quals1 = load_query_quals(args.reads, ns.numqueries)
        quals2 = load_query_quals(args.paired, ns.numqueries)
    l1 = (b1 != VARLEN_PAD).sum(axis=1)
    l2 = (b2 != VARLEN_PAD).sum(axis=1)
    with stages("setup"):
        engine = PairedEndEngine(
            index, loc, args.insert_min, args.insert_max, max_hits=args.max_hits, max_pairs=args.max_pairs,
            lut_m=ns.lut, mismatches=args.mismatches, edits=args.edits, seed_hits=args.seed_hits,
            text=codes if (args.mismatches >= 2 or args.edits) else None, device=device,
            mesh=mesh_of(ns, device),
        )
    B = ns.numqueries
    blocks = [None] * B
    paired = overflowed = 0
    combos = sorted({(int(a), int(b)) for a, b in zip(l1, l2)})
    for L1, L2 in combos:
        sel = np.flatnonzero((l1 == L1) & (l2 == L2))
        r1g = np.ascontiguousarray(b1[sel, b1.shape[1] - L1:])
        r2g = np.ascontiguousarray(b2[sel, b2.shape[1] - L2:])
        with stages("engine"):
            pairs, strand, counts, overflow = engine.pair(r1g, r2g)
        paired += int((counts > 0).sum())
        overflowed += int(overflow.sum())
        with stages("emit"):
            group = sam_paired_records(
                [names[i] for i in sel], r1g, r2g, pairs, strand, cmap,
                codes=codes if need_text else None, edits=args.edits, return_blocks=True,
                quals1=None if quals1 is None else [quals1[i] for i in sel],
                quals2=None if quals2 is None else [quals2[i] for i in sel])
        for j, i in enumerate(sel):
            blocks[i] = group[j]
    out = args.output or f"{args.reads}." + ("bam" if args.bam else "sam")
    with stages("emit"):
        text = sam_header(cmap, extra_pg="tpufm align --paired (mixed-length)") + "\n".join(
            line for blk in blocks for line in blk) + "\n"
    write_sam_or_bam(out, text, args.bam, stages)
    if overflowed:
        print(f"warning: {overflowed} read pairs have a mate in a repeat wider than "
              f"max-hits={args.max_hits}; their pair lists are lower bounds")
    print(f"{B} mixed-length read pairs ({len(combos)} length combos), {paired} "
          f"properly paired (insert [{args.insert_min}, {args.insert_max}])")
    print(f"wrote {out}")
    return SamRun(out, stages)


def _align_grouped(args, ns, device) -> SamRun:
    """Mixed-length reads within --mismatches or --edits (tpufm/cli.py:
    1355-1424): one engine for the run, one pass a read length, the record
    blocks back in input order."""
    stages = Stages()
    with stages("tables"):
        index, loc, codes = locate_tables(ns)
    with stages("reference"):
        if codes is None:
            codes = read_reference(args.reference, ns.refsize or None)
        cmap = read_contigs(args.reference, ns.refsize or None)
    with stages("reads"):
        batch = load_queries_varlen(args.reads, ns.numqueries)
        names = load_query_names(args.reads, ns.numqueries)
        quals = load_query_quals(args.reads, ns.numqueries)
    lengths = (batch != VARLEN_PAD).sum(axis=1)
    with stages("setup"):
        engine = position_engine(ns, index, loc, codes, device, mesh_of(ns, device))
    B = ns.numqueries
    blocks = [None] * B
    overflowed = 0
    for L in sorted({int(x) for x in lengths}):
        sel = np.flatnonzero(lengths == L)
        qL = np.ascontiguousarray(batch[sel, batch.shape[1] - L:])
        nL = sel.size
        with stages("engine"):
            pos, ovf = single_end_positions(ns, engine, qL, codes)
        if ovf is not None:
            overflowed += int(ovf.sum())
        gnames = [names[i] for i in sel]
        gquals = None if quals is None else [quals[i] for i in sel]
        with stages("emit"):
            if args.edits:
                group = sam_edit_records(gnames, qL, pos[:nL], pos[nL:], cmap, codes, args.edits,
                                         return_blocks=True, quals=gquals)
            else:
                group = sam_single_records(gnames, qL, pos[:nL], pos[nL:], cmap, codes=codes,
                                           return_blocks=True, quals=gquals)
        for j, i in enumerate(sel):
            blocks[i] = group[j]
    out = args.output or f"{args.reads}." + ("bam" if args.bam else "sam")
    with stages("emit"):
        text = sam_header(cmap, extra_pg="tpufm align (mixed-length)") + "\n".join(
            line for blk in blocks for line in blk) + "\n"
    write_sam_or_bam(out, text, args.bam, stages)
    if overflowed:
        print(f"warning: {overflowed} read strands hit the seed-hits={args.seed_hits} cap; "
              "their SAM records are lower bounds")
    print(f"{B} mixed-length reads ({len(set(lengths.tolist()))} lengths), both strands")
    print(f"wrote {out}")
    return SamRun(out, stages)


def _align_varlen(args, ns, device) -> SamRun:
    """Mixed-length exact alignment (tpufm/cli.py:1425-1477): both strands
    of the right-aligned batch through one ``search_varlen`` (the locate
    tables' k=1 index as its tail), the walk, and SAM records at each
    read's own length."""
    stages = Stages()
    with stages("tables"):
        index, loc, _ = locate_tables(ns)
    with stages("reads"):
        batch = load_queries_varlen(args.reads, ns.numqueries)
    lengths = (batch != VARLEN_PAD).sum(axis=1)
    q2 = np.concatenate([batch, reverse_complement_varlen(batch)])
    tail = loc.lf1 if index.config.k > 1 else None
    with stages("setup"):
        mesh = mesh_of(ns, device)
        if mesh is not None:
            search = DataParallelEngine(index, mesh, lut_m=ns.lut, tail_index=tail)
            walker = DataParallelLocate(loc, mesh)
        else:
            search = SearchEngine(index, device, lut_m=ns.lut, tail_index=tail)
            walker = LocateEngine(loc, device)
    with stages("engine"):
        pos = walker.locate_hits(search.search_varlen(q2), max_hits=args.max_hits)
    B = ns.numqueries
    with stages("reference"):
        cmap = read_contigs(args.reference, ns.refsize or None)
    with stages("reads"):
        names = load_query_names_packed(args.reads, B)
        quals = load_query_quals_packed(args.reads, B)
    out = args.output or f"{args.reads}." + ("bam" if args.bam else "sam")
    with stages("emit"):
        text = sam_header(cmap, extra_pg="tpufm align (mixed-length)") + sam_single_records(
            names, batch, pos[:B], pos[B:], cmap, lengths=lengths, quals=quals)
    write_sam_or_bam(out, text, args.bam, stages)
    print(f"{B} mixed-length reads, both strands")
    print(f"wrote {out}")
    return SamRun(out, stages, positions=pos)


def cmd_build(args) -> BuildRun:
    """The k-step FM-index of a FASTA reference, built on the host (with
    --sa device its suffix sort on the card) or with --on-device wholly on
    the card (``--device``), or with --on-device --mesh N over N cards
    (with --store-sharded its tables written a shard at a time into a
    per-shard .tpufm store), as an .fmi image (the default name
    ``<ref>.<refsize>.<d>fmi<k>steps.fmi``), an .npz archive or a .tpufm
    store; with --tail also its k=1 tail index (``<out>.tail.npz``) from the
    same suffix sort; with --save-ref the reference re-emitted as
    ``<ref>.<refsize>.fa`` (tpufm/cli.py:54)."""
    codes = read_reference(args.reference, args.refsize)
    if args.auto:
        rec = recommend_config(args.refsize)
        args.k, args.d = rec["k"], rec["d"]
        print(f"auto config: k={args.k} d={args.d} (recommend lut_m={rec['lut_m']})")
    t0 = time.perf_counter()
    if args.mesh and not args.on_device:
        sys.exit("build --mesh requires --on-device (the sharded build runs "
                 "on the accelerator mesh; the host build has no mesh mode)")
    if args.store_sharded and not (args.mesh and args.on_device):
        sys.exit("--store-sharded persists the device-resident sharded "
                 "tables; it requires --on-device --mesh N")
    if args.store_sharded and not (args.output or "").endswith(".tpufm"):
        sys.exit("--store-sharded writes a .tpufm store; pass "
                 "--output <name>.tpufm")
    method = "native" if args.sa == "auto" else args.sa
    # one suffix sort for the index and its tail; at k=1 the index is the tail
    want_tail = args.tail and args.k != 1
    tail = None
    if args.on_device and args.mesh:
        # the sharded build; --store-sharded keeps the tables on the shards
        mesh = make_mesh(args.mesh, device=args.device)
        order = suffix_array_sharded_arr(codes, mesh)
        index = build_index_sharded(codes, IndexConfig(k=args.k, d=args.d), mesh, sa_dev=order,
                                    return_host=not args.store_sharded)
        if want_tail:
            tail = build_index_sharded(codes, IndexConfig(k=1, d=args.d), mesh, sa_dev=order)
        del order
    elif args.on_device:
        cd, order = device_sort(codes, args.device)
        index = build_index_device(codes, IndexConfig(k=args.k, d=args.d), sa_dev=order, codes_dev=cd)
        if want_tail:
            tail = build_index_device(codes, IndexConfig(k=1, d=args.d), sa_dev=order, codes_dev=cd)
        del cd, order
    else:
        sa = suffix_array(codes, method, device=args.device) if want_tail or method in ("device", "sharded") else None
        index = build_index(codes, IndexConfig(k=args.k, d=args.d), sa_method=method, sa=sa)
        if want_tail:
            tail = build_index(codes, IndexConfig(k=1, d=args.d), sa=sa)
        del sa
    if args.tail and args.k == 1:
        tail = index.host_index() if isinstance(index, ShardTables) else index
    print(f"built k={args.k} d={args.d} bwtsize={index.bwtsize} "
          f"entries={index.nentries} in {time.perf_counter() - t0:.1f}s"
          f"{' (on device)' if args.on_device else ''}")
    out = args.output or f"{args.reference}.{args.refsize}.{args.d}fmi{args.k}steps.fmi"
    if args.store_sharded:
        save_store_sharded(out, index)
    elif out.endswith(".tpufm"):
        save_store(out, index)
    elif out.endswith(".npz"):
        save_npz(out, index)
    else:
        write_fmi(out, index)
    print(f"wrote {out}")
    if tail is not None:
        save_npz(f"{out}.tail.npz", tail)
        print(f"wrote {out}.tail.npz (k=1 any-length tail index)")
    if args.save_ref:
        write_reference(f"{args.reference}.{args.refsize}.fa", decode_bases(codes))
    return BuildRun(index, tail, out)


def cmd_genreads(args) -> None:
    """Reads sampled from a FASTA reference as a .qry multi-FASTA with
    '>ridN start-end' headers (default name ``Q-<num>_B-<length>_R-<refsize>
    .qry``), or with --paired FR pairs as ``<out>_1.qry`` and ``<out>_2.qry``
    (tpufm/cli.py:174)."""
    codes = read_reference(args.reference, args.refsize)
    if args.paired:
        r1, r2, (ls, rs, minus) = generate_read_pairs(
            codes, args.length, args.num, args.insert_min, args.insert_max,
            seed=args.seed, return_truth=True,
        )
        base = args.output or f"Q-{args.num}_B-{args.length}_R-{args.refsize}"
        if base.endswith(".qry"):
            base = base[:-4]
        write_reads_fasta(base + "_1.qry", r1, np.where(minus, rs, ls))
        write_reads_fasta(base + "_2.qry", r2, np.where(minus, ls, rs))
        print(f"wrote {base}_1.qry + {base}_2.qry ({args.num} FR pairs x {args.length} bp, "
              f"insert [{args.insert_min}, {args.insert_max}])")
        return
    reads, starts = generate_reads(codes, args.length, args.num, seed=args.seed, return_starts=True)
    out = args.output or f"Q-{args.num}_B-{args.length}_R-{args.refsize}.qry"
    write_reads_fasta(out, reads, starts)
    print(f"wrote {out} ({args.num} reads x {args.length} bp)")


def cmd_transform(args) -> None:
    """Write the alternate layouts of a baseline .fmi (tpufm/cli.py:158):
    ``<index>.interleaving`` (tag 101), ``.ac`` (200) and
    ``.interleaving.ac`` (201), the reference's tfmiBMP and tfmiAC steps."""
    index, layout = read_fmi(args.index)
    if layout != Layout.BASELINE:
        sys.exit("transform expects a tag-100 baseline .fmi")
    for name in args.layouts:
        target = Layout(name)
        suffix = {
            Layout.INTERLEAVED: ".interleaving",
            Layout.ALT_COUNTERS: ".ac",
            Layout.INTERLEAVED_ALT_COUNTERS: ".interleaving.ac",
        }[target]
        out = args.index + suffix
        write_fmi(out, index, target)
        print(f"wrote {out}")


def cmd_dumpentry(args) -> None:
    """Print entries' counters and bitmap words, the transforms' debug mode
    (tpufm/cli.py:707): the stored half rows ``occ_slim`` of an
    alternate-counters image, else the full counter rows."""
    index = load_index(args.index)
    if isinstance(index, AltCountersIndex):
        occ, base = index.occ_slim, index.base
        label = "counters (slim half)"
    else:
        occ, base = index.occ, index
        label = "counters"
    for e in range(args.entry, min(args.entry + args.num, base.nentries + 1)):
        print(f"entry {e}:")
        print(f"  {label}:", occ[e].tolist())
        for lvl in range(base.config.k):
            for plane in range(2):
                words = [f"{w:08x}" for w in base.bitmaps[e, lvl, plane]]
                print(f"  bwt{lvl} plane{plane}: {' '.join(words)}")


def cmd_diff(args) -> None:
    """Compare two .res files (tpufm/cli.py:1871): ``IDENTICAL: n
    intervals``, else the first differing queries and a non-zero exit."""
    a = load_results(args.a)
    b = load_results(args.b)
    if a.shape != b.shape:
        sys.exit(f"DIFFER: {a.shape[0]} vs {b.shape[0]} results")
    bad = np.flatnonzero((a != b).any(axis=1))
    if bad.size:
        for i in bad[:10]:
            print(f"  query {i}: {a[i].tolist()} vs {b[i].tolist()}")
        sys.exit(f"DIFFER: {bad.size}/{a.shape[0]} intervals mismatch")
    print(f"IDENTICAL: {a.shape[0]} intervals")


def cmd_dumpbwt(args) -> None:
    """Print the k BWT strings of a reference (tpufm/cli.py:1888)."""
    codes = read_reference(args.reference, args.refsize)
    bwts, dollar_pos = derive_bwts(codes, args.k)
    for i, (s, dp) in enumerate(zip(bwts, dollar_pos)):
        print(f"BWT{i} dollarPosition={dp}")
        print(s.decode())


def cmd_bench(args) -> dict:
    """One bench record (tpufm_torch.bench), printed as one JSON line, by
    tpufm's dispatch (tpufm/cli.py:508): --genome, --paired, --edits,
    --mismatches, --locate --fused, --locate (over ``--mesh N`` devices, or
    every card with --multichip), --sharded, --multichip (over ``--mesh N``
    devices, default every card), else the search record."""
    if args.mismatches < 0 or args.edits < 0:
        sys.exit("--mismatches/--edits must be >= 0")
    resolve_device(args.device)  # no CPU fallback: fail before any build
    if args.genome:
        record = bench.run_bench_genome(
            refsize=args.refsize if args.refsize is not None else 250_000_000,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
            device=args.device,
        )
        print(json.dumps(record))
        return record
    args.refsize = args.refsize if args.refsize is not None else 10_000_000
    args.lut = args.lut if args.lut is not None else 0
    if args.edits and args.mismatches:
        sys.exit("--edits (indel-aware) and --mismatches (substitutions "
                 "only) are different distance models; pass one")
    common = dict(refsize=args.refsize, iterations=args.iterations, seed=args.seed, device=args.device)
    located = dict(k=args.k, d=args.d, sample_rate=args.sample_rate, query_len=args.length,
                   lut_m=args.lut, max_hits=args.max_hits, **common)
    if args.paired_bench:
        if args.edits or args.mismatches or args.locate or args.sharded or args.multichip:
            sys.exit("--paired is its own bench mode; drop "
                     "--edits/--mismatches/--locate/--sharded/--multichip")
        record = bench.run_bench_paired(num_pairs=args.numqueries, insert_min=args.insert_min,
                                        insert_max=args.insert_max, **located)
        print(json.dumps(record))
        return record
    if (args.edits or args.mismatches >= 2) and (args.locate or args.sharded or args.multichip):
        sys.exit("bench --edits/--mismatches>=2 are single-chip records; "
                 "drop --locate/--sharded/--multichip")
    if args.edits:
        record = bench.run_bench_edit(num_queries=args.numqueries, edits=args.edits,
                                      seed_hits=args.seed_hits, **located)
    elif args.mismatches >= 2:
        record = bench.run_bench_seed(num_queries=args.numqueries, mismatches=args.mismatches,
                                      seed_hits=args.seed_hits, **located)
    elif args.mismatches:
        record = bench.run_bench_mismatch(
            k=args.k, d=args.d, num_queries=args.numqueries, query_len=args.length,
            lut_m=args.lut, **common)
    elif args.locate and args.fused:
        record = bench.run_bench_search_locate(
            k=args.k, d=args.d, sample_rate=args.sample_rate, num_queries=args.numqueries,
            query_len=args.length, lut_m=args.lut, max_hits=args.max_hits, **common)
    elif args.locate:
        record = bench.run_bench_locate(
            d=args.d, sample_rate=args.sample_rate, num_rows=args.numqueries,
            n_devices=(args.mesh or None) if args.multichip or args.mesh else 1, **common)
    elif args.sharded:
        record = bench.run_bench_sharded(
            k=args.k, d=args.d, num_queries=args.numqueries, query_len=args.length,
            lut_m=args.lut, routing=args.routing, n_devices=args.mesh or None, **common)
    elif args.multichip:
        record = bench.run_bench_multichip(
            k=args.k, d=args.d, num_queries=args.numqueries, query_len=args.length,
            lut_m=args.lut, n_devices=args.mesh or None, **common)
    else:
        record = bench.run_bench(
            k=args.k, d=args.d, num_queries=args.numqueries, query_len=args.length,
            engine=args.engine, lut_m=args.lut, **common)
    print(json.dumps(record))
    return record


def cmd_sweep(args) -> list:
    """The (refsize x k x d x engine x lut) matrix (tpufm_torch.sweep), one
    JSON line a row; exits non-zero if a row is not bit-exact
    (tpufm/cli.py:683-705)."""
    records = sweep.run_sweep(
        refsizes=tuple(args.refsizes),
        ks=tuple(args.ks),
        ds=tuple(args.ds),
        engines=tuple(args.engines),
        lut_ms=tuple(args.luts),
        num_queries=args.numqueries,
        query_len=args.length,
        iterations=args.iterations,
        out_path=args.output,
        device=args.device,
    )
    bad = [r for r in records if r.get("bit_exact") is False]
    if bad:
        sys.exit(
            f"SWEEP FAILED: {len(bad)}/{len(records)} rows not bit-exact "
            f"vs oracle (first: {bad[0]})"
        )
    return records


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
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="profile the command (torch.profiler) and write DIR/trace.json: its "
                        "device work and the program's tpufm.* spans on one clock")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="build a k-step FM-index from FASTA (on the host, or on the card)")
    b.add_argument("reference")
    b.add_argument("refsize", type=int)
    b.add_argument("--k", type=int, default=2)
    b.add_argument("--d", type=int, default=64)
    b.add_argument("--auto", action="store_true",
                   help="(k, d) from recommend_config for this refsize")
    b.add_argument("--output", default=None,
                   help=".fmi (reference format), .npz, or .tpufm (memory-mapped store)")
    b.add_argument("--sa", default="auto", choices=["auto", "native", "doubling", "device", "sharded"],
                   help="suffix sort: auto = native (SA-IS); device = prefix doubling on --device; "
                        "sharded = prefix doubling over every card (one CPU shard with --device cpu)")
    b.add_argument("--on-device", action="store_true",
                   help="build the whole index on --device (tpufm_torch.index.builder_device)")
    b.add_argument("--mesh", type=int, default=0,
                   help="with --on-device: build sharded over an N-device mesh "
                        "(tpufm_torch.index.builder_sharded)")
    b.add_argument("--store-sharded", action="store_true",
                   help="with --on-device --mesh N: write one table file per "
                        "shard into --output X.tpufm (search it with --sharded)")
    b.add_argument("--save-ref", action="store_true",
                   help="also write the reference as <ref>.<refsize>.fa")
    b.add_argument("--tail", action="store_true",
                   help="also build a k=1 tail index (<out>.tail.npz) so that "
                        "search accepts any query length")
    _add_device(b)
    b.set_defaults(fn=cmd_build)

    g = sub.add_parser("genreads", help="sample a query workload")
    g.add_argument("reference")
    g.add_argument("refsize", type=int)
    g.add_argument("length", type=int)
    g.add_argument("num", type=int)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--output", default=None)
    g.add_argument("--paired", action="store_true",
                   help="sample FR read pairs instead: <out>_1.qry + <out>_2.qry")
    g.add_argument("--insert-min", type=int, default=200, help="--paired: smallest fragment length")
    g.add_argument("--insert-max", type=int, default=600, help="--paired: largest fragment length")
    g.set_defaults(fn=cmd_genreads)

    t = sub.add_parser("transform", help="emit alternate index layouts")
    t.add_argument("index")
    t.add_argument("--layouts", nargs="+",
                   default=["interleaved", "alt_counters", "interleaved_alt_counters"])
    t.set_defaults(fn=cmd_transform)

    s = sub.add_parser("search", help="batch exact backward search")
    _add_io(s, iterations=5)
    s.add_argument("--engine", default="xla", choices=["xla", "xla-ac", "xla-paired", "pallas"],
                   help="xla: K1 loads its own rows (K8 on an alternate-counters image); "
                        "xla-ac: K8 on the alternate counters; xla-paired: K1's paired "
                        "entry (needs --lut); pallas: rows gathered by torch indexing, then "
                        "K1 on the gathered rows")
    s.add_argument("--pad-words", type=int, default=None,
                   help="pad every fused row to this many words")
    s.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="run data-parallel over an N-device mesh (0 = every "
                        "card); index replicated, batch split")
    s.add_argument("--sharded", action="store_true",
                   help="split the entry table over the mesh (indexes "
                        "larger than one card's memory); baseline layout only")
    s.add_argument("--routing", default="allgather", choices=["allgather", "ring", "a2a"],
                   help="collective plan for --sharded lookups")
    s.add_argument("--resume", action="store_true",
                   help="checkpoint each wave; a re-run with the same "
                        "arguments continues after a crash")
    s.set_defaults(fn=cmd_search)

    c = sub.add_parser("count", help="occurrence counts per read (exact or <=1 mismatch)")
    _add_io(c, iterations=1)
    c.add_argument("--mismatches", type=int, default=0, choices=[0, 1],
                   help="1 = count occurrences within Hamming distance 1 "
                        "(each read's 3L+1 variants searched on the device)")
    c.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="data-parallel counting over an N-device mesh (0 = every card)")
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
    lc.add_argument("--mismatches", type=int, default=0,
                    help="positions of occurrences within this Hamming distance: 1 = "
                         "on-device variant expansion; >= 2 = pigeonhole seed-and-extend "
                         "(needs the reference FASTA for the verify pass, also with "
                         "--from-store)")
    lc.add_argument("--edits", type=int, default=0, metavar="E",
                    help="indel-aware: distinct alignment start sites within edit distance "
                         "E (pigeonhole seeds + the Myers verify; needs the reference FASTA, "
                         "also with --from-store)")
    lc.add_argument("--seed-hits", type=int, default=32,
                    help="mismatches >= 2 / edits: per-seed interval cap; reads whose seeds "
                         "exceed it are flagged (their hit list is a lower bound)")
    lc.add_argument("--paired", default=None, metavar="R2.qry",
                    help="paired-end FR placement: queries is R1, this is R2 (same length "
                         "and count); writes <out> (default <queries>.pairs), one line per "
                         "pair of left:right:strand tokens")
    lc.add_argument("--insert-min", type=int, default=0,
                    help="--paired: smallest proper fragment length")
    lc.add_argument("--insert-max", type=int, default=1000,
                    help="--paired: largest proper fragment length")
    lc.add_argument("--max-pairs", type=int, default=4,
                    help="--paired: proper pairs reported per read pair")
    lc.add_argument("--sam", action="store_true",
                    help="write SAM v1.6 instead of position lines: both strands of single reads, "
                         "or the proper pairs with --paired; needs the reference FASTA for the "
                         "record map, also with --from-store")
    lc.add_argument("--bam", action="store_true",
                    help="write the same records as bgzf-compressed BAM (implies --sam)")
    lc.add_argument("--contigs", action="store_true",
                    help="write record:offset instead of absolute positions (the reference "
                         "FASTA's record map; a match crossing a record's end is labelled "
                         "':spans')")
    lc.add_argument("--store", default=None, metavar="PREFIX",
                    help="persist PREFIX.search.tpufm + PREFIX.locate.tpufm")
    lc.add_argument("--from-store", default=None, metavar="PREFIX",
                    help="load prebuilt stores; reference/refsize are "
                         "ignored (pass '-' 0)")
    lc.add_argument("--on-device", action="store_true",
                    help="build the index and the locate tables on --device (one device suffix sort)")
    lc.add_argument("--resume", action="store_true",
                    help="checkpoint each completed wave next to the output; a killed run "
                         "re-invoked with the same arguments continues (exact positions only)")
    lc.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="data-parallel search + locate over an N-device "
                         "mesh (0 = all local devices)")
    lc.add_argument("--output", default=None)
    _add_device(lc)
    lc.set_defaults(fn=cmd_locate)

    al = sub.add_parser("align", help="reference + FASTA/FASTQ reads -> SAM v1.6 (auto-sized locate --sam)")
    al.add_argument("reference", help="reference FASTA(.gz); needed also with --from-store (the record map)")
    al.add_argument("reads", help="FASTA/FASTQ(.gz) reads; their lengths and count are read from the file")
    al.add_argument("-2", "--paired", default=None, metavar="R2", help="mate-2 reads: paired-end FR placement")
    al.add_argument("-o", "--output", default=None, help="SAM path (default <reads>.sam, <reads>.bam with --bam)")
    al.add_argument("--bam", action="store_true", help="write bgzf-compressed BAM v1 instead of SAM text")
    al.add_argument("--mismatches", type=int, default=0,
                    help="substitutions allowed a read (1: variants; >= 2: seed-and-extend)")
    al.add_argument("--edits", type=int, default=0, metavar="E",
                    help="edit distance allowed a read (seeds and the Myers verify)")
    al.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard the batch over an N-device mesh "
                         "(0 = all local devices)")
    al.add_argument("--insert-min", type=int, default=0)
    al.add_argument("--insert-max", type=int, default=1000)
    al.add_argument("--max-pairs", type=int, default=4)
    al.add_argument("--max-hits", type=int, default=16)
    al.add_argument("--seed-hits", type=int, default=32)
    al.add_argument("--sample-rate", type=int, default=32)
    al.add_argument("--lut", type=int, default=None,
                    help="prefix-LUT m (default: the largest m <= 12 that k divides, 4^m no larger "
                         "than the reference, m no longer than the shortest read)")
    al.add_argument("--on-device", action="store_true",
                    help="build the tables on --device (one device suffix sort)")
    al.add_argument("--store", default=None, metavar="PREFIX",
                    help="keep the tables as PREFIX.search.tpufm + PREFIX.locate.tpufm")
    al.add_argument("--from-store", default=None, metavar="PREFIX",
                    help="load the tables of an earlier --store run (no suffix sort)")
    _add_device(al)
    al.set_defaults(fn=cmd_align)

    be = sub.add_parser("bench", help="synthetic benchmark, one JSON line")
    be.add_argument("--refsize", type=int, default=None,
                    help="reference bases (default 10 Mbase; 250 Mbase with --genome)")
    be.add_argument("--k", type=int, default=2)
    be.add_argument("--d", type=int, default=64)
    be.add_argument("--numqueries", type=int, default=131072)
    be.add_argument("--length", type=int, default=120)
    be.add_argument("--iterations", type=_positive, default=5)
    be.add_argument("--seed", type=int, default=0)
    be.add_argument("--engine", default="xla",
                    help="xla (K1 loads its own rows), xla-split or xla-ac (K8), xla-paired "
                         "(K1's paired entry; --lut defaults to 12) or pallas (rows gathered "
                         "by torch indexing, then K1's rows entry)")
    be.add_argument("--lut", type=int, default=None,
                    help="prefix-LUT m (default: none; with --genome, recommend_config's "
                         "pick — pass 0 for LUT-free)")
    be.add_argument("--mismatches", type=int, default=0,
                    help="1 = the Hamming<=1 count record; >= 2 = the seed-and-extend "
                         "locate record")
    be.add_argument("--edits", type=int, default=0, metavar="E",
                    help="the edit-distance (Myers-verified seed-and-extend) record")
    be.add_argument("--seed-hits", type=int, default=32, help="with --mismatches>=2 / --edits")
    be.add_argument("--paired", dest="paired_bench", action="store_true",
                    help="the paired-end FR placement record (--numqueries = pairs)")
    be.add_argument("--insert-min", type=int, default=250)
    be.add_argument("--insert-max", type=int, default=450)
    be.add_argument("--genome", action="store_true",
                    help="the genome-scale record: a 250 Mbase index built on the card (on the "
                         "host with --device cpu) and cached under .bench/genome; k/d/lut from "
                         "recommend_config")
    be.add_argument("--multichip", action="store_true",
                    help="the data-parallel scaling record (DataParallelEngine)")
    be.add_argument("--sharded", action="store_true",
                    help="the sharded-index scaling record (ShardedIndexEngine, --routing)")
    be.add_argument("--routing", default="allgather", choices=["allgather", "ring", "a2a"],
                    help="with --sharded")
    be.add_argument("--locate", action="store_true",
                    help="the sampled-SA walk record (positions/s; --numqueries = rows)")
    be.add_argument("--fused", action="store_true",
                    help="with --locate: the one-pass search+locate record")
    be.add_argument("--max-hits", type=int, default=4,
                    help="positions per read (--locate --fused, --mismatches>=2, --edits, "
                         "--paired)")
    be.add_argument("--sample-rate", type=int, default=32,
                    help="locate SA sampling rate (with --locate)")
    be.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="device count of --multichip and --sharded (default: every card) "
                         "and of --locate (default 1; 0 = every card)")
    _add_device(be)
    be.set_defaults(fn=cmd_bench)

    sw = sub.add_parser("sweep", help="run the (refsize x k x d x engine) matrix")
    sw.add_argument("--refsizes", type=int, nargs="+", default=[1_000_000])
    sw.add_argument("--ks", type=int, nargs="+", default=[1, 2, 3])
    sw.add_argument("--ds", type=int, nargs="+", default=[64, 128])
    sw.add_argument("--engines", nargs="+", default=["xla"],
                    help="any of: " + " ".join(sweep.SWEEP_ENGINES))
    sw.add_argument("--luts", nargs="+", type=int, default=[0],
                    help="prefix-LUT m values to sweep (0 = no LUT)")
    sw.add_argument("--numqueries", type=int, default=65536)
    sw.add_argument("--length", type=int, default=120)
    sw.add_argument("--iterations", type=int, default=3)
    sw.add_argument("--output", default=None)
    _add_device(sw)
    sw.set_defaults(fn=cmd_sweep)

    tools.add_parsers(sub)
    de = sub.add_parser("dumpentry", help="print entry counters/bitmaps (debug)")
    de.add_argument("index")
    de.add_argument("entry", type=int)
    de.add_argument("--num", type=int, default=1)
    de.set_defaults(fn=cmd_dumpentry)

    df = sub.add_parser("diff", help="compare two .res interval files")
    df.add_argument("a")
    df.add_argument("b")
    df.set_defaults(fn=cmd_diff)

    db = sub.add_parser("dumpbwt", help="print the k BWT strings (debug)")
    db.add_argument("reference")
    db.add_argument("refsize", type=int)
    db.add_argument("--k", type=int, default=2)
    db.set_defaults(fn=cmd_dumpbwt)
    args = p.parse_args(argv)
    if args.trace is None:
        return args.fn(args)
    with profiling.trace(args.trace):
        return args.fn(args)


if __name__ == "__main__":
    main()
