"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, report.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is non-zero):
  1. the card's name and power limit (nvidia-smi); a host without CUDA exits 1
  2. build the kernels from tpufm_torch/csrc/ with nvcc
  3. K1 (the LF round kernel) against its plain PyTorch version on the card,
     seeded tables at the search's shapes (k=3 d=192 and the k=1 d=192 tail
     table of a 10 Mbase reference), 2M random interval ends through the
     per-end entry: bit-identical, and both timed with CUDA events (median
     of 7 after a warm-up)
  4. the main path: a seeded 10 Mbase reference, k=3 d=192 index, 1,048,576
     x 120 bp reads, ``python -m tpufm_torch.cli search ... --lut 12
     --device cuda`` in process, every round through K1's pair entry; every
     interval checked against the plain path on the card and the first
     65,536 against the numpy oracle, and the prefix LUT K1 built against
     the LUT the plain rounds build
 3b. (printed after phase 4) K1 at the main path's shape: phase 4's first
     wave replayed round by round (ending on phase 4's intervals), the (iv,
     code) of rounds 1 and 18 captured; the pair entry bit-identical to
     plain there, timed beside its bound and the per-end entry on the same
     ends
  5. any-length reads: 65,536 x 151 bp (one k=1 tail round per read)
  6. K1's rows entry (``lf_round_rows``, 2M ends, k=3 and k=1 d=192) and K3
     (``row_gather``, tiles of rows over a persistent grid) against their
     plain versions on the card, bit-identical and timed with CUDA events:
     K3 at the search's shape (52,085 x 100 words, 2M rows), with 6-word
     rows (its word path), at probe 5's shape, over probe 35's (E, W) grid
     and, as a control, at the search's widths on a 2 MB table that stays
     whole in L2; each case prints the kernel's time, rows/s and GB/s, its bound
     and the share of it reached, ``index_select``'s time and the kernel's
     speed against it, ``out.zero_()`` (the same output bytes written
     alone) and the plain ``table[idx]``; every index stream includes E and
     E+5 (clamped); the kernels line's ``row_gather.rates`` has each case
     with its ``share``
  7. the gathered-row engines on phase 4's index and reads:
     ``SearchEngine(gather="dma")`` (K3 then K1's rows entry per round) and
     the CLI's ``--engine pallas`` (torch indexing then K1's rows entry);
     all 1M intervals equal to phase 4's
  8. variable-length reads: 1,048,576 reads sampled at 151 bp and trimmed to
     50-151 bp, written as FASTQ, loaded with ``load_queries_varlen`` and
     searched with ``search_varlen`` (lut12) on the default and the gather
     path; all equal to the plain path, the two paths equal, and the first
     65,536 equal to the numpy oracle run once per distinct length
  9. K4 (the sampled-SA walk) on locate tables at sample rate 32, d=192
     from one native suffix sort, the rows padded to 24 words as the
     engines hold them: all 10,000,001 BWT rows, bwtsize and rows past the
     table (clamped) equal to the suffix array and to the plain walk on the
     card; both timed at 1,048,576 random rows and at all rows, the kernel
     also at 262,144 (one fused-locate wave); one hop timed (a lane of 31
     hops against one of none) for the latency floor
 10. locate through the CLI on phase 4's reads, max-hits 16: two-pass with
     ``--store``, then ``--from-store --fused`` and ``--fused --rc``; the
     .pos files byte-identical, every true start found, the first 65,536
     equal to the host oracle and the plain path; ``search_locate`` and
     ``search`` + ``locate_hits`` timed
 11. wide intervals: 65,536 reads of 10 bp, no LUT, max-hits 8, fused equal
     to two-pass, each fill min(R - L, 8), each position an occurrence
 12. Hamming <= 1: ``count`` and ``locate --mismatches 1`` through the CLI
     on 65,536 x 120 bp reads (cut from 1M for the time limit), half with
     one planted substitution; counts >= 1 and equal to the plain path on
     the first 4,096, every origin found, every position within one
     substitution of its read
 13. ``build --auto --tail`` of a seeded 1 Mbase FASTA through the CLI, its
     .fmi byte-identical to ``write_fmi`` of the index built in process and
     its .tail.npz equal to the k=1 index; ``genreads`` of 65,536 x 151 bp
     and ``search`` on the built files, all equal to the oracle; then the
     bench records through ``bench`` (tpufm_torch.bench), each printed on
     its line with every ``bit_exact_*`` field true: the flagship (phase 4's
     configuration and reads, ``seconds_per_pass`` on the device beside
     ``host_seconds_per_pass`` host to host, every read checked against the
     plain rounds), ``--locate --fused --max-hits 16`` at 1M reads,
     ``--locate`` at 1M rows and ``--mismatches 1`` at 65,536 reads
 14. approximate matching on phase 10's stores (the text from the reference
     FASTA): K5 (the Hamming verify) and K6 (the Myers verify) bit-identical
     to their plain versions on the first wave of each path (65,536 reads x
     96 lanes; 8,192 x 96) and on edge cases (every offset in a word, the
     last valid start, windows past the text end, invalid lanes; L = 120 and
     151, E = 1-3), both timed on the device (a CUDA graph of back-to-back
     calls: their wrappers' host time is longer than the kernels) beside
     their bounds (K6: the larger of its bytes and its integer operations
     over the INT32 rate; and with one valid lane left, its latency
     floor), and a wrapper call each; ``locate
     --mismatches 2`` on 65,536 x 120 bp reads with two planted
     substitutions (every origin found where not flagged, the first 4,096
     equal to the plain path, 256 equal to the naive Hamming scan on the
     card); ``locate --edits 2`` on 16,384 reads with two planted edits
     (every site within 2 edits by the windowed DP, a site within 4 of
     every origin not flagged, the first 1,024 equal to the plain path);
     ``locate --paired`` on 131,072 FR pairs, insert 250-450 (every true
     pair, all equal to the plain path, 64 equal to ``pair_oracle``), and
     with ``--mismatches 2`` and ``--edits 1`` on 4,096 pairs; then the
     ``bench --mismatches 2``, ``--edits 2`` and ``--paired`` records at
     tpufm's defaults, each printed on its line with every check true; one
     more pass of the seed and the edit record under torch.profiler
     (outside the counted runs): the device time by kernel and group (K1,
     K4, K5, K6, the sorts, ``sorted_unique``, copies, the rest), its top
     operations and the device's idle share of the record's pass
Every path is driven with all launch counts set to 0 just before it and
read just after; a kernel of the path launched too few times fails the run.
Then one JSON line of kernel figures (each kernel's time beside its bound:
the bytes the call must move, each input read once and each output written
once, over 3.35 TB/s of HBM, or for K6 its integer operations over the
INT32 rate where that is longer; the one PyTorch call of the same function
where there is one; launches per pass on each path), and last the device
JSON line.
Nothing here imports jax or the JAX package tpufm: the index builder, the
read I/O and the numpy oracle are the port's own host modules
(tpufm_torch.host).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpufm_torch import SearchEngine, bench, cli, kernels
from tpufm_torch.engine import edit as edit_mod
from tpufm_torch.engine import lf_round as lf_mod
from tpufm_torch.engine import locate as loc_mod
from tpufm_torch.engine import row_gather as rg_mod
from tpufm_torch.engine import seed as seed_mod
from tpufm_torch.engine.edit import EditExtendEngine, build_peq, myers_verify, myers_verify_reference
from tpufm_torch.engine.locate import (
    LocateEngine,
    locate_tables_from_index,
    locate_walk,
    locate_walk_reference,
)
from tpufm_torch.engine.paired import PairedEndEngine, pair_oracle
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.seed import (
    SeedExtendEngine,
    hamming_to_text,
    hamming_to_text_reference,
    pack_query_words,
)
from tpufm_torch.bitops import from_u32_bits
from tpufm_torch.engine.codes import fuse_prefix_codes, fuse_round_codes
from tpufm_torch.engine.lf_round import (
    lf_round,
    lf_round_pairs,
    lf_round_pairs_reference,
    lf_round_reference,
    lf_round_rows,
    lf_round_rows_reference,
)
from tpufm_torch.engine.row_gather import row_gather, row_gather_reference
from tpufm_torch.host.formats import load_npz, load_store, write_fmi
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
from tpufm_torch.host.locate import build_locate, locate_hits
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.suffix_array import suffix_array
from tpufm_torch.host.seqio import (
    decode_bases,
    generate_read_pairs,
    generate_reads,
    load_queries,
    load_queries_varlen,
    read_reference,
    write_reads_fasta,
    write_reference,
)

REPO = Path(__file__).resolve().parent
REF_BASES = 10_000_000
K, D, LUT_M = 3, 192, 12
READS, READ_LEN = 1 << 20, 120
ORACLE_READS = 1 << 16
TAIL_READS, TAIL_LEN = 1 << 16, 151
K1_ENDS = 2 << 20
SEED = 20261016
#: K3 cases (label, rows E, words W, gathered rows N): the search's shape
#: (the 10 Mbase k=3 d=192 table, both ends of 1M reads), 6-word rows (the
#: word path), probe 5's shape, probe 35's (E, W) grid, and a control: the
#: search's widths on a 2 MB table, which stays whole in L2
GATHER_CASES = [
    ("search", 52_085, 100, 2 << 20),
    ("words", 52_085, 6, 2 << 20),
    ("P5", 156_256, 128, 1 << 17),
] + [("P35", E, W, 1 << 20) for E in (208_000, 2_000_000) for W in (8, 32, 88, 128)] + [
    ("2MB", 5_000, 100, 2 << 20)]
VARLEN_READS, VARLEN_MIN, VARLEN_MAX = 1 << 20, 50, 151
SAMPLE_RATE, MAX_HITS = 32, 16
WALK_ROWS = 1 << 20  # the walk lanes of a 1M-read locate
WALK_WAVE = 1 << 18  # the walk lanes of one fused-locate wave (about a row a read)
WIDE_READS, WIDE_LEN, WIDE_HITS = 1 << 16, 10, 8
MM_READS, MM_PLAIN = 1 << 16, 4096
#: phase 13: the FASTA that ``build --auto --tail`` indexes and the reads
#: ``genreads`` samples from it (151 bp: one k=1 tail round after the LUT)
BUILD_BASES, BUILD_READS, BUILD_LEN = 1_000_000, 1 << 16, 151
#: phase 13: timed passes of the bench records (the Hamming <= 1 record's own)
BENCH_PASSES, MM_PASSES = 5, 3
#: the rounds of phase 4's first wave whose (iv, code) phase 3b captures
CAPTURED_ROUNDS = (1, 18)
#: phase 14: seed-and-extend reads (each with APPROX_M planted substitutions),
#: those held against the plain path and the naive scan; edit-distance reads
#: (APPROX_E planted edits) and those held against the plain path; FR pairs
#: and the pairs of the approximate pairing runs
APPROX_M, APPROX_E = 2, 2
SEED_READS, SEED_PLAIN, SEED_NAIVE = 1 << 16, 4096, 256
EDIT_READS, EDIT_PLAIN = 1 << 14, 1024
PAIRS, PAIRS_APPROX, PAIRS_ORACLE = 1 << 17, 4096, 64
INSERT_MIN, INSERT_MAX = 250, 450
#: phase 14: the lanes of the synthetic edge-case grids of K5 and K6
EDGE_READS, EDGE_LANES = 64, 96
#: one H100 SXM's INT32 issue rate: 64 INT32 lanes an SM (a quarter of its
#: 128 FP32 lanes doing 2 flops an FMA: 67 TFLOP/s, NVIDIA's data sheet, so
#: the clock is 1.98 GHz) x 132 SMs x 1.98e9
INT32_OPS_PER_S = 64 * 132 * 1.98e9
#: K6's integer operations a scan step: 30 a word of the bit vectors and 18
#: for the step (counted in tpufm_torch/csrc/myers_verify.cu)
K6_OPS_PER_WORD, K6_OPS_PER_STEP = 30, 18
#: the records' fields that must be true besides the bit_exact_* ones
VERIFY_FIELDS = ("sound_vs_dp_oracle", "origin_recovered_sample")
#: HBM rate of one H100 SXM (NVIDIA's data sheet): every kernel's bound is
#: the bytes its call must move, each input read once and each output
#: written once, over this rate
HBM_BYTES_PER_S = 3.35e12

#: each kernel's wrapper and the module attribute holding its launch count
COUNTS = {
    "lf_round": (lf_mod, "LAUNCHES"),
    "lf_round_pairs": (lf_mod, "PAIRS_LAUNCHES"),
    "lf_round_rows": (lf_mod, "ROWS_LAUNCHES"),
    "row_gather": (rg_mod, "LAUNCHES"),
    "locate_walk": (loc_mod, "LAUNCHES"),
    "hamming_verify": (seed_mod, "LAUNCHES"),
    "myers_verify": (edit_mod, "LAUNCHES"),
}


def reset_counts() -> None:
    for mod, attr in COUNTS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTS.items()}


def expect_launches(path: str, counts: dict, need: dict) -> None:
    """Fail unless each kernel in ``need`` launched at least that often."""
    for name, n in need.items():
        if counts[name] < n:
            raise AssertionError(f"{path}: {name} launched {counts[name]} times, expected >= {n}")


def ptxas_summary(log: str) -> str:
    """Registers (fewest-most over its instances) of each kernel and the
    spill bytes, from ``nvcc -Xptxas -v``."""
    regs, spills, name = {}, 0, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d([A-Za-z_]+_kernel)", line)
            name = "?" if m is None else m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spills += int(m.group(1))
        elif m := re.search(r"Used (\d+) registers", line):
            regs.setdefault(name, []).append(int(m.group(1)))
    per = " ".join(f"{n} x{len(r)}: {min(r)}-{max(r)}" for n, r in regs.items())
    return f"registers {per}, spill stores {spills} B"


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` (HBM)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def touched_bytes(table: torch.Tensor, rows: torch.Tensor) -> int:
    """Bytes of the distinct rows of ``table`` that ``rows`` (clamped into
    the table) reads, each once and whole, as K3 copies them."""
    distinct = torch.unique(rows.clamp(0, table.shape[0] - 1)).numel()
    return distinct * table.shape[1] * table.element_size()


def k1_table_bytes(iv: torch.Tensor, code: torch.Tensor, k: int, d: int, nrows: int) -> int:
    """Bytes of the fused table that K1 must read for the ends ``iv`` (int64
    [N] or [N, 2], the code of a read shared by its ends), each word once:
    of every distinct row, the plane words of the windows the ends' prefixes
    cover there (2k a window, as many windows as the end of that row that
    covers the most), and each distinct (row, code) counter."""
    ends = iv.reshape(-1)
    codes = code.repeat_interleave(ends.numel() // code.numel()) & (4**k - 1)
    rows = (ends // d).clamp(max=nrows - 1)
    windows = torch.zeros(nrows, dtype=torch.int64, device=iv.device).scatter_reduce_(
        0, rows, (ends % d + 31) // 32, "amax")
    counters = torch.unique(rows * 4**k + codes).numel()
    return 4 * (2 * k * int(windows.sum()) + counters)


def cuda_ms(fn, reps: int = 7, run: int | None = None) -> float:
    """Median milliseconds of one call of ``fn`` on the card, after a
    warm-up: CUDA events around a run of ``run`` calls back to back, over
    ``run``, so that the host's time per call (a wrapper's checks and its
    launch) overlaps the kernels before it. ``run`` defaults to as many
    calls as fill about 2 ms, at most 20; run=1 times single calls."""
    def timed(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / n

    first = timed(1)  # the warm-up
    if run is None:
        run = max(1, min(20, int(2.0 / max(first, 0.1))))
    return statistics.median(timed(run) for _ in range(reps))


def graph_ms(fn, reps: int = 7, run: int = 20) -> float:
    """Median milliseconds of one call of ``fn`` on the device alone:
    ``run`` calls captured in a CUDA graph after a warm-up call, the graph
    replayed between CUDA events, median of ``reps`` replays over ``run``.
    For a kernel shorter than its wrapper's host time (checks, allocation,
    the ctypes call), which ``cuda_ms`` would measure instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(run):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / run)
    return statistics.median(times)


def k1_inputs(rng, k: int, d: int, bwtsize: int, n: int, dev):
    """Seeded tables and ends at the search's shapes: random fused rows, three
    '$' levels' metadata, ends over [0, bwtsize] with an eighth of them inside
    the '$' blocks (half of those carrying the '$' k-mer) and the end-of-text
    end bwtsize itself."""
    nb = d // 32
    rows = -(-bwtsize // d) + 1
    words = 2 * k * nb + 4**k
    entries = rng.integers(0, 1 << 32, size=(rows, words), dtype=np.uint64).astype(np.uint32)
    dpos = rng.choice(bwtsize, size=k, replace=False).astype(np.int64)
    dbase = rng.integers(0, 4**k, size=k)
    dollar = np.stack([dpos, dbase, dpos // d]).astype(np.int64)
    iv = rng.integers(0, bwtsize + 1, size=n)
    code = rng.integers(0, 4**k, size=n)
    near = rng.random(n) < 0.125
    lvl = rng.integers(0, k, size=n)
    iv[near] = np.minimum(dpos[lvl[near]] // d * d + rng.integers(0, d, size=near.sum()), bwtsize)
    same = near & (rng.random(n) < 0.5)
    code[same] = dbase[lvl[same]]
    iv[:k] = dpos
    iv[k:2 * k] = dpos + 1
    iv[2 * k] = bwtsize
    return tuple(
        torch.from_numpy(a).to(dev)
        for a in (entries.view(np.int32), iv.astype(np.int64), code.astype(np.int64), dollar)
    )


def check_k1(rng, k: int, d: int, dev) -> dict:
    args = k1_inputs(rng, k, d, REF_BASES + 1, K1_ENDS, dev)
    got = lf_round(*args, k, d)
    want = lf_round_reference(*args, k, d)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"K1 k={k} d={d}: kernel differs from plain (max abs err {err})")
    entries, iv = args[0], args[1]
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lf_round(*args, k, d)),
        "plain_ms": cuda_ms(lambda: lf_round_reference(*args, k, d)),
        # iv, code and out (int64, the port's interface: int32 would halve
        # them), and the table words the ends need
        "bound_ms": bound_ms(3 * 8 * iv.numel() + k1_table_bytes(iv, args[2], k, d, entries.shape[0])),
    }


def k1_main_shape(engine, reads: np.ndarray, want: np.ndarray, dev) -> list:
    """K1 at the main path's shape: phase 4's first wave replayed round by
    round through the pair entry, the (iv, code) entering CAPTURED_ROUNDS
    kept; the replay must end on phase 4's intervals. For each captured
    round, the pair entry against its plain version (bit-identical) and the
    per-end entry on the same ends, all timed, with the pair entry's bound."""
    q = torch.from_numpy(reads[:engine.WAVE]).to(dev)
    body = q[:, (READ_LEN - LUT_M) % K:]
    iv = from_u32_bits(engine.lut[fuse_prefix_codes(body, LUT_M)])
    captured = {}
    for j, code in enumerate(fuse_round_codes(body[:, :body.shape[1] - LUT_M], K), start=1):
        if j in CAPTURED_ROUNDS:
            captured[j] = (iv, code)
        iv = lf_round_pairs(engine.entries, iv, code, engine.dollar, K, D)
    if not np.array_equal(iv.cpu().numpy(), want[:engine.WAVE].astype(np.int64)):
        raise AssertionError("phase 3b: the replayed rounds do not end on phase 4's intervals")
    out = []
    for j, (iv, code) in captured.items():
        args = (engine.entries, iv, code, engine.dollar, K, D)
        got, ref = lf_round_pairs(*args), lf_round_pairs_reference(*args)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max())
        if err != 0 or not torch.equal(got, ref):
            raise AssertionError(f"K1 pair entry, round {j}: kernel differs from plain (max abs err {err})")
        flat, codes2 = iv.reshape(-1).contiguous(), code.repeat_interleave(2)
        blocks = iv // D
        out.append({
            "round": j, "reads": int(iv.shape[0]), "max_abs_err": err,
            "same_block_share": float((blocks[:, 0] == blocks[:, 1]).double().mean()),
            "ms": cuda_ms(lambda: lf_round_pairs(*args)),
            "plain_ms": cuda_ms(lambda: lf_round_pairs_reference(*args)),
            "per_end_ms": cuda_ms(lambda: lf_round(engine.entries, flat, codes2, engine.dollar, K, D)),
            # iv [2], out [2] and code a read (int64, the port's interface),
            # and the table words the ends need
            "bound_ms": bound_ms(5 * 8 * iv.shape[0] + k1_table_bytes(iv, code, K, D, engine.entries.shape[0])),
        })
    return out


def check_run(name, run, index, reads, tail=None) -> None:
    res = run.results
    if res.shape != (reads.shape[0], 2) or res.dtype != np.uint32:
        raise AssertionError(f"{name}: results {res.shape} {res.dtype}")
    if not (res[:, 1] > res[:, 0]).all():
        raise AssertionError(f"{name}: {(res[:, 1] <= res[:, 0]).sum()} sampled reads not found")
    plain = run.engine.search(reads, step=lf_round_reference)
    if not np.array_equal(res, plain):
        raise AssertionError(f"{name}: {(res != plain).any(1).sum()} reads differ from the plain path")
    n = min(ORACLE_READS, reads.shape[0])
    oracle = search_oracle(index, reads[:n], tail_index=tail)
    if not np.array_equal(res[:n], oracle):
        raise AssertionError(f"{name}: {(res[:n] != oracle).any(1).sum()} reads differ from the oracle")


def check_rows(rng, k: int, d: int, dev) -> dict:
    """K1's rows entry against its plain version on rows gathered by the
    plain gather, at the search's shapes."""
    entries, iv, code, dollar = k1_inputs(rng, k, d, REF_BASES + 1, K1_ENDS, dev)
    rows = row_gather_reference(entries, iv // d)
    got = lf_round_rows(rows, iv, code, dollar, k, d)
    want = lf_round_rows_reference(rows, iv, code, dollar, k, d)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"lf_round_rows k={k} d={d}: kernel differs from plain (max abs err {err})")
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lf_round_rows(rows, iv, code, dollar, k, d)),
        "plain_ms": cuda_ms(lambda: lf_round_rows_reference(rows, iv, code, dollar, k, d)),
        # iv, code and out, and the words of its row each end needs (the
        # plane words of the windows its prefix covers and one counter)
        "bound_ms": bound_ms(3 * 8 * iv.numel() + 4 * int((2 * k * ((iv % d + 31) // 32) + 1).sum())),
    }


def check_gather(gen, label: str, E: int, W: int, N: int, dev) -> dict:
    """K3 against the plain ``table[idx]`` on a seeded table and index
    stream that includes E and E+5 (clamped to the last row): bit-identical,
    timed beside the plain version, ``index_select`` and ``out.zero_()``
    (the same output bytes written alone); GB/s counts the rows read and
    written and the 8-byte indices."""
    table = torch.randint(-(1 << 31), 1 << 31, (E, W), dtype=torch.int32, device=dev, generator=gen)
    idx = torch.randint(0, E, (N,), dtype=torch.int64, device=dev, generator=gen)
    idx[:2] = torch.tensor([E, E + 5])
    out = torch.empty((N, W), dtype=torch.int32, device=dev)
    got = row_gather(table, idx, out=out)
    want = row_gather_reference(table, idx)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"row_gather {label} E={E} W={W} N={N}: kernel differs from plain (max abs err {err})")
    ms = cuda_ms(lambda: row_gather(table, idx, out=out))
    write_ms = cuda_ms(lambda: out.zero_())
    plain_ms = cuda_ms(lambda: row_gather_reference(table, idx))
    # the one PyTorch call of the same function: index_select on indices
    # already in range (it refuses E and E+5)
    inside = idx.clamp(0, E - 1)
    library_ms = cuda_ms(lambda: torch.index_select(table, 0, inside))
    gb = (2 * N * W * 4 + 8 * N) / 1e9
    # out and idx, and the distinct rows read
    bound = bound_ms(N * W * 4 + 8 * N + touched_bytes(table, idx))
    return {
        "case": label, "E": E, "W": W, "N": N,
        "path": rg_mod.plan(N, W, table.data_ptr(), out.data_ptr(), rg_mod._sms(dev)).path,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound, "share": bound / ms, "write_ms": write_ms,
        "rows_per_s": N / (ms / 1e3), "GB_per_s": gb / (ms / 1e3),
        "plain_rows_per_s": N / (plain_ms / 1e3), "plain_GB_per_s": gb / (plain_ms / 1e3),
    }


def timed_passes(fn, iterations: int = 3):
    """(result, mean seconds per pass) of ``fn`` after one warm-up pass, as
    the CLI's TIME: line measures a pass."""
    res = fn()
    t0 = time.perf_counter()
    for _ in range(iterations):
        res = fn()
    return res, (time.perf_counter() - t0) / iterations


def write_fastq(path, codes: np.ndarray, lengths: np.ndarray) -> None:
    """Reads ``codes[j, :lengths[j]]`` as 4-line FASTQ records."""
    chunk = 1 << 16
    with open(path, "wb") as fp:
        for base in range(0, codes.shape[0], chunk):
            block = codes[base:base + chunk]
            seqs = decode_bases(block)
            W = block.shape[1]
            fp.write(b"".join(
                b"@r%d\n%s\n+\n%s\n" % (base + j, seqs[j * W:j * W + n], b"I" * n)
                for j, n in enumerate(lengths[base:base + chunk].tolist())
            ))


def check_walk(loc, sa: np.ndarray, dev) -> dict:
    """K4 over every BWT row, bwtsize and rows past the table (clamped):
    equal to the suffix array and to the plain walk; both timed at
    WALK_ROWS random rows and at all rows, the kernel also at the first
    WALK_WAVE of them, on the rows as LocateEngine holds them on the device
    (padded to 24 words). Beside the bytes bound, the
    latency floor: the longest trip of the random rows times one hop, a hop
    timed as the difference between one lane that walks SAMPLE_RATE - 1
    hops and one that walks none, over SAMPLE_RATE - 1."""
    t = locate_tables_from_index(loc)
    tables = [LocateEngine(t, dev).rows, torch.from_numpy(t.samples.view(np.int32)).to(dev),
              torch.from_numpy(t.dollar.astype(np.int64)).to(dev)]
    bwtsize = sa.shape[0]
    past = [bwtsize, bwtsize + 3, bwtsize + 5 * D, (bwtsize // D + 7) * D + 11]
    p = torch.cat([torch.arange(bwtsize, dtype=torch.int64, device=dev),
                   torch.tensor(past, dtype=torch.int64, device=dev)])
    got = locate_walk(*tables, p, D, SAMPLE_RATE)
    want = locate_walk_reference(*tables, p, D, SAMPLE_RATE)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"K4: kernel differs from plain on {(got != want).sum()} rows (max abs err {err})")
    if not np.array_equal(got[:bwtsize].cpu().numpy(), sa):
        raise AssertionError("K4: walked rows differ from the suffix array")
    del want
    rnd = torch.randint(0, bwtsize, (WALK_ROWS,), dtype=torch.int64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    trips = sa[rnd.cpu().numpy()] % SAMPLE_RATE  # the row of SA value v walks v % s hops
    lanes = [torch.tensor([int(np.flatnonzero(sa % SAMPLE_RATE == h)[0])], device=dev)
             for h in (0, SAMPLE_RATE - 1)]
    one = [cuda_ms(lambda: locate_walk(*tables, lane, D, SAMPLE_RATE), reps=51, run=1) for lane in lanes]
    hop_ms = (one[1] - one[0]) / (SAMPLE_RATE - 1)
    return {
        "max_abs_err": err, "rows": int(p.shape[0]),
        "ms": cuda_ms(lambda: locate_walk(*tables, rnd, D, SAMPLE_RATE)),
        "plain_ms": cuda_ms(lambda: locate_walk_reference(*tables, rnd, D, SAMPLE_RATE)),
        "wave_ms": cuda_ms(lambda: locate_walk(*tables, rnd[:WALK_WAVE], D, SAMPLE_RATE)),
        "all_ms": cuda_ms(lambda: locate_walk(*tables, p, D, SAMPLE_RATE)),
        "all_plain_ms": cuda_ms(lambda: locate_walk_reference(*tables, p, D, SAMPLE_RATE)),
        # p and out (int64) a lane, the locate rows and the samples once:
        # ~16M hops over 52K rows visit every row at many offsets
        "bound_ms": bound_ms(2 * 8 * WALK_ROWS + sum(x.numel() * x.element_size() for x in tables[:2])),
        "mean_trip": float(trips.mean()), "longest_trip": int(trips.max()),
        "hop_ms": hop_ms, "latency_floor_ms": int(trips.max()) * hop_ms,
    }


def bench_record(label: str, argv: list, need: dict, by_path: dict) -> dict:
    """``python -m tpufm_torch.cli bench ARGV --device cuda`` in process,
    the launch counts zeroed just before and read just after (kept under
    ``label``): its one JSON line must be the record it returns, every
    ``bit_exact_*`` field and every one of ``VERIFY_FIELDS`` true and each
    kernel of ``need`` launched at least that often. The record is printed on its own line after ``label``."""
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        record = cli.main(["bench", *argv, "--device", "cuda"])
    by_path[label] = read_counts()
    lines = out.getvalue().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != record:
        raise AssertionError(f"bench {label}: printed {len(lines)} lines, not its record as one JSON line")
    flags = {key: v for key, v in record["detail"].items() if key.startswith("bit_exact") or key in VERIFY_FIELDS}
    if not flags or not all(v is True for v in flags.values()):
        raise AssertionError(f"bench {label}: {flags}")
    if record["detail"]["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench {label}: ran on {record['detail']['device']}")
    expect_launches(f"bench {label}", by_path[label], need)
    print(f"    {label}: {lines[0]}", flush=True)
    return record


@contextlib.contextmanager
def keep_pass(kept: dict):
    """Within: ``kept["fn"]`` is the pass of the last bench record run (the
    function its timed passes call, engine and reads on board), so that
    ``profile_pass`` can run one more pass outside the counted run."""
    passes = bench._passes

    def keeping(fn, iterations):
        kept["fn"] = fn
        return passes(fn, iterations)

    bench._passes = keeping
    try:
        yield kept
    finally:
        bench._passes = passes


#: the profile's groups of device operations: (label, test on the name)
PROFILE_GROUPS = (
    ("K1 lf_round", lambda n: "lf_round" in n), ("K4 locate_walk", lambda n: "locate_walk" in n),
    ("K5 hamming_verify", lambda n: "hamming_verify" in n), ("K6 myers_verify", lambda n: "myers_verify" in n),
    ("sorts", lambda n: "sort" in n.lower()), ("copies", lambda n: n.startswith(("Memcpy", "Memset"))),
)


def profile_pass(label: str, fn, pass_s: float) -> None:
    """One pass of ``fn`` under torch.profiler, printed on two lines: the
    device time (kernels, copies and sets) by group of ``PROFILE_GROUPS``
    (the rest: elementwise, reductions, scatters) and of ``sorted_unique``
    (the sort and neighbour dedup, its kernels those launched inside it),
    the top operations, each with its share of the device time, and the
    device's busy time against ``pass_s`` (the record's unprofiled mean
    pass) and the profiled pass. Launches here are not counted on a path."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def labelled(f):
        def run(*args, **kwargs):
            with record_function("sorted_unique"):
                return f(*args, **kwargs)
        return run

    plain = seed_mod.sorted_unique, edit_mod.sorted_unique
    seed_mod.sorted_unique, edit_mod.sorted_unique = labelled(plain[0]), labelled(plain[1])
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        seed_mod.sorted_unique, edit_mod.sorted_unique = plain
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    for e in events:  # the device's kernels, copies and sets; not the annotation's span
        if e.device_type == cuda and e.name != "sorted_unique":
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError(f"profile {label}: no device time traced")
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for name, ms in by_name.items():
        groups[next((g for g, test in PROFILE_GROUPS if test(name)), "other")] += ms
    dedup = sum(e.device_time_total for e in events if e.name == "sorted_unique" and e.device_type != cuda) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    share = lambda ms: f"{ms:.4f} ms ({ms / busy * 100:.1f}%)"
    print(f"    profile {label} (one pass): device busy {busy:.4f} ms of the record's {pass_s * 1e3:.4f} ms pass "
          f"(idle {(1 - busy / (pass_s * 1e3)) * 100:.1f}%; the profiled pass {wall * 1e3:.4f} ms); by group: "
          + ", ".join(f"{g} {share(ms)}" for g, ms in groups.items()) + f"; sorted_unique {share(dedup)}",
          flush=True)
    print(f"    profile {label} top device operations: "
          + "; ".join(f"{name[:90]} {share(ms)}" for name, ms in top), flush=True)


def text_windows(codes: np.ndarray, pos: np.ndarray, L: int) -> np.ndarray:
    """uint8 [N, L]: the text at each position."""
    return codes[pos.astype(np.int64)[:, None] + np.arange(L, dtype=np.int64)[None, :]]


def check_k5(text_words, pos, qwords, valid, L: int, what: str, timed: bool) -> dict:
    """K5 against its plain version on one candidate grid: bit-identical;
    with ``timed``, both timed beside the bytes bound: the valid mask and
    out over every lane (the function writes every lane), and per valid
    lane W + 1 text words, the read's W words (int64) and pos. The kernel's
    ``ms`` is its device time (``graph_ms``), ``call_ms`` the wrapper's
    back-to-back calls (``cuda_ms``), host time included, and
    ``no_valid_ms`` the device time on the same grid with no lane valid
    (the mask read and every output written: the stream alone)."""
    got = hamming_to_text(text_words, pos, qwords, valid, L)
    want = hamming_to_text_reference(text_words, pos, qwords, valid, L)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"K5 {what}: kernel differs from plain on {int((got != want).sum())} lanes "
                             f"(max abs err {err})")
    out = {"lanes": pos.numel(), "valid": int(valid.sum()), "max_abs_err": err}
    if timed:
        W = qwords.shape[1]
        nbytes = out["valid"] * ((W + 1) * 4 + W * 8 + 8) + pos.numel() * (1 + 4)
        out.update(ms=graph_ms(lambda: hamming_to_text(text_words, pos, qwords, valid, L)),
                   call_ms=cuda_ms(lambda: hamming_to_text(text_words, pos, qwords, valid, L)),
                   no_valid_ms=graph_ms(lambda: hamming_to_text(text_words, pos, qwords, torch.zeros_like(valid), L)),
                   plain_ms=cuda_ms(lambda: hamming_to_text_reference(text_words, pos, qwords, valid, L)),
                   bound_ms=bound_ms(nbytes), bound_by="bytes")
    return out


def check_k6(text_words, n_text: int, peq, lo, hi, valid, L: int, E: int, what: str, timed: bool) -> dict:
    """K6 against its plain version on one candidate grid: bit-identical;
    with ``timed``, both timed beside the bound, the larger of the bytes
    (the valid mask, dist and start over every lane, and per valid lane its
    TL/16 + 2 text words, its read's peq row (int64), lo and hi) and the
    integer operations of the valid lanes' scans over the INT32 rate; and
    the kernel on the same grid with one valid lane left (``one_lane_ms``:
    one lane's scan in a chain, beside the grid's mask and outputs), the
    latency floor of a design that runs each lane's steps in one thread.
    Kernel times are device times (``graph_ms``); ``call_ms`` is the
    wrapper's back-to-back calls (``cuda_ms``), host time included."""
    got = myers_verify(text_words, n_text, peq, lo, hi, valid, L, E)
    want = myers_verify_reference(text_words, n_text, peq, lo, hi, valid, L, E)
    torch.cuda.synchronize()
    err = max(int((got[0].long() - want[0]).abs().max()), int((got[1] - want[1]).abs().max()))
    if err != 0 or not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K6 {what}: kernel differs from plain (max abs err {err})")
    out = {"lanes": lo.numel(), "valid": int(valid.sum()), "max_abs_err": err, "L": L, "E": E}
    if timed:
        W, TL = peq.shape[-1], L + 3 * E
        nbytes = out["valid"] * ((TL // 16 + 2) * 4 + 4 * W * 8 + 16) + lo.numel() * (1 + 4 + 8)
        ops = out["valid"] * TL * (K6_OPS_PER_WORD * W + K6_OPS_PER_STEP)
        by_bytes, by_ops = bound_ms(nbytes), ops / INT32_OPS_PER_S * 1e3
        one = torch.zeros_like(valid)
        one.view(-1)[int(valid.reshape(-1).nonzero()[0])] = True
        out.update(ms=graph_ms(lambda: myers_verify(text_words, n_text, peq, lo, hi, valid, L, E)),
                   call_ms=cuda_ms(lambda: myers_verify(text_words, n_text, peq, lo, hi, valid, L, E)),
                   plain_ms=cuda_ms(lambda: myers_verify_reference(text_words, n_text, peq, lo, hi, valid, L, E)),
                   bound_ms=max(by_bytes, by_ops), bound_by="operations" if by_ops >= by_bytes else "bytes",
                   bytes_bound_ms=by_bytes, ops_bound_ms=by_ops, ops=ops,
                   one_lane_ms=graph_ms(lambda: myers_verify(text_words, n_text, peq, lo, hi, one, L, E)))
    return out


def kernel_edges(text_words, codes: np.ndarray, dev, rng) -> int:
    """K5 and K6 against their plain versions on synthetic grids over the
    reference's packed text at L = 120 and 151 (K6 at E = 1, 2, 3): starts
    at every offset in a word, the last valid start n - L, windows past the
    text end, invalid lanes. Returns the lanes checked."""
    n, lanes = codes.shape[0], 0
    shape = (EDGE_READS, EDGE_LANES)
    for L in (120, 151):
        pos = rng.integers(0, n - L + 1, size=shape)
        pos[0, :16] = 16 * 1000 + np.arange(16)
        pos[1, :3] = [n - L, n - L + 7, n]
        reads = codes[pos[:, :1] % (n - L + 1) + np.arange(L)]
        reads[::2, ::10] ^= 1
        valid = rng.random(shape) < 0.75
        valid[:2] = True
        t = [torch.from_numpy(a).to(dev) for a in (pos.astype(np.int64), reads, valid)]
        lanes += check_k5(text_words, t[0], pack_query_words(t[1]), t[2], L, f"edges L={L}", False)["lanes"]
        for E in (1, 2, 3):
            a = rng.integers(-E, n + E, size=shape)
            a[0, :4] = [n - 1 + E, n - 1, n - L, -E]
            origin = rng.integers(0, n - L - E, size=EDGE_READS)
            a[1:, 1] = origin[1:]
            reads = codes[origin[:, None] + np.arange(L)]
            reads[:, ::37] ^= 1
            valid = rng.random(shape) < 0.75
            valid[:, 1] = valid[0, :4] = True
            lo, hi = np.maximum(a - E, 0), np.minimum(a + E, n - 1)
            peq = build_peq(torch.from_numpy(reads[:, ::-1].copy()).to(dev), -(-L // 32))
            t = [torch.from_numpy(x).to(dev) for x in (lo, hi, valid)]
            lanes += check_k6(text_words, n, peq, *t, L, E, f"edges L={L} E={E}", False)["lanes"]
    return lanes


def same_arrays(what: str, got, want) -> None:
    for a, b in zip(got, want):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: differs from the plain path")


def approximate(tmp: str, ref: str, codes: np.ndarray, store: str, dev, by_path: dict, lut_launches: int) -> dict:
    """Phase 14 (see the module docstring): K5 and K6 against their plain
    versions, then ``locate --mismatches 2``, ``--edits 2`` and
    ``--paired`` (also with --mismatches 2 and --edits 1) through the CLI
    on phase 10's stores and the reference's text, each against the plain
    path and its oracle; returns the kernels' figures."""
    n = codes.shape[0]
    index_s = load_store(f"{store}.search.tpufm")
    loc_s = load_store(f"{store}.locate.tpufm")
    common = ["--from-store", store, "--lut", str(LUT_M), "--max-hits", str(MAX_HITS), "--device", "cuda"]
    plain = dict(step=lf_round_reference, walk=locate_walk_reference)
    rng = np.random.default_rng(SEED + 6)
    seed_rounds = ((READ_LEN // (APPROX_M + 1)) // K * K - LUT_M) // K  # the seeds' k-step rounds
    found = {}

    t0 = time.perf_counter()
    sreads, sstarts = generate_reads(codes, READ_LEN, SEED_READS, seed=SEED + 6, return_starts=True)
    cols = np.argsort(rng.random((SEED_READS, READ_LEN)), axis=1)[:, :APPROX_M]
    rows = np.arange(SEED_READS)[:, None]
    sreads[rows, cols] = (sreads[rows, cols] + rng.integers(1, 4, size=(SEED_READS, APPROX_M))) % 4
    sqry = os.path.join(tmp, "mm2.qry")
    write_reads_fasta(sqry, sreads, sstarts)
    reset_counts()
    srun = cli.main(["locate", ref, str(REF_BASES), sqry, str(READ_LEN), str(SEED_READS),
                     "--mismatches", str(APPROX_M), *common, "--output", os.path.join(tmp, "mm2.pos")])
    by_path["locate_mm2"] = read_counts()
    swaves = -(-SEED_READS // SeedExtendEngine.WAVE)
    expect_launches("locate --mismatches 2", by_path["locate_mm2"], {
        "lf_round_pairs": seed_rounds * swaves + lut_launches, "locate_walk": swaves, "hamming_verify": swaves})
    spos, sovf = srun.positions, srun.overflow
    if not ((spos == sstarts[:, None]).any(axis=1) | sovf).all():
        raise AssertionError("locate --mismatches 2: an origin is missing from a read not flagged")
    seng = SeedExtendEngine(index_s, loc_s, codes, mismatches=APPROX_M, max_hits=MAX_HITS, lut_m=LUT_M,
                            device=dev)
    same_arrays("locate --mismatches 2", (srun.positions[:SEED_PLAIN], srun.counts[:SEED_PLAIN],
                                          sovf[:SEED_PLAIN]),
                seng.locate_approx(sreads[:SEED_PLAIN], verify=hamming_to_text_reference, **plain))
    vidx = np.sort(np.random.default_rng(SEED + 7).choice(SEED_READS, SEED_NAIVE, replace=False))
    for i, want in zip(vidx, bench.hamming_hits(codes, sreads[vidx], APPROX_M, dev)):
        got = spos[i][spos[i] != 0xFFFFFFFF]
        ok = np.isin(got, want).all() if sovf[i] else (
            srun.counts[i] == want.size and np.array_equal(got, want[:got.size]))
        if not ok:
            raise AssertionError(f"locate --mismatches 2: read {i} differs from the naive Hamming scan")
    q = torch.from_numpy(sreads[:SeedExtendEngine.WAVE]).to(dev)
    cand, uniq, qwords, _ = seng.candidates(q)
    k5 = check_k5(seng.text_words, torch.where(uniq, cand, 0), qwords, uniq, READ_LEN, "bench shape", True)
    edge_lanes = kernel_edges(seng.text_words, codes, dev, rng)
    found["seed"] = {"seconds": srun.seconds, "overflow": int(sovf.sum()), "positions": int((spos != 0xFFFFFFFF).sum())}
    print(f"[14 approximate matching] seed-and-extend: locate --mismatches {APPROX_M} --lut {LUT_M} on "
          f"{SEED_READS} x {READ_LEN} bp, each with {APPROX_M} planted substitutions: pass {srun.seconds:.6f} s "
          f"({SEED_READS / srun.seconds:.0f} reads/s), {int(sovf.sum())} reads flagged, every origin of the others "
          f"found; first {SEED_PLAIN} equal to the plain path (plain rounds, walk, verify), {SEED_NAIVE} equal "
          f"to the naive Hamming scan on the card; launches {by_path['locate_mm2']}; K5 at the bench shape "
          f"({k5['lanes']} lanes, {k5['valid']} valid): bit-identical, kernel {k5['ms']:.4f} ms on the device "
          f"(bound {k5['bound_ms']:.4f} ms, {k5['bound_ms'] / k5['ms'] * 100:.1f}% of it; no lane valid "
          f"{k5['no_valid_ms']:.4f} ms; a wrapper call {k5['call_ms']:.4f} ms), plain {k5['plain_ms']:.4f} ms; K5 and K6 bit-identical on {edge_lanes} edge-case lanes; {time.perf_counter() - t0:.2f} s",
          flush=True)
    del seng, q, cand, uniq, qwords

    t0 = time.perf_counter()
    ereads, origins = bench.edit_reads(codes, np.random.default_rng(SEED + 8), READ_LEN, APPROX_E, EDIT_READS)
    eqry = os.path.join(tmp, "e2.qry")
    write_reads_fasta(eqry, ereads, origins)
    reset_counts()
    erun = cli.main(["locate", ref, str(REF_BASES), eqry, str(READ_LEN), str(EDIT_READS),
                     "--edits", str(APPROX_E), *common, "--output", os.path.join(tmp, "e2.pos")])
    by_path["locate_e2"] = read_counts()
    ewaves = -(-EDIT_READS // EditExtendEngine.WAVE)
    expect_launches("locate --edits 2", by_path["locate_e2"], {
        "lf_round_pairs": seed_rounds * ewaves + lut_launches, "locate_walk": ewaves, "myers_verify": ewaves})
    sound, sensitive = bench.edit_sites_check(codes, ereads, erun.positions, erun.overflow, origins, APPROX_E, dev)
    if not (sound and sensitive):
        raise AssertionError(f"locate --edits 2: sites within {APPROX_E} edits {sound}, origins near a site "
                             f"{sensitive}")
    eeng = EditExtendEngine(index_s, loc_s, codes, edits=APPROX_E, max_hits=MAX_HITS, lut_m=LUT_M, device=dev)
    same_arrays("locate --edits 2", (erun.positions[:EDIT_PLAIN], erun.counts[:EDIT_PLAIN],
                                     erun.overflow[:EDIT_PLAIN]),
                eeng.locate_edits(ereads[:EDIT_PLAIN], verify=myers_verify_reference, **plain))
    q = torch.from_numpy(ereads[:EditExtendEngine.WAVE]).to(dev)
    lo, hi, valid, peq, _ = eeng.candidates(q)
    k6 = check_k6(eeng.text_words, n, peq, lo, hi, valid, READ_LEN, APPROX_E, "bench shape", True)
    found["edit"] = {"seconds": erun.seconds, "overflow": int(erun.overflow.sum()),
                     "sites": int((erun.positions != 0xFFFFFFFF).sum())}
    print(f"    edit distance: locate --edits {APPROX_E} on {EDIT_READS} x {READ_LEN} bp, each with {APPROX_E} "
          f"planted edits: pass {erun.seconds:.6f} s ({EDIT_READS / erun.seconds:.0f} reads/s), "
          f"{found['edit']['sites']} sites, every one within {APPROX_E} edits by the windowed DP, a site within "
          f"{2 * APPROX_E} of every origin not flagged ({found['edit']['overflow']} flagged); first {EDIT_PLAIN} "
          f"equal to the plain path; launches {by_path['locate_e2']}; K6 at the bench shape ({k6['lanes']} "
          f"lanes, {k6['valid']} valid): bit-identical, kernel {k6['ms']:.4f} ms on the device (a wrapper call "
          f"{k6['call_ms']:.4f} ms; bound {k6['bound_ms']:.4f} "
          f"ms by {k6['bound_by']}: operations {k6['ops_bound_ms']:.4f}, bytes {k6['bytes_bound_ms']:.4f}; "
          f"{k6['bound_ms'] / k6['ms'] * 100:.1f}% of it; one valid lane {k6['one_lane_ms']:.4f} ms), plain "
          f"{k6['plain_ms']:.4f} ms; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del eeng, q, lo, hi, valid, peq

    t0 = time.perf_counter()
    r1, r2, (ls, rs, minus) = generate_read_pairs(codes, READ_LEN, PAIRS, INSERT_MIN, INSERT_MAX,
                                                  seed=SEED + 9, return_truth=True)
    q1, q2 = os.path.join(tmp, "pairs_1.qry"), os.path.join(tmp, "pairs_2.qry")
    write_reads_fasta(q1, r1)
    write_reads_fasta(q2, r2)
    window = ["--insert-min", str(INSERT_MIN), "--insert-max", str(INSERT_MAX)]
    reset_counts()
    prun = cli.main(["locate", ref, str(REF_BASES), q1, str(READ_LEN), str(PAIRS), "--paired", q2, *window,
                     *common, "--output", os.path.join(tmp, "pairs.pairs")])
    by_path["locate_paired"] = read_counts()
    pwaves = -(-4 * PAIRS // SearchLocateEngine.WAVE)
    rounds = (READ_LEN - LUT_M) // K
    expect_launches("locate --paired", by_path["locate_paired"], {
        "lf_round_pairs": rounds * pwaves + lut_launches, "locate_walk": pwaves})
    truth = bench.truth_pairs_found(prun.pairs, prun.strand, ls, rs, minus)
    if truth != PAIRS:
        raise AssertionError(f"locate --paired: {PAIRS - truth} true pairs missing")
    peng = PairedEndEngine(index_s, loc_s, INSERT_MIN, INSERT_MAX, max_hits=MAX_HITS, lut_m=LUT_M, device=dev)
    same_arrays("locate --paired", (prun.pairs, prun.strand, prun.counts, prun.overflow),
                peng.pair(r1, r2, **plain))
    del peng
    vidx = np.sort(np.random.default_rng(SEED + 10).choice(PAIRS, PAIRS_ORACLE, replace=False))
    want = pair_oracle(codes, r1[vidx], r2[vidx], INSERT_MIN, INSERT_MAX, device=dev)
    if not bench.pairs_match_oracle(prun.pairs[vidx], prun.strand[vidx], prun.counts[vidx], prun.overflow[vidx],
                                    want):
        raise AssertionError("locate --paired: the sample differs from pair_oracle")
    found["paired"] = {"seconds": prun.seconds, "properly_paired": int((prun.counts > 0).sum())}
    a1 = r1[:PAIRS_APPROX].copy()
    a1[:, READ_LEN // 2] = (a1[:, READ_LEN // 2] + 1) % 4  # one substitution in every R1 mate
    a2 = r2[:PAIRS_APPROX]
    qa1, qa2 = os.path.join(tmp, "apairs_1.qry"), os.path.join(tmp, "apairs_2.qry")
    write_reads_fasta(qa1, a1)
    write_reads_fasta(qa2, a2)
    for label, extra, kind, verify, kernel, wave in (
            ("paired_mm2", {"mismatches": 2}, "--mismatches", hamming_to_text_reference, "hamming_verify",
             SeedExtendEngine.WAVE),
            ("paired_e1", {"edits": 1}, "--edits", myers_verify_reference, "myers_verify", EditExtendEngine.WAVE)):
        value = str(next(iter(extra.values())))
        reset_counts()
        run = cli.main(["locate", ref, str(REF_BASES), qa1, str(READ_LEN), str(PAIRS_APPROX), "--paired", qa2,
                        *window, kind, value, *common, "--output", os.path.join(tmp, f"{label}.pairs")])
        by_path[label] = read_counts()
        waves = -(-4 * PAIRS_APPROX // wave)
        expect_launches(f"locate --paired {kind} {value}", by_path[label], {
            "lf_round_pairs": seed_rounds * waves + lut_launches, "locate_walk": waves, kernel: waves})
        t = bench.truth_pairs_found(run.pairs, run.strand, ls[:PAIRS_APPROX], rs[:PAIRS_APPROX],
                                    minus[:PAIRS_APPROX])
        if t != PAIRS_APPROX:
            raise AssertionError(f"locate --paired {kind} {value}: {PAIRS_APPROX - t} true pairs missing")
        eng = PairedEndEngine(index_s, loc_s, INSERT_MIN, INSERT_MAX, max_hits=MAX_HITS, lut_m=LUT_M, text=codes,
                              device=dev, **extra)
        same_arrays(f"locate --paired {kind} {value}", (run.pairs, run.strand, run.counts, run.overflow),
                    eng.pair(a1, a2, verify=verify, **plain))
        found[label] = {"seconds": run.seconds}
        del eng
    print(f"    paired: locate --paired on {PAIRS} FR pairs x {READ_LEN} bp, insert [{INSERT_MIN}, {INSERT_MAX}]: "
          f"pass {prun.seconds:.6f} s ({PAIRS / prun.seconds:.0f} pairs/s), {found['paired']['properly_paired']} "
          f"properly paired, every true pair recovered, all equal to the plain path, {PAIRS_ORACLE} equal to "
          f"pair_oracle; launches {by_path['locate_paired']}; --mismatches 2 and --edits 1 on {PAIRS_APPROX} pairs "
          f"with a substitution in every R1 mate: passes {found['paired_mm2']['seconds']:.6f} / "
          f"{found['paired_e1']['seconds']:.6f} s, every true pair recovered, equal to the plain path, launches "
          f"{by_path['paired_mm2']} / {by_path['paired_e1']}; {time.perf_counter() - t0:.2f} s", flush=True)
    return {"k5": k5, "k6": k6, "edge_lanes": edge_lanes, "paths": found}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; it runs only on a GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them

    t0 = time.perf_counter()
    libs = kernels.build()  # one nvcc per source, all started together
    for name in libs:
        kernels.library(name)
    print(f"[2 build] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{time.perf_counter() - t0:.2f} s; " + "; ".join(
              f"{kernels.CSRC_DIR.relative_to(REPO)}/{name}.cu -> {lib.relative_to(REPO)}: "
              f"{ptxas_summary(lib.with_suffix('.log').read_text())}" for name, lib in libs.items()),
          flush=True)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    k1 = check_k1(rng, K, D, dev)
    k1_tail = check_k1(rng, 1, D, dev)
    print(f"[3 K1 vs plain, {K1_ENDS} ends] k=3 d=192: bit-identical, kernel "
          f"{k1['ms']:.4f} ms (bound {k1['bound_ms']:.4f} ms), plain {k1['plain_ms']:.4f} ms; k=1 d=192: "
          f"bit-identical, kernel {k1_tail['ms']:.4f} ms (bound {k1_tail['bound_ms']:.4f} ms), plain "
          f"{k1_tail['plain_ms']:.4f} ms; phase {time.perf_counter() - t0:.2f} s", flush=True)

    by_path = {}
    with tempfile.TemporaryDirectory(prefix="tpufm_torch_smoke_") as tmp:
        t0 = time.perf_counter()
        ref = os.path.join(tmp, "ref.fa")
        write_reference(ref, decode_bases(np.random.default_rng(SEED).integers(0, 4, REF_BASES, dtype=np.uint8)))
        codes = read_reference(ref, REF_BASES)
        index = build_index(codes, IndexConfig(k=K, d=D), sa_method="native")
        fmi = os.path.join(tmp, "ref.fmi")
        write_fmi(fmi, index)
        build_s = time.perf_counter() - t0
        reads, starts = generate_reads(codes, READ_LEN, READS, seed=SEED, return_starts=True)
        qry = os.path.join(tmp, "reads.qry")
        write_reads_fasta(qry, reads, starts)
        setup_s = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        reset_counts()
        run = cli.main(["search", fmi, qry, str(READ_LEN), str(READS), "--lut", str(LUT_M),
                        "--device", "cuda", "--iterations", "3",
                        "--output", os.path.join(tmp, "reads.res")])
        by_path["main"] = read_counts()
        launches = by_path["main"]["lf_round_pairs"]
        cli_s = time.perf_counter() - t0
        rounds = (READ_LEN - LUT_M) // K
        waves = -(-READS // run.engine.WAVE)
        lut_launches = (4**LUT_M // min(4**LUT_M, 1 << 20)) * (LUT_M // K)
        need = (1 + 3) * rounds * waves + lut_launches
        expect_launches("main path", by_path["main"], {"lf_round_pairs": need})
        peak = torch.cuda.max_memory_allocated(dev)
        check_run("main path", run, index, reads)
        lut_plain = run.engine.build_prefix_lut(LUT_M, step=lf_round_reference)
        if not torch.equal(lut_plain, run.engine.lut):
            rows = int((lut_plain != run.engine.lut).any(1).sum())
            raise AssertionError(f"main path: {rows} LUT rows differ from the plain rounds' LUT")
        del lut_plain
        print(f"[4 main path] 10 Mbase k=3 d=192 lut12, {READS} x {READ_LEN} bp: "
              f"{run.seconds_per_pass:.6f} s/pass = {READS / run.seconds_per_pass:.0f} reads/s, "
              f"LUT build {run.engine.lut_build_seconds:.4f} s, K1 pair-entry launches {launches} "
              f"(>= {need}), peak device memory {peak} B; all reads found, all equal to the "
              f"plain path, first {ORACLE_READS} equal to the oracle, all {4**LUT_M} LUT rows equal "
              f"to the plain rounds' LUT; host set-up "
              f"{setup_s:.2f} s (index {build_s:.2f} s), cli {cli_s:.2f} s, checks "
              f"{time.perf_counter() - t0 - cli_s:.2f} s", flush=True)

        t0 = time.perf_counter()
        k1_main = k1_main_shape(run.engine, reads, run.results, dev)
        print(f"[3b K1 at the main path's shape] phase 4's first wave replayed through the pair entry, "
              f"ending on phase 4's intervals; captured rounds bit-identical to plain:", flush=True)
        for c in k1_main:
            print(f"    round {c['round']}: {c['reads']} reads, {c['same_block_share'] * 100:.2f}% with both "
                  f"ends in one block: pair entry {c['ms']:.4f} ms (bound {c['bound_ms']:.4f} ms, "
                  f"{c['bound_ms'] / c['ms'] * 100:.1f}% of it), per-end entry on the same "
                  f"{2 * c['reads']} ends {c['per_end_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms", flush=True)
        print(f"    phase {time.perf_counter() - t0:.2f} s", flush=True)

        t0 = time.perf_counter()
        reads151 = generate_reads(codes, TAIL_LEN, TAIL_READS, seed=SEED + 1)
        qry151 = os.path.join(tmp, "reads151.qry")
        write_reads_fasta(qry151, reads151)
        reset_counts()
        run151 = cli.main(["search", fmi, qry151, str(TAIL_LEN), str(TAIL_READS), "--lut", str(LUT_M),
                           "--device", "cuda", "--iterations", "1",
                           "--output", os.path.join(tmp, "reads151.res")])
        by_path["tail"] = read_counts()
        expect_launches("tail run", by_path["tail"], {"lf_round_pairs": 2 * ((TAIL_LEN - LUT_M) // K + 1)})
        check_run("tail", run151, index, reads151, tail=derive_tail(index))
        print(f"[5 any length] {TAIL_READS} x {TAIL_LEN} bp, 46 k=3 rounds + 1 k=1 tail round: "
              f"{run151.seconds_per_pass:.6f} s/pass, K1 launches {by_path['tail']['lf_round_pairs']}; "
              f"all equal to the plain path and the oracle; phase {time.perf_counter() - t0:.2f} s",
              flush=True)
        del run151, reads151

        t0 = time.perf_counter()
        rows3 = check_rows(rng, K, D, dev)
        rows1 = check_rows(rng, 1, D, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        gathers = []
        for case in GATHER_CASES:
            gathers.append(check_gather(gen, *case, dev))
            torch.cuda.empty_cache()
        print(f"[6 rows entry and K3 vs plain] lf_round_rows {K1_ENDS} ends: k=3 d=192 bit-identical, "
              f"kernel {rows3['ms']:.4f} ms (bound {rows3['bound_ms']:.4f} ms), plain {rows3['plain_ms']:.4f} "
              f"ms; k=1 d=192 bit-identical, kernel {rows1['ms']:.4f} ms (bound {rows1['bound_ms']:.4f} ms), "
              f"plain {rows1['plain_ms']:.4f} ms; row_gather, all bit-identical (idx includes E and E+5):",
              flush=True)
        for g in gathers:
            print(f"    {g['case']:6s} E={g['E']:>9} W={g['W']:>3} N={g['N']:>7} {g['path']:5s}: kernel "
                  f"{g['ms']:.4f} ms = {g['rows_per_s']:.4g} rows/s = {g['GB_per_s']:.4g} GB/s, bound "
                  f"{g['bound_ms']:.4f} ms ({g['share'] * 100:.1f}% of it); index_select "
                  f"{g['library_ms']:.4f} ms (the kernel {g['library_ms'] / g['ms']:.2f}x as fast); "
                  f"out.zero_() {g['write_ms']:.4f} ms; plain table[idx] {g['plain_ms']:.4f} ms = "
                  f"{g['plain_rows_per_s']:.4g} rows/s = {g['plain_GB_per_s']:.4g} GB/s", flush=True)
        print(f"    phase {time.perf_counter() - t0:.2f} s", flush=True)

        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        dma = SearchEngine(index, dev, lut_m=LUT_M, gather="dma")
        dma_res, dma_s = timed_passes(lambda: dma.search(reads))
        by_path["gather"] = read_counts()
        dma_peak = torch.cuda.max_memory_allocated(dev)
        need_rows = (1 + 3) * rounds * waves
        expect_launches("gather engine", by_path["gather"],
                        {"row_gather": need_rows, "lf_round_rows": need_rows, "lf_round_pairs": lut_launches})
        if not np.array_equal(dma_res, run.results):
            raise AssertionError(f"gather engine: {(dma_res != run.results).any(1).sum()} reads differ from phase 4")
        del dma
        reset_counts()
        pallas = cli.main(["search", fmi, qry, str(READ_LEN), str(READS), "--lut", str(LUT_M),
                           "--device", "cuda", "--iterations", "3", "--engine", "pallas",
                           "--output", os.path.join(tmp, "reads.pallas.res")])
        by_path["pallas"] = read_counts()
        expect_launches("--engine pallas", by_path["pallas"], {"lf_round_rows": need_rows})
        if not np.array_equal(pallas.results, run.results):
            raise AssertionError(
                f"--engine pallas: {(pallas.results != run.results).any(1).sum()} reads differ from phase 4")
        print(f"[7 gathered-row engines] {READS} x {READ_LEN} bp, all intervals equal to phase 4's: "
              f"gather=\"dma\" {dma_s:.6f} s/pass ({READS / dma_s:.0f} reads/s), launches "
              f"{by_path['gather']} (>= {need_rows} K3 and rows), peak device memory {dma_peak} B; "
              f"--engine pallas {pallas.seconds_per_pass:.6f} s/pass ({READS / pallas.seconds_per_pass:.0f} "
              f"reads/s), launches {by_path['pallas']}; phase 4 fused {run.seconds_per_pass:.6f} s/pass; "
              f"phase {time.perf_counter() - t0:.2f} s", flush=True)
        del pallas

        t0 = time.perf_counter()
        full = generate_reads(codes, VARLEN_MAX, VARLEN_READS, seed=SEED + 2)
        lengths = np.random.default_rng(SEED + 2).integers(VARLEN_MIN, VARLEN_MAX + 1, size=VARLEN_READS)
        fastq = os.path.join(tmp, "varlen.fastq")
        write_fastq(fastq, full, lengths)
        t1 = time.perf_counter()
        batch = load_queries_varlen(fastq)
        load_s = time.perf_counter() - t1
        cols = np.arange(VARLEN_MAX)
        want = np.full((VARLEN_READS, VARLEN_MAX), 0xFF, dtype=np.uint8)
        want[cols >= VARLEN_MAX - lengths[:, None]] = full[cols < lengths[:, None]]
        if not np.array_equal(batch, want):
            raise AssertionError("load_queries_varlen: the batch is not the right-aligned trimmed reads")
        del want
        setup_v = time.perf_counter() - t0
        tail = derive_tail(index)
        pad = -(VARLEN_MAX - LUT_M) % K
        vrounds = (VARLEN_MAX + pad - LUT_M) // K
        vwaves = -(-VARLEN_READS // SearchEngine.WAVE)
        reset_counts()
        veng = SearchEngine(index, dev, lut_m=LUT_M, tail_index=tail)
        vres, v_s = timed_passes(lambda: veng.search_varlen(batch))
        by_path["varlen"] = read_counts()
        expect_launches("varlen", by_path["varlen"], {"lf_round_pairs": 4 * (vrounds + K - 1) * vwaves})
        reset_counts()
        vdma = SearchEngine(index, dev, lut_m=LUT_M, tail_index=tail, gather="dma")
        vdres, vd_s = timed_passes(lambda: vdma.search_varlen(batch))
        by_path["varlen_gather"] = read_counts()
        expect_launches("varlen gather", by_path["varlen_gather"], {
            "row_gather": 4 * vrounds * vwaves, "lf_round_rows": 4 * vrounds * vwaves,
            "lf_round_pairs": 4 * (K - 1) * vwaves,
        })
        del vdma
        t1 = time.perf_counter()
        if not (vres[:, 1] > vres[:, 0]).all():
            raise AssertionError(f"varlen: {(vres[:, 1] <= vres[:, 0]).sum()} sampled reads not found")
        if not np.array_equal(vdres, vres):
            raise AssertionError(f"varlen: {(vdres != vres).any(1).sum()} reads differ between the paths")
        plain = veng.search_varlen(batch, step=lf_round_reference)
        if not np.array_equal(vres, plain):
            raise AssertionError(f"varlen: {(vres != plain).any(1).sum()} reads differ from the plain path")
        head = lengths[:ORACLE_READS]
        for L in np.unique(head).tolist():
            sel = np.flatnonzero(head == L)
            oracle = search_oracle(index, full[sel, :L], tail_index=tail)
            if not np.array_equal(vres[sel], oracle):
                raise AssertionError(f"varlen: {(vres[sel] != oracle).any(1).sum()} reads of {L} bp differ from the oracle")
        print(f"[8 variable length] {VARLEN_READS} reads of {VARLEN_MIN}-{VARLEN_MAX} bp (mean "
              f"{lengths.mean():.2f}), FASTQ written and loaded ({load_s:.2f} s to load, set-up "
              f"{setup_v:.2f} s); search_varlen lut12: default {v_s:.6f} s/pass "
              f"({VARLEN_READS / v_s:.0f} reads/s), launches {by_path['varlen']}; gather=\"dma\" "
              f"{vd_s:.6f} s/pass ({VARLEN_READS / vd_s:.0f} reads/s), launches "
              f"{by_path['varlen_gather']}; all found, both paths equal, equal to the plain path, "
              f"first {ORACLE_READS} equal to the oracle over {len(np.unique(head))} lengths; checks "
              f"{time.perf_counter() - t1:.2f} s; phase {time.perf_counter() - t0:.2f} s", flush=True)

        t0 = time.perf_counter()
        sa = suffix_array(codes)
        loc = build_locate(codes, sample_rate=SAMPLE_RATE, d=D, sa=sa)
        loc_s = time.perf_counter() - t0
        walk = check_walk(loc, sa, dev)
        del sa, loc
        torch.cuda.empty_cache()
        print(f"[9 K4 vs plain] sample rate {SAMPLE_RATE}, d={D}: all {REF_BASES + 1} BWT rows plus "
              f"bwtsize and 3 rows past it walked, equal to the suffix array and bit-identical to the "
              f"plain walk; {WALK_ROWS} random rows: kernel {walk['ms']:.4f} ms, plain "
              f"{walk['plain_ms']:.4f} ms; {WALK_WAVE} (a fused-locate wave): kernel {walk['wave_ms']:.4f} ms; "
              f"bound {walk['bound_ms']:.4f} ms (bytes), latency floor "
              f"{walk['latency_floor_ms']:.4f} ms (longest trip {walk['longest_trip']} hops, mean "
              f"{walk['mean_trip']:.2f}, x {walk['hop_ms'] * 1e3:.3f} us a hop); all {walk['rows']} rows: "
              f"kernel {walk['all_ms']:.4f} ms, "
              f"plain {walk['all_plain_ms']:.4f} ms; suffix sort + locate tables {loc_s:.2f} s; phase "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        t0 = time.perf_counter()
        store = os.path.join(tmp, "P")
        pos_two, pos_fused = os.path.join(tmp, "two.pos"), os.path.join(tmp, "fused.pos")
        common = [qry, str(READ_LEN), str(READS), "--k", str(K), "--d", str(D), "--sample-rate",
                  str(SAMPLE_RATE), "--max-hits", str(MAX_HITS), "--lut", str(LUT_M), "--device", "cuda"]
        reset_counts()
        two = cli.main(["locate", ref, str(REF_BASES), *common, "--store", store, "--output", pos_two])
        by_path["locate"] = read_counts()
        walk_waves = -(-int((two.positions != 0xFFFFFFFF).sum()) // LocateEngine.WAVE)
        expect_launches("locate two-pass", by_path["locate"],
                        {"lf_round_pairs": rounds * waves + lut_launches, "locate_walk": walk_waves})
        reset_counts()
        fused = cli.main(["locate", "-", "0", *common, "--from-store", store, "--fused", "--output", pos_fused])
        by_path["locate_fused"] = read_counts()
        fwaves = -(-READS // SearchLocateEngine.WAVE)
        expect_launches("locate --fused", by_path["locate_fused"],
                        {"lf_round_pairs": rounds * fwaves + lut_launches, "locate_walk": fwaves})
        reset_counts()
        both = cli.main(["locate", "-", "0", *common, "--from-store", store, "--fused", "--rc",
                         "--output", os.path.join(tmp, "rc.pos")])
        by_path["locate_fused_rc"] = read_counts()
        # the minus-strand waves hold no hit in a random text, and a wave
        # with no row to walk launches no walk
        expect_launches("locate --fused --rc", by_path["locate_fused_rc"],
                        {"lf_round_pairs": 2 * rounds * fwaves + lut_launches, "locate_walk": fwaves})
        cli_s = time.perf_counter() - t0
        if Path(pos_two).read_bytes() != Path(pos_fused).read_bytes():
            raise AssertionError("locate: the two-pass and fused .pos files differ")
        if not np.array_equal(both.positions[:READS], fused.positions):
            raise AssertionError("locate --rc: the plus strand differs from the fused run")
        for name, run_ in (("two-pass", two), ("fused", fused), ("fused --rc", both)):
            if not (run_.positions[:READS] == starts[:, None]).any(axis=1).all():
                raise AssertionError(f"locate {name}: a read's true start is missing from its positions")
        if not np.array_equal(two.intervals, run.results):
            raise AssertionError("locate two-pass: intervals differ from phase 4's")
        index_s = load_store(f"{store}.search.tpufm")
        loc_store = load_store(f"{store}.locate.tpufm")
        oracle = locate_hits(loc_store, search_oracle(index_s, reads[:ORACLE_READS]), MAX_HITS)
        if not np.array_equal(fused.positions[:ORACLE_READS], oracle):
            raise AssertionError("locate: the first reads differ from the host oracle")
        sle = SearchLocateEngine(index_s, loc_store, dev, max_hits=MAX_HITS, lut_m=LUT_M)
        plain_iv, plain_pos = sle.search_locate(reads[:ORACLE_READS], step=lf_round_reference,
                                                walk=locate_walk_reference)
        if not (np.array_equal(plain_pos, fused.positions[:ORACLE_READS])
                and np.array_equal(plain_iv, run.results[:ORACLE_READS])):
            raise AssertionError("locate: the first reads differ from the plain path")
        reset_counts()
        (_, f_pos), f_s = timed_passes(lambda: sle.search_locate(reads))
        by_path["search_locate_timed"] = read_counts()
        expect_launches("search_locate", by_path["search_locate_timed"],
                        {"lf_round_pairs": 4 * rounds * fwaves, "locate_walk": 4 * fwaves})
        two_search = SearchEngine(index_s, dev, lut_m=LUT_M)
        two_locate = LocateEngine(loc_store, dev)
        reset_counts()
        t_pos, t_s = timed_passes(lambda: two_locate.locate_hits(two_search.search(reads), MAX_HITS))
        by_path["two_pass_timed"] = read_counts()
        expect_launches("search + locate_hits", by_path["two_pass_timed"],
                        {"lf_round_pairs": 4 * rounds * waves, "locate_walk": 4 * walk_waves})
        if not (np.array_equal(f_pos, fused.positions) and np.array_equal(t_pos, fused.positions)):
            raise AssertionError("locate: the timed passes differ from the CLI's positions")
        hits = int((fused.positions != 0xFFFFFFFF).sum())
        print(f"[10 locate] {READS} x {READ_LEN} bp, max-hits {MAX_HITS}, {hits} positions: CLI two-pass "
              f"(+ --store) pass {two.seconds:.6f} s, --fused {fused.seconds:.6f} s, --fused --rc "
              f"{both.seconds:.6f} s; .pos byte-identical, every true start found, first {ORACLE_READS} "
              f"equal to the host oracle and the plain path; timed passes: search_locate "
              f"{f_s:.6f} s/pass ({READS / f_s:.0f} reads/s), search + locate_hits {t_s:.6f} s/pass "
              f"({READS / t_s:.0f} reads/s); launches {by_path['locate']} / {by_path['locate_fused']} / "
              f"{by_path['locate_fused_rc']}; CLI {cli_s:.2f} s; phase {time.perf_counter() - t0:.2f} s",
              flush=True)
        del two, both, two_search, two_locate, f_pos, t_pos

        t0 = time.perf_counter()
        wide = generate_reads(codes, WIDE_LEN, WIDE_READS, seed=SEED + 3)
        reset_counts()
        wide_sle = SearchLocateEngine(index_s, loc_store, dev, max_hits=WIDE_HITS)
        w_iv, w_pos = wide_sle.search_locate(wide)
        by_path["wide_fused"] = read_counts()
        reset_counts()
        w_two_iv = SearchEngine(index_s, dev, tail_index=loc_store.lf1).search(wide)
        w_two = LocateEngine(loc_store, dev).locate_hits(w_two_iv, WIDE_HITS)
        by_path["wide_two_pass"] = read_counts()
        for name in ("wide_fused", "wide_two_pass"):
            expect_launches(name, by_path[name], {"lf_round_pairs": WIDE_LEN // K + 1, "locate_walk": 1})
        if not (np.array_equal(w_iv, w_two_iv) and np.array_equal(w_pos, w_two)):
            raise AssertionError("wide intervals: fused and two-pass differ")
        width = w_iv[:, 1].astype(np.int64) - w_iv[:, 0]
        fill = (w_pos != 0xFFFFFFFF).sum(axis=1)
        if not np.array_equal(fill, np.minimum(width, WIDE_HITS)):
            raise AssertionError("wide intervals: a fill count is not min(R - L, max-hits)")
        valid = w_pos != 0xFFFFFFFF
        at = text_windows(codes, w_pos[valid], WIDE_LEN)
        if not (at == np.repeat(wide, fill, axis=0)).all():
            raise AssertionError("wide intervals: a reported position is not an occurrence")
        print(f"[11 wide intervals] {WIDE_READS} x {WIDE_LEN} bp, no LUT, max-hits {WIDE_HITS}: mean "
              f"R - L {width.mean():.2f}, {(width >= WIDE_HITS).mean() * 100:.1f}% of reads at the cap, "
              f"{int(valid.sum())} positions; fused equal to two-pass, fill = min(R - L, {WIDE_HITS}), every "
              f"position an occurrence; launches {by_path['wide_fused']} / {by_path['wide_two_pass']}; "
              f"phase {time.perf_counter() - t0:.2f} s", flush=True)
        del wide_sle

        t0 = time.perf_counter()
        mm_reads, mm_starts = generate_reads(codes, READ_LEN, MM_READS, seed=SEED + 4, return_starts=True)
        mrng = np.random.default_rng(SEED + 4)
        mutated = np.arange(MM_READS) % 2 == 0
        col = mrng.integers(0, READ_LEN, size=MM_READS)
        sub = (mm_reads[np.arange(MM_READS), col] + mrng.integers(1, 4, size=MM_READS)) % 4
        mm_reads[mutated, col[mutated]] = sub[mutated]
        mm_qry = os.path.join(tmp, "mm.qry")
        write_reads_fasta(mm_qry, mm_reads, mm_starts)
        mm_waves = -(-MM_READS // (SearchEngine.WAVE // (3 * READ_LEN + 1)))
        reset_counts()
        cnt = cli.main(["count", fmi, mm_qry, str(READ_LEN), str(MM_READS), "--mismatches", "1",
                        "--lut", str(LUT_M), "--device", "cuda", "--output", os.path.join(tmp, "mm.cnt")])
        by_path["count_mm1"] = read_counts()
        expect_launches("count --mismatches 1", by_path["count_mm1"], {"lf_round_pairs": 2 * rounds * mm_waves})
        reset_counts()
        mloc = cli.main(["locate", "-", "0", mm_qry, str(READ_LEN), str(MM_READS), "--from-store", store,
                         "--mismatches", "1", "--lut", str(LUT_M), "--max-hits", str(MAX_HITS),
                         "--device", "cuda", "--output", os.path.join(tmp, "mm.pos")])
        by_path["locate_mm1"] = read_counts()
        expect_launches("locate --mismatches 1", by_path["locate_mm1"],
                        {"lf_round_pairs": rounds * mm_waves + lut_launches, "locate_walk": mm_waves})
        t1 = time.perf_counter()
        if not (cnt.counts >= 1).all():
            raise AssertionError("count --mismatches 1: a sampled read counts 0")
        plain_cnt = cnt.engine.count(mm_reads[:MM_PLAIN], mismatches=1, step=lf_round_reference)
        if not np.array_equal(cnt.counts[:MM_PLAIN], plain_cnt):
            raise AssertionError("count --mismatches 1: counts differ from the plain path")
        mpos = mloc.positions
        if not (mpos == mm_starts[:, None]).any(axis=1).all():
            raise AssertionError("locate --mismatches 1: a read's origin is missing from its positions")
        valid = mpos != 0xFFFFFFFF
        dist = (text_windows(codes, mpos[valid], READ_LEN)
                != np.repeat(mm_reads, valid.sum(axis=1), axis=0)).sum(axis=1)
        if not (dist <= 1).all():
            raise AssertionError("locate --mismatches 1: a position is more than one substitution away")
        if not np.array_equal(valid.sum(axis=1), np.minimum(cnt.counts, MAX_HITS)):
            raise AssertionError("locate --mismatches 1: fill counts differ from min(count, max-hits)")
        print(f"[12 Hamming <= 1] {MM_READS} x {READ_LEN} bp (cut from 1M for the time limit; width not "
              f"cut), half with one planted substitution, {3 * READ_LEN + 1} variants per read = "
              f"{MM_READS * (3 * READ_LEN + 1)} search lanes, {mm_waves} waves: count --mismatches 1 "
              f"{cnt.seconds_per_pass:.6f} s/pass ({MM_READS / cnt.seconds_per_pass:.0f} reads/s), locate "
              f"--mismatches 1 {mloc.seconds:.6f} s ({MM_READS / mloc.seconds:.0f} reads/s); counts >= 1, "
              f"first {MM_PLAIN} equal to the plain path, every origin found, all {int(valid.sum())} "
              f"positions within Hamming 1; launches {by_path['count_mm1']} / {by_path['locate_mm1']}; "
              f"checks {time.perf_counter() - t1:.2f} s; phase {time.perf_counter() - t0:.2f} s", flush=True)
        del cnt, mloc, sle, index_s, loc_store

        t0 = time.perf_counter()
        ref1 = os.path.join(tmp, "ref1m.fa")
        codes1 = np.random.default_rng(SEED + 5).integers(0, 4, BUILD_BASES, dtype=np.uint8)
        write_reference(ref1, decode_bases(codes1))
        with contextlib.redirect_stdout(io.StringIO()):
            built = cli.main(["build", ref1, str(BUILD_BASES), "--auto", "--tail"])
        k_built, d_built = built.index.config.k, built.index.config.d
        in_process = build_index(codes1, IndexConfig(k=k_built, d=d_built), sa_method="native")
        fmi1 = os.path.join(tmp, "in_process.fmi")
        write_fmi(fmi1, in_process)
        if Path(built.output).read_bytes() != Path(fmi1).read_bytes():
            raise AssertionError("build: the .fmi differs from write_fmi of the in-process index")
        tail1 = load_npz(f"{built.output}.tail.npz")
        want_tail = build_index(codes1, IndexConfig(k=1, d=d_built), sa_method="native")
        for name in ("occ", "bitmaps", "dollar_pos", "dollar_base"):
            if not np.array_equal(getattr(tail1, name), getattr(want_tail, name)):
                raise AssertionError(f"build --tail: the k=1 tail's {name} differs from the in-process one")
        qry1 = os.path.join(tmp, "reads1m.qry")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["genreads", ref1, str(BUILD_BASES), str(BUILD_LEN), str(BUILD_READS),
                      "--seed", str(SEED), "--output", qry1])
        reset_counts()
        run1 = cli.main(["search", built.output, qry1, str(BUILD_LEN), str(BUILD_READS), "--lut", str(LUT_M),
                         "--device", "cuda", "--iterations", "1", "--output", os.path.join(tmp, "reads1m.res")])
        by_path["built_search"] = read_counts()
        expect_launches("search on the built index", by_path["built_search"],
                        {"lf_round_pairs": 2 * ((BUILD_LEN - LUT_M) // K + 1)})
        reads1 = load_queries(qry1, BUILD_LEN, BUILD_READS)
        if not np.array_equal(run1.results, search_oracle(in_process, reads1, tail_index=tail1)):
            raise AssertionError("search on the built index: intervals differ from the oracle")
        if not (run1.results[:, 1] > run1.results[:, 0]).all():
            raise AssertionError("search on the built index: a sampled read is not found")
        print(f"[13 build, genreads, bench] build --auto --tail of a {BUILD_BASES}-base FASTA (k={k_built} "
              f"d={d_built}): .fmi byte-identical to write_fmi of the in-process index, tail equal; genreads "
              f"{BUILD_READS} x {BUILD_LEN} bp, search --lut {LUT_M} (one k=1 tail round from the .tail.npz) "
              f"all equal to the oracle, launches {by_path['built_search']}; "
              f"{time.perf_counter() - t0:.2f} s. bench records:", flush=True)
        del run1, reads1, in_process, tail1, want_tail

        flagship = ["--refsize", str(REF_BASES), "--k", str(K), "--d", str(D), "--lut", str(LUT_M),
                    "--length", str(READ_LEN), "--iterations", str(BENCH_PASSES)]
        mm_config = [*flagship[:-2], "--iterations", str(MM_PASSES)]
        rounds_a_pass = (READ_LEN - LUT_M) // K
        main_rec = bench_record("bench", [*flagship, "--numqueries", str(READS)], {
            "lf_round_pairs": (2 * BENCH_PASSES + 1) * rounds_a_pass * waves + lut_launches}, by_path)
        if main_rec["detail"]["verified_reads"] != READS:
            raise AssertionError(f"bench: {main_rec['detail']['verified_reads']} reads verified, not {READS}")
        fused_waves = -(-READS // SearchLocateEngine.WAVE)
        bench_record("bench_search_locate", [
            *flagship, "--numqueries", str(READS), "--locate", "--fused", "--max-hits", str(MAX_HITS),
            "--sample-rate", str(SAMPLE_RATE)], {
            "lf_round_pairs": (BENCH_PASSES + 1) * rounds_a_pass * fused_waves + lut_launches,
            "locate_walk": (BENCH_PASSES + 1) * fused_waves}, by_path)
        bench_record("bench_locate", [
            *flagship, "--numqueries", str(WALK_ROWS), "--locate", "--sample-rate", str(SAMPLE_RATE)],
            {"locate_walk": BENCH_PASSES + 1}, by_path)
        bench_record("bench_mismatch", [
            *mm_config, "--numqueries", str(MM_READS), "--mismatches", "1"],
            {"lf_round_pairs": (MM_PASSES + 1) * rounds_a_pass * mm_waves}, by_path)
        print(f"    flagship: seconds_per_pass {main_rec['detail']['seconds_per_pass']:.6f} (reads on the "
              f"device), host_seconds_per_pass {main_rec['detail']['host_seconds_per_pass']:.6f} (host to "
              f"host); phase {time.perf_counter() - t0:.2f} s", flush=True)

        t0 = time.perf_counter()
        approx = approximate(tmp, ref, codes, store, dev, by_path, lut_launches)
        # the bench records at tpufm's defaults (k=2 d=64, no LUT, 131,072 reads or pairs, 5 passes)
        t1 = time.perf_counter()
        print("    bench records:", flush=True)
        bench_waves = {"seed": 2, "edit": 16, "paired": 2}  # 131,072 reads (x 4 for pairs) a record
        kstep = 120 // 2  # k=2 rounds of a whole read
        seed_k2 = (120 // 3) // 2  # and of a seed
        kept = {}
        with keep_pass(kept):
            seed_rec = bench_record("bench_seed", ["--mismatches", str(APPROX_M)], {
                "hamming_verify": (BENCH_PASSES + 1) * bench_waves["seed"],
                "locate_walk": (BENCH_PASSES + 1) * bench_waves["seed"],
                "lf_round_pairs": (BENCH_PASSES + 1) * bench_waves["seed"] * seed_k2}, by_path)
        profile_pass("bench --mismatches 2", kept.pop("fn"), seed_rec["detail"]["seconds_per_pass"])
        with keep_pass(kept):
            edit_rec = bench_record("bench_edit", ["--edits", str(APPROX_E)], {
                "myers_verify": (BENCH_PASSES + 1) * bench_waves["edit"],
                "locate_walk": (BENCH_PASSES + 1) * bench_waves["edit"],
                "lf_round_pairs": (BENCH_PASSES + 1) * bench_waves["edit"] * seed_k2}, by_path)
        profile_pass("bench --edits 2", kept.pop("fn"), edit_rec["detail"]["seconds_per_pass"])
        paired_rec = bench_record("bench_paired", ["--paired"], {
            "locate_walk": (BENCH_PASSES + 1) * bench_waves["paired"],
            "lf_round_pairs": (BENCH_PASSES + 1) * bench_waves["paired"] * kstep}, by_path)
        if paired_rec["detail"]["truth_pairs_recovered"] != 131072:
            raise AssertionError(f"bench --paired: {paired_rec['detail']['truth_pairs_recovered']} true pairs")
        print(f"    records {time.perf_counter() - t1:.2f} s; phase {time.perf_counter() - t0:.2f} s", flush=True)

    for pkg in ("jax", "tpufm"):
        if any(m == pkg or m.startswith(pkg + ".") for m in sys.modules):
            raise AssertionError(f"{pkg} was imported")
    search_case = gathers[0]
    # launches per pass on the paths users run: (counted run, passes in it,
    # whether it built the prefix LUT inside the count)
    passes = {"search": ("main", 4, True), "varlen": ("varlen", 4, True),
              "fused_locate": ("search_locate_timed", 4, False),
              "two_pass_locate": ("two_pass_timed", 4, False),
              "hamming1_count": ("count_mm1", 2, False), "gather_engine": ("gather", 4, True),
              # the bench records: a warm-up and the timed passes (run_bench's
              # search also its host passes), each record with its own LUT
              "bench": ("bench", 2 * BENCH_PASSES + 1, True),
              "bench_search_locate": ("bench_search_locate", BENCH_PASSES + 1, True),
              "bench_locate": ("bench_locate", BENCH_PASSES + 1, False),
              "bench_mismatch": ("bench_mismatch", MM_PASSES + 1, True),
              # phase 14: one CLI pass each, which builds the LUT; the records run no LUT
              "seed_locate": ("locate_mm2", 1, True), "edit_locate": ("locate_e2", 1, True),
              "paired_locate": ("locate_paired", 1, True), "paired_mm2": ("paired_mm2", 1, True),
              "paired_e1": ("paired_e1", 1, True), "bench_seed": ("bench_seed", BENCH_PASSES + 1, False),
              "bench_edit": ("bench_edit", BENCH_PASSES + 1, False),
              "bench_paired": ("bench_paired", BENCH_PASSES + 1, False)}

    def per_pass(name: str) -> dict:
        return {label: (by_path[path][name] - (lut_launches if lut and name == "lf_round_pairs" else 0)) / n
                for label, (path, n, lut) in passes.items()}

    r18 = k1_main[-1]
    print(json.dumps({"kernels": [
        {
            # K1 on the fused table: the pair entry, which every path runs,
            # and the per-end entry (the Pallas contract, on no path)
            "name": "lf_round",
            "route": "cuda",
            "source": "tpufm_torch/csrc/lf_round.cu",
            "replaces": "tpufm/engine/pallas_kernel.py:41",
            "launches": by_path["main"]["lf_round_pairs"] + by_path["main"]["lf_round"],
            "max_abs_err": max(k1["max_abs_err"], k1_tail["max_abs_err"], *(c["max_abs_err"] for c in k1_main)),
            "ms": r18["ms"],
            "plain_ms": r18["plain_ms"],
            "bound_ms": r18["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": f"pair entry, round {r18['round']} of phase 4's first wave, {r18['reads']} reads",
            "launches_per_pass": per_pass("lf_round_pairs"),
            "launches_by_path": {path: {"pairs": c["lf_round_pairs"], "per_end": c["lf_round"]}
                                 for path, c in by_path.items()},
            "main_path_rounds": k1_main,
            "per_end": {"ends": K1_ENDS, "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
                        "k1_tail_ms": k1_tail["ms"], "k1_tail_bound_ms": k1_tail["bound_ms"]},
        },
        {
            "name": "lf_round_rows",
            "route": "cuda",
            "source": "tpufm_torch/csrc/lf_round.cu",
            "replaces": "tpufm/engine/pallas_kernel.py:41",
            "contract": "rows gathered beforehand",
            "launches": by_path["gather"]["lf_round_rows"],
            "max_abs_err": max(rows3["max_abs_err"], rows1["max_abs_err"]),
            "ms": rows3["ms"],
            "plain_ms": rows3["plain_ms"],
            "bound_ms": rows3["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "launches_per_pass": per_pass("lf_round_rows"),
            "launches_by_path": {path: c["lf_round_rows"] for path, c in by_path.items()},
        },
        {
            "name": "row_gather",
            "route": "cuda",
            "source": "tpufm_torch/csrc/row_gather.cu",
            "replaces": "tpufm/engine/dma_gather.py:40",
            "launches": by_path["gather"]["row_gather"],
            "max_abs_err": max(g["max_abs_err"] for g in gathers),
            "ms": search_case["ms"],
            "plain_ms": search_case["plain_ms"],
            "bound_ms": search_case["bound_ms"],
            "bound_by": "bytes",
            "library_ms": search_case["library_ms"],
            "launches_per_pass": per_pass("row_gather"),
            "launches_by_path": {path: c["row_gather"] for path, c in by_path.items()},
            "rates": gathers,
        },
        {
            "name": "locate_walk",
            "route": "cuda",
            "source": "tpufm_torch/csrc/locate_walk.cu",
            "replaces": "tpufm/engine/xla.py:970 (jnp walk, no pallas_call)",
            "launches": by_path["locate_fused"]["locate_walk"],
            "max_abs_err": walk["max_abs_err"],
            "ms": walk["ms"],
            "plain_ms": walk["plain_ms"],
            "bound_ms": walk["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "latency_floor_ms": walk["latency_floor_ms"],
            "hop_ms": walk["hop_ms"],
            "longest_trip": walk["longest_trip"],
            "wave_ms": walk["wave_ms"],
            "all_rows_ms": walk["all_ms"],
            "all_rows_plain_ms": walk["all_plain_ms"],
            "launches_per_pass": per_pass("locate_walk"),
            "launches_by_path": {path: c["locate_walk"] for path, c in by_path.items()},
        },
        {
            "name": "hamming_verify",
            "route": "cuda",
            "source": "tpufm_torch/csrc/hamming_verify.cu",
            "replaces": "tpufm/engine/seed.py:94 (jnp hamming_to_text, no pallas_call)",
            "launches": by_path["locate_mm2"]["hamming_verify"],
            "max_abs_err": approx["k5"]["max_abs_err"],
            "ms": approx["k5"]["ms"],
            "call_ms": approx["k5"]["call_ms"],
            "no_valid_ms": approx["k5"]["no_valid_ms"],
            "plain_ms": approx["k5"]["plain_ms"],
            "bound_ms": approx["k5"]["bound_ms"],
            "bound_by": approx["k5"]["bound_by"],
            "library_ms": None,
            "shape": f"phase 14's first seed wave: {approx['k5']['lanes']} lanes, {approx['k5']['valid']} valid, "
                     f"L={READ_LEN}",
            "launches_per_pass": per_pass("hamming_verify"),
            "launches_by_path": {path: c["hamming_verify"] for path, c in by_path.items()},
        },
        {
            "name": "myers_verify",
            "route": "cuda",
            "source": "tpufm_torch/csrc/myers_verify.cu",
            "replaces": "tpufm/engine/edit.py:105 (jnp lax.scan make_myers_verify_fn, no pallas_call)",
            "launches": by_path["locate_e2"]["myers_verify"],
            "max_abs_err": approx["k6"]["max_abs_err"],
            "ms": approx["k6"]["ms"],
            "call_ms": approx["k6"]["call_ms"],
            "plain_ms": approx["k6"]["plain_ms"],
            "bound_ms": approx["k6"]["bound_ms"],
            "bound_by": approx["k6"]["bound_by"],
            "library_ms": None,
            "bytes_bound_ms": approx["k6"]["bytes_bound_ms"],
            "ops_bound_ms": approx["k6"]["ops_bound_ms"],
            "latency_floor_ms": approx["k6"]["one_lane_ms"],
            "shape": f"phase 14's first edit wave: {approx['k6']['lanes']} lanes, {approx['k6']['valid']} valid, "
                     f"L={READ_LEN} E={APPROX_E}",
            "launches_per_pass": per_pass("myers_verify"),
            "launches_by_path": {path: c["myers_verify"] for path, c in by_path.items()},
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
