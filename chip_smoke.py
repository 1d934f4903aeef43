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
 15. the aligner: phase 4's text as a 24-record FASTA (chr1..chr24, uneven
     lengths), 150 bp FASTQ reads with qualities, a random half
     reverse-complemented; ``align --store`` (the auto configuration, the
     tables built) on 262,144 reads, a quarter with one planted
     substitution (every error-free read inside one record primary at its
     origin, FLAG 0/16, NM:i:0; no record at the origin of a read across
     two records), then on the stores ``--mismatches 2`` on the same reads
     (a record at every origin not flagged, NM the planted count), ``-2
     --bam`` on 131,072 FR pairs, insert 250-450 (decoded with
     ``read_sam_or_bam``: every pair proper at its origin, FLAG 99/147 or 83/163,
     |TLEN| the fragment), ``--edits 2`` on 16,384 reads with two planted
     edits (NM <= 2, CIGARs of 150 read bases, a record within 4 of every
     origin) and 65,536 reads of 50-151 bp (CIGAR the read's length, every
     read at its origin; the same run again as a new process, ``python -m
     tpufm_torch.cli align``, its SAM byte-identical); each run's first
     4,096 reads (pairs) equal to the plain path's through the same writer, each run's seconds, reads/s and
     stages (tables, reads, reference, setup, engine, emit, encode, bgzf,
     write), and the native SAM emitter against its Python loop on 65,536
     reads
 16. the index built on the card (tpufm_torch.index): (a) phase 4's text,
     its k=3 d=192 index, k=1 tail and s=32 locate tables from one device
     suffix sort, equal to phases 4 and 9 (the suffix array to phase 9's
     SA-IS), the sort's rounds (CUDA events), the whole build and the host
     build of the same tables timed; ``build --on-device --tail`` through the
     CLI (the .fmi byte-identical to phase 4's) and ``locate --on-device
     --fused --store`` on 65,536 reads (both stores byte-identical to phase
     10's); (b) K7 (``build_tables``, csrc/build_tables.cu, on the text's
     2-bit pack) bit-identical to its plain version at k 1-4, d=192, timed
     on the device (a CUDA graph of calls, median of 7) and a wrapper call
     back to back, beside its bound and the 32-byte sectors its random text
     reads touch (in the byte text and in the pack), and the pack's kernel
     bit-identical to its plain version, timed beside its bound; (c) ``bench
     --genome`` (250 Mbase) on a fresh cache, its index built on the card,
     every bit_exact field true, then that text sorted again on the card and
     its suffix array held to a full check (a permutation, strictly
     increasing 32-base prefixes on neighbouring rows, ties compared to the
     end on the host), and the pack and K7 (k=3 d=192) on that text and
     suffix array, bit-identical to plain and timed as in (b); (d) the peak
     device memory of that build per base and the MAX_DEVICE_BASES it allows
     at 90% of the card (the set limit must be within it)
 17. the rest of the CLI, on earlier phases' files (host seconds of each
     command printed): (a) ``search --rc --resume`` on phase 4's reads (two
     waves of 2^20): a run killed in process after the first wave (an
     engine wrapper raising), the CLI resuming the second with K1 launched
     one wave's rounds; .res and .res.rc byte-identical to a plain ``search
     --rc``, the checkpoint removed; (b) ``locate --resume --fused
     --max-hits 16`` from phase 10's stores, four waves of 2^18 killed after
     two and resumed, the .pos byte-identical to phase 10's fused .pos, K1
     and K4 counted; (c) the SAM/BAM tools on phase 15(c)'s BAM: ``sort``
     (the records as a multiset, in coordinate order), ``view REGION`` on
     a 16 KiB window edge, a whole contig and 50 kb (each a linear filter's
     records), ``idxstats`` (its mapped counts sum to the mapped records),
     ``flagstat`` (every mapped record in a proper pair), ``depth`` and
     ``bedcov`` (a numpy coverage of the records' CIGARs), ``markdup``,
     ``stats``, ``merge`` of two halves (the sorted records) and ``fastq -1
     -2`` (every read of both FASTQ files back); (d) ``faidx`` of phase 15's
     FASTA and 10 random regions, each the text's slice; (e) ``transform``
     of phase 4's .fmi, each image read back equal to the index; ``search``
     of the .ac image with ``--lut`` refused with tpufm's text, then without
     it on the card through K8's alternate-counters entry (40 rounds from
     the full interval, K1 not launched) to phase 4's intervals (``diff``
     prints IDENTICAL), ``dumpentry`` of entry 0
 18. the other layouts on phase 4's index and reads, every interval equal
     to phase 4's: (a) ``search --engine xla-ac`` of the .ac image (K8's
     alternate-counters entry, 40 rounds a pass from the full interval, K1
     not launched); (b) ``SearchEngine(layout="split", lut_m=12)`` (K8's
     split entry, its LUT built by its own rounds equal to phase 4's); (c)
     ``search --engine xla-paired --lut 12`` (K1's paired entry, the repair
     waves on K1's pair entry, the repair fraction printed); (d) ``search
     --pad-words 128``; each kernel entry at rounds 1 and 18 of phase 4's
     first wave (the alternate counters' from the full interval) against its
     plain version, timed beside its bound (``cuda_ms``, a wrapper call back
     to back, and ``graph_ms``, the kernel on the device alone); (e) the
     ``bench --engine xla-ac
     | xla-split | xla-paired`` records at the flagship's shape; (f) a
     ``sweep`` of 1 Mbase, k 1-3, d 64/128, all five engines, LUT 0 and 6,
     65,536 reads, every row bit-exact
 19. the mesh engines (tpufm_torch.parallel), every interval equal to phase
     4's and every launch count exact: (a) ``search --mesh 1``, ``search
     --sharded --routing a2a --mesh 1`` (its LUT built by its own rounds)
     and ``count --mesh 1`` through the CLI; ``search --mesh 2`` on a
     one-card machine exits with make_mesh's text; the ``bench --multichip``
     and ``bench --sharded --routing a2a`` records (lut12, flagship,
     ``--mesh 1``); DataParallelEngine on one device timed beside
     SearchEngine on the same reads; (b) DataParallelEngine over
     ``Mesh([cuda:0] * 4)``, fused lut12 (K1 pairs 36 a shard) and
     alternate counters (K8-AC 40 a shard); (c) ShardedIndexEngine over the
     same 4 shards, allgather, ring and a2a with lut12 (each LUT equal to
     phase 4's) and a2a without a LUT, the overflow rounds printed,
     ``assert_collective_model`` on a wave of each, and 65,536 copies of
     one read through a2a lut12, whose every round overflows to the
     allgather step on the card; (d) the 250 Mbase text
     built on the card (``return_host=False``), split 4 ways there,
     allgather and a2a lut12 equal to the one-device SearchEngine on
     1,048,576 reads, the first 65,536 to the oracle, device seconds a pass
     of each; (e) K9 (``lf_answer_owned``) against its plain version at
     rounds 1 and 18 of (c)'s allgather wave on every shard (shard 0 timed
     beside its bound), on the ring's half-blocks and the a2a buckets of
     (c)'s lut12 waves (call 1 of every shard, shard 0 timed), on the ring's
     first half at an odd row offset (a stream base off 16 bytes), and on
     edge cases (zero rows, '$' blocks, shard
     edges, rows past the table, owners past the mesh). Four shards on one
     card copy within its memory: no transport time is measured.
 20. the mesh locate (tpufm_torch.parallel.locate), every result held
     against the one-device result of an earlier phase and every launch
     count exact (a shard's walk only where it has rows to walk): (a)
     ``locate --mesh 1`` from phase 10's stores, two-pass, ``--fused``,
     ``--fused --rc`` and ``--fused --resume`` (killed after two of its 32
     waves, resumed), each .pos byte-identical to phase 10's; ``locate --mesh
     2`` on a one-card machine exits with make_mesh's text; the ``bench
     --locate --mesh 1`` record; (b) four colocated shards:
     ``DataParallelLocate.locate_hits`` on phase 4's intervals and
     ``DataParallelSearchLocate.search_locate`` (lut12 from phase 4's cache)
     equal to phase 10, device seconds a pass beside ``SearchLocateEngine``
     (in turns); (c) on the same shards ``locate_mismatch`` (phase 12's
     reads), ``locate_approx`` m=2 and ``locate_edits`` E=2 (phase 14's), and
     ``PairedEndEngine(mesh=...)`` exact (phase 14's 131,072 pairs) and with
     ``--mismatches 2`` and ``--edits 1`` (4,096 pairs), each equal to the
     one-device run; (d) ``align --from-store --mesh 1`` on phase 15's
     fixed-length reads, ``-2 --bam`` pairs and 50-151 bp reads, each file
     byte-identical to phase 15's; (e) the 250 Mbase text sorted once on the
     card, its k=3 d=192 index and s=32 locate tables built there,
     ``DataParallelSearchLocate`` lut12 on four shards equal to
     ``SearchLocateEngine`` on 262,144 reads, every origin among its
     positions where the interval fits max-hits, device seconds a pass of
     both.
 21. the sharded build (tpufm_torch.index.sa_sharded, builder_sharded), on
     four shards of this card: (a) phase 4's text sorted once over them, its
     k=3 d=192 index, k=1 tail and s=32 locate tables built from that sort,
     each equal to phases 4 and 9 (the suffix array to phase 9's SA-IS), K7
     and its pack launched once a shard a table set; the sort again round by
     round (CUDA events), each round's collectives (``recording()``) equal to
     ``sa_sharded.round_collectives``' closed form; K7 on each shard's rows
     (``build_tables(..., p0=...)``, the last shard with pads) bit-identical
     to its plain version and timed beside its bound; (b)
     ``save_store_sharded`` of the ``return_host=False`` tables, every shard
     file byte-identical to phase 4's index split four ways,
     ``load_store_sharded`` and ``ShardedIndexEngine`` (allgather) on phase
     4's reads equal to phase 4, K9 launches exact; through the CLI at
     ``--mesh 1``: ``build --on-device --tail`` (phase 4's .fmi bytes),
     ``--store-sharded`` and ``search --sharded`` of that store (phase 4's
     intervals), ``locate --on-device --fused --store`` (phase 10's stores,
     phase 16's .pos); ``build --on-device --mesh 2`` on a one-card machine
     raises make_mesh's text; (c) the 250 Mbase text sorted on one device and
     on the four shards, the suffix arrays and k=3 d=192 tables equal, both
     timed, the sharded build's peak device memory a base.
 22. the port across processes (tpufm_torch.parallel.mesh
     ``initialize_distributed``): two worker processes (this script with
     ``--mesh-worker``, on the kernels phase 2 built) join one gloo group
     over a localhost coordinator, each owning two shards of this card (a
     four-shard mesh); a worker that fails or runs past its time limit
     fails the run. Each process's results are held to the earlier phase's
     and its launch counts to the exact numbers: (a) phase 4's index and
     1,048,576 reads through ``DataParallelEngine`` (phase 4's LUT) and
     ``ShardedIndexEngine`` allgather (its LUT built by its own rounds
     across processes, equal to phase 4's) and a2a, host seconds a pass, a
     device pass of every read placed at once beside phase 19's, its
     collectives' bytes between shards and across processes against the
     closed form (``traffic.wave_bytes``), the a2a overflow rounds; (b) on
     65,536 of those reads the ring, ``DataParallelLocate.locate_hits`` and
     ``DataParallelSearchLocate.search_locate`` (lut12, max-hits 16, equal
     to phase 10), ``locate_approx`` m=2 on phase 14's seed reads; (c) phase
     4's text sorted over the four shards of both processes (the suffix
     array equal to phase 9's), its k=3 d=192 index and k=1 tail (equal to
     phases 4 and 10), ``save_store_sharded`` by both processes (every file
     byte-identical to phase 21's), ``load_store_sharded`` and
     ``ShardedIndexEngine`` on 65,536 reads; (d) tpufm's chromosome-scale
     case: a seeded 100 Mbase k=3 d=128 index built on the card and stored
     with ``save_store``, opened by both workers, 8,192 x 120 bp reads
     streamed in waves of 2,048 through ``DataParallelEngine`` lut9, equal
     to the one-device ``SearchEngine``. NCCL is not run: one card.
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

import argparse
import contextlib
import dataclasses
import datetime
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpufm_torch import SearchEngine, bench, cli, kernels, profiling
from tpufm_torch import sweep as sweep_mod
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
from tpufm_torch.engine.search import stream_waves
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
from tpufm_torch.host.contigs import read_contigs
from tpufm_torch.host.bam import read_bam
from tpufm_torch.host.formats import (
    load_npz,
    load_store,
    load_store_sharded,
    read_fmi,
    save_store,
    save_store_sharded,
    write_fmi,
)
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
from tpufm_torch.host.locate import build_locate, locate_hits
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.sam import sam_edit_records, sam_paired_records, sam_single_records
from tpufm_torch.host.stream import locate_resumable, search_resumable
from tpufm_torch.host.suffix_array import suffix_array
from tpufm_torch.config import recommend_config
from tpufm_torch.index import builder_device as bd_mod
from tpufm_torch.index import builder_sharded as bs_mod
from tpufm_torch.index import sa_device as sa_mod
from tpufm_torch.index import sa_sharded as sas_mod
from tpufm_torch.index.builder_device import (
    build_index_device,
    build_locate_device,
    build_tables,
    build_tables_reference,
    pack_text_2bit,
    pack_text_2bit_reference,
)
from tpufm_torch.index.builder_sharded import build_index_sharded, build_locate_sharded
from tpufm_torch.index.sa_device import suffix_array_device_arr, upload_text
from tpufm_torch.index.sa_sharded import suffix_array_sharded_arr
from tpufm_torch.engine.tables import host_words, shard_tables
from tpufm_torch.host.index import KStepFMIndex
from tpufm_torch.host.layouts import make_alt_counters
from tpufm_torch.parallel import (
    DataParallelEngine,
    DataParallelLocate,
    DataParallelSearchLocate,
    Mesh,
    ShardedIndexEngine,
    assert_collective_model,
    make_mesh,
)
from tpufm_torch.parallel import collectives as coll
from tpufm_torch.timer import timed_device_passes
from tpufm_torch.host.seqio import (
    decode_bases,
    generate_read_pairs,
    generate_reads,
    load_queries,
    load_queries_varlen,
    load_query_quals,
    read_reference,
    reverse_complement,
    reverse_complement_varlen,
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
#: phase 15: the aligner on phase 4's text as a FASTA of ALIGN_RECORDS
#: records; single reads (a quarter with one planted substitution), FR pairs,
#: reads with two planted edits and trimmed reads; the reads (or pairs) of
#: each run held against the plain path, and the reads the native SAM
#: emitter is timed on against its Python loop
ALIGN_RECORDS, ALIGN_LEN = 24, 150
ALIGN_READS, ALIGN_PAIRS, ALIGN_EDIT_READS, ALIGN_VARLEN_READS = 1 << 18, 1 << 17, 1 << 14, 1 << 16
ALIGN_PLAIN, EMIT_READS = 4096, 1 << 16
#: phase 16: the genome record's reference (bench --genome's default), the
#: reads of the ``locate --on-device`` run, and the share of the card's
#: memory that the derived MAX_DEVICE_BASES lets the device build fill
GENOME_BASES, DEVICE_LOCATE_READS = 250_000_000, 1 << 16
DEVICE_BUILD_SHARE = 0.9
#: phase 16(b): the k at which K7 is held to its plain version and timed
K7_KS = (1, 2, 3, 4)
#: phase 18(f): the sweep's reference and reads
SWEEP_BASES, SWEEP_READS = 1_000_000, 1 << 16
#: phase 19: the shards of the meshes built on this one card; (c)'s batch of
#: one read repeated, whose every a2a round overflows
MESH_SHARDS, SAME_READS = 4, 1 << 16
#: phase 20(e): the reads located on the 250 Mbase text
GENOME_LOCATE_READS = 1 << 18
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
    "lf_round_paired": (lf_mod, "PAIRED_LAUNCHES"),
    "lf_round_split": (lf_mod, "SPLIT_LAUNCHES"),
    "lf_round_ac": (lf_mod, "AC_LAUNCHES"),
    "lf_answer_owned": (lf_mod, "OWNED_LAUNCHES"),
    "row_gather": (rg_mod, "LAUNCHES"),
    "locate_walk": (loc_mod, "LAUNCHES"),
    "hamming_verify": (seed_mod, "LAUNCHES"),
    "myers_verify": (edit_mod, "LAUNCHES"),
    "build_tables": (bd_mod, "LAUNCHES"),
    "pack_text": (bd_mod, "PACK_LAUNCHES"),
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


def prefix_halves(codes: torch.Tensor):
    """The 32-symbol prefix of every suffix of ``codes`` (uint8 [n], on any
    device) and of the sentinel, packed 2 bits a symbol MSB-first into two
    int64 halves of 16 symbols, past the end read as 0: int64 [n+1] each."""
    n = codes.shape[0]
    t = torch.zeros(n + 33, dtype=torch.int64, device=codes.device)
    t[:n] = codes
    halves = []
    for first in (0, 16):
        h = torch.zeros(n + 1, dtype=torch.int64, device=codes.device)
        for j in range(first, first + 16):
            h <<= 2
            h |= t[j:j + n + 1]
        halves.append(h)
    return halves


def check_suffix_array(codes: torch.Tensor, sa: torch.Tensor) -> int:
    """Fail unless ``sa`` (int32 [n+1]) is the suffix array of ``codes`` +
    '$': a permutation of 0..n whose neighbouring rows have strictly
    increasing 32-symbol prefixes, compared further on the host only where
    those tie (a prefix read past the end as 'A' that is strictly smaller
    belongs to the smaller suffix). Returns the rows compared on the host."""
    n = codes.shape[0]
    s = sa.to(torch.int64)
    if s.shape[0] != n + 1 or int(s.min()) < 0 or int(s.max()) > n:
        raise AssertionError(f"suffix array of {s.shape[0]} rows, values outside [0, {n}]")
    seen = torch.zeros(n + 1, dtype=torch.bool, device=s.device)
    seen[s] = True
    if not bool(seen.all()):
        raise AssertionError(f"suffix array: {int((~seen).sum())} positions missing (not a permutation)")
    del seen
    hi, lo = prefix_halves(codes)
    a, b = s[:-1], s[1:]
    ha, hb, la, lb = hi[a], hi[b], lo[a], lo[b]
    del hi, lo
    less = (ha < hb) | ((ha == hb) & (la < lb))
    tie = (ha == hb) & (la == lb)
    if not bool((less | tie).all()):
        bad = int(torch.nonzero(~(less | tie))[0])
        raise AssertionError(f"suffix array: rows {bad} and {bad + 1} out of order")
    (rows,) = torch.nonzero(tie, as_tuple=True)
    if rows.numel():
        text = codes.cpu().numpy()
        for r in rows.tolist():
            x, y = int(s[r]), int(s[r + 1])
            i = 32
            while True:  # '$' (the end) is the smallest symbol
                cx, cy = text[x + i:x + i + 4096], text[y + i:y + i + 4096]
                m = min(len(cx), len(cy))
                diff = np.flatnonzero(cx[:m] != cy[:m])
                if diff.size:
                    ok = cx[diff[0]] < cy[diff[0]]
                    break
                if m < 4096:  # one suffix ended: the shorter is the smaller
                    ok = n - x < n - y
                    break
                i += 4096
            if not ok:
                raise AssertionError(f"suffix array: rows {r} and {r + 1} out of order past 32 symbols")
    return int(rows.numel())


def k7_text_sectors(sa: torch.Tensor, n: int, k: int, bases_per_sector: int = 32) -> int:
    """The 32-byte sectors of the text that K7 reads: at each position p the
    distinct sectors of T[(SA[p] - 1 - i) mod (n + 1)], i < k, the '$' at n
    read as no byte; 32 bases a sector in the byte text, 128 in the 2-bit
    packed text (``pack_text_2bit``)."""
    s = sa.to(torch.int64)
    secs = []
    total = 0
    for i in range(k):
        q = (s - 1 - i) % (n + 1)
        sec = torch.where(q < n, q // bases_per_sector, -1)
        new = sec >= 0
        for prev in secs:
            new &= sec != prev
        total += int(new.sum())
        secs.append(sec)
    return total


def k7_bytes(n: int, k: int, d: int) -> int:
    """The bytes ``build_tables`` must move on an n-base text: the text (a
    byte a base, as the wrapper takes it and its pack launch reads it) and
    the suffix array read once, the planes (row E included), counts and '$'
    positions written once."""
    E = -(-(n + 1) // d)
    return n + 4 * (n + 1) + 4 * (E + 1) * 2 * k * (d // 32) + 4 * E * 4**k + 8 * k


def k7_case(cd: torch.Tensor, order: torch.Tensor, k: int, d: int, run: int = 20) -> dict:
    """K7 on a text and its suffix array on the card: fail unless the
    wrapper's three outputs equal the plain version's bit for bit, then its
    device time (``graph_ms`` of ``run`` calls, the text's pack and K7 in
    each), its time a call back to back (``cuda_ms``), its bytes bound, and
    two references at HBM rate, not bounds where the text stays in L2: the
    bound's bytes with the text read as the sectors a position's k symbols
    touch in the byte text, and with the pack written and its sectors read
    in place of those."""
    n = cd.shape[0]
    got, want = build_tables(cd, order, k, d), build_tables_reference(cd, order, k, d)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("counts", "bitmaps", "dollar_pos")):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"K7 k={k} d={d} on {n} bases: {name} differs from the plain version's")
    del got, want
    nbytes = k7_bytes(n, k, d)
    sectors, packed = k7_text_sectors(order, n, k), k7_text_sectors(order, n, k, bases_per_sector=128)
    return {
        "k": k, "d": d, "bases": n, "max_abs_err": 0,
        "ms": graph_ms(lambda: build_tables(cd, order, k, d), run=run),
        "call_ms": cuda_ms(lambda: build_tables(cd, order, k, d)),
        "bytes": nbytes, "bound_ms": bound_ms(nbytes),
        "sectors": sectors, "sector_bound_ms": bound_ms(nbytes - n + 32 * sectors),
        "packed_sectors": packed, "packed_sector_ms": bound_ms(nbytes + 4 * (-(-n // 16) + 1) + 32 * packed),
    }


def k7_line(case: dict) -> str:
    return (f"k={case['k']} d={case['d']}: {case['ms']:.4f} ms on the device ({case['call_ms']:.4f} a wrapper "
            f"call back to back), bound {case['bound_ms']:.4f} ms ({case['bytes']} B; "
            f"{case['bound_ms'] / case['ms'] * 100:.1f}% of it); sector references: byte text {case['sectors']} "
            f"sectors, {case['sector_bound_ms']:.4f} ms; packed {case['packed_sectors']}, "
            f"{case['packed_sector_ms']:.4f} ms")


def pack_case(cd: torch.Tensor, run: int = 20) -> dict:
    """The text's 2-bit pack on the card: fail unless the kernel's words
    equal the plain version's, then its device time, the plain version's
    and its bytes bound (the text read once, the words written once)."""
    words = pack_text_2bit(cd)
    if not torch.equal(words, pack_text_2bit_reference(cd)):
        raise AssertionError(f"pack_text on {cd.shape[0]} bases differs from the plain version")
    nbytes = cd.shape[0] + 4 * words.shape[0]
    return {"bases": cd.shape[0], "max_abs_err": 0, "ms": graph_ms(lambda: pack_text_2bit(cd), run=run),
            "plain_ms": cuda_ms(lambda: pack_text_2bit_reference(cd), reps=3), "bytes": nbytes,
            "bound_ms": bound_ms(nbytes)}


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


def write_fastq(path, codes: np.ndarray, lengths: np.ndarray, quals: np.ndarray | None = None) -> None:
    """Reads ``codes[j, :lengths[j]]`` as 4-line FASTQ records named r<j>,
    their qualities ``quals[j, :lengths[j]]`` (ASCII bytes) or all 'I'."""
    chunk = 1 << 16
    with open(path, "wb") as fp:
        for base in range(0, codes.shape[0], chunk):
            block = codes[base:base + chunk]
            seqs = decode_bases(block)
            W = block.shape[1]
            qs = None if quals is None else np.ascontiguousarray(quals[base:base + chunk]).tobytes()
            fp.write(b"".join(
                b"@r%d\n%s\n+\n%s\n" % (base + j, seqs[j * W:j * W + n],
                                          b"I" * n if qs is None else qs[j * W:j * W + n])
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
    from torch.profiler import record_function

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
        with profiling.trace() as prof:
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
    runs = {}  # phase 20's inputs: the reads of each path and the one-device results

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
        runs[label] = (run.pairs, run.strand, run.counts, run.overflow)
        del eng
    print(f"    paired: locate --paired on {PAIRS} FR pairs x {READ_LEN} bp, insert [{INSERT_MIN}, {INSERT_MAX}]: "
          f"pass {prun.seconds:.6f} s ({PAIRS / prun.seconds:.0f} pairs/s), {found['paired']['properly_paired']} "
          f"properly paired, every true pair recovered, all equal to the plain path, {PAIRS_ORACLE} equal to "
          f"pair_oracle; launches {by_path['locate_paired']}; --mismatches 2 and --edits 1 on {PAIRS_APPROX} pairs "
          f"with a substitution in every R1 mate: passes {found['paired_mm2']['seconds']:.6f} / "
          f"{found['paired_e1']['seconds']:.6f} s, every true pair recovered, equal to the plain path, launches "
          f"{by_path['paired_mm2']} / {by_path['paired_e1']}; {time.perf_counter() - t0:.2f} s", flush=True)
    runs.update(seed=(sreads, (srun.positions, srun.counts, srun.overflow)),
                edit=(ereads, (erun.positions, erun.counts, erun.overflow)),
                pairs=(r1, r2, minus, (prun.pairs, prun.strand, prun.counts, prun.overflow)), approx_pairs=(a1, a2))
    return {"k5": k5, "k6": k6, "edge_lanes": edge_lanes, "paths": found, "runs": runs}


def write_records(path: str, codes: np.ndarray, bounds: np.ndarray) -> None:
    """``codes`` as a multi-FASTA: record chr<i+1> holds codes[bounds[i]:
    bounds[i+1]], in 70-column lines."""
    with open(path, "wb") as fp:
        for i in range(len(bounds) - 1):
            seq = decode_bases(codes[bounds[i]:bounds[i + 1]])
            fp.write(b">chr%d\n" % (i + 1) + b"\n".join(seq[o:o + 70] for o in range(0, len(seq), 70)) + b"\n")


def strand_reads(codes: np.ndarray, starts: np.ndarray, lengths: np.ndarray, minus: np.ndarray,
                 width: int) -> np.ndarray:
    """uint8 [N, width]: read j in its first lengths[j] columns, the text
    codes[starts[j]:starts[j] + lengths[j]], reverse-complemented where
    minus[j]."""
    t = np.arange(width)[None, :]
    idx = np.where(minus[:, None], starts[:, None] + lengths[:, None] - 1 - t, starts[:, None] + t)
    out = codes[np.clip(idx, 0, codes.shape[0] - 1)]
    return np.where(minus[:, None], 3 - out, out).astype(np.uint8)


def sam_blocks(lines: list, n: int) -> list:
    """The record field lists of SAM record ``lines`` (no header), by read:
    QNAMEs are r<i>."""
    blocks = [[] for _ in range(n)]
    for line in lines:
        f = line.split("\t")
        blocks[int(f[0][1:])].append(f)
    return blocks


def same_text_start(what: str, body: list, plain: str, n: int) -> None:
    """The record lines of the first ``n`` reads in ``body`` (a run's record
    lines) must be exactly ``plain``, the plain path's records of those reads."""
    want = plain.splitlines()
    if body[:len(want)] != want or (len(body) > len(want) and body[len(want)].split("\t")[0] != f"r{n}"):
        raise AssertionError(f"{what}: the SAM records of the first {n} reads differ from the plain path's")


def origin(bounds: np.ndarray, starts: np.ndarray, span: int):
    """(record index, 1-based offset, inside) of text positions ``starts``:
    inside where a ``span``-long match from there stays in its record."""
    rec = np.searchsorted(bounds, starts, side="right") - 1
    return rec, starts - bounds[rec] + 1, starts + span <= bounds[rec + 1]


def aligner(tmp: str, codes: np.ndarray, dev, by_path: dict) -> dict:
    """Phase 15 (see the module docstring): ``align`` through the CLI on a
    24-record FASTA of phase 4's text, five runs, each held against its
    planted truth and, on its first ALIGN_PLAIN reads or pairs, against the
    plain path through the same writer; returns each run's stages."""
    n, L = codes.shape[0], ALIGN_LEN
    rng = np.random.default_rng(SEED + 11)
    weights = rng.uniform(0.5, 1.5, ALIGN_RECORDS)
    bounds = np.concatenate([[0], np.cumsum(weights / weights.sum() * n).astype(np.int64)])
    bounds[-1] = n
    ref = os.path.join(tmp, "chroms.fa")
    write_records(ref, codes, bounds)
    store = os.path.join(tmp, "A")
    plain = dict(step=lf_round_reference, walk=locate_walk_reference)
    found = {}

    def reads_file(name, reads, lengths):
        path = os.path.join(tmp, name)
        write_fastq(path, reads, lengths, rng.integers(33, 75, size=reads.shape, dtype=np.uint8))
        return path

    def run(label, argv, need):
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            r = cli.main(["align", *argv, "--device", dev.type])
        seconds = time.perf_counter() - t0
        by_path[label] = read_counts()
        expect_launches(f"align {label}", by_path[label], need)
        found[label] = {"seconds": seconds, "stages": dict(r.stages)}
        return r, seconds, said.getvalue()

    def stage_line(label):
        return ", ".join(f"{k} {v:.3f}" for k, v in found[label]["stages"].items())

    B = ALIGN_READS
    starts = rng.integers(0, n - L + 1, size=B)
    minus = rng.random(B) < 0.5
    reads = strand_reads(codes, starts, np.full(B, L), minus, L)
    mutated = rng.random(B) < 0.25
    col = rng.integers(0, L, size=B)
    reads[mutated, col[mutated]] = (reads[mutated, col[mutated]] + rng.integers(1, 4, size=int(mutated.sum()))) % 4
    fq = reads_file("se.fq", reads, np.full(B, L))
    rec, pos1, inside = origin(bounds, starts, L)
    lut = next(m for m in range(12 - 12 % K, 0, -K) if 4**m <= n)
    lut_launches = (4**lut // min(4**lut, 1 << 20)) * (lut // K)
    found["lut"] = {"m": lut, "launches": lut_launches}
    rounds = (L - lut) // K
    t0 = time.perf_counter()
    se, se_s, said = run("align_se", [ref, fq, "--store", store, "-o", os.path.join(tmp, "se.sam")], {
        "lf_round_pairs": rounds * -(-2 * B // SearchLocateEngine.WAVE) + lut_launches,
        "locate_walk": -(-2 * B // SearchLocateEngine.WAVE)})
    if f"k={K} d={D} lut={lut}" not in said:
        raise AssertionError(f"align: the auto configuration is not k={K} d={D} lut={lut}: {said.splitlines()[0]}")
    text = Path(se.output).read_text()
    header = [x for x in text.splitlines() if x.startswith("@")]
    body = text.splitlines()[len(header):]
    if header[1:-1] != [f"@SQ\tSN:chr{i + 1}\tLN:{bounds[i + 1] - bounds[i]}" for i in range(ALIGN_RECORDS)]:
        raise AssertionError("align: the @SQ lines differ from the records written")
    blocks = sam_blocks(body, B)
    for i in range(B):
        first = blocks[i][0]
        at_origin = [f for f in blocks[i] if f[2] == f"chr{rec[i] + 1}" and int(f[3]) == pos1[i]]
        if not inside[i]:
            ok = not at_origin
        elif mutated[i]:
            ok = first[1] == "4"
        else:
            ok = (first[1:4] == [str(16 * minus[i]), f"chr{rec[i] + 1}", str(pos1[i])] and first[-1] == "NM:i:0"
                  and len(first[9]) == L)
        if not ok:
            raise AssertionError(f"align: read {i} is not where it was sampled from: {blocks[i]}")
    index_s = load_store(f"{store}.search.tpufm")
    loc_s = load_store(f"{store}.locate.tpufm")
    cmap = read_contigs(ref)
    P_ = ALIGN_PLAIN
    names = [f"r{i}" for i in range(P_)]
    quals = load_query_quals(fq, P_)
    exact = argparse.Namespace(mismatches=0, edits=0)
    eng = SearchLocateEngine(index_s, loc_s, dev, max_hits=MAX_HITS, lut_m=lut)
    pos = cli.single_end_positions(exact, eng, reads[:P_], **plain)[0]
    same_arrays("align (exact)", (pos[:P_], pos[P_:]), (se.positions[:P_], se.positions[B:B + P_]))
    same_text_start("align (exact)", body, sam_single_records(names, reads[:P_], pos[:P_], pos[P_:], cmap,
                                                               quals=quals), P_)
    del eng
    t1 = time.perf_counter()
    sel = slice(0, EMIT_READS)
    e_names = [f"r{i}" for i in range(EMIT_READS)]
    e_quals = load_query_quals(fq, EMIT_READS)
    emit = {}
    for how in ("native", "python"):
        t2 = time.perf_counter()
        emit[how] = sam_single_records(e_names, reads[sel], se.positions[sel], se.positions[B:B + EMIT_READS], cmap,
                                       quals=e_quals, emitter=how)
        emit[f"{how}_s"] = time.perf_counter() - t2
    if emit["native"] != emit["python"]:
        raise AssertionError("sam_single_records: the native emitter and the Python loop differ")
    print(f"[15 aligner] 24-record FASTA of phase 4's text ({int(np.diff(bounds).min())}-"
          f"{int(np.diff(bounds).max())} bases a record), 150 bp FASTQ, half reverse-complemented; auto "
          f"config k={K} d={D} lut={lut}:", flush=True)
    print(f"    (a) align --store, {B} reads, a quarter with one substitution: {se_s:.3f} s host to host "
          f"({B / se_s:.0f} reads/s), stages {stage_line('align_se')}; every error-free read in one record "
          f"primary at its origin (FLAG 0/16, NM:i:0), every spanning read without a record there; first {P_} "
          f"equal to the plain path; launches {by_path['align_se']}; emitter on {EMIT_READS} reads: native "
          f"{emit['native_s']:.4f} s, Python loop {emit['python_s']:.4f} s, the same bytes; checks "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    found["emit"] = {"reads": EMIT_READS, "native_s": emit["native_s"], "python_s": emit["python_s"]}
    del emit, text, body, blocks

    t1 = time.perf_counter()
    m2, m2_s, _ = run("align_m2", [ref, fq, "--from-store", store, "--mismatches", "2",
                                   "-o", os.path.join(tmp, "m2.sam")], {
        "lf_round_pairs": ((L // 3) // K * K - lut) // K * -(-2 * B // SeedExtendEngine.WAVE) + lut_launches,
        "locate_walk": -(-2 * B // SeedExtendEngine.WAVE),
        "hamming_verify": -(-2 * B // SeedExtendEngine.WAVE)})
    body = [x for x in Path(m2.output).read_text().splitlines() if not x.startswith("@")]
    blocks = sam_blocks(body, B)
    flagged = m2.overflow[:B] | m2.overflow[B:]
    for i in np.flatnonzero(inside & ~flagged):
        want = [str(16 * minus[i]), f"chr{rec[i] + 1}", str(pos1[i])]
        if not any([str(int(f[1]) & ~0x100), f[2], f[3]] == want and f[-1] == f"NM:i:{int(mutated[i])}"
                   for f in blocks[i]):
            raise AssertionError(f"align --mismatches 2: read {i} has no record at its origin: {blocks[i]}")
    eng = SeedExtendEngine(index_s, loc_s, codes, mismatches=2, max_hits=MAX_HITS, lut_m=lut, device=dev)
    pos, ovf = cli.single_end_positions(argparse.Namespace(mismatches=2, edits=0), eng, reads[:P_],
                                        verify=hamming_to_text_reference, **plain)
    same_arrays("align --mismatches 2", (pos[:P_], pos[P_:], ovf[:P_], ovf[P_:]),
                (m2.positions[:P_], m2.positions[B:B + P_], m2.overflow[:P_], m2.overflow[B:B + P_]))
    same_text_start("align --mismatches 2", body, sam_single_records(
        names, reads[:P_], pos[:P_], pos[P_:], cmap, codes=codes, quals=quals), P_)
    del eng, body, blocks
    print(f"    (b) align --from-store --mismatches 2, the same reads: {m2_s:.3f} s ({B / m2_s:.0f} reads/s), "
          f"stages {stage_line('align_m2')}; {int(flagged.sum())} reads flagged, every other read in one record "
          f"has a record at its origin with NM its planted count; first {P_} equal to the plain path; launches "
          f"{by_path['align_m2']}; checks {time.perf_counter() - t1:.2f} s", flush=True)

    t1 = time.perf_counter()
    NP = ALIGN_PAIRS
    r1, r2, (ls, rs, pminus) = generate_read_pairs(codes, L, NP, INSERT_MIN, INSERT_MAX, seed=SEED + 12,
                                                   return_truth=True)
    q1, q2 = reads_file("pe_1.fq", r1, np.full(NP, L)), reads_file("pe_2.fq", r2, np.full(NP, L))
    pe, pe_s, _ = run("align_paired", [ref, q1, "-2", q2, "--from-store", store, "--bam", "--insert-min",
                                       str(INSERT_MIN), "--insert-max", str(INSERT_MAX),
                                       "-o", os.path.join(tmp, "pe.bam")], {
        "lf_round_pairs": rounds * -(-4 * NP // SearchLocateEngine.WAVE) + lut_launches,
        "locate_walk": -(-4 * NP // SearchLocateEngine.WAVE)})
    body = [x for x in cli.read_sam_or_bam(pe.output).splitlines() if not x.startswith("@")]  # BAM decoded
    blocks = sam_blocks(body, NP)
    lrec, lpos1, _ = origin(bounds, ls, L)
    rrec, rpos1, _ = origin(bounds, rs, L)
    frag = rs + L - ls
    inside_pairs = np.flatnonzero((lrec == rrec) & (rs + L <= bounds[rrec + 1]))
    found["fasta"] = {"path": ref, "bounds": bounds}
    for i in inside_pairs:
        a, b = blocks[i][0], blocks[i][1]
        chrom = f"chr{lrec[i] + 1}"
        want = ([str(0x53), chrom, str(rpos1[i]), str(-frag[i])], [str(0xA3), chrom, str(lpos1[i]), str(frag[i])]) \
            if pminus[i] else ([str(0x63), chrom, str(lpos1[i]), str(frag[i])],
                               [str(0x93), chrom, str(rpos1[i]), str(-frag[i])])
        if [a[1], a[2], a[3], a[8]] != want[0] or [b[1], b[2], b[3], b[8]] != want[1]:
            raise AssertionError(f"align -2: pair {i} is not proper at its origin: {blocks[i]}")
    eng = PairedEndEngine(index_s, loc_s, INSERT_MIN, INSERT_MAX, max_hits=MAX_HITS, lut_m=lut, device=dev)
    got = eng.pair(r1[:P_], r2[:P_], **plain)
    same_arrays("align -2", got, (pe.pairs.pairs[:P_], pe.pairs.strand[:P_], pe.pairs.counts[:P_],
                                  pe.pairs.overflow[:P_]))
    same_text_start("align -2", body, sam_paired_records(
        names, r1[:P_], r2[:P_], got[0], got[1], cmap, quals1=load_query_quals(q1, P_),
        quals2=load_query_quals(q2, P_)), P_)
    del eng, body, blocks
    print(f"    (c) align -2 --from-store --bam, {NP} FR pairs, insert [{INSERT_MIN}, {INSERT_MAX}]: {pe_s:.3f} s "
          f"({NP / pe_s:.0f} pairs/s), stages {stage_line('align_paired')}; decoded with read_sam_or_bam, every pair in "
          f"one record proper at its origin (FLAG 99/147 or 83/163, |TLEN| the fragment); first {P_} equal to "
          f"the plain path; launches {by_path['align_paired']}; checks {time.perf_counter() - t1:.2f} s",
          flush=True)
    found["align_paired"]["inside_pairs"] = int(inside_pairs.size)

    t1 = time.perf_counter()
    NE, E = ALIGN_EDIT_READS, 2
    ereads, eorig = bench.edit_reads(codes, np.random.default_rng(SEED + 13), L, E, NE)
    eminus = rng.random(NE) < 0.5
    ereads[eminus] = reverse_complement(ereads[eminus])
    eq = reads_file("e2.fq", ereads, np.full(NE, L))
    e2, e2_s, _ = run("align_e2", [ref, eq, "--from-store", store, "--edits", str(E),
                                   "-o", os.path.join(tmp, "e2.sam")], {
        "lf_round_pairs": ((L // 3) // K * K - lut) // K * -(-2 * NE // EditExtendEngine.WAVE) + lut_launches,
        "locate_walk": -(-2 * NE // EditExtendEngine.WAVE),
        "myers_verify": -(-2 * NE // EditExtendEngine.WAVE)})
    body = [x for x in Path(e2.output).read_text().splitlines() if not x.startswith("@")]
    blocks = sam_blocks(body, NE)
    erec, epos1, einside = origin(bounds, eorig, L + E)
    einside &= epos1 > 2 * E
    flagged = e2.overflow[:NE] | e2.overflow[NE:]
    for i in range(NE):
        mapped = [f for f in blocks[i] if f[1] != "4"]
        for f in mapped:
            ops = re.findall(r"(\d+)([MID])", f[5])
            if int(f[-1][5:]) > E or sum(int(c) for c, op in ops if op in "MI") != L:
                raise AssertionError(f"align --edits {E}: read {i} has a record past E or off its length: {f}")
        if einside[i] and not flagged[i] and not any(
                f[2] == f"chr{erec[i] + 1}" and abs(int(f[3]) - epos1[i]) <= 2 * E for f in mapped):
            raise AssertionError(f"align --edits {E}: read {i} has no record within {2 * E} of its origin")
    eng = EditExtendEngine(index_s, loc_s, codes, edits=E, max_hits=MAX_HITS, lut_m=lut, device=dev)
    pos, ovf = cli.single_end_positions(argparse.Namespace(mismatches=0, edits=E), eng, ereads[:P_],
                                        verify=myers_verify_reference, **plain)
    same_arrays(f"align --edits {E}", (pos[:P_], pos[P_:], ovf[:P_], ovf[P_:]),
                (e2.positions[:P_], e2.positions[NE:NE + P_], e2.overflow[:P_], e2.overflow[NE:NE + P_]))
    same_text_start(f"align --edits {E}", body, sam_edit_records(
        names, ereads[:P_], pos[:P_], pos[P_:], cmap, codes, E, quals=load_query_quals(eq, P_)), P_)
    del eng, body, blocks
    print(f"    (d) align --from-store --edits {E}, {NE} reads with {E} planted edits: {e2_s:.3f} s "
          f"({NE / e2_s:.0f} reads/s), stages {stage_line('align_e2')}; every record NM <= {E} with a CIGAR of "
          f"{L} read bases, a record within {2 * E} of every origin not flagged ({int(flagged.sum())} flagged); "
          f"first {P_} equal to the plain path; launches {by_path['align_e2']}; checks "
          f"{time.perf_counter() - t1:.2f} s", flush=True)

    t1 = time.perf_counter()
    NV = ALIGN_VARLEN_READS
    vlen = rng.integers(VARLEN_MIN, VARLEN_MAX + 1, size=NV)
    vstarts = rng.integers(0, n - VARLEN_MAX + 1, size=NV)
    vminus = rng.random(NV) < 0.5
    vq = reads_file("v.fq", strand_reads(codes, vstarts, vlen, vminus, VARLEN_MAX), vlen)
    vbatch = load_queries_varlen(vq)
    vrounds = (VARLEN_MAX + (-(VARLEN_MAX - lut) % K) - lut) // K
    va, va_s, _ = run("align_varlen", [ref, vq, "--from-store", store, "-o", os.path.join(tmp, "v.sam")], {
        "lf_round_pairs": vrounds + lut_launches, "locate_walk": 1})
    body = [x for x in Path(va.output).read_text().splitlines() if not x.startswith("@")]
    blocks = sam_blocks(body, NV)
    vrec, vpos1, vinside = origin(bounds, vstarts, vlen)
    for i in range(NV):
        if any(f[1] != "4" and f[5] != f"{vlen[i]}M" for f in blocks[i]):
            raise AssertionError(f"align (mixed lengths): read {i}'s CIGAR is not its length {vlen[i]}")
        if vinside[i] and blocks[i][0][1:4] != [str(16 * vminus[i]), f"chr{vrec[i] + 1}", str(vpos1[i])]:
            raise AssertionError(f"align (mixed lengths): read {i} is not at its origin: {blocks[i]}")
    search = SearchEngine(index_s, dev, lut_m=lut, tail_index=loc_s.lf1)
    vb = vbatch[:P_]
    v2 = np.concatenate([vb, reverse_complement_varlen(vb)])
    pos = LocateEngine(loc_s, dev).locate_hits(search.search_varlen(v2, step=lf_round_reference), MAX_HITS,
                                               walk=locate_walk_reference)
    same_arrays("align (mixed lengths)", (pos[:P_], pos[P_:]), (va.positions[:P_], va.positions[NV:NV + P_]))
    same_text_start("align (mixed lengths)", body, sam_single_records(
        names, vb, pos[:P_], pos[P_:], cmap, lengths=vlen[:P_], quals=load_query_quals(vq, P_)), P_)
    del search, body, blocks
    # the same run as a user starts it: a new process (interpreter, torch,
    # the card, the built kernel libraries loaded, the first pass)
    cold = os.path.join(tmp, "v_cold.sam")
    t2 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpufm_torch.cli", "align", ref, vq, "--from-store", store,
                           "-o", cold, "--device", dev.type], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    cold_s = time.perf_counter() - t2
    if proc.returncode != 0 or Path(cold).read_bytes() != Path(va.output).read_bytes():
        raise AssertionError(f"align in a new process: exit {proc.returncode}, or its SAM differs: {proc.stderr}")
    found["align_varlen"]["new_process_seconds"] = cold_s
    found["mesh_inputs"] = {"ref": ref, "store": store, "lut": lut, "se": (fq, se.output, se.positions),
                            "paired": (q1, q2, pe.output, pminus), "varlen": (vq, va.output, va.positions)}
    print(f"    (e) align --from-store, {NV} reads of {VARLEN_MIN}-{VARLEN_MAX} bp: {va_s:.3f} s "
          f"({NV / va_s:.0f} reads/s), stages {stage_line('align_varlen')}; every CIGAR its read's length, "
          f"every read in one record primary at its origin; first {P_} equal to the plain path; launches "
          f"{by_path['align_varlen']}; the same command as a new process (python -m tpufm_torch.cli align): "
          f"{cold_s:.3f} s, the same SAM bytes; checks {time.perf_counter() - t1 - cold_s:.2f} s; phase "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return found


def tree_bytes(path: str) -> dict:
    """{relative name: bytes} of every file under a .tpufm store."""
    root = Path(path)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def same_tables(what: str, got, want, fields) -> None:
    """Fail unless each field of ``got`` equals ``want``'s, dtype included."""
    for f in fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {f} differs from the host build ({a.dtype} {b.dtype})")


INDEX_FIELDS = ("occ", "bitmaps", "dollar_pos", "dollar_base")


def cuda_events_ms(fn):
    """(fn's result, its device milliseconds between two CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def device_build(tmp: str, ref: str, codes: np.ndarray, index, fmi: str, sa: np.ndarray, loc, store: str,
                 reads: np.ndarray, dev, by_path: dict) -> dict:
    """Phase 16: the index built on the card. (a) At 10 Mbase, the k=3 d=192
    index, its k=1 tail and the s=32 locate tables from one device sort,
    equal to phase 4's index, phase 9's locate tables and suffix array, the
    rounds and the whole build timed beside the host build of the same
    tables; ``build --on-device --tail`` through the CLI writing phase 4's
    .fmi bytes; ``locate --on-device --store`` writing phase 10's stores.
    (b) K7 against its plain version at k 1-4 on that text, timed beside
    its bound. (c) ``bench --genome`` at 250 Mbase on a fresh cache (the
    device build, every bit_exact field true), then that text sorted again
    on the card, its suffix array held to a full check, K7 held to its plain
    version and timed there. (d) The peak device memory of the 250 Mbase
    build per base and the MAX_DEVICE_BASES it allows."""
    t0 = time.perf_counter()
    n = codes.shape[0]
    t1 = time.perf_counter()
    hsa = suffix_array(codes)
    host_sort_s = time.perf_counter() - t1
    build_index(codes, IndexConfig(k=K, d=D), sa=hsa)
    build_index(codes, IndexConfig(k=1, d=D), sa=hsa)
    build_locate(codes, sample_rate=SAMPLE_RATE, d=D, sa=hsa)
    host_s = time.perf_counter() - t1
    del hsa

    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    cd = upload_text(codes, dev)
    order = suffix_array_device_arr(cd)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t1
    d_index = build_index_device(codes, IndexConfig(k=K, d=D), sa_dev=order, codes_dev=cd)
    d_tail = build_index_device(codes, IndexConfig(k=1, d=D), sa_dev=order, codes_dev=cd)
    d_loc = build_locate_device(codes, sample_rate=SAMPLE_RATE, d=D, sa_dev=order, codes_dev=cd)
    device_s = time.perf_counter() - t1
    by_path["device_build"] = read_counts()
    expect_launches("device build", by_path["device_build"], {"build_tables": 3, "pack_text": 3})
    same_tables("device k=3 index", d_index, index, INDEX_FIELDS)
    same_tables("device k=1 tail", d_tail, loc.lf1, INDEX_FIELDS)
    same_tables("device locate tables", d_loc, loc, ("samples", "mark_words", "mark_rank"))
    same_tables("device locate k=1 index", d_loc.lf1, loc.lf1, INDEX_FIELDS)
    if not np.array_equal(order.cpu().numpy().astype(np.int64), sa):
        raise AssertionError("device suffix array differs from phase 9's SA-IS suffix array")
    del d_index, d_tail, d_loc

    rounds = []  # the sort again round by round, each between CUDA events
    (rank, again, distinct), ms = cuda_events_ms(lambda: sa_mod.initial(cd))
    rounds.append(ms)
    h = sa_mod.PACK
    while not bool(distinct) and h < n + 1:
        del again
        (rank, again, distinct), ms = cuda_events_ms(lambda: sa_mod.step(rank, h))
        rounds.append(ms)
        h *= 2
    if not torch.equal(again.to(torch.int32), order):
        raise AssertionError("the sort's rounds one by one end elsewhere than suffix_array_device_arr")
    del rank, again
    torch.cuda.empty_cache()

    # (b) K7 against its plain version at k 1-4, d=192
    k7_cases = {k: k7_case(cd, order, k, D) for k in K7_KS}
    k7 = dict(k7_cases[K], plain_ms=cuda_ms(lambda: build_tables_reference(cd, order, K, D)),
              k_ms={k: c["ms"] for k, c in k7_cases.items()},
              k_call_ms={k: c["call_ms"] for k, c in k7_cases.items()}, cases=list(k7_cases.values()))
    pack = pack_case(cd)
    del cd, order
    torch.cuda.empty_cache()
    print(f"[16 device build] (a) {n} bases, k={K} d={D} index + k=1 tail + s={SAMPLE_RATE} locate tables "
          f"from one device sort, each equal to phases 4 and 9 (the suffix array too): host {host_s:.2f} s "
          f"(SA-IS {host_sort_s:.2f} s), device {device_s:.3f} s (upload and sort {sort_s:.3f} s; rounds "
          f"{', '.join(f'{ms:.3f}' for ms in rounds)} ms; K7 launches {by_path['device_build']['build_tables']})",
          flush=True)
    print(f"    (b) K7 vs plain, bit-identical at k {', '.join(map(str, K7_KS))}; plain k={K} "
          f"{k7['plain_ms']:.4f} ms; the text's 2-bit pack (inside each K7 call) bit-identical to plain: "
          f"{pack['ms']:.4f} ms, plain {pack['plain_ms']:.4f} ms, bound {pack['bound_ms']:.4f} ms", flush=True)
    for case in k7_cases.values():
        print(f"        {k7_line(case)}", flush=True)

    t1 = time.perf_counter()
    out = os.path.join(tmp, "ondev.fmi")
    reset_counts()
    run = cli.main(["build", ref, str(n), "--k", str(K), "--d", str(D), "--on-device", "--tail",
                    "--output", out])
    by_path["build_on_device"] = read_counts()
    expect_launches("build --on-device --tail", by_path["build_on_device"], {"build_tables": 2, "pack_text": 2})
    if Path(out).read_bytes() != Path(fmi).read_bytes():
        raise AssertionError("build --on-device: the .fmi differs from phase 4's")
    same_tables("build --on-device --tail: the tail", load_npz(out + ".tail.npz"), loc.lf1, INDEX_FIELDS)
    cli_build_s = time.perf_counter() - t1
    del run
    t1 = time.perf_counter()
    qry = os.path.join(tmp, "ondev.qry")
    write_reads_fasta(qry, reads[:DEVICE_LOCATE_READS])
    reset_counts()
    cli.main(["locate", ref, str(n), qry, str(READ_LEN), str(DEVICE_LOCATE_READS), "--k", str(K), "--d", str(D),
              "--sample-rate", str(SAMPLE_RATE), "--max-hits", str(MAX_HITS), "--lut", str(LUT_M), "--fused",
              "--on-device", "--store", os.path.join(tmp, "ondev"), "--output", os.path.join(tmp, "ondev.pos")])
    by_path["locate_on_device"] = read_counts()
    expect_launches("locate --on-device", by_path["locate_on_device"],
                    {"build_tables": 2, "pack_text": 2, "lf_round_pairs": (READ_LEN - LUT_M) // K,
                     "locate_walk": 1})
    for kind in ("search", "locate"):
        if tree_bytes(os.path.join(tmp, f"ondev.{kind}.tpufm")) != tree_bytes(f"{store}.{kind}.tpufm"):
            raise AssertionError(f"locate --on-device --store: {kind}.tpufm differs from phase 10's store")
    print(f"    build --on-device --tail through the CLI: .fmi byte-identical to phase 4's, tail equal, "
          f"{cli_build_s:.2f} s, launches {by_path['build_on_device']}; locate --on-device --fused --store on "
          f"{DEVICE_LOCATE_READS} reads: both stores byte-identical to phase 10's, "
          f"{time.perf_counter() - t1:.2f} s, launches {by_path['locate_on_device']}", flush=True)

    # (c) the genome record on a fresh cache: its index built on the card
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    reset_counts()
    record = bench.run_bench_genome(refsize=GENOME_BASES, device=dev, cache_dir=os.path.join(tmp, "genome"))
    by_path["genome"] = read_counts()
    detail = record["detail"]
    flags = {key: v for key, v in detail.items() if key.startswith("bit_exact")}
    if not flags or not all(v is True for v in flags.values()) or detail["index_cached"]:
        raise AssertionError(f"bench --genome: {flags}, index_cached {detail['index_cached']}")
    expect_launches("bench --genome", by_path["genome"], {"build_tables": 1, "pack_text": 1, "lf_round_pairs": 1})
    genome_s = time.perf_counter() - t1
    print(f"    (c) bench --genome, {GENOME_BASES} bases, fresh cache ({genome_s:.2f} s): "
          f"{json.dumps(record)}", flush=True)
    shutil.rmtree(os.path.join(tmp, "genome"))
    del record

    # the genome's text sorted again on the card: the peak of the build and a full check
    _, gcodes = bench._reference_codes(GENOME_BASES, 0)
    rec = recommend_config(GENOME_BASES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    gcd = upload_text(gcodes, dev)
    gorder = suffix_array_device_arr(gcd)
    torch.cuda.synchronize()
    gsort_s = time.perf_counter() - t1
    sort_peak = torch.cuda.max_memory_allocated(dev) - base
    gidx = build_index_device(gcodes, IndexConfig(k=rec["k"], d=rec["d"]), return_host=False,
                              sa_dev=gorder, codes_dev=gcd)
    torch.cuda.synchronize()
    gbuild_s = time.perf_counter() - t1
    build_peak = torch.cuda.max_memory_allocated(dev) - base
    del gidx
    torch.cuda.empty_cache()
    # K7 on the genome's text and suffix array, against its plain version
    genome_pack = pack_case(gcd, run=5)
    genome_k7 = k7_case(gcd, gorder, rec["k"], rec["d"], run=5)
    torch.cuda.empty_cache()
    print(f"    K7 on the {GENOME_BASES}-base text, bit-identical to plain: {k7_line(genome_k7)}; the pack, "
          f"bit-identical: {genome_pack['ms']:.4f} ms, plain {genome_pack['plain_ms']:.4f} ms, bound "
          f"{genome_pack['bound_ms']:.4f} ms", flush=True)
    t1 = time.perf_counter()
    deep = check_suffix_array(gcd, gorder)
    check_s = time.perf_counter() - t1
    del gcd, gorder
    torch.cuda.empty_cache()
    per_base = build_peak / GENOME_BASES
    total = torch.cuda.get_device_properties(dev).total_memory
    derived = min(2**31 - 2, int(DEVICE_BUILD_SHARE * total / per_base) // 10_000_000 * 10_000_000)
    print(f"    {GENOME_BASES} bases sorted again: {gsort_s:.3f} s (upload and sort), the k={rec['k']} "
          f"d={rec['d']} build {gbuild_s:.3f} s; suffix array a permutation with strictly increasing 32-base "
          f"prefixes on neighbouring rows ({deep} ties compared to the end on the host; check {check_s:.2f} s)",
          flush=True)
    print(f"    (d) peak device memory: the sort {sort_peak} B ({sort_peak / GENOME_BASES:.2f} B/base), the "
          f"build {build_peak} B ({per_base:.2f} B/base); card {total} B: MAX_DEVICE_BASES up to {derived} "
          f"at {DEVICE_BUILD_SHARE:.0%} of it (set: {sa_mod.MAX_DEVICE_BASES}); phase "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if sa_mod.MAX_DEVICE_BASES > derived:
        raise AssertionError(f"MAX_DEVICE_BASES {sa_mod.MAX_DEVICE_BASES} is past the {derived} this card allows")
    k7["genome"] = genome_k7
    pack["genome"] = genome_pack
    return {"k7": k7, "pack": pack, "summary": {
        "bases": n, "host_s": host_s, "host_sort_s": host_sort_s, "device_s": device_s,
        "device_sort_s": sort_s, "round_ms": rounds, "cli_build_s": cli_build_s,
        "genome_build_seconds": detail["build_seconds"], "genome_record_s": genome_s,
        "genome_sort_s": gsort_s, "genome_device_build_s": gbuild_s, "sort_peak_bytes": sort_peak,
        "build_peak_bytes": build_peak, "peak_bytes_per_base": per_base, "card_bytes": total,
        "max_device_bases_derived": derived, "max_device_bases": sa_mod.MAX_DEVICE_BASES,
        "sa_ties_checked_on_host": deep}}


class Crashing:
    """An engine whose ``method`` raises after ``left`` calls, as a run
    killed mid-stream; every other attribute is the engine's."""

    def __init__(self, engine, left: int, method: str):
        self._engine, self._left, self._method = engine, left, method

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name != self._method:
            return attr

        def call(*args, **kwargs):
            if self._left == 0:
                raise RuntimeError("simulated crash")
            self._left -= 1
            return attr(*args, **kwargs)
        return call


def crash_after(run, what: str, out: str, waves: int) -> None:
    """``run()`` must die of the simulated crash and leave a checkpoint of
    ``waves`` completed waves beside ``out``."""
    try:
        run()
    except RuntimeError as e:
        if "simulated crash" not in str(e):
            raise
    else:
        raise AssertionError(f"{what}: the first run did not crash")
    done = json.loads(Path(out + ".progress").read_text())["done_waves"]
    if done != waves:
        raise AssertionError(f"{what}: the crashed run left {done} waves, expected {waves}")


def ref_span(f: list) -> int:
    """Reference bases a SAM record's CIGAR spans (M, D, N, =, X)."""
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5]) if op in "MDN=X")


def overlapping(records: list, contig: str, beg0: int, end0: int) -> list:
    """The records overlapping [beg0, end0) of ``contig``, in their order:
    the linear filter an indexed region query must equal."""
    return [f for f in records if f[2] == contig
            and int(f[3]) - 1 < end0 and int(f[3]) - 1 + max(ref_span(f), 1) > beg0]


def coverage(records: list, contig: str, beg0: int, end0: int) -> np.ndarray:
    """int64 [end0 - beg0]: the depth over [beg0, end0) of the records' M, =
    and X bases, unmapped, secondary, QC-failed and duplicate records left
    out (samtools depth's rule)."""
    diff = np.zeros(end0 - beg0 + 1, np.int64)
    for f in records:
        if f[2] != contig or int(f[1]) & 0x704 or f[5] == "*":
            continue
        p = int(f[3]) - 1
        for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5]):
            n = int(n)
            if op in "M=X":
                lo, hi = min(max(p - beg0, 0), end0 - beg0), min(max(p + n - beg0, 0), end0 - beg0)
                diff[lo] += 1
                diff[hi] -= 1
            if op in "MDN=X":
                p += n
    return np.cumsum(diff[:-1])


def fastq_set(path: str) -> set:
    """{(name, bases, qualities)} of a FASTQ file's records."""
    lines = Path(path).read_text().splitlines()
    return {(lines[i][1:], lines[i + 1], lines[i + 3]) for i in range(0, len(lines), 4)}


def resume_and_tools(tmp: str, codes: np.ndarray, index, fmi: str, qry: str, store: str, pos_fused: str,
                     align: dict, dev, by_path: dict, lut_launches: int) -> dict:
    """Phase 17 (see the module docstring): ``search --resume`` and ``locate
    --resume`` continuing runs killed in process, the SAM/BAM tools on phase
    15(c)'s BAM, ``faidx`` of phase 15's FASTA, ``transform`` of phase 4's
    .fmi and a search of its alternate-counters image on the card. Returns
    each command's host seconds."""
    t0 = time.perf_counter()
    seconds = {}

    def command(label: str, argv: list):
        """``argv`` through the CLI, its standard output and error captured;
        (its result, what it printed)."""
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said, contextlib.redirect_stderr(io.StringIO()):
            run = cli.main(argv)
        seconds[label] = time.perf_counter() - t1
        return run, said.getvalue()

    def same_bytes(what: str, a: str, b: str) -> None:
        if Path(a).read_bytes() != Path(b).read_bytes():
            raise AssertionError(f"{what}: {a} and {b} differ")

    rounds = (READ_LEN - LUT_M) // K
    reads_res = os.path.join(tmp, "reads.res")  # phase 4's intervals
    # (a) search --resume --rc: 2M reads, two waves of 2^20; the first run
    # dies after one, the CLI finishes the other
    out, plain = os.path.join(tmp, "resume.res"), os.path.join(tmp, "rc.res")
    argv = ["search", fmi, qry, str(READ_LEN), str(READS), "--lut", str(LUT_M), "--rc", "--device", "cuda"]
    engine = SearchEngine(cli.load_index(fmi), dev, lut_m=LUT_M, lut_cache=f"{fmi}.lut{LUT_M}.npz")
    both = cli.rc_expand(load_queries(qry, READ_LEN, READS))
    crash_after(lambda: search_resumable(Crashing(engine, 1, "search"), both, out), "search --resume", out, 1)
    del engine, both
    reset_counts()
    resumed, said = command("search --resume (second wave)", [*argv, "--resume", "--output", out])
    by_path["resume_search"] = read_counts()
    if by_path["resume_search"]["lf_round_pairs"] != rounds:
        raise AssertionError(f"search --resume: K1 launched {by_path['resume_search']['lf_round_pairs']} "
                             f"times, one wave's {rounds} expected")
    reset_counts()
    command("search --rc", [*argv, "--iterations", "1", "--output", plain])
    by_path["search_rc"] = read_counts()
    expect_launches("search --rc", by_path["search_rc"], {"lf_round_pairs": 2 * 2 * rounds})
    same_bytes("search --resume", out, plain)
    same_bytes("search --resume (minus strand)", out + ".rc", plain + ".rc")
    same_bytes("search --resume against phase 4", out, reads_res)
    if any(os.path.exists(out + x) for x in (".partial", ".progress")):
        raise AssertionError("search --resume: the checkpoint files are left")
    print(f"[17 --resume, SAM/BAM tools, faidx, transform] (a) search --resume --rc, {2 * READS} reads in two "
          f"waves: a run killed after the first wave, the CLI resumed the second (TIME: "
          f"{resumed.seconds_per_pass:.6f} s, K1 launches {by_path['resume_search']['lf_round_pairs']} = one "
          f"wave's); .res and .res.rc byte-identical to a plain search --rc (launches "
          f"{by_path['search_rc']['lf_round_pairs']}) and .res to phase 4's; checkpoint removed", flush=True)

    # (b) locate --resume --fused: four waves of 2^18, killed after two
    out = os.path.join(tmp, "resume.pos")
    index_s, loc_s = load_store(f"{store}.search.tpufm"), load_store(f"{store}.locate.tpufm")
    sle = SearchLocateEngine(index_s, loc_s, dev, max_hits=MAX_HITS, lut_m=LUT_M)
    reads = load_queries(qry, READ_LEN, READS)
    crash_after(lambda: locate_resumable(Crashing(sle, 2, "search_locate"), reads, out), "locate --resume", out, 2)
    del sle, reads, index_s, loc_s
    reset_counts()
    command("locate --resume (waves 3-4)", [
        "locate", "-", "0", qry, str(READ_LEN), str(READS), "--k", str(K), "--d", str(D), "--sample-rate",
        str(SAMPLE_RATE), "--max-hits", str(MAX_HITS), "--lut", str(LUT_M), "--device", "cuda",
        "--from-store", store, "--fused", "--resume", "--output", out])
    by_path["resume_locate"] = read_counts()
    want = {"lf_round_pairs": 2 * rounds + lut_launches, "locate_walk": 2}
    if {n: by_path["resume_locate"][n] for n in want} != want:
        raise AssertionError(f"locate --resume: launches {by_path['resume_locate']}, expected {want}")
    same_bytes("locate --resume", out, pos_fused)
    print(f"    (b) locate --resume --fused --max-hits {MAX_HITS}, {READS} reads in four waves of "
          f"{SearchLocateEngine.WAVE}: killed after two, resumed; .pos byte-identical to phase 10's fused .pos; "
          f"launches K1 {by_path['resume_locate']['lf_round_pairs']} (two waves' {2 * rounds} + the LUT's "
          f"{lut_launches}), K4 {by_path['resume_locate']['locate_walk']}", flush=True)

    # (c) the SAM/BAM tools on phase 15(c)'s BAM
    bam, srt = os.path.join(tmp, "pe.bam"), os.path.join(tmp, "sorted.bam")
    header, recs = read_bam(bam)
    command("sort", ["sort", bam, "--output", srt])
    sheader, srecs = read_bam(srt)
    if sorted(map(tuple, srecs)) != sorted(map(tuple, recs)):
        raise AssertionError("sort: the sorted records are not the input's")
    rank = {line.split("\t")[1][3:]: i for i, line in enumerate(x for x in sheader.splitlines()
                                                                if x.startswith("@SQ"))}
    keys = [(1, 0, 0) if f[2] == "*" else (0, rank[f[2]], int(f[3])) for f in srecs]
    if any(a > b for a, b in zip(keys, keys[1:])):
        raise AssertionError("sort: the records are not in coordinate order")
    bounds = align["fasta"]["bounds"]
    length = {f"chr{i + 1}": int(bounds[i + 1] - bounds[i]) for i in range(ALIGN_RECORDS)}
    rng = np.random.default_rng(SEED + 17)
    b12 = int(rng.integers(1, length["chr12"] - 50_000))
    regions = {"a 16 KiB window edge": ("chr3", (1 << 14) - 200, (1 << 14) + 200),
               "a whole contig": ("chr7", 0, length["chr7"]), "50 kb of chr12": ("chr12", b12 - 1, b12 + 49_999)}
    viewed = {}
    for what, (contig, beg0, end0) in regions.items():
        text = f"{contig}:{beg0 + 1}-{end0}" if what != "a whole contig" else contig
        got = [x.split("\t") for x in command(f"view {text}", ["view", srt, text, "--no-header"])[1].splitlines()]
        if got != overlapping(srecs, contig, beg0, end0) or not got:
            raise AssertionError(f"view {text}: not the records a linear filter finds")
        viewed[text] = len(got)
    rows = [x.split("\t") for x in command("idxstats", ["idxstats", srt])[1].splitlines()]
    mapped = sum(1 for f in srecs if f[2] != "*" and not int(f[1]) & 4)
    if sum(int(r[2]) for r in rows) != mapped:
        raise AssertionError("idxstats: the mapped counts do not sum to the mapped records")
    fs = {line.split(" ", 1)[1]: int(line.split(" ", 1)[0])
          for line in command("flagstat", ["flagstat", srt])[1].splitlines()}
    inside = align["align_paired"]["inside_pairs"]
    if not (fs["properly paired"] == fs["primary mapped"] >= 2 * inside
            and fs["paired in sequencing"] == 2 * ALIGN_PAIRS):
        raise AssertionError(f"flagstat: a mapped record not in a proper pair, or fewer than phase 15's: {fs}")
    contig, beg0, end0 = "chr5", 100_000, 101_000
    cov = coverage(overlapping(srecs, contig, beg0, end0), contig, beg0, end0)
    depth_rows = [x.split("\t") for x in command("depth", ["depth", srt, f"{contig}:{beg0 + 1}-{end0}"])[1]
                  .splitlines()]
    nz = np.flatnonzero(cov)
    if [(int(r[1]) - 1, int(r[2])) for r in depth_rows] != list(zip((nz + beg0).tolist(), cov[nz].tolist())):
        raise AssertionError("depth: not the coverage of the records' CIGARs")
    bed = os.path.join(tmp, "r.bed")
    Path(bed).write_text(f"{contig}\t{beg0}\t{end0}\n{regions['a 16 KiB window edge'][0]}\t16000\t17000\n")
    bc = [x.split("\t") for x in command("bedcov", ["bedcov", srt, bed])[1].splitlines()]
    edge = coverage(overlapping(srecs, "chr3", 16000, 17000), "chr3", 16000, 17000)
    if [int(r[3]) for r in bc] != [int(cov.sum()), int(edge.sum())]:
        raise AssertionError("bedcov: not the sums of the records' coverage")
    md = os.path.join(tmp, "md.bam")
    said = command("markdup", ["markdup", srt, "--output", md])[1]
    _, mrecs = read_bam(md)
    marked = sum(1 for f in mrecs if int(f[1]) & 0x400)
    if ([[f[0], str(int(f[1]) & ~0x400), *f[2:]] for f in mrecs] != srecs
            or f"({marked} duplicates marked)" not in said):
        raise AssertionError("markdup: records other than their 0x400 flags changed, or the count differs")
    sn = {line.split("\t")[1][:-1]: line.split("\t")[2]
          for line in command("stats", ["stats", srt])[1].splitlines() if line.startswith("SN\t")}
    if int(sn["raw total sequences"]) != fs["primary"] or int(sn["reads properly paired"]) != fs["properly paired"]:
        raise AssertionError(f"stats: SN disagrees with flagstat: {sn}")
    half = len(recs) // 2
    h1, h2, mg = (os.path.join(tmp, x) for x in ("h1.sam", "h2.sam", "mg.bam"))
    Path(h1).write_text(header + "".join("\t".join(f) + "\n" for f in recs[:half]))
    Path(h2).write_text(header + "".join("\t".join(f) + "\n" for f in recs[half:]))
    command("merge", ["merge", mg, h1, h2])
    if read_bam(mg)[1] != srecs:
        raise AssertionError("merge: the merged halves are not the sorted records")
    f1, f2 = os.path.join(tmp, "x_1.fq"), os.path.join(tmp, "x_2.fq")
    command("fastq", ["fastq", srt, "-1", f1, "-2", f2])
    for got, want in ((f1, "pe_1.fq"), (f2, "pe_2.fq")):
        if fastq_set(got) != fastq_set(os.path.join(tmp, want)):
            raise AssertionError(f"fastq: {got} does not hold the reads of {want}")
    print(f"    (c) the SAM/BAM tools on phase 15(c)'s BAM, {len(recs)} records of {ALIGN_PAIRS} FR pairs: sort "
          f"(the input's records, in coordinate order), view of {viewed} (each a linear filter's records), "
          f"idxstats ({mapped} mapped), flagstat ({fs['properly paired']} properly paired = primary mapped, "
          f">= {2 * inside}), depth and bedcov on {contig}:{beg0 + 1}-{end0} (the CIGARs' coverage, sum "
          f"{int(cov.sum())}), markdup ({marked} marked), stats, merge of two halves (the sorted records), "
          f"fastq -1 -2 (every read of both FASTQ files back): all held", flush=True)

    # (d) faidx of phase 15's 24-record FASTA
    fa = align["fasta"]["path"]
    command("faidx", ["faidx", fa])
    picks = []
    for _ in range(10):
        i = int(rng.integers(ALIGN_RECORDS))
        b = int(rng.integers(1, length[f"chr{i + 1}"]))
        picks.append((i, b, min(length[f"chr{i + 1}"], b + int(rng.integers(0, 5000)))))
    said = command("faidx (10 regions)", ["faidx", fa, *[f"chr{i + 1}:{b}-{e}" for i, b, e in picks]])[1]
    blocks = said.split(">")[1:]
    for (i, b, e), block in zip(picks, blocks):
        head, *lines = block.splitlines()
        if head != f"chr{i + 1}:{b}-{e}" or "".join(lines).encode() != decode_bases(
                codes[bounds[i] + b - 1:bounds[i] + e]):
            raise AssertionError(f"faidx chr{i + 1}:{b}-{e}: not the text's slice")
    if len(blocks) != len(picks):
        raise AssertionError("faidx: a region is missing")
    print(f"    (d) faidx of the {ALIGN_RECORDS}-record FASTA, then 10 random regions: each the text's slice",
          flush=True)

    # (e) transform of phase 4's .fmi; its alternate-counters image searched on the card
    command("transform", ["transform", fmi])
    for suffix in (".interleaving", ".ac", ".interleaving.ac"):
        t1 = time.perf_counter()
        back, layout = read_fmi(fmi + suffix)
        seconds[f"read back {suffix}"] = time.perf_counter() - t1
        same_tables(f"transform {suffix}", getattr(back, "base", back), index, INDEX_FIELDS)
        del back
    ac_res = os.path.join(tmp, "ac.res")
    ac_argv = ["search", fmi + ".ac", qry, str(READ_LEN), str(READS), "--device", "cuda", "--iterations", "1",
               "--output", ac_res]
    try:  # tpufm refuses a LUT on an alternate-counters index, and so does the port
        command("search (.ac image, --lut)", [*ac_argv, "--lut", str(LUT_M)])
    except ValueError as err:
        if str(err) != "lut_m is not supported with alt-counters":
            raise
    else:
        raise AssertionError("search of the .ac image took --lut")
    reset_counts()
    ac, _ = command("search (.ac image)", ac_argv)
    by_path["ac_search"] = read_counts()
    # a warm-up and one pass, every round from the full interval through K8
    expect_launches("search of the .ac image", by_path["ac_search"], {"lf_round_ac": 2 * (READ_LEN // K)})
    if by_path["ac_search"]["lf_round_pairs"]:
        raise AssertionError(f"search of the .ac image launched K1: {by_path['ac_search']}")
    diff = command("diff", ["diff", reads_res, ac_res])[1]
    if diff != f"IDENTICAL: {READS} intervals\n":
        raise AssertionError(f"diff: {diff!r}")
    said = command("dumpentry", ["dumpentry", fmi + ".ac", "0"])[1].splitlines()
    if said[0] != "entry 0:" or not said[1].startswith("  counters (slim half): [") or len(said) != 2 + 2 * K:
        raise AssertionError(f"dumpentry: {said[:3]}")
    print(f"    (e) transform of phase 4's .fmi: .interleaving, .ac and .interleaving.ac each read back equal to "
          f"the index; search of the .ac image with --lut refused (tpufm's text), without it on the card "
          f"({ac.seconds_per_pass:.6f} s/pass, K8 alternate-counters launches "
          f"{by_path['ac_search']['lf_round_ac']}, K1 {by_path['ac_search']['lf_round_pairs']}), diff against phase "
          f"4's .res: {diff.strip()}; dumpentry printed entry 0", flush=True)
    print("    host seconds (the card machine's host clock): " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()) + f"; phase {time.perf_counter() - t0:.2f} s", flush=True)
    return seconds


def ac_table_bytes(iv: torch.Tensor, code: torch.Tensor, k: int, d: int, nrows: int, slim_rows: int) -> int:
    """Bytes of the alternate-counters tables that the ends ``iv`` (int64
    [N, 2], one code a read) need, each word once: of every distinct
    bit-plane row, the plane words of the windows its forward ends' prefixes
    cover and of those its backward ends' suffixes cover (from the end's
    window to the block's last), and each distinct slim counter."""
    ends = iv.reshape(-1)
    codes = code.repeat_interleave(2)
    S, nb = 4**k // 2, d // 32
    block = ends // d
    rows = block.clamp(max=nrows - 1)
    off = ends % d
    back = ((block & 1) != 0) ^ (codes >= S)
    zeros = torch.zeros(nrows, dtype=torch.int64, device=iv.device)
    pre = zeros.scatter_reduce(0, rows[~back], ((off + 31) // 32)[~back], "amax")
    start = torch.full_like(zeros, nb).scatter_reduce(0, rows[back], (off // 32)[back], "amin")
    windows = pre + (nb - start) - (pre - start).clamp(min=0)
    counters = torch.unique((block + back).clamp(max=slim_rows - 1) * S + (codes & (S - 1))).numel()
    return 4 * (2 * k * int(windows.sum()) + counters)


def layout_rounds(label: str, fn, plain_fn, tables: tuple, dollar, iv, codes, want, bound) -> list:
    """A layout's round kernel at the main path's shape: the rounds of phase
    4's first wave replayed from ``iv`` through ``fn``, the (iv, code)
    entering CAPTURED_ROUNDS kept; the replay must end on ``want`` (the
    paired layout's on its ok reads). Each captured round: the kernel against
    its plain version ``plain_fn`` (every output bit-identical), both timed
    (``cuda_ms``; the kernel also alone on the device, ``graph_ms``), beside
    ``bound(iv, code)`` (bytes)."""
    captured, ok = {}, None
    for j, code in enumerate(codes, start=1):
        if j in CAPTURED_ROUNDS:
            captured[j] = (iv, code)
        out = fn(*tables, iv, code, dollar, K, D)
        if isinstance(out, tuple):
            out, ok_j = out
            ok = ok_j if ok is None else ok & ok_j
        iv = out
    keep = torch.ones(iv.shape[0], dtype=torch.bool, device=iv.device) if ok is None else ok
    want = torch.from_numpy(want.astype(np.int64)).to(iv.device)
    if not torch.equal(iv[keep], want[keep]):
        raise AssertionError(f"phase 18 {label}: the replayed rounds do not end on phase 4's intervals")
    rows = []
    for j, (iv, code) in captured.items():
        args = (*tables, iv, code, dollar, K, D)
        got, ref = fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max()) for g, r in zip(got, ref))
        if err != 0 or not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"{label}, round {j}: kernel differs from plain (max abs err {err})")
        blocks = iv // D
        rows.append({
            "round": j, "reads": int(iv.shape[0]), "max_abs_err": err,
            "same_block_share": float((blocks[:, 0] == blocks[:, 1]).double().mean()),
            "ms": cuda_ms(lambda: fn(*args)),
            "graph_ms": graph_ms(lambda: fn(*args)),
            "plain_ms": cuda_ms(lambda: plain_fn(*args)),
            "bound_ms": bound_ms(bound(iv, code)),
        })
    return rows


def layouts(tmp: str, index, fmi: str, qry: str, reads: np.ndarray, main_res: np.ndarray, dev,
            by_path: dict) -> dict:
    """Phase 18 (see the module docstring): the other layouts on phase 4's
    index and reads, each path driven with the launch counts zeroed before
    and read after, each kernel entry held against its plain version at the
    path's shape and timed beside its bound."""
    t0 = time.perf_counter()
    rounds = (READ_LEN - LUT_M) // K
    wave = SearchEngine.WAVE
    q = torch.from_numpy(reads[:wave]).to(dev)
    found = {}

    def cli_run(label: str, argv: list):
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            run = cli.main(["search", *argv, qry, str(READ_LEN), str(READS), "--device", "cuda",
                            "--iterations", "1", "--output", os.path.join(tmp, f"{label}.res")])
        by_path[label] = read_counts()
        if not np.array_equal(run.results, main_res):
            raise AssertionError(f"phase 18 {label}: {(run.results != main_res).any(1).sum()} reads differ "
                                 "from phase 4")
        return run

    # (a) search --engine xla-ac on the .ac image: every round from the full
    # interval through K8's alternate-counters entry, a warm-up and one pass
    t1 = time.perf_counter()
    ac = cli_run("search_ac", [fmi + ".ac", "--engine", "xla-ac"])
    if (by_path["search_ac"]["lf_round_ac"] != 2 * (READ_LEN // K) * -(-READS // wave)
            or by_path["search_ac"]["lf_round_pairs"]):
        raise AssertionError(f"search --engine xla-ac: launches {by_path['search_ac']}")
    eng = ac.engine
    found["ac"] = layout_rounds(
        "K8 alternate counters", lf_mod.lf_round_ac, lf_mod.lf_round_ac_reference, (eng.bitmaps, eng.occ_slim),
        eng.dollar, eng._full_interval(wave), fuse_round_codes(q, K), main_res[:wave],
        lambda iv, code: 5 * 8 * iv.shape[0] + ac_table_bytes(iv, code, K, D, eng.bitmaps.shape[0],
                                                               eng.occ_slim.shape[0]))
    ac_s, ac_cli = ac.seconds_per_pass, time.perf_counter() - t1
    del ac, eng

    # (b) the split layout with the 12-mer LUT, built by its own rounds
    t1 = time.perf_counter()
    reset_counts()
    split = SearchEngine(index, dev, layout="split", lut_m=LUT_M)
    res, split_s = timed_passes(lambda: split.search(reads), iterations=1)
    by_path["split"] = read_counts()
    lut_split = (4**LUT_M // min(4**LUT_M, 1 << 20)) * (LUT_M // K)
    expect_launches("split layout", by_path["split"], {"lf_round_split": 2 * rounds * -(-READS // wave) + lut_split})
    if not np.array_equal(res, main_res):
        raise AssertionError(f"split layout: {(res != main_res).any(1).sum()} reads differ from phase 4")
    with np.load(f"{fmi}.lut{LUT_M}.npz") as z:  # phase 4's LUT, built by K1
        if not np.array_equal(split.lut.cpu().numpy().view(np.uint32), z["lut"]):
            raise AssertionError("split layout: its LUT differs from phase 4's")
    body = q[:, : READ_LEN - LUT_M]
    start = from_u32_bits(split.lut[fuse_prefix_codes(q, LUT_M)])
    found["split"] = layout_rounds(
        "K8 split", lf_mod.lf_round_split, lf_mod.lf_round_split_reference, (split.bitmaps, split.occ),
        split.dollar, start, fuse_round_codes(body, K), main_res[:wave],
        lambda iv, code: 5 * 8 * iv.shape[0] + k1_table_bytes(iv, code, K, D, split.bitmaps.shape[0]))
    split_cli = time.perf_counter() - t1
    del split

    # (c) search --engine xla-paired --lut 12: K1's paired entry, the reads
    # whose interval spans more than two blocks searched again by K1's pairs
    t1 = time.perf_counter()
    paired = cli_run("search_paired", [fmi, "--engine", "xla-paired", "--lut", str(LUT_M)])
    repaired = paired.engine.last_repair_fraction
    expect_launches("search --engine xla-paired", by_path["search_paired"],
                    {"lf_round_paired": 2 * rounds * -(-READS // wave)})
    if repaired and not by_path["search_paired"]["lf_round_pairs"]:
        raise AssertionError("search --engine xla-paired: reads to repair, K1's pair entry not launched")
    eng = paired.engine
    found["paired"] = layout_rounds(
        "K1 paired", lf_mod.lf_round_paired, lf_mod.lf_round_paired_reference, (eng.entries_paired,), eng.dollar,
        start, fuse_round_codes(body, K), main_res[:wave],
        lambda iv, code: 5 * 8 * iv.shape[0] + iv.shape[0] + k1_table_bytes(iv, code, K, D, eng.entries.shape[0]))
    paired_s, paired_cli = paired.seconds_per_pass, time.perf_counter() - t1
    del paired, eng

    # (d) --pad-words 128: the fused rows of K1's pair entry, 512 B each
    t1 = time.perf_counter()
    padded = cli_run("search_pad", [fmi, "--pad-words", "128", "--lut", str(LUT_M)])
    if tuple(padded.engine.entries.shape) != (index.occ.shape[0], 128):
        raise AssertionError(f"--pad-words 128: device rows {tuple(padded.engine.entries.shape)}")
    expect_launches("--pad-words 128", by_path["search_pad"], {"lf_round_pairs": 2 * rounds * -(-READS // wave)})
    pad_s, pad_cli = padded.seconds_per_pass, time.perf_counter() - t1
    del padded
    torch.cuda.empty_cache()
    print(f"[18 layouts] phase 4's index and {READS} x {READ_LEN} bp reads, all intervals equal to phase 4's:",
          flush=True)
    print(f"    (a) search --engine xla-ac of the .ac image: {ac_s:.6f} s/pass, K8 alternate-counters launches "
          f"{by_path['search_ac']['lf_round_ac']} ({READ_LEN // K} a pass), K1 0; CLI {ac_cli:.2f} s", flush=True)
    print(f"    (b) SearchEngine(layout=\"split\", lut_m={LUT_M}): {split_s:.6f} s/pass, K8 split launches "
          f"{by_path['split']['lf_round_split']} ({lut_split} the LUT's, equal to phase 4's LUT); {split_cli:.2f} s",
          flush=True)
    print(f"    (c) search --engine xla-paired --lut {LUT_M}: {paired_s:.6f} s/pass, K1 paired launches "
          f"{by_path['search_paired']['lf_round_paired']}, repair fraction {repaired}, K1 pair launches (the "
          f"repairs) {by_path['search_paired']['lf_round_pairs']}; CLI {paired_cli:.2f} s", flush=True)
    print(f"    (d) search --pad-words 128 --lut {LUT_M}: {pad_s:.6f} s/pass, K1 pair launches "
          f"{by_path['search_pad']['lf_round_pairs']} on 128-word rows; CLI {pad_cli:.2f} s", flush=True)
    for name, rows in found.items():
        for c in rows:
            print(f"    {name} round {c['round']}: {c['reads']} reads, {c['same_block_share'] * 100:.2f}% with both "
                  f"ends in one block: kernel {c['ms']:.4f} ms (bound {c['bound_ms']:.4f} ms, "
                  f"{c['bound_ms'] / c['ms'] * 100:.1f}% of it), on the device alone {c['graph_ms']:.4f} ms "
                  f"({c['bound_ms'] / c['graph_ms'] * 100:.1f}%), plain {c['plain_ms']:.4f} ms", flush=True)

    # (e) the bench records of the three engines at the flagship's shape
    t1 = time.perf_counter()
    flagship = ["--refsize", str(REF_BASES), "--k", str(K), "--d", str(D), "--numqueries", str(READS),
                "--length", str(READ_LEN), "--iterations", str(BENCH_PASSES)]
    passes = BENCH_PASSES + 1
    records = {
        "xla-ac": bench_record("bench_ac", [*flagship, "--engine", "xla-ac"],
                               {"lf_round_ac": passes * (READ_LEN // K)}, by_path),
        "xla-split": bench_record("bench_split", [*flagship, "--engine", "xla-split", "--lut", str(LUT_M)],
                                  {"lf_round_split": passes * rounds + lut_split}, by_path),
        "xla-paired": bench_record("bench_paired_layout", [*flagship, "--engine", "xla-paired", "--lut", str(LUT_M)],
                                   {"lf_round_paired": passes * rounds}, by_path),
    }
    print(f"    (e) bench records {time.perf_counter() - t1:.2f} s", flush=True)

    # (f) a small sweep: 1 Mbase, k 1-3, d 64 and 128, all five engines, LUT 0 and 6
    t1 = time.perf_counter()
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rows = cli.main(["sweep", "--refsizes", str(SWEEP_BASES), "--ks", "1", "2", "3", "--ds", "64", "128",
                         "--engines", *sweep_mod.SWEEP_ENGINES, "--luts", "0", "6", "--numqueries", str(SWEEP_READS),
                         "--length", str(READ_LEN), "--device", "cuda"])
    by_path["sweep"] = read_counts()
    if len(rows) != 48 or not all(r["bit_exact"] is True for r in rows):
        raise AssertionError(f"sweep: {len(rows)} rows, {sum(r['bit_exact'] is not True for r in rows)} not bit-exact")
    expect_launches("sweep", by_path["sweep"], {name: 1 for name in (
        "lf_round_pairs", "lf_round_rows", "lf_round_split", "lf_round_ac", "lf_round_paired")})
    print(f"    (f) sweep, {SWEEP_BASES} bases, k 1-3, d 64/128, engines {' '.join(sweep_mod.SWEEP_ENGINES)}, "
          f"LUT 0/6, {SWEEP_READS} x {READ_LEN} bp: {len(rows)} rows, every one bit-exact, in "
          f"{time.perf_counter() - t1:.2f} s:", flush=True)
    for r in rows:
        print(f"      k={r['k']} d={r['d']} {r['engine']:10s} lut {r['lut_m']}: {r['seconds_per_pass']:.6f} s/pass, "
              f"{r['reads_per_s']} reads/s", flush=True)
    print(f"    phase {time.perf_counter() - t0:.2f} s", flush=True)
    return {"rounds": found, "records": records, "sweep": rows}


def layout_kernel(name: str, rows: list, by_path: dict, path: str, counter: str, replaces: str) -> dict:
    """The kernels-line entry of a layout's round (phase 18): its launches on
    its path, its figures at the last of CAPTURED_ROUNDS of phase 4's first
    wave (every captured round under ``rounds``), and its launches on every
    path."""
    last = rows[-1]
    return {
        "name": name,
        "route": "cuda",
        "source": "tpufm_torch/csrc/lf_round.cu" if name == "lf_round_paired" else "tpufm_torch/csrc/lf_round_split.cu",
        "replaces": replaces,
        "launches": by_path[path][counter],
        "max_abs_err": max(c["max_abs_err"] for c in rows),
        "ms": last["ms"],
        "graph_ms": last["graph_ms"],
        "plain_ms": last["plain_ms"],
        "bound_ms": last["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": f"round {last['round']} of phase 4's first wave, {last['reads']} reads",
        "rounds": rows,
        "launches_by_path": {p: c[counter] for p, c in by_path.items()},
    }


def expect_exact(path: str, counts: dict, need: dict) -> None:
    """Fail unless each kernel in ``need`` launched exactly that often."""
    for name, n in need.items():
        if counts[name] != n:
            raise AssertionError(f"{path}: {name} launched {counts[name]} times, expected {n}")


def same_results(what: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (got != want).any(1).sum() if got.shape == want.shape else got.shape
        raise AssertionError(f"{what}: {bad} reads differ")


def k9_edge_requests(rng, bwtsize: int, k: int, d: int, dollar: np.ndarray, n_shards: int, e_local: int,
                     n: int) -> np.ndarray:
    """int32 [N, 3] requests (block, code, interval; uint32 bits) of K9's edge
    cases on a table of ``n_shards`` shards of ``e_local`` rows: ``n`` random
    ends over [0, bwtsize] under random codes; zero rows (the ring's and the
    a2a buckets' padding); ends around every '$' position and at its block's
    first and last offset, under its k-mer (the '$' hits, global blocks); the
    last and first block of every shard, under the first and last code (the
    shard edges; the last shard's last rows are the zero rows padded past the
    table when e_local does not divide it); blocks owned by no shard."""
    iv = rng.integers(0, bwtsize + 1, size=n, dtype=np.int64)
    rows = [np.stack([iv // d, rng.integers(0, 4**k, size=n, dtype=np.int64), iv], axis=1),
            np.zeros((5, 3), np.int64)]
    for pos, base in zip(dollar[0].tolist(), dollar[1].tolist()):  # rows pos, base
        start = pos - pos % d
        for v in (pos - 1, pos, pos + 1, start, start + d - 1):
            v = min(max(v, 0), bwtsize)
            rows.append(np.array([[v // d, base, v]]))
    for s in range(1, n_shards + 1):
        for b in (s * e_local - 1, s * e_local):
            for c in (0, 4**k - 1):
                rows.append(np.array([[b, c, b * d + int(rng.integers(0, d))]]))
    for b in (n_shards * e_local + 7, (1 << 32) // d - 1):  # owners past the mesh
        rows.append(np.array([[b, 1, b * d + 5]]))
    return np.concatenate(rows).astype(np.uint32).view(np.int32)


def k9_bytes(req: torch.Tensor, shard: int, e_local: int, k: int, d: int) -> int:
    """Bytes K9 must move for ``req`` on shard ``shard``: 12 B in and 4 B out
    a request, and the table words its owned requests need, each once (of
    every distinct local row the plane words of the windows its ends cover
    and each distinct (row, code) counter, as ``k1_table_bytes``)."""
    block, code, iv = from_u32_bits(req).unbind(1)
    owned = block // e_local == shard
    local = iv[owned] - shard * e_local * d
    return 16 * req.shape[0] + k1_table_bytes(local, code[owned], k, d, e_local)


def check_k9(eng, s: int, req: torch.Tensor, timed: bool) -> dict:
    """K9 on shard ``s`` of the sharded engine ``eng`` against its plain
    version on ``req``: every answer bit-identical; timed beside its bound
    where ``timed``: the kernel on the device alone (``graph_ms``: it is
    shorter than its wrapper's host time), the plain version with CUDA
    events (median of 7)."""
    args = (eng.bitmaps[s], eng.occ[s], req, s, eng.e_local, eng.dollar[s], eng.k, eng.d)
    got = lf_mod.lf_answer_owned(*args)
    ref = lf_mod.lf_answer_owned_reference(*args)
    torch.cuda.synchronize()
    err = int((from_u32_bits(got) - from_u32_bits(ref)).abs().max()) if req.shape[0] else 0
    if err or not torch.equal(got, ref):
        raise AssertionError(f"K9 shard {s}: kernel differs from plain (max abs err {err})")
    block = from_u32_bits(req[:, 0])
    row = {"shard": s, "requests": int(req.shape[0]), "max_abs_err": err,
           "owned": int((block // eng.e_local == s).sum())}
    if timed:
        row.update(ms=graph_ms(lambda: lf_mod.lf_answer_owned(*args)),
                   plain_ms=cuda_ms(lambda: lf_mod.lf_answer_owned_reference(*args)),
                   bound_ms=bound_ms(k9_bytes(req, s, eng.e_local, eng.k, eng.d)))
    return row


def capture_requests(eng, queries: list, rounds: tuple) -> tuple:
    """One ``search_device`` of ``eng`` on the placed ``queries``, keeping
    the request stream each shard's owner answer gets at ``rounds`` (the
    allgather routing answers once a shard a round): ((intervals, overflow),
    {(round, shard): requests})."""
    kept, calls = {}, [0] * eng.mesh.size
    answer = eng._answer

    def capturing(s, req):
        calls[s] += 1
        if calls[s] in rounds:
            kept[calls[s], s] = req.clone()
        return answer(s, req)

    eng._answer = capturing
    try:
        out = eng.search_device(queries)
    finally:
        del eng._answer
    return out, kept


def mesh_phase(tmp: str, index, fmi: str, qry: str, reads: np.ndarray, main_res: np.ndarray, dev,
               by_path: dict) -> dict:
    """Phase 19 (see the module docstring): the mesh engines, every interval
    held against phase 4's (or the one-device engine's at 250 Mbase), every
    launch count exact, K9 against its plain version."""
    t0 = time.perf_counter()
    rounds = (READ_LEN - LUT_M) // K
    SH = MESH_SHARDS
    wave = ShardedIndexEngine.WAVE_PER_CHIP * SH
    waves = -(-READS // wave)
    lut_waves = 4**LUT_M // min(4**LUT_M, wave)  # a sharded LUT build's waves on SH shards
    lut_cache = f"{fmi}.lut{LUT_M}.npz"
    with np.load(lut_cache) as z:  # phase 4's LUT, built by K1
        main_lut = torch.from_numpy(z["lut"].view(np.int32)).to(dev)
    seconds = {}

    # (a) the CLI at mesh 1, the bench records, mesh=1 beside one device
    def cli_run(label: str, cmd: str, argv: list):
        t1 = time.perf_counter()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            run = cli.main([cmd, fmi, qry, str(READ_LEN), str(READS), *argv, "--device", "cuda",
                            "--iterations", "1", "--output", os.path.join(tmp, f"{label}.out")])
        by_path[label] = read_counts()
        seconds[label] = time.perf_counter() - t1
        return run

    run = cli_run("mesh1_search", "search", ["--lut", str(LUT_M), "--mesh", "1"])
    same_results("search --mesh 1", run.results, main_res)
    expect_exact("search --mesh 1", by_path["mesh1_search"], {"lf_round_pairs": 2 * rounds, "lf_answer_owned": 0})
    run = cli_run("mesh1_sharded_a2a", "search", ["--lut", str(LUT_M), "--mesh", "1", "--sharded", "--routing", "a2a"])
    same_results("search --sharded --routing a2a --mesh 1", run.results, main_res)
    one_wave = ShardedIndexEngine.WAVE_PER_CHIP
    expect_exact("search --sharded --mesh 1", by_path["mesh1_sharded_a2a"], {
        "lf_answer_owned": (4**LUT_M // one_wave) * (LUT_M // K) + 2 * rounds * -(-READS // one_wave),
        "lf_round_pairs": 0})
    run = cli_run("mesh1_count", "count", ["--lut", str(LUT_M), "--mesh", "1"])
    same_results("count --mesh 1", run.counts[:, None], (main_res[:, 1] - main_res[:, 0])[:, None])
    expect_exact("count --mesh 1", by_path["mesh1_count"], {"lf_round_pairs": 2 * rounds})
    del run
    have = torch.cuda.device_count()
    if have < 2:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["search", fmi, qry, str(READ_LEN), "1024", "--mesh", "2", "--device", "cuda"])
            raise AssertionError("search --mesh 2 ran on one card")
        except ValueError as e:
            if str(e) != f"need 2 devices, have {have}":
                raise
    flagship = ["--refsize", str(REF_BASES), "--k", str(K), "--d", str(D), "--lut", str(LUT_M),
                "--length", str(READ_LEN), "--iterations", str(BENCH_PASSES), "--numqueries", str(READS),
                "--mesh", "1"]
    passes = 2 * (BENCH_PASSES + 1)  # the one-device run and the mesh run, each a warm-up and the passes
    lut_k1 = (4**LUT_M // min(4**LUT_M, 1 << 20)) * (LUT_M // K)
    lut_k9 = (4**LUT_M // one_wave) * (LUT_M // K)
    need = {"bench_multichip": {"lf_round_pairs": passes * rounds + 2 * lut_k1},
            "bench_sharded_a2a": {"lf_answer_owned": passes * rounds + 2 * lut_k9}}
    records = {
        "multichip": bench_record("bench_multichip", [*flagship, "--multichip"], need["bench_multichip"], by_path),
        "sharded_a2a": bench_record("bench_sharded_a2a", [*flagship, "--sharded", "--routing", "a2a"],
                                    need["bench_sharded_a2a"], by_path),
    }
    for label, n in need.items():
        expect_exact(label, by_path[label], n)
    dp1 = DataParallelEngine(index, make_mesh(1, device=dev), lut_m=LUT_M, lut_cache=lut_cache)
    placed1 = dp1.shard_queries(reads)
    one = dp1.engines[0]
    turns = {"search_engine": [], "mesh1": []}
    for name in ("search_engine", "mesh1", "mesh1", "search_engine"):
        fn = (lambda: one.search_device(placed1[0])) if name == "search_engine" else (
            lambda: dp1.search_device(placed1))
        turns[name].extend(timed_device_passes(fn, iterations=3)[2])
    overhead = {name: statistics.mean(t) for name, t in turns.items()}
    del dp1, placed1, one
    print(f"[19 mesh] (a) phase 4's index and {READS} x {READ_LEN} bp reads: search --mesh 1 "
          f"({by_path['mesh1_search']['lf_round_pairs']} K1 launches), search --sharded --routing a2a --mesh 1 "
          f"({by_path['mesh1_sharded_a2a']['lf_answer_owned']} K9 launches, its LUT built by its own rounds) and "
          f"count --mesh 1 all equal to phase 4; search --mesh 2 on {have} card(s): "
          + (f"'need 2 devices, have {have}'" if have < 2 else "not tried") + f"; CLI seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}; device seconds a "
          f"pass (the same {READS} reads on the card, in turns): SearchEngine {overhead['search_engine']:.6f}, "
          f"DataParallelEngine on one device {overhead['mesh1']:.6f} "
          f"({(overhead['mesh1'] / overhead['search_engine'] - 1) * 100:+.2f}%)", flush=True)

    # (b) DataParallelEngine over four shards on this card
    t1 = time.perf_counter()
    mesh4 = Mesh([dev] * SH)
    dp4 = DataParallelEngine(index, mesh4, lut_m=LUT_M, lut_cache=lut_cache)
    reset_counts()
    same_results("DataParallelEngine, 4 shards", dp4.search(reads), main_res)
    by_path["mesh4_dp"] = read_counts()
    expect_exact("DataParallelEngine, 4 shards", by_path["mesh4_dp"], {"lf_round_pairs": SH * rounds})
    placed4 = dp4.shard_queries(reads)
    dp4_s = timed_device_passes(lambda: dp4.search_device(placed4), iterations=3)[0]
    del dp4
    ac4 = DataParallelEngine(make_alt_counters(index), mesh4)
    reset_counts()
    same_results("DataParallelEngine alternate counters, 4 shards", ac4.search(reads), main_res)
    by_path["mesh4_dp_ac"] = read_counts()
    expect_exact("DataParallelEngine alternate counters", by_path["mesh4_dp_ac"],
                 {"lf_round_ac": SH * (READ_LEN // K), "lf_round_pairs": 0})
    ac4_s = timed_device_passes(lambda: ac4.search_device(placed4), iterations=3)[0]
    del ac4
    print(f"    (b) DataParallelEngine over {SH} shards of this card, all equal to phase 4: fused lut{LUT_M} "
          f"{by_path['mesh4_dp']['lf_round_pairs']} K1 pair launches ({rounds} a shard), {dp4_s:.6f} s a device "
          f"pass; alternate counters {by_path['mesh4_dp_ac']['lf_round_ac']} K8-AC launches ({READ_LEN // K} a "
          f"shard), {ac4_s:.6f} s a device pass; {time.perf_counter() - t1:.2f} s", flush=True)

    # (c) ShardedIndexEngine over four shards on this card, each routing
    routings, k9 = {}, {"rounds": [], "edges": [], "streams": []}
    same_reads = np.repeat(reads[:1], SAME_READS, axis=0)
    same_want = np.repeat(main_res[:1], SAME_READS, axis=0)
    place = placed4  # the device passes: all reads at once, as the bench records time them
    for routing, lut in (("allgather", LUT_M), ("ring", LUT_M), ("a2a", LUT_M), ("a2a", 0)):
        t1 = time.perf_counter()
        label = f"mesh4_{routing}" + ("" if lut else "_nolut")
        reset_counts()
        eng = ShardedIndexEngine(index, mesh4, routing=routing, lut_m=lut)
        by_path[label + "_lut"] = read_counts()
        if lut and not torch.equal(eng.lut[0], main_lut):
            raise AssertionError(f"{label}: its LUT differs from phase 4's")
        reset_counts()
        same_results(f"ShardedIndexEngine {routing}" + ("" if lut else " without LUT"), eng.search(reads), main_res)
        by_path[label] = read_counts()
        n_rounds = rounds if lut else READ_LEN // K
        overflowed = int(sum(ov.sum() for ov in eng.last_overflow_waves))
        flags = np.concatenate(eng.last_overflow_waves) if eng.last_overflow_waves else np.zeros(0, bool)
        # an a2a round that overflows takes the allgather step instead: SH launches either way
        per_round = {"allgather": SH, "ring": 2 * SH * SH, "a2a": SH}[routing]
        expect_exact(label, by_path[label], {"lf_answer_owned": per_round * n_rounds * waves, "lf_round_pairs": 0})
        if lut:
            expect_exact(label + "_lut", by_path[label + "_lut"],
                         {"lf_answer_owned": per_round * lut_waves * (LUT_M // K), "lf_round_pairs": 0})
        model = assert_collective_model(eng, reads[:wave])
        if routing == "allgather" and lut:
            (_, _), kept = capture_requests(eng, eng.place_queries(reads[:wave]), CAPTURED_ROUNDS)
            for (j, s), req in sorted(kept.items()):
                row = check_k9(eng, s, req, timed=s == 0)
                k9["rounds"].append({"round": j, **row})
            rng = np.random.default_rng(SEED + 19)
            dollar = np.stack([index.dollar_pos, index.dollar_base]).astype(np.int64)
            edges = torch.from_numpy(k9_edge_requests(rng, eng.bwtsize, K, D, dollar, SH, eng.e_local,
                                                      1 << 16)).to(dev)
            k9["edges"] = [check_k9(eng, s, edges, timed=False) for s in range(SH)]
        elif lut:
            # the ring's half-blocks and the a2a buckets (call 1 of each shard), and the ring's first
            # half copied to an odd row offset: K9 loads such a stream by words, not 16-byte units
            (_, _), kept = capture_requests(eng, eng.place_queries(reads[:wave]), (1,))
            for (j, s), req in sorted(kept.items()):
                k9["streams"].append({"routing": routing, "call": j, **check_k9(eng, s, req, timed=s == 0)})
            if routing == "ring":
                odd = torch.zeros((kept[1, 0].shape[0] + 1, 3), dtype=torch.int32, device=dev)
                odd[1:] = kept[1, 0]
                k9["streams"].append({"routing": "ring, odd row offset", "call": 1,
                                      **check_k9(eng, 0, odd[1:], timed=True)})
        dev_s = timed_device_passes(lambda: eng.search_device(place), iterations=3)[0]
        same_overflow = None
        if routing == "a2a" and lut:
            # one read repeated: a round's requests all lie in one bucket, so every round overflows and
            # takes the allgather step, on the card: SH launches a round, as a bucketed round
            reset_counts()
            same_results("ShardedIndexEngine a2a, one read repeated", eng.search(same_reads), same_want)
            by_path[label + "_same"] = read_counts()
            expect_exact(label + "_same", by_path[label + "_same"], {"lf_answer_owned": SH * rounds})
            if not eng.last_overflow_rounds.all():
                raise AssertionError(f"{label}: one read repeated overflowed in rounds "
                                     f"{np.flatnonzero(eng.last_overflow_rounds).tolist()} of {rounds} only")
            same_overflow = int(eng.last_overflow_rounds.sum())
            assert_collective_model(eng, same_reads)
        routings[label] = {
            "routing": routing, "lut_m": lut, "device_seconds_per_pass": dev_s,
            "lut_build_seconds": eng.lut_build_seconds, "k9_launches": by_path[label]["lf_answer_owned"],
            "overflow_round_fraction": float(flags.mean()) if flags.size else 0.0,
            "overflow_rounds": overflowed, "collective_bytes_a_wave": model["bytes"],
            "model_sent_a_round": model["model"]["sent"], "one_read_repeated_overflow_rounds": same_overflow,
            "seconds": time.perf_counter() - t1,
        }
        del eng
        torch.cuda.empty_cache()
    print(f"    (c) ShardedIndexEngine over {SH} shards of this card (e_local {-(-index.occ.shape[0] // SH)} of "
          f"{index.occ.shape[0]} rows), {waves} waves of {wave}, all equal to phase 4, each LUT equal to phase "
          f"4's, every K9 count exact, assert_collective_model passed:", flush=True)
    for label, r in routings.items():
        print(f"      {label}: {r['device_seconds_per_pass']:.6f} s a device pass, K9 launches {r['k9_launches']}, "
              f"overflow rounds {r['overflow_rounds']} (fraction {r['overflow_round_fraction']:.4f}), LUT build "
              f"{r['lut_build_seconds']} s, {r['collective_bytes_a_wave']} B between shards a wave (model "
              f"{r['model_sent_a_round']} B a shard a round)"
              + ("" if r["one_read_repeated_overflow_rounds"] is None else
                 f"; one read x {SAME_READS}: {r['one_read_repeated_overflow_rounds']} of {rounds} rounds overflowed "
                 f"to the allgather step, {by_path[label + '_same']['lf_answer_owned']} K9 launches, equal to "
                 f"phase 4")
              + f"; {r['seconds']:.2f} s", flush=True)

    # (d) the 250 Mbase text, built on the card, split four ways there
    t1 = time.perf_counter()
    _, gcodes = bench._reference_codes(GENOME_BASES, 0)
    rec = recommend_config(GENOME_BASES)
    gcd = upload_text(gcodes, dev)
    gorder = suffix_array_device_arr(gcd)
    gidx = build_index_device(gcodes, IndexConfig(k=rec["k"], d=rec["d"]), return_host=False,
                              sa_dev=gorder, codes_dev=gcd)
    del gcd, gorder
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t1
    greads = generate_reads(gcodes, READ_LEN, READS, seed=SEED + 19)
    single = SearchEngine(gidx, dev, lut_m=LUT_M)
    want = single.search(greads)
    gq = torch.from_numpy(greads).to(dev)
    genome = {"single_device_seconds_per_pass": timed_device_passes(lambda: single.search_device(gq), 3)[0]}
    glut = single.lut
    del single, gq
    torch.cuda.empty_cache()
    gwaves = -(-READS // wave)
    grounds = (READ_LEN - LUT_M) // rec["k"]
    for routing in ("allgather", "a2a"):
        eng = ShardedIndexEngine(gidx, mesh4, routing=routing, lut_m=LUT_M)
        if not torch.equal(eng.lut[0], glut):
            raise AssertionError(f"250 Mbase {routing}: its LUT differs from the one-device engine's")
        label = f"genome_{routing}"
        reset_counts()
        same_results(f"250 Mbase {routing}", eng.search(greads), want)
        by_path[label] = read_counts()
        overflowed = int(sum(ov.sum() for ov in eng.last_overflow_waves))
        expect_exact(label, by_path[label], {"lf_answer_owned": SH * grounds * gwaves})
        gplaced = eng.place_queries(greads)
        genome[routing] = {"device_seconds_per_pass": timed_device_passes(lambda: eng.search_device(gplaced), 3)[0],
                           "overflow_rounds": overflowed, "e_local": eng.e_local}
        del eng, gplaced
        torch.cuda.empty_cache()
    host = KStepFMIndex(config=gidx.config, bwtsize=gidx.bwtsize, occ=host_words(gidx.occ),
                        bitmaps=host_words(gidx.bitmaps), dollar_pos=gidx.dollar_pos, dollar_base=gidx.dollar_base)
    same_results("250 Mbase, the oracle", want[:ORACLE_READS], search_oracle(host, greads[:ORACLE_READS]))
    del host, gidx, glut, greads, gcodes
    torch.cuda.empty_cache()
    print(f"    (d) {GENOME_BASES} bases, k={rec['k']} d={rec['d']} built on the card ({build_s:.2f} s, no host "
          f"copy of the tables), split {SH} ways there ({genome['a2a']['e_local']} rows a shard), lut{LUT_M}, {READS} x "
          f"{READ_LEN} bp: one device {genome['single_device_seconds_per_pass']:.6f} s a device pass; allgather "
          f"{genome['allgather']['device_seconds_per_pass']:.6f} s; a2a {genome['a2a']['device_seconds_per_pass']:.6f} "
          f"s ({genome['a2a']['overflow_rounds']} overflow rounds); all equal to the one-device engine, first "
          f"{ORACLE_READS} to the oracle; {time.perf_counter() - t1:.2f} s", flush=True)

    # (e) K9 against its plain version
    for c in k9["rounds"] + k9["streams"]:
        where = f"round {c['round']}" if "round" in c else f"{c['routing']} call {c['call']}"
        line = f"{where} shard {c['shard']}: {c['requests']} requests, {c['owned']} owned"
        if "ms" in c:
            line += (f": kernel {c['ms']:.4f} ms (bound {c['bound_ms']:.4f} ms, {c['bound_ms'] / c['ms'] * 100:.1f}% "
                     f"of it), plain {c['plain_ms']:.4f} ms")
        print(f"    (e) K9 {line}, bit-identical", flush=True)
    print(f"    (e) K9 edge cases on every shard ({k9['edges'][0]['requests']} requests: zero rows, '$' blocks, "
          f"shard edges, rows past the table, owners past the mesh): bit-identical; phase "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"k9": k9, "routings": routings, "genome": genome, "records": records, "overhead": overhead,
            "dp4_s": dp4_s, "ac4_s": ac4_s}


def mesh_walks(found: np.ndarray, n: int, wave: int, shards=None) -> int:
    """The walks (K4 launches) a mesh engine of ``n`` shards makes over a
    batch whose read i has rows to walk where ``found[i]``: the batch padded
    by cycling to a mesh multiple, streamed in waves of ``wave`` reads (past
    one wave the last padded by cycling to a whole one), each wave cut into
    n parts; a part with no row to walk launches no walk. ``shards``: count
    the parts of those shards only (one process of a multi-process mesh)."""
    B = found.shape[0]
    idx = np.resize(np.arange(B), B + (-B % n))
    walks = 0
    for start in range(0, idx.size, wave):
        chunk = idx[start:start + wave]
        if idx.size > wave and chunk.size < wave:
            chunk = np.resize(chunk, wave)
        parts = np.split(chunk, n)
        walks += sum(bool(found[parts[s]].any()) for s in (range(n) if shards is None else shards))
    return walks


def mesh_waves(B: int, n: int, wave: int) -> int:
    """The waves of ``wave`` reads a mesh engine of ``n`` shards streams a
    batch of B reads in (the batch padded to a mesh multiple first)."""
    return -(-(B + (-B % n)) // wave)


def mesh_locate(tmp: str, codes: np.ndarray, fmi: str, qry: str, reads: np.ndarray, main_res: np.ndarray,
                store: str, pos: dict, mm: tuple, approx: dict, align: dict, dev, by_path: dict) -> dict:
    """Phase 20 (see the module docstring): the mesh locate, every result
    held against the one-device result of an earlier phase and every launch
    count exact. ``pos``: phase 10's .pos files ("two", "fused", "rc") and
    fused positions ("positions"); ``mm``: phase 12's reads and positions."""
    t0 = time.perf_counter()
    rounds = (READ_LEN - LUT_M) // K
    lut_launches = (4**LUT_M // min(4**LUT_M, 1 << 20)) * (LUT_M // K)
    SH = MESH_SHARDS
    FULL = 0xFFFFFFFF
    seconds = {}

    def cli_run(label: str, argv: list, need):
        """``argv`` through the CLI (stdout captured), the counts zeroed
        just before and read just after; ``need(run)`` the exact launches."""
        t1 = time.perf_counter()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            run = cli.main([*argv, "--device", "cuda"])
        by_path[label] = read_counts()
        seconds[label] = time.perf_counter() - t1
        expect_exact(label, by_path[label], need(run))
        return run

    def same_bytes(what: str, a: str, b: str) -> None:
        if Path(a).read_bytes() != Path(b).read_bytes():
            raise AssertionError(f"{what}: {a} and {b} differ")

    # (a) the CLI at --mesh 1, the bench record
    locate = ["locate", "-", "0", qry, str(READ_LEN), str(READS), "--from-store", store, "--max-hits",
              str(MAX_HITS), "--lut", str(LUT_M), "--mesh", "1"]
    one_wave = DataParallelSearchLocate.WAVE_PER_CHIP
    fwaves = mesh_waves(READS, 1, one_wave)
    hits = int((main_res[:, 1] - main_res[:, 0]).clip(max=MAX_HITS).sum())  # the rows two-pass walks
    out = os.path.join(tmp, "mesh1_two.pos")
    cli_run("mesh1_locate", [*locate, "--output", out], lambda run: {
        "lf_round_pairs": rounds + lut_launches, "locate_walk": -(-hits // DataParallelLocate.WAVE_PER_CHIP)})
    same_bytes("locate --mesh 1", out, pos["two"])
    out = os.path.join(tmp, "mesh1_fused.pos")
    run = cli_run("mesh1_locate_fused", [*locate, "--fused", "--output", out], lambda run: {
        "lf_round_pairs": rounds * fwaves + lut_launches,
        "locate_walk": mesh_walks(run.positions[:, 0] != FULL, 1, one_wave)})
    same_bytes("locate --fused --mesh 1", out, pos["fused"])
    found = run.positions[:, 0] != FULL
    out = os.path.join(tmp, "mesh1_rc.pos")
    cli_run("mesh1_locate_fused_rc", [*locate, "--fused", "--rc", "--output", out], lambda run: {
        "lf_round_pairs": rounds * mesh_waves(2 * READS, 1, one_wave) + lut_launches,
        "locate_walk": mesh_walks(run.positions[:, 0] != FULL, 1, one_wave)})
    same_bytes("locate --fused --rc --mesh 1", out, pos["rc"])
    same_bytes("locate --fused --rc --mesh 1 (minus strand)", out + ".rc", pos["rc"] + ".rc")
    # --resume: killed after two of its waves of 2^15, then the CLI finishes
    out = os.path.join(tmp, "mesh1_resume.pos")
    index_s, loc_s = load_store(f"{store}.search.tpufm"), load_store(f"{store}.locate.tpufm")
    dp1 = DataParallelSearchLocate(index_s, loc_s, make_mesh(1, device=dev), max_hits=MAX_HITS, lut_m=LUT_M)
    crash_after(lambda: locate_resumable(Crashing(dp1, 2, "search_locate"), reads, out), "locate --resume --mesh 1",
                out, 2)
    del dp1
    cli_run("mesh1_locate_resume", [*locate, "--fused", "--resume", "--output", out], lambda run: {
        "lf_round_pairs": rounds * (fwaves - 2) + lut_launches,
        "locate_walk": mesh_walks(found[2 * one_wave:], 1, one_wave)})
    same_bytes("locate --fused --resume --mesh 1", out, pos["fused"])
    have = torch.cuda.device_count()
    if have < 2:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["locate", "-", "0", qry, str(READ_LEN), "1024", "--from-store", store, "--mesh", "2",
                          "--device", "cuda"])
            raise AssertionError("locate --mesh 2 ran on one card")
        except ValueError as e:
            if str(e) != f"need 2 devices, have {have}":
                raise
    record = bench_record("bench_locate_mesh1", [
        "--refsize", str(REF_BASES), "--d", str(D), "--iterations", str(BENCH_PASSES), "--numqueries",
        str(WALK_ROWS), "--locate", "--sample-rate", str(SAMPLE_RATE), "--mesh", "1"],
        {"locate_walk": BENCH_PASSES + 1}, by_path)
    expect_exact("bench --locate --mesh 1", by_path["bench_locate_mesh1"], {"locate_walk": BENCH_PASSES + 1})
    print(f"[20 mesh locate] (a) phase 10's stores and {READS} x {READ_LEN} bp reads, max-hits {MAX_HITS}: locate "
          f"--mesh 1 two-pass, --fused, --fused --rc and --fused --resume (killed after 2 of {fwaves} waves of "
          f"{one_wave}, resumed) all byte-identical to phase 10's .pos, launches exact (K1 / K4: "
          + ", ".join(f"{p[6:]} {by_path[p]['lf_round_pairs']} / {by_path[p]['locate_walk']}" for p in (
              "mesh1_locate", "mesh1_locate_fused", "mesh1_locate_fused_rc", "mesh1_locate_resume"))
          + "); locate --mesh 2 on "
          f"{have} card(s): " + (f"'need 2 devices, have {have}'" if have < 2 else "not tried")
          + f"; bench --locate --mesh 1 {record['value']} positions/s, bit-exact; CLI seconds "
          f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)

    # (b) four colocated shards, fused and two-pass, beside the one device
    t1 = time.perf_counter()
    mesh4 = Mesh([dev] * SH)
    reset_counts()
    dpl = DataParallelLocate(loc_s, mesh4)
    same_results("DataParallelLocate.locate_hits, 4 shards", dpl.locate_hits(main_res, MAX_HITS), pos["positions"])
    by_path["mesh4_locate_hits"] = read_counts()
    expect_exact("DataParallelLocate, 4 shards", by_path["mesh4_locate_hits"], {
        "locate_walk": SH * -(-hits // (DataParallelLocate.WAVE_PER_CHIP * SH)), "lf_round_pairs": 0})
    lut_cache = f"{fmi}.lut{LUT_M}.npz"
    reset_counts()
    dp4 = DataParallelSearchLocate(index_s, loc_s, mesh4, max_hits=MAX_HITS, lut_m=LUT_M, lut_cache=lut_cache)
    lut_loaded = dp4.engines[0].search_engine.lut_build_seconds is None
    expect_exact("DataParallelSearchLocate's LUT", read_counts(), {"lf_round_pairs": 0 if lut_loaded else lut_launches})
    wave4 = one_wave * SH
    reset_counts()
    iv, fpos = dp4.search_locate(reads)
    by_path["mesh4_search_locate"] = read_counts()
    same_results("DataParallelSearchLocate intervals, 4 shards", iv, main_res)
    same_results("DataParallelSearchLocate positions, 4 shards", fpos, pos["positions"])
    expect_exact("DataParallelSearchLocate, 4 shards", by_path["mesh4_search_locate"], {
        "lf_round_pairs": rounds * SH * mesh_waves(READS, SH, wave4), "locate_walk": mesh_walks(found, SH, wave4)})
    del iv, fpos
    sle = SearchLocateEngine(index_s, loc_s, dev, max_hits=MAX_HITS, lut_m=LUT_M, lut_cache=lut_cache)
    q_all = torch.from_numpy(reads).to(dev)
    parts = [q_all[s * (READS // SH):(s + 1) * (READS // SH)] for s in range(SH)]
    turns = {"one_device": [], "mesh4": []}
    for name in ("one_device", "mesh4", "mesh4", "one_device"):
        fn = (lambda: sle.search_locate_device(q_all)) if name == "one_device" else (
            lambda: dp4.search_locate_device(parts))
        turns[name].extend(timed_device_passes(fn, iterations=3)[2])
    fused_s = {name: statistics.mean(t) for name, t in turns.items()}
    profile_pass("SearchLocateEngine, 10 Mbase", lambda: sle.search_locate_device(q_all), fused_s["one_device"])
    profile_pass(f"DataParallelSearchLocate, {SH} shards, 10 Mbase", lambda: dp4.search_locate_device(parts),
                 fused_s["mesh4"])
    del sle, q_all, parts
    print(f"    (b) {SH} colocated shards of this card: DataParallelLocate.locate_hits on phase 4's intervals "
          f"({hits} rows, K4 {by_path['mesh4_locate_hits']['locate_walk']}) and DataParallelSearchLocate lut{LUT_M} "
          f"(its LUT {'loaded from phase 4' if lut_loaded else 'built'}; {mesh_waves(READS, SH, wave4)} waves of "
          f"{wave4}; K1 {by_path['mesh4_search_locate']['lf_round_pairs']}, K4 "
          f"{by_path['mesh4_search_locate']['locate_walk']}) equal to phase 10; device seconds a pass, all "
          f"{READS} reads placed at once, in turns: SearchLocateEngine {fused_s['one_device']:.6f}, "
          f"{SH} shards {fused_s['mesh4']:.6f} ({(fused_s['mesh4'] / fused_s['one_device'] - 1) * 100:+.2f}%); "
          f"{time.perf_counter() - t1:.2f} s", flush=True)

    # (c) the approximate sources on the same four shards
    t1 = time.perf_counter()
    runs = approx["runs"]
    mm_reads, mm_pos = mm
    mm_wave = max(1, SearchEngine.WAVE // (3 * READ_LEN + 1)) * SH
    approx_s = {}  # host seconds of each pass, reads on the host to results on the host
    reset_counts()
    t2 = time.perf_counter()
    got = dp4.locate_mismatch(mm_reads)
    approx_s["mm1"] = time.perf_counter() - t2
    by_path["mesh4_mm1"] = read_counts()
    same_results("locate_mismatch, 4 shards", got, mm_pos)
    expect_exact("locate_mismatch, 4 shards", by_path["mesh4_mm1"], {
        "lf_round_pairs": rounds * SH * mesh_waves(MM_READS, SH, mm_wave),
        "locate_walk": mesh_walks(mm_pos[:, 0] != FULL, SH, mm_wave)})
    seed_rounds = {S: ((READ_LEN // S) // K * K - LUT_M) // K for S in (2, 3)}  # k-step rounds of S seeds a read
    sreads, swant = runs["seed"]
    dp4.locate_approx(sreads[:SH], codes, APPROX_M)  # builds the seed engines over the packed text
    reset_counts()
    t2 = time.perf_counter()
    got = dp4.locate_approx(sreads, codes, APPROX_M)
    approx_s["mm2"] = time.perf_counter() - t2
    by_path["mesh4_mm2"] = read_counts()
    same_arrays("locate_approx, 4 shards", got, swant)
    # every read holds an exact seed (pigeonhole), so every part walks
    n = SH * mesh_waves(SEED_READS, SH, SeedExtendEngine.WAVE * SH)
    expect_exact("locate_approx, 4 shards", by_path["mesh4_mm2"], {
        "lf_round_pairs": seed_rounds[APPROX_M + 1] * n, "locate_walk": n, "hamming_verify": n})
    ereads, ewant = runs["edit"]
    dp4.locate_edits(ereads[:SH], codes, APPROX_E)
    reset_counts()
    t2 = time.perf_counter()
    got = dp4.locate_edits(ereads, codes, APPROX_E)
    approx_s["e2"] = time.perf_counter() - t2
    by_path["mesh4_e2"] = read_counts()
    same_arrays("locate_edits, 4 shards", got, ewant)
    n = SH * mesh_waves(EDIT_READS, SH, EditExtendEngine.WAVE * SH)
    expect_exact("locate_edits, 4 shards", by_path["mesh4_e2"], {
        "lf_round_pairs": seed_rounds[APPROX_E + 1] * n, "locate_walk": n, "myers_verify": n})
    del dp4
    r1, r2, minus, pwant = runs["pairs"]
    found4 = np.concatenate([~minus, ~minus, minus, minus])  # [R1; rc(R2); rc(R1); R2] found on its strand
    paired = {}
    for label, extra, verify_kernel in (("mesh4_paired", {}, None),
                                        ("mesh4_paired_mm2", {"mismatches": 2, "text": codes}, "hamming_verify"),
                                        ("mesh4_paired_e1", {"edits": 1, "text": codes}, "myers_verify")):
        pe = PairedEndEngine(index_s, loc_s, INSERT_MIN, INSERT_MAX, max_hits=MAX_HITS, lut_m=LUT_M, mesh=mesh4,
                             **extra)
        if extra:
            a1, a2 = runs["approx_pairs"]
            want, B = runs[label[6:]], a1.shape[0]
            pe.pair(a1[:SH], a2[:SH])  # builds the engines over the packed text
            S = 2 if "edits" in extra else APPROX_M + 1
            n = SH * mesh_waves(4 * B, SH, (EditExtendEngine if "edits" in extra else SeedExtendEngine).WAVE * SH)
            need = {"lf_round_pairs": seed_rounds[S] * n, "locate_walk": n, verify_kernel: n}
        else:
            a1, a2, want, B = r1, r2, pwant, r1.shape[0]
            need = {"lf_round_pairs": rounds * SH * mesh_waves(4 * B, SH, wave4),
                    "locate_walk": mesh_walks(found4, SH, wave4)}
        reset_counts()
        t2 = time.perf_counter()
        got = pe.pair(a1, a2)
        paired[label] = time.perf_counter() - t2
        by_path[label] = read_counts()
        same_arrays(f"PairedEndEngine(mesh=...) {label}", got, want)
        expect_exact(label, by_path[label], need)
        del pe
    print(f"    (c) on the {SH} shards, each equal to the one-device engine of phases 12/14 with launches exact: "
          f"locate_mismatch {MM_READS} reads {approx_s['mm1']:.3f} s (K1 / K4 "
          f"{by_path['mesh4_mm1']['lf_round_pairs']} / {by_path['mesh4_mm1']['locate_walk']}); locate_approx "
          f"m={APPROX_M} {SEED_READS} reads {approx_s['mm2']:.3f} s (K1 / K4 / K5 "
          f"{by_path['mesh4_mm2']['lf_round_pairs']} / {by_path['mesh4_mm2']['locate_walk']} / "
          f"{by_path['mesh4_mm2']['hamming_verify']}); locate_edits E={APPROX_E} {EDIT_READS} reads "
          f"{approx_s['e2']:.3f} s (K1 / K4 / K6 {by_path['mesh4_e2']['lf_round_pairs']} / "
          f"{by_path['mesh4_e2']['locate_walk']} / {by_path['mesh4_e2']['myers_verify']}); PairedEndEngine(mesh=...) exact {PAIRS} pairs "
          f"{paired['mesh4_paired']:.3f} s, --mismatches 2 and --edits 1 on {PAIRS_APPROX} pairs "
          f"{paired['mesh4_paired_mm2']:.3f} / {paired['mesh4_paired_e1']:.3f} s; {time.perf_counter() - t1:.2f} s",
          flush=True)

    # (d) align --mesh 1 on phase 15's FASTA and reads
    t1 = time.perf_counter()
    a = align["mesh_inputs"]
    alut = a["lut"]
    alut_launches = (4**alut // min(4**alut, 1 << 20)) * (alut // K)
    arounds = (ALIGN_LEN - alut) // K
    common = ["align", a["ref"], "--from-store", a["store"], "--mesh", "1"]
    fq, se_out, se_pos = a["se"]
    out = os.path.join(tmp, "mesh1_se.sam")
    cli_run("mesh1_align_se", [*common[:2], fq, *common[2:], "-o", out], lambda run: {
        "lf_round_pairs": arounds * mesh_waves(2 * ALIGN_READS, 1, one_wave) + alut_launches,
        "locate_walk": mesh_walks(se_pos[:, 0] != FULL, 1, one_wave)})
    same_bytes("align --mesh 1", out, se_out)
    q1, q2, pe_out, pminus = a["paired"]
    out = os.path.join(tmp, "mesh1_pe.bam")
    cli_run("mesh1_align_paired", [*common[:2], q1, "-2", q2, *common[2:], "--bam", "--insert-min", str(INSERT_MIN),
                                   "--insert-max", str(INSERT_MAX), "-o", out], lambda run: {
        "lf_round_pairs": arounds * mesh_waves(4 * ALIGN_PAIRS, 1, one_wave) + alut_launches,
        "locate_walk": mesh_walks(np.concatenate([~pminus, ~pminus, pminus, pminus]), 1, one_wave)})
    same_bytes("align -2 --bam --mesh 1", out, pe_out)
    vq, v_out, v_pos = a["varlen"]
    vrounds = (VARLEN_MAX + (-(VARLEN_MAX - alut) % K) - alut) // K
    out = os.path.join(tmp, "mesh1_v.sam")
    cli_run("mesh1_align_varlen", [*common[:2], vq, *common[2:], "-o", out], lambda run: {
        "lf_round_pairs": vrounds + K - 1 + alut_launches,  # the k-step rounds, then the tail's
        "locate_walk": -(-int((v_pos != FULL).sum()) // DataParallelLocate.WAVE_PER_CHIP)})
    same_bytes("align --mesh 1 (mixed lengths)", out, v_out)
    print(f"    (d) align --from-store --mesh 1 on phase 15's reads: {ALIGN_READS} x {ALIGN_LEN} bp "
          f"{seconds['mesh1_align_se']:.2f} s, -2 --bam {ALIGN_PAIRS} pairs {seconds['mesh1_align_paired']:.2f} s, "
          f"{ALIGN_VARLEN_READS} reads of {VARLEN_MIN}-{VARLEN_MAX} bp {seconds['mesh1_align_varlen']:.2f} s: each "
          f"byte-identical to phase 15's, launches exact (K1 / K4: "
          + ", ".join(f"{by_path[p]['lf_round_pairs']} / {by_path[p]['locate_walk']}" for p in (
              "mesh1_align_se", "mesh1_align_paired", "mesh1_align_varlen")) + f"); {time.perf_counter() - t1:.2f} s",
          flush=True)

    # (e) 250 Mbase: the genome record's text, its index and locate tables built on the card from one sort
    t1 = time.perf_counter()
    _, gcodes = bench._reference_codes(GENOME_BASES, 0)
    gcd = upload_text(gcodes, dev)
    gorder = suffix_array_device_arr(gcd)
    gidx = build_index_device(gcodes, IndexConfig(k=K, d=D), return_host=False, sa_dev=gorder, codes_dev=gcd)
    gloc = build_locate_device(gcodes, sample_rate=SAMPLE_RATE, d=D, return_host=False, sa_dev=gorder, codes_dev=gcd)
    del gcd, gorder
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t1
    greads, gstarts = generate_reads(gcodes, READ_LEN, GENOME_LOCATE_READS, seed=SEED + 20, return_starts=True)
    del gcodes
    single = SearchLocateEngine(gidx, gloc, dev, max_hits=MAX_HITS, lut_m=LUT_M)
    want_iv, want_pos = single.search_locate(greads)
    gdp = DataParallelSearchLocate(gidx, gloc, mesh4, max_hits=MAX_HITS, lut_m=LUT_M)
    if not torch.equal(gdp.engines[0].search_engine.lut, single.search_engine.lut):
        raise AssertionError("250 Mbase: the mesh engine's LUT differs from the one-device engine's")
    reset_counts()
    g_iv, g_pos = gdp.search_locate(greads)
    by_path["genome_mesh4_search_locate"] = read_counts()
    same_results("250 Mbase DataParallelSearchLocate intervals", g_iv, want_iv)
    same_results("250 Mbase DataParallelSearchLocate positions", g_pos, want_pos)
    expect_exact("250 Mbase DataParallelSearchLocate", by_path["genome_mesh4_search_locate"], {
        "lf_round_pairs": rounds * SH * mesh_waves(GENOME_LOCATE_READS, SH, wave4),
        "locate_walk": mesh_walks(g_pos[:, 0] != FULL, SH, wave4)})
    wide = (g_iv[:, 1] - g_iv[:, 0]) > MAX_HITS
    if not ((g_pos == gstarts[:, None]).any(axis=1) | wide).all():
        raise AssertionError("250 Mbase: a read's origin is missing from its positions")
    gq = torch.from_numpy(greads).to(dev)
    gparts = [gq[s * (GENOME_LOCATE_READS // SH):(s + 1) * (GENOME_LOCATE_READS // SH)] for s in range(SH)]
    genome = {"one_device": [], "mesh4": []}
    for name in ("one_device", "mesh4", "mesh4", "one_device"):
        fn = (lambda: single.search_locate_device(gq)) if name == "one_device" else (
            lambda: gdp.search_locate_device(gparts))
        genome[name].extend(timed_device_passes(fn, iterations=3)[2])
    genome_s = {name: statistics.mean(t) for name, t in genome.items()}
    profile_pass("SearchLocateEngine, 250 Mbase", lambda: single.search_locate_device(gq), genome_s["one_device"])
    profile_pass(f"DataParallelSearchLocate, {SH} shards, 250 Mbase", lambda: gdp.search_locate_device(gparts),
                 genome_s["mesh4"])
    del single, gdp, gq, gparts, gidx, gloc
    torch.cuda.empty_cache()
    print(f"    (e) {GENOME_BASES} bases, k={K} d={D} s={SAMPLE_RATE} built on the card from one sort ({build_s:.2f} s), "
          f"lut{LUT_M}, {GENOME_LOCATE_READS} x {READ_LEN} bp: DataParallelSearchLocate on {SH} shards equal to "
          f"SearchLocateEngine (K1 / K4 {by_path['genome_mesh4_search_locate']['lf_round_pairs']} / "
          f"{by_path['genome_mesh4_search_locate']['locate_walk']}), every origin found ({int(wide.sum())} reads "
          f"wider than max-hits); device seconds a pass, in turns: one device {genome_s['one_device']:.6f}, {SH} "
          f"shards {genome_s['mesh4']:.6f} ({(genome_s['mesh4'] / genome_s['one_device'] - 1) * 100:+.2f}%); "
          f"{time.perf_counter() - t1:.2f} s; phase {time.perf_counter() - t0:.2f} s", flush=True)
    return {"seconds": seconds, "fused_seconds_per_pass": fused_s, "genome_seconds_per_pass": genome_s,
            "paired_seconds": paired, "approx_seconds": approx_s, "lut_loaded": lut_loaded, "bench_locate_mesh1": record["value"],
            "phase_seconds": time.perf_counter() - t0}


def k7_slice_case(cd: torch.Tensor, sa_s: torch.Tensor, s: int, k: int, d: int, run: int = 20) -> dict:
    """K7 on shard ``s``'s rows of the sharded build (``sa_s``, rows s*m ..
    (s+1)*m - 1): fail unless the wrapper's outputs equal the plain
    version's, then its device time (``graph_ms``, the pack and K7) beside
    its bound: the text (the pack reads all of it) and the slice's suffix
    array read once, its planes, counts and '$' rows written once."""
    m = sa_s.shape[0]
    got, want = build_tables(cd, sa_s, k, d, p0=s * m), build_tables_reference(cd, sa_s, k, d, p0=s * m)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("counts", "bitmaps", "dollar_pos")):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"K7 k={k} d={d}, shard {s} (rows {s * m}-{(s + 1) * m - 1}): {name} differs "
                                 "from the plain version's")
    del got, want
    E = m // d
    nbytes = cd.shape[0] + 4 * m + 4 * (E + 1) * 2 * k * (d // 32) + 4 * E * 4**k + 8 * k
    return {"shard": s, "rows": m, "k": k, "d": d, "max_abs_err": 0, "bytes": nbytes, "bound_ms": bound_ms(nbytes),
            "ms": graph_ms(lambda: build_tables(cd, sa_s, k, d, p0=s * m), run=run)}


def same_log(what: str, log: list, want: list) -> int:
    """Fail unless the logged collectives are ``want`` (kind, shape, dtype,
    bytes), in order; returns their bytes."""
    got = [(c.kind, c.shape, c.dtype, c.bytes) for c in log]
    if got != want:
        raise AssertionError(f"{what}: the collectives {got} are not the closed form {want}")
    return sum(c.bytes for c in log)


def sharded_build(tmp: str, ref: str, codes: np.ndarray, index, fmi: str, sa: np.ndarray, loc, store: str,
                  qry: str, reads: np.ndarray, main_res: np.ndarray, ondev: dict, dev, by_path: dict) -> dict:
    """Phase 21 (see the module docstring): the sharded build on four
    colocated shards and through the CLI at --mesh 1, every array held
    against the one-device build or the host's, every launch count exact."""
    t0 = time.perf_counter()
    n, big, SH = codes.shape[0], codes.shape[0] + 1, MESH_SHARDS
    mesh4 = Mesh([dev] * SH)
    rounds = (READ_LEN - LUT_M) // K

    # (a) the index, the tail and the locate tables from one sort over four shards
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    order = suffix_array_sharded_arr(codes, mesh4)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t1
    s_index = build_index_sharded(codes, IndexConfig(k=K, d=D), mesh4, sa_dev=order)
    s_tail = build_index_sharded(codes, IndexConfig(k=1, d=D), mesh4, sa_dev=order)
    s_loc = build_locate_sharded(codes, sample_rate=SAMPLE_RATE, d=D, mesh=mesh4, sa_dev=order)
    build_s = time.perf_counter() - t1
    by_path["sharded_build"] = read_counts()
    expect_exact("sharded build", by_path["sharded_build"], {"build_tables": 3 * SH, "pack_text": 3 * SH})
    same_tables("sharded k=3 index", s_index, index, INDEX_FIELDS)
    same_tables("sharded k=1 tail", s_tail, loc.lf1, INDEX_FIELDS)
    same_tables("sharded locate tables", s_loc, loc, ("samples", "mark_words", "mark_rank"))
    same_tables("sharded locate k=1 index", s_loc.lf1, loc.lf1, INDEX_FIELDS)
    if not np.array_equal(sas_mod.gather_rows(order, big).numpy().astype(np.int64), sa):
        raise AssertionError("sharded suffix array differs from phase 9's SA-IS suffix array")
    del s_index, s_tail, s_loc

    # the sort again round by round, each between CUDA events, its collectives against the closed form
    m = sas_mod.shard_lanes(n, SH)
    c3 = sas_mod.text_lanes(codes, mesh4)
    round_ms, round_bytes = [], []
    with coll.recording() as log:
        (rank, again, distinct), ms = cuda_events_ms(lambda: sas_mod.initial(c3, big))
    round_ms.append(ms)
    round_bytes.append(same_log("the sort's first round", log, sas_mod.round_collectives(SH, m)))
    h = sa_mod.PACK
    while not bool(distinct) and h < big:
        with coll.recording() as log:
            (rank, again, distinct), ms = cuda_events_ms(lambda: sas_mod.step(rank, h, big))
        round_ms.append(ms)
        round_bytes.append(same_log(f"the sort's round at h={h}", log, sas_mod.round_collectives(SH, m, h)))
        h *= 2
    if not all(torch.equal(a, b) for a, b in zip(again, order)):
        raise AssertionError("the sharded sort's rounds one by one end elsewhere than suffix_array_sharded_arr")
    del rank, again, c3

    # K7 on each shard's rows against its plain version; the first and last shard timed
    sa2 = coll.relayout(order, big, bs_mod.table_rows(big, D, SH))
    cd = upload_text(codes, dev)
    slices = [k7_slice_case(cd, x, s, K, D) for s, x in enumerate(sa2)]
    del sa2, cd
    torch.cuda.empty_cache()
    one = ondev["summary"]
    print(f"[21 sharded build] (a) {n} bases on {SH} shards of this card, k={K} d={D} index + k=1 tail + "
          f"s={SAMPLE_RATE} locate tables from one sharded sort, each equal to phases 4 and 9 (the suffix array "
          f"too): {build_s:.3f} s (sort {sort_s:.3f} s; rounds {', '.join(f'{x:.3f}' for x in round_ms)} ms, "
          f"their collectives the closed form, {', '.join(map(str, round_bytes))} B between shards; K7 / pack "
          f"launches {by_path['sharded_build']['build_tables']} / {by_path['sharded_build']['pack_text']}); one "
          f"device (phase 16): {one['device_s']:.3f} s (sort {one['device_sort_s']:.3f} s; rounds "
          f"{', '.join(f'{x:.3f}' for x in one['round_ms'])} ms)", flush=True)
    print("    K7 on each shard's rows, bit-identical to plain: " + "; ".join(
        f"shard {c['shard']} {c['ms']:.4f} ms (bound {c['bound_ms']:.4f} ms, {c['bound_ms'] / c['ms'] * 100:.1f}% "
        f"of it)" for c in slices), flush=True)

    # (b) the per-shard store, its search, and the CLI at --mesh 1
    t1 = time.perf_counter()
    tables = build_index_sharded(codes, IndexConfig(k=K, d=D), mesh4, sa_dev=order, return_host=False)
    del order
    root = save_store_sharded(os.path.join(tmp, "sharded4.tpufm"), tables)
    del tables
    split = shard_tables(index, SH)
    for s in range(SH):
        for name, arr in (("occ", split.occ[s]), ("bitmaps", split.bitmaps[s].reshape(split.e_local, K, 2, D // 32))):
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(arr))
            if (root / f"{name}.shard{s:04d}.npy").read_bytes() != buf.getvalue():
                raise AssertionError(f"save_store_sharded: {name}.shard{s:04d}.npy differs from phase 4's split")
    meta = json.loads((root / "meta.json").read_text())
    if meta != {"kind": "kstep_sharded", "format": 1, "n_shards": SH, "rows": SH * split.e_local, "k": K, "d": D,
                "layout": "baseline", "bwtsize": big}:
        raise AssertionError(f"save_store_sharded: meta.json {meta}")
    reset_counts()
    eng = ShardedIndexEngine(load_store_sharded(root, mesh4), mesh4, lut_m=LUT_M)
    by_path["sharded_store_lut"] = read_counts()
    reset_counts()
    same_results("the per-shard store's search, 4 shards", eng.search(reads), main_res)
    by_path["sharded_store_search"] = read_counts()
    wave = ShardedIndexEngine.WAVE_PER_CHIP * SH
    expect_exact("the per-shard store's LUT", by_path["sharded_store_lut"],
                 {"lf_answer_owned": SH * (4**LUT_M // min(4**LUT_M, wave)) * (LUT_M // K), "lf_round_pairs": 0})
    expect_exact("the per-shard store's search", by_path["sharded_store_search"],
                 {"lf_answer_owned": SH * rounds * -(-READS // wave), "lf_round_pairs": 0})
    del eng, split
    torch.cuda.empty_cache()
    store_s = time.perf_counter() - t1

    seconds = {}

    def cli_run(label: str, argv: list, exact: dict, least: dict | None = None):
        t2 = time.perf_counter()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            run = cli.main(argv)
        by_path[label] = read_counts()
        expect_exact(label, by_path[label], exact)
        expect_launches(label, by_path[label], least or {})
        seconds[label] = time.perf_counter() - t2
        return run

    build = ["build", ref, str(n), "--k", str(K), "--d", str(D), "--on-device", "--mesh", "1", "--device", "cuda"]
    out = os.path.join(tmp, "sharded1.fmi")
    cli_run("build_mesh1", [*build, "--tail", "--output", out], {"build_tables": 2, "pack_text": 2})
    if Path(out).read_bytes() != Path(fmi).read_bytes():
        raise AssertionError("build --on-device --mesh 1: the .fmi differs from phase 4's")
    same_tables("build --on-device --mesh 1 --tail: the tail", load_npz(out + ".tail.npz"), loc.lf1, INDEX_FIELDS)
    st = os.path.join(tmp, "sharded1.tpufm")
    cli_run("build_store_sharded", [*build, "--store-sharded", "--output", st], {"build_tables": 1, "pack_text": 1})
    one_wave = ShardedIndexEngine.WAVE_PER_CHIP
    run = cli_run("search_store_sharded", [
        "search", st, qry, str(READ_LEN), str(READS), "--sharded", "--mesh", "1", "--lut", str(LUT_M),
        "--device", "cuda", "--iterations", "1", "--output", os.path.join(tmp, "sharded1.res")], {
        "lf_answer_owned": (4**LUT_M // one_wave) * (LUT_M // K) + 2 * rounds * -(-READS // one_wave),
        "lf_round_pairs": 0})
    same_results("search --sharded --mesh 1 of the per-shard store", run.results, main_res)
    del run
    cli_run("locate_mesh1_on_device", [
        "locate", ref, str(n), os.path.join(tmp, "ondev.qry"), str(READ_LEN), str(DEVICE_LOCATE_READS), "--k", str(K),
        "--d", str(D), "--sample-rate", str(SAMPLE_RATE), "--max-hits", str(MAX_HITS), "--lut", str(LUT_M),
        "--fused", "--on-device", "--mesh", "1", "--store", os.path.join(tmp, "sharded1"), "--device", "cuda",
        "--output", os.path.join(tmp, "sharded1.pos")], {"build_tables": 2, "pack_text": 2},
        {"lf_round_pairs": rounds, "locate_walk": 1})
    for kind in ("search", "locate"):
        if tree_bytes(os.path.join(tmp, f"sharded1.{kind}.tpufm")) != tree_bytes(f"{store}.{kind}.tpufm"):
            raise AssertionError(f"locate --on-device --mesh 1 --store: {kind}.tpufm differs from phase 10's store")
    if Path(os.path.join(tmp, "sharded1.pos")).read_bytes() != Path(os.path.join(tmp, "ondev.pos")).read_bytes():
        raise AssertionError("locate --on-device --mesh 1: the .pos differs from phase 16's")
    have = torch.cuda.device_count()
    if have < 2:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main([*build[:8], "--mesh", "2", "--device", "cuda", "--output", os.path.join(tmp, "mesh2.fmi")])
            raise AssertionError("build --on-device --mesh 2 ran on one card")
        except ValueError as e:
            if str(e) != f"need 2 devices, have {have}":
                raise
    print(f"    (b) save_store_sharded of (a)'s return_host=False tables: every shard file byte-identical to phase "
          f"4's index split {SH} ways, meta.json tpufm's; load_store_sharded + ShardedIndexEngine (allgather, "
          f"lut{LUT_M} built by its own rounds) on phase 4's {READS} reads all equal to phase 4, K9 "
          f"{by_path['sharded_store_lut']['lf_answer_owned']} (LUT) + "
          f"{by_path['sharded_store_search']['lf_answer_owned']} launches; {store_s:.2f} s. CLI at --mesh 1: "
          f"build --on-device --tail (.fmi byte-identical to phase 4's, tail equal), --store-sharded, search "
          f"--sharded of that store (all equal to phase 4), locate --on-device --fused --store on "
          f"{DEVICE_LOCATE_READS} reads (both stores byte-identical to phase 10's, .pos to phase 16's); build "
          f"--mesh 2 on {have} card(s): " + (f"'need 2 devices, have {have}'" if have < 2 else "not tried")
          + f"; seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)

    # (c) the 250 Mbase genome text: one device, then four shards, the suffix array and index compared
    t1 = time.perf_counter()
    _, gcodes = bench._reference_codes(GENOME_BASES, 0)
    gbig = GENOME_BASES + 1
    cfg = IndexConfig(k=K, d=D)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gcd = upload_text(gcodes, dev)
    gorder = suffix_array_device_arr(gcd)
    torch.cuda.synchronize()
    one_sort_s = time.perf_counter() - t2
    gidx = build_index_device(gcodes, cfg, return_host=False, sa_dev=gorder, codes_dev=gcd)
    torch.cuda.synchronize()
    one_build_s = time.perf_counter() - t2
    want = shard_tables(gidx, SH)
    del gcd, gidx
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t2 = time.perf_counter()
    gsorder = suffix_array_sharded_arr(gcodes, mesh4)
    torch.cuda.synchronize()
    sh_sort_s = time.perf_counter() - t2
    sort_peak = torch.cuda.max_memory_allocated(dev) - base
    gm = gsorder[0].shape[0]
    for s, x in enumerate(gsorder):
        lo, hi = s * gm, min((s + 1) * gm, gbig)
        if not torch.equal(x[:hi - lo], gorder[lo:hi]):
            raise AssertionError(f"250 Mbase: shard {s} of the sharded suffix array differs from the one-device sort's")
    gtab = build_index_sharded(gcodes, cfg, mesh4, sa_dev=gsorder, return_host=False)
    torch.cuda.synchronize()
    sh_build_s = time.perf_counter() - t2
    build_peak = torch.cuda.max_memory_allocated(dev) - base
    by_path["genome_sharded_build"] = read_counts()
    expect_exact("250 Mbase sharded build", by_path["genome_sharded_build"], {"build_tables": SH, "pack_text": SH})
    if gtab.e_local != want.e_local or not np.array_equal(gtab.dollar, want.dollar) or not all(
            torch.equal(a, b) for a, b in zip(gtab.occ + gtab.bitmaps, want.occ + want.bitmaps)):
        raise AssertionError("250 Mbase: the sharded k=3 d=192 tables differ from the one-device build's")
    nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs)
    shard_bytes = {"suffix_array": nbytes(gsorder[:1]), "tables": nbytes([gtab.occ[0], gtab.bitmaps[0]])}
    del gsorder, gtab, gorder, want, gcodes
    torch.cuda.empty_cache()
    genome = {"bases": GENOME_BASES, "one_device_sort_s": one_sort_s, "one_device_build_s": one_build_s,
              "sharded_sort_s": sh_sort_s, "sharded_build_s": sh_build_s, "sort_peak_bytes": sort_peak,
              "build_peak_bytes": build_peak, "peak_bytes_per_base": build_peak / GENOME_BASES,
              "shard0_bytes": shard_bytes, "phase16_peak_bytes_per_base": ondev["summary"]["peak_bytes_per_base"]}
    print(f"    (c) {GENOME_BASES} bases, k={K} d={D}: the suffix array sorted on {SH} shards equal to the "
          f"one-device sort's, the tables equal (K7 / pack launches {by_path['genome_sharded_build']['build_tables']}"
          f" / {by_path['genome_sharded_build']['pack_text']}): sharded sort {sh_sort_s:.3f} s, sort and build "
          f"{sh_build_s:.3f} s; one device, as phase 16(c): sort {one_sort_s:.3f} s, sort and build "
          f"{one_build_s:.3f} s; peak device memory of the sharded sort {sort_peak} B ({sort_peak / GENOME_BASES:.2f}"
          f" B/base), of the sort and build {build_peak} B ({build_peak / GENOME_BASES:.2f} B/base; one device "
          f"{genome['phase16_peak_bytes_per_base']:.2f}), every shard on this one card; a shard's own tensors at "
          f"the end: suffix array {shard_bytes['suffix_array']} B, tables {shard_bytes['tables']} B; "
          f"{time.perf_counter() - t1:.2f} s; phase {time.perf_counter() - t0:.2f} s", flush=True)
    return {"bases": n, "sort_s": sort_s, "build_s": build_s, "round_ms": round_ms, "round_bytes": round_bytes,
            "k7_slices": slices, "store_s": store_s, "cli_seconds": seconds, "genome": genome,
            "phase_seconds": time.perf_counter() - t0}


#: phase 22: the processes of the multi-process mesh, the shards each owns
#: on this card, the reads of its reduced parts, (d)'s reference, reads,
#: wave and LUT, and the seconds a worker may take
MP_PROCS, MP_SHARDS, MP_READS = 2, 2, 1 << 16
MP_SCALE_BASES, MP_SCALE_D, MP_SCALE_READS, MP_SCALE_WAVE, MP_SCALE_LUT = 100_000_000, 128, 8192, 2048, 9
MP_TIMEOUT_S = 420


def mesh_worker(argv: list) -> None:
    """One process of phase 22 (``chip_smoke.py --mesh-worker COORDINATOR
    PID DIR``): joins the gloo group, owns MP_SHARDS shards of cuda:0, runs
    (a)-(d) on the inputs the parent wrote to DIR, holds every result to
    the earlier phase's (an AssertionError exits non-zero), and writes its
    launch counts, seconds and collective bytes to DIR/worker_PID.json."""
    from tpufm_torch.engine.tables import shard_tables
    from tpufm_torch.parallel import initialize_distributed, shutdown_distributed
    from tpufm_torch.parallel.traffic import check_collective_log, wave_bytes

    coordinator, pid, work = argv[0], int(argv[1]), Path(argv[2])
    if not torch.cuda.is_available():
        sys.exit("chip_smoke --mesh-worker: torch.cuda.is_available() is false")
    initialize_distributed(coordinator, num_processes=MP_PROCS, process_id=pid, local_device_ids=[0] * MP_SHARDS,
                           backend="gloo", timeout=MP_TIMEOUT_S - 60)
    mesh = make_mesh()
    SH, mine = mesh.size, mesh.local_shards
    if (SH, mesh.process_index, mesh.local_count) != (MP_PROCS * MP_SHARDS, pid, MP_SHARDS):
        raise AssertionError(f"process {pid}: {mesh}")
    inp = json.loads((work / "inputs.json").read_text())
    index, _ = read_fmi(inp["fmi"])
    index_s, loc_s = load_store(f"{inp['store']}.search.tpufm"), load_store(f"{inp['store']}.locate.tpufm")
    reads, main_res = np.load(work / "reads.npy"), np.load(work / "main_res.npy")
    codes = np.load(work / "codes.npy")
    out = {"counts": {}, "seconds": {}, "bytes": {}, "overflow_rounds": {}, "process": pid, "shards": list(mine)}

    def counted(label: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out["seconds"][label] = time.perf_counter() - t0
        out["counts"][label] = read_counts()
        return r

    def logged(label: str, eng, routing: str):
        """A second host pass (warm), then one device pass of every read
        placed at once (phase 19's protocol), its collectives held to the
        closed form."""
        t0 = time.perf_counter()
        eng.search(reads)
        out["seconds"][label + "_warm"] = time.perf_counter() - t0
        placed = eng.place_queries(reads) if routing != "dp" else eng.shard_queries(reads)
        with coll.recording() as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = eng.search_device(placed)
            torch.cuda.synchronize()
        out["seconds"][label + "_device"] = time.perf_counter() - t0
        overflow = () if routing == "dp" else r[1]
        got = check_collective_log(log, routing, SH, READS, overflow, mesh.local_count)
        out["bytes"][label] = {k: got[k] for k in ("bytes", "within", "across")}
        out["bytes"][label]["closed_form"] = wave_bytes(routing, SH, READS, overflow, mesh.local_count)

    # (a) phase 4's index and reads at full width
    lut_cache = f"{inp['fmi']}.lut{LUT_M}.npz"
    dp = counted("a_dp_lut", lambda: DataParallelEngine(index, mesh, lut_m=LUT_M, lut_cache=lut_cache))
    same_results(f"process {pid}: DataParallelEngine", counted("a_dp", lambda: dp.search(reads)), main_res)
    logged("a_dp", dp, "dp")
    del dp
    with np.load(lut_cache) as z:
        main_lut = z["lut"]
    ag = counted("a_allgather_lut", lambda: ShardedIndexEngine(index, mesh, routing="allgather", lut_m=LUT_M))
    if not np.array_equal(ag.lut[0].cpu().numpy().view(np.uint32), main_lut.view(np.uint32)):
        raise AssertionError(f"process {pid}: the sharded LUT differs from phase 4's")
    out["seconds"]["a_allgather_lut_build"] = ag.lut_build_seconds
    same_results(f"process {pid}: ShardedIndexEngine allgather", counted("a_allgather", lambda: ag.search(reads)),
                 main_res)
    logged("a_allgather", ag, "allgather")
    del ag
    with_lut = dataclasses.replace(shard_tables(index, SH), lut=main_lut.view(np.uint32))
    a2a = ShardedIndexEngine(with_lut, mesh, routing="a2a")
    same_results(f"process {pid}: ShardedIndexEngine a2a", counted("a_a2a", lambda: a2a.search(reads)), main_res)
    out["overflow_rounds"]["a_a2a"] = int(sum(ov.sum() for ov in a2a.last_overflow_waves))
    logged("a_a2a", a2a, "a2a")
    del a2a
    torch.cuda.empty_cache()

    # (b) at MP_READS reads: the ring, the locate engines, seed-and-extend
    part = reads[:MP_READS]
    ring = ShardedIndexEngine(with_lut, mesh, routing="ring")
    same_results(f"process {pid}: ring", counted("b_ring", lambda: ring.search(part)), main_res[:MP_READS])
    del ring
    positions = np.load(work / "positions.npy")
    dpl = DataParallelLocate(loc_s, mesh)
    same_results(f"process {pid}: DataParallelLocate.locate_hits",
                 counted("b_locate_hits", lambda: dpl.locate_hits(main_res[:MP_READS], MAX_HITS)), positions)
    dpsl = counted("b_dpsl_lut", lambda: DataParallelSearchLocate(index_s, loc_s, mesh, max_hits=MAX_HITS,
                                                                  lut_m=LUT_M, lut_cache=lut_cache))
    iv, pos = counted("b_search_locate", lambda: dpsl.search_locate(part))
    same_results(f"process {pid}: search_locate intervals", iv, main_res[:MP_READS])
    same_results(f"process {pid}: search_locate positions", pos, positions)
    sreads = np.load(work / "seed_reads.npy")
    with np.load(work / "seed_want.npz") as z:
        swant = (z["pos"], z["cnt"], z["ovf"])
    dpsl.locate_approx(sreads[:SH], codes, APPROX_M)  # builds the seed engines over the packed text
    same_arrays(f"process {pid}: locate_approx", counted("b_seed", lambda: dpsl.locate_approx(sreads, codes, APPROX_M)),
                swant)
    del dpsl, dpl
    torch.cuda.empty_cache()

    # (c) the sharded build of phase 4's text across both processes
    def build():
        order = suffix_array_sharded_arr(codes, mesh)
        return (order, build_index_sharded(codes, IndexConfig(k=K, d=D), mesh, sa_dev=order),
                build_index_sharded(codes, IndexConfig(k=1, d=D), mesh, sa_dev=order),
                build_index_sharded(codes, IndexConfig(k=K, d=D), mesh, sa_dev=order, return_host=False))

    order, s_index, s_tail, tables = counted("c_build", build)
    big = codes.shape[0] + 1
    if not np.array_equal(sas_mod.gather_rows(order, big, mesh).numpy().astype(np.int64), np.load(work / "sa.npy")):
        raise AssertionError(f"process {pid}: the sharded suffix array differs from phase 9's")
    same_tables(f"process {pid}: sharded k=3 index", s_index, index, INDEX_FIELDS)
    same_tables(f"process {pid}: sharded k=1 tail", s_tail, loc_s.lf1, INDEX_FIELDS)
    del order, s_index, s_tail
    root = save_store_sharded(work / "sharded.tpufm", tables)
    if tree_bytes(root) != tree_bytes(inp["sharded4"]):
        raise AssertionError(f"process {pid}: save_store_sharded's files differ from phase 21's")
    del tables
    eng = ShardedIndexEngine(load_store_sharded(root, mesh), mesh)
    same_results(f"process {pid}: load_store_sharded search", counted("c_store_search", lambda: eng.search(part)),
                 main_res[:MP_READS])
    del eng
    torch.cuda.empty_cache()

    # (d) the chromosome-scale store, streamed in waves
    big_index = load_store(inp["scale_store"])
    queries = np.load(work / "scale_reads.npy")
    eng = counted("d_lut", lambda: DataParallelEngine(big_index, mesh, lut_m=MP_SCALE_LUT))
    got = counted("d_stream", lambda: stream_waves(queries, MP_SCALE_WAVE,
                                                   lambda q: eng.search_device(eng.shard_queries(q)), None, (2,)))
    same_results(f"process {pid}: the chromosome-scale stream", got, np.load(work / "scale_want.npy"))
    del eng, big_index
    for pkg in ("jax", "tpufm"):
        if any(m == pkg or m.startswith(pkg + ".") for m in sys.modules):
            raise AssertionError(f"{pkg} was imported")
    (work / f"worker_{pid}.json").write_text(json.dumps(out))
    shutdown_distributed()


def multi_process(tmp: str, codes: np.ndarray, index, fmi: str, reads: np.ndarray, main_res: np.ndarray,
                  positions: np.ndarray, sa: np.ndarray, store: str, approx: dict, mesh: dict, dev,
                  by_path: dict) -> dict:
    """Phase 22 (see the module docstring): MP_PROCS processes of the port,
    MP_SHARDS shards each on this card, joined by gloo over a localhost
    coordinator (``mesh_worker``); each process's results held to the
    earlier phases (in the worker) and its launch counts to the exact
    numbers (here)."""
    t0 = time.perf_counter()
    work = Path(tmp) / "p22"
    work.mkdir()
    # the inputs, written once: phase 4's reads and intervals, phase 10's positions, phase 9's suffix array,
    # phase 14's seed reads and one-device results
    np.save(work / "reads.npy", reads)
    np.save(work / "main_res.npy", main_res)
    np.save(work / "codes.npy", codes)
    np.save(work / "positions.npy", positions[:MP_READS])
    np.save(work / "sa.npy", sa)
    sreads, (spos, scnt, sovf) = approx["runs"]["seed"]
    np.save(work / "seed_reads.npy", sreads)
    np.savez(work / "seed_want.npz", pos=spos, cnt=scnt, ovf=sovf)
    # (d) tpufm's chromosome-scale case: a seeded 100 Mbase text, k=3 d=128 built on the card, its store
    t1 = time.perf_counter()
    scodes = np.random.default_rng(SEED + 22).integers(0, 4, MP_SCALE_BASES, dtype=np.uint8)
    sidx = build_index_device(scodes, IndexConfig(k=K, d=MP_SCALE_D), device=dev)
    scale_store = save_store(work / "chrom.tpufm", sidx)
    squeries = generate_reads(scodes, READ_LEN, MP_SCALE_READS, seed=SEED + 22)
    np.save(work / "scale_reads.npy", squeries)
    one = SearchEngine(sidx, dev, lut_m=MP_SCALE_LUT)
    np.save(work / "scale_want.npy", one.search(squeries))
    del one, sidx, scodes
    torch.cuda.empty_cache()
    scale_s = time.perf_counter() - t1
    (work / "inputs.json").write_text(json.dumps({"fmi": fmi, "store": store, "scale_store": str(scale_store),
                                                  "sharded4": os.path.join(tmp, "sharded4.tpufm")}))
    setup_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    # the coordinator's store is held here, on a port the system picks, for the workers' whole run, as
    # torchrun's agent holds it: no port is freed and bound again, so no other process can take it between
    store = torch.distributed.TCPStore("127.0.0.1", 0, world_size=MP_PROCS, is_master=True, wait_for_workers=False,
                                       timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    coordinator = f"127.0.0.1:{store.port}"
    env = {**os.environ, "TORCHELASTIC_USE_AGENT_STORE": "True"}
    procs = []
    try:
        for pid in range(MP_PROCS):
            with open(work / f"worker_{pid}.log", "w") as log:
                procs.append(subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--mesh-worker",
                                               coordinator, str(pid), str(work)], cwd=REPO, env=env, stdout=log,
                                              stderr=subprocess.STDOUT))
        # until both end, one fails (its peer would wait out the group's timeout) or the time is up
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            if time.perf_counter() - t1 > MP_TIMEOUT_S:
                raise AssertionError(f"phase 22: a worker ran past {MP_TIMEOUT_S} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    run_s = time.perf_counter() - t1
    failed = [(pid, p.returncode) for pid, p in enumerate(procs) if p.returncode != 0]
    if failed:  # each failed worker's exit code and the end of its log (a peer killed here exits -9)
        raise AssertionError("phase 22: " + "\n".join(
            f"worker {pid} exited {rc}:\n{(work / f'worker_{pid}.log').read_text()[-4000:]}" for pid, rc in failed))
    results = [json.loads((work / f"worker_{pid}.json").read_text()) for pid in range(MP_PROCS)]

    # the exact launches of one process (MP_SHARDS shards): every count read in the worker
    L, SH = MP_SHARDS, MP_PROCS * MP_SHARDS
    rounds = (READ_LEN - LUT_M) // K
    wave = ShardedIndexEngine.WAVE_PER_CHIP * SH
    waves, lut_waves = -(-READS // wave), 4**LUT_M // min(4**LUT_M, wave)
    hits = int(np.minimum(main_res[:MP_READS, 1] - main_res[:MP_READS, 0], MAX_HITS).sum())
    found = positions[:MP_READS, 0] != 0xFFFFFFFF
    seed_n = L * mesh_waves(SEED_READS, SH, SeedExtendEngine.WAVE * SH)
    seed_rounds = ((READ_LEN // (APPROX_M + 1)) // K * K - LUT_M) // K
    scale_rounds = (READ_LEN - MP_SCALE_LUT) // K
    for r in results:
        shards = r["shards"]
        need = {
            "a_dp_lut": {"lf_round_pairs": 0},
            "a_dp": {"lf_round_pairs": L * rounds, "lf_answer_owned": 0},
            "a_allgather_lut": {"lf_answer_owned": L * lut_waves * (LUT_M // K), "lf_round_pairs": 0},
            "a_allgather": {"lf_answer_owned": L * rounds * waves, "lf_round_pairs": 0},
            "a_a2a": {"lf_answer_owned": L * rounds * waves, "lf_round_pairs": 0},
            "b_ring": {"lf_answer_owned": 2 * SH * L * rounds, "lf_round_pairs": 0},
            "b_locate_hits": {"locate_walk": L * mesh_waves(hits, SH, DataParallelLocate.WAVE_PER_CHIP * SH)},
            "b_dpsl_lut": {"lf_round_pairs": 0},
            "b_search_locate": {"lf_round_pairs": L * rounds * mesh_waves(MP_READS, SH,
                                                                           DataParallelSearchLocate.WAVE_PER_CHIP * SH),
                                "locate_walk": mesh_walks(found, SH, DataParallelSearchLocate.WAVE_PER_CHIP * SH,
                                                          shards)},
            "b_seed": {"lf_round_pairs": seed_rounds * seed_n, "locate_walk": seed_n, "hamming_verify": seed_n},
            "c_build": {"build_tables": 3 * L, "pack_text": 3 * L},
            "c_store_search": {"lf_answer_owned": L * (READ_LEN // K), "lf_round_pairs": 0},
            "d_lut": {"lf_round_pairs": (4**MP_SCALE_LUT // min(4**MP_SCALE_LUT, SearchEngine.WAVE))
                      * (MP_SCALE_LUT // K)},
            "d_stream": {"lf_round_pairs": L * scale_rounds * (MP_SCALE_READS // MP_SCALE_WAVE)},
        }
        for label, n in need.items():
            expect_exact(f"phase 22 process {r['process']} {label}", r["counts"][label], n)
            by_path[f"mp_{label}_p{r['process']}"] = r["counts"][label]
        if any(r["counts"][label]["build_tables"] for label in need if label != "c_build"):
            raise AssertionError(f"phase 22 process {r['process']}: K7 launched outside the build")
    one19 = {"dp": mesh["dp4_s"], "allgather": mesh["routings"]["mesh4_allgather"]["device_seconds_per_pass"],
             "a2a": mesh["routings"]["mesh4_a2a"]["device_seconds_per_pass"]}
    print(f"[22 multi-process] {MP_PROCS} processes of the port, {MP_SHARDS} shards each on this card (a "
          f"{SH}-shard mesh), joined by gloo over {coordinator}: every result equal to its earlier phase in every "
          f"process, every launch count exact; set-up {setup_s:.2f} s (the {MP_SCALE_BASES}-base store "
          f"{scale_s:.2f} s), workers {run_s:.2f} s", flush=True)
    print("    NCCL was not run: this machine has one card, and NCCL refuses two ranks on one card; the collectives "
          "crossed processes through gloo, staged through the host", flush=True)
    for r in results:
        sec, b = r["seconds"], r["bytes"]
        print(f"    process {r['process']} (shards {r['shards']}): (a) {READS} x {READ_LEN} bp, host seconds a pass, "
              "the first / a second: "
              + ", ".join(f"{name} {sec['a_' + name]:.3f} / {sec['a_' + name + '_warm']:.3f}"
                          for name in ("dp", "allgather", "a2a"))
              + "; device seconds a pass (all reads placed), phase 19's four colocated shards in one process "
              "beside: " + ", ".join(f"{name} {sec['a_' + name + '_device']:.3f} ({one19[name]:.3f})"
                                     for name in ("dp", "allgather", "a2a"))
              + f"; allgather LUT built by its own rounds {sec['a_allgather_lut_build']:.2f} s; a2a overflow rounds "
              f"{r['overflow_rounds']['a_a2a']}; bytes a pass between shards / across processes (closed form): "
              + ", ".join(f"{name} {b['a_' + name]['bytes']} / {b['a_' + name]['across']} "
                          f"({b['a_' + name]['closed_form']['across']})" for name in ("dp", "allgather", "a2a")),
              flush=True)
        print(f"      (b) {MP_READS} reads: ring {sec['b_ring']:.3f} s, locate_hits {sec['b_locate_hits']:.3f} s, "
              f"search_locate {sec['b_search_locate']:.3f} s, locate_approx m={APPROX_M} {sec['b_seed']:.3f} s; "
              f"(c) sort and three table sets {sec['c_build']:.3f} s, the store's search {sec['c_store_search']:.3f} "
              f"s; (d) {MP_SCALE_BASES} bases k={K} d={MP_SCALE_D} from its store, {MP_SCALE_READS} x {READ_LEN} bp "
              f"in waves of {MP_SCALE_WAVE}, lut{MP_SCALE_LUT} {sec['d_lut']:.3f} s, stream {sec['d_stream']:.3f} s; "
              "launches " + json.dumps({label: {k: v for k, v in c.items() if v} for label, c in r["counts"].items()}),
              flush=True)
    print(f"    phase {time.perf_counter() - t0:.2f} s", flush=True)
    return {"processes": MP_PROCS, "shards_a_process": MP_SHARDS, "workers": results, "phase19_device_s": one19,
            "setup_s": setup_s, "run_s": run_s, "phase_seconds": time.perf_counter() - t0}


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
        walk = check_walk(loc, sa, dev)  # sa and loc stay for phase 16
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

        align = aligner(tmp, codes, dev, by_path)
        main_res = run.results
        del run
        torch.cuda.empty_cache()
        ondev = device_build(tmp, ref, codes, index, fmi, sa, loc, store, reads, dev, by_path)
        resume_and_tools(tmp, codes, index, fmi, qry, store, pos_fused, align, dev, by_path, lut_launches)
        torch.cuda.empty_cache()
        lay = layouts(tmp, index, fmi, qry, reads, main_res, dev, by_path)
        torch.cuda.empty_cache()
        mesh = mesh_phase(tmp, index, fmi, qry, reads, main_res, dev, by_path)
        torch.cuda.empty_cache()
        mesh_loc = mesh_locate(tmp, codes, fmi, qry, reads, main_res, store, {
            "two": pos_two, "fused": pos_fused, "rc": os.path.join(tmp, "rc.pos"), "positions": fused.positions},
            (mm_reads, mpos), approx, align, dev, by_path)
        torch.cuda.empty_cache()
        sharded = sharded_build(tmp, ref, codes, index, fmi, sa, loc, store, qry, reads, main_res, ondev, dev,
                                by_path)
        torch.cuda.empty_cache()
        multi = multi_process(tmp, codes, index, fmi, reads, main_res, fused.positions, sa, store, approx, mesh, dev,
                              by_path)

    for pkg in ("jax", "tpufm"):
        if any(m == pkg or m.startswith(pkg + ".") for m in sys.modules):
            raise AssertionError(f"{pkg} was imported")
    search_case = gathers[0]
    # launches per pass on the paths users run: (counted run, passes in it,
    # the LUT build's launches inside the count, taken off)
    lut_built, align_lut = lut_launches, align["lut"]["launches"]
    passes = {"search": ("main", 4, lut_built), "varlen": ("varlen", 4, lut_built),
              "fused_locate": ("search_locate_timed", 4, 0),
              "two_pass_locate": ("two_pass_timed", 4, 0),
              "hamming1_count": ("count_mm1", 2, 0), "gather_engine": ("gather", 4, lut_built),
              # the bench records: a warm-up and the timed passes (run_bench's
              # search also its host passes), each record with its own LUT
              "bench": ("bench", 2 * BENCH_PASSES + 1, lut_built),
              "bench_search_locate": ("bench_search_locate", BENCH_PASSES + 1, lut_built),
              "bench_locate": ("bench_locate", BENCH_PASSES + 1, 0),
              "bench_mismatch": ("bench_mismatch", MM_PASSES + 1, lut_built),
              # phase 14: one CLI pass each, which builds the LUT; the records run no LUT
              "seed_locate": ("locate_mm2", 1, lut_built), "edit_locate": ("locate_e2", 1, lut_built),
              "paired_locate": ("locate_paired", 1, lut_built), "paired_mm2": ("paired_mm2", 1, lut_built),
              "paired_e1": ("paired_e1", 1, lut_built), "bench_seed": ("bench_seed", BENCH_PASSES + 1, 0),
              "bench_edit": ("bench_edit", BENCH_PASSES + 1, 0),
              "bench_paired": ("bench_paired", BENCH_PASSES + 1, 0),
              # phase 20: one pass each; the CLI's builds the LUT, the 4-shard engine loads phase 4's
              "mesh1_fused_locate": ("mesh1_locate_fused", 1, lut_built),
              "mesh4_fused_locate": ("mesh4_search_locate", 1, 0),
              # phase 15: one align run each, which builds its own (9-mer) LUT
              **{path: (path, 1, align_lut) for path in ("align_se", "align_m2", "align_paired", "align_e2",
                                                         "align_varlen")}}

    def per_pass(name: str) -> dict:
        return {label: (by_path[path][name] - (lut if name == "lf_round_pairs" else 0)) / n
                for label, (path, n, lut) in passes.items()}

    r18 = k1_main[-1]
    k9_last = [c for c in mesh["k9"]["rounds"] if "ms" in c][-1]
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
            "mesh_locate": mesh_loc,
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
        {
            "name": "build_tables",
            "route": "cuda",
            "source": "tpufm_torch/csrc/build_tables.cu",
            "replaces": "tpufm/index/builder_device.py:35 (jnp _build_tables, no pallas_call)",
            "launches": by_path["build_on_device"]["build_tables"],
            "max_abs_err": ondev["k7"]["max_abs_err"],
            "ms": ondev["k7"]["ms"],
            "plain_ms": ondev["k7"]["plain_ms"],
            "bound_ms": ondev["k7"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": f"k={K} d={D}, {REF_BASES} bases (phase 4's text and its device suffix array); ms is the "
                     "wrapper's, the text's pack and K7",
            "call_ms": ondev["k7"]["call_ms"],
            "k_ms": ondev["k7"]["k_ms"],
            "k_call_ms": ondev["k7"]["k_call_ms"],
            "text_sectors": ondev["k7"]["sectors"],
            "sector_bound_ms": ondev["k7"]["sector_bound_ms"],
            "packed_sectors": ondev["k7"]["packed_sectors"],
            "packed_sector_ms": ondev["k7"]["packed_sector_ms"],
            "genome_ms": ondev["k7"]["genome"]["ms"],
            "genome_call_ms": ondev["k7"]["genome"]["call_ms"],
            "genome_bound_ms": ondev["k7"]["genome"]["bound_ms"],
            "genome_sector_bound_ms": ondev["k7"]["genome"]["sector_bound_ms"],
            "genome_packed_sector_ms": ondev["k7"]["genome"]["packed_sector_ms"],
            "genome_shape": f"k={ondev['k7']['genome']['k']} d={ondev['k7']['genome']['d']}, {GENOME_BASES} "
                            "bases (the genome record's text, sorted on the card)",
            "cases": ondev["k7"]["cases"] + [ondev["k7"]["genome"]],
            "launches_by_path": {path: c["build_tables"] for path, c in by_path.items()},
            "device_build": ondev["summary"],
            # phase 21: one launch a shard a table set (K7 on each shard's rows of the suffix array)
            "sharded_launches": by_path["sharded_build"]["build_tables"],
            "sharded_slices": sharded["k7_slices"],
            "sharded_build": {key: v for key, v in sharded.items() if key != "k7_slices"},
        },
        {
            "name": "pack_text",
            "route": "cuda",
            "source": "tpufm_torch/csrc/build_tables.cu",
            "replaces": "tpufm/index/builder_device.py:51,65 (K7's byte text, read by jnp _build_tables' gathers; "
                        "no pallas_call)",
            "launches": by_path["build_on_device"]["pack_text"],
            "max_abs_err": ondev["pack"]["max_abs_err"],
            "ms": ondev["pack"]["ms"],
            "plain_ms": ondev["pack"]["plain_ms"],
            "bound_ms": ondev["pack"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": f"{REF_BASES} bases (phase 4's text)",
            "genome_ms": ondev["pack"]["genome"]["ms"],
            "genome_plain_ms": ondev["pack"]["genome"]["plain_ms"],
            "genome_bound_ms": ondev["pack"]["genome"]["bound_ms"],
            "launches_by_path": {path: c["pack_text"] for path, c in by_path.items()},
        },
        *[layout_kernel(name, lay["rounds"][key], by_path, path, counter, replaces) for name, key, path, counter, replaces in (
            ("lf_round_split", "split", "split", "lf_round_split",
             "tpufm/engine/xla.py:179 (jnp lf_step_split, no pallas_call)"),
            ("lf_round_ac", "ac", "search_ac", "lf_round_ac",
             "tpufm/engine/xla.py:215 (jnp lf_step_ac, no pallas_call)"),
            ("lf_round_paired", "paired", "search_paired", "lf_round_paired",
             "tpufm/engine/xla.py:128 (jnp lf_step_paired, no pallas_call)"))],
        {
            "name": "lf_answer_owned",
            "route": "cuda",
            "source": "tpufm_torch/csrc/lf_round_split.cu",
            "replaces": "tpufm/parallel/search.py:267 (jnp _answer_owned, no pallas_call)",
            "launches": by_path["mesh4_allgather"]["lf_answer_owned"],
            "max_abs_err": max(c["max_abs_err"] for c in mesh["k9"]["rounds"] + mesh["k9"]["edges"]
                               + mesh["k9"]["streams"]),
            "ms": k9_last["ms"],
            "plain_ms": k9_last["plain_ms"],
            "bound_ms": k9_last["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": f"round {k9_last['round']} of phase 19(c)'s allgather wave ({MESH_SHARDS} shards of this "
                     f"card), shard 0: {k9_last['requests']} requests, {k9_last['owned']} owned",
            "rounds": mesh["k9"]["rounds"],
            "edges": mesh["k9"]["edges"],
            "streams": mesh["k9"]["streams"],
            "routings": mesh["routings"],
            "genome": mesh["genome"],
            "mesh1_seconds_per_pass": mesh["overhead"],
            # phase 22: each process's launches, seconds and bytes across processes
            "multi_process": multi,
            "launches_by_path": {path: c["lf_answer_owned"] for path, c in by_path.items()},
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2:])
    else:
        main()
