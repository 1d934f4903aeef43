"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, report.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is non-zero):
  1. the card's name and power limit (nvidia-smi); a host without CUDA exits 1
  2. build the kernels from tpufm_torch/csrc/ with nvcc
  3. K1 (the LF round kernel) against its plain PyTorch version on the card,
     seeded tables at the search's shapes (k=3 d=192 and the k=1 d=192 tail
     table of a 10 Mbase reference), 2M interval ends: bit-identical, and
     both timed with CUDA events (median of 7 after a warm-up)
  4. the main path: a seeded 10 Mbase reference, k=3 d=192 index, 1,048,576
     x 120 bp reads, ``python -m tpufm_torch.cli search ... --lut 12
     --device cuda`` in process; every interval checked against the plain
     path on the card and the first 65,536 against the numpy oracle, and
     the prefix LUT K1 built against the LUT the plain rounds build
  5. any-length reads: 65,536 x 151 bp (one k=1 tail round per read)
  6. K1's rows entry (``lf_round_rows``, 2M ends, k=3 and k=1 d=192) and K3
     (``row_gather``) against their plain versions on the card, bit-identical
     and timed with CUDA events: K3 at the search's shape (52,085 x 100
     words, 2M rows), with 6-word rows (the 4-byte word path), at probe 5's
     shape and over probe 35's (E, W) grid, rows/s and GB/s beside the plain
     ``table[idx]``; every index stream includes E and E+5 (clamped)
  7. the gathered-row engines on phase 4's index and reads:
     ``SearchEngine(gather="dma")`` (K3 then K1's rows entry per round) and
     the CLI's ``--engine pallas`` (torch indexing then K1's rows entry);
     all 1M intervals equal to phase 4's
  8. variable-length reads: 1,048,576 reads sampled at 151 bp and trimmed to
     50-151 bp, written as FASTQ, loaded with ``load_queries_varlen`` and
     searched with ``search_varlen`` (lut12) on the default and the gather
     path; all equal to the plain path, the two paths equal, and the first
     65,536 equal to the numpy oracle run once per distinct length
Every path is driven with all launch counts set to 0 just before it and
read just after; a kernel of the path launched too few times fails the run.
Then one JSON line of kernel figures, and last the device JSON line.
Nothing here imports jax or the JAX package tpufm: the index builder, the
read I/O and the numpy oracle are the port's own host modules
(tpufm_torch.host).
"""

from __future__ import annotations

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

from tpufm_torch import SearchEngine, cli, kernels
from tpufm_torch.engine import lf_round as lf_mod
from tpufm_torch.engine import row_gather as rg_mod
from tpufm_torch.engine.lf_round import (
    lf_round,
    lf_round_reference,
    lf_round_rows,
    lf_round_rows_reference,
)
from tpufm_torch.engine.row_gather import row_gather, row_gather_reference, vector_path
from tpufm_torch.host.formats import write_fmi
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.seqio import (
    decode_bases,
    generate_reads,
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
#: word path), probe 5's shape and probe 35's (E, W) grid
GATHER_CASES = [
    ("search", 52_085, 100, 2 << 20),
    ("words", 52_085, 6, 2 << 20),
    ("P5", 156_256, 128, 1 << 17),
] + [("P35", E, W, 1 << 20) for E in (208_000, 2_000_000) for W in (8, 32, 88, 128)]
VARLEN_READS, VARLEN_MIN, VARLEN_MAX = 1 << 20, 50, 151

#: each kernel's wrapper and the module attribute holding its launch count
COUNTS = {
    "lf_round": (lf_mod, "LAUNCHES"),
    "lf_round_rows": (lf_mod, "ROWS_LAUNCHES"),
    "row_gather": (rg_mod, "LAUNCHES"),
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
    """Registers and spill bytes of each kernel instance from ``nvcc -Xptxas -v``."""
    regs, spills, name = [], 0, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d([A-Za-z_]+_kernel)(?:ILi(\d+)E|I(\w+?)E)?", line)
            name = "?" if m is None else m.group(1) + (f"<{m.group(2) or m.group(3)}>" if m.group(2) or m.group(3) else "")
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spills += int(m.group(1))
        elif m := re.search(r"Used (\d+) registers", line):
            regs.append(f"{name}:{m.group(1)}")
    return f"registers per instance {' '.join(regs)}, spill stores {spills} B"


def cuda_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
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
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lf_round(*args, k, d)),
        "plain_ms": cuda_ms(lambda: lf_round_reference(*args, k, d)),
    }


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
    }


def check_gather(gen, label: str, E: int, W: int, N: int, dev) -> dict:
    """K3 against the plain ``table[idx]`` on a seeded table and index
    stream that includes E and E+5 (clamped to the last row): bit-identical,
    both timed; GB/s counts the rows read and written and the 8-byte
    indices."""
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
    plain_ms = cuda_ms(lambda: row_gather_reference(table, idx))
    gb = (2 * N * W * 4 + 8 * N) / 1e9
    return {
        "case": label, "E": E, "W": W, "N": N,
        "path": "int4" if vector_path(table, out) else "word",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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
          f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms; k=1 d=192: "
          f"bit-identical, kernel {k1_tail['ms']:.4f} ms, plain "
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
        launches = by_path["main"]["lf_round"]
        cli_s = time.perf_counter() - t0
        rounds = (READ_LEN - LUT_M) // K
        waves = -(-READS // run.engine.WAVE)
        lut_launches = (4**LUT_M // min(4**LUT_M, 1 << 20)) * (LUT_M // K)
        need = (1 + 3) * rounds * waves + lut_launches
        expect_launches("main path", by_path["main"], {"lf_round": need})
        peak = torch.cuda.max_memory_allocated(dev)
        check_run("main path", run, index, reads)
        lut_plain = run.engine.build_prefix_lut(LUT_M, step=lf_round_reference)
        if not torch.equal(lut_plain, run.engine.lut):
            rows = int((lut_plain != run.engine.lut).any(1).sum())
            raise AssertionError(f"main path: {rows} LUT rows differ from the plain rounds' LUT")
        del lut_plain
        print(f"[4 main path] 10 Mbase k=3 d=192 lut12, {READS} x {READ_LEN} bp: "
              f"{run.seconds_per_pass:.6f} s/pass = {READS / run.seconds_per_pass:.0f} reads/s, "
              f"LUT build {run.engine.lut_build_seconds:.4f} s, K1 launches {launches} "
              f"(>= {need}), peak device memory {peak} B; all reads found, all equal to the "
              f"plain path, first {ORACLE_READS} equal to the oracle, all {4**LUT_M} LUT rows equal "
              f"to the plain rounds' LUT; host set-up "
              f"{setup_s:.2f} s (index {build_s:.2f} s), cli {cli_s:.2f} s, checks "
              f"{time.perf_counter() - t0 - cli_s:.2f} s", flush=True)

        t0 = time.perf_counter()
        reads151 = generate_reads(codes, TAIL_LEN, TAIL_READS, seed=SEED + 1)
        qry151 = os.path.join(tmp, "reads151.qry")
        write_reads_fasta(qry151, reads151)
        reset_counts()
        run151 = cli.main(["search", fmi, qry151, str(TAIL_LEN), str(TAIL_READS), "--lut", str(LUT_M),
                           "--device", "cuda", "--iterations", "1",
                           "--output", os.path.join(tmp, "reads151.res")])
        by_path["tail"] = read_counts()
        expect_launches("tail run", by_path["tail"], {"lf_round": 2 * ((TAIL_LEN - LUT_M) // K + 1)})
        check_run("tail", run151, index, reads151, tail=derive_tail(index))
        print(f"[5 any length] {TAIL_READS} x {TAIL_LEN} bp, 46 k=3 rounds + 1 k=1 tail round: "
              f"{run151.seconds_per_pass:.6f} s/pass, K1 launches {by_path['tail']['lf_round']}; "
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
              f"kernel {rows3['ms']:.4f} ms, plain {rows3['plain_ms']:.4f} ms; k=1 d=192 "
              f"bit-identical, kernel {rows1['ms']:.4f} ms, plain {rows1['plain_ms']:.4f} ms; "
              f"row_gather, all bit-identical (idx includes E and E+5):", flush=True)
        for g in gathers:
            print(f"    {g['case']:6s} E={g['E']:>9} W={g['W']:>3} N={g['N']:>7} {g['path']:4s}: kernel "
                  f"{g['ms']:.4f} ms = {g['rows_per_s']:.4g} rows/s = {g['GB_per_s']:.4g} GB/s; plain "
                  f"table[idx] {g['plain_ms']:.4f} ms = {g['plain_rows_per_s']:.4g} rows/s = "
                  f"{g['plain_GB_per_s']:.4g} GB/s", flush=True)
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
                        {"row_gather": need_rows, "lf_round_rows": need_rows, "lf_round": lut_launches})
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
        expect_launches("varlen", by_path["varlen"], {"lf_round": 4 * (vrounds + K - 1) * vwaves})
        reset_counts()
        vdma = SearchEngine(index, dev, lut_m=LUT_M, tail_index=tail, gather="dma")
        vdres, vd_s = timed_passes(lambda: vdma.search_varlen(batch))
        by_path["varlen_gather"] = read_counts()
        expect_launches("varlen gather", by_path["varlen_gather"], {
            "row_gather": 4 * vrounds * vwaves, "lf_round_rows": 4 * vrounds * vwaves,
            "lf_round": 4 * (K - 1) * vwaves,
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

    for pkg in ("jax", "tpufm"):
        if any(m == pkg or m.startswith(pkg + ".") for m in sys.modules):
            raise AssertionError(f"{pkg} was imported")
    search_case = gathers[0]
    print(json.dumps({"kernels": [
        {
            "name": "lf_round",
            "route": "cuda",
            "source": "tpufm_torch/csrc/lf_round.cu",
            "replaces": "tpufm/engine/pallas_kernel.py:41",
            "launches": launches,
            "max_abs_err": max(k1["max_abs_err"], k1_tail["max_abs_err"]),
            "ms": k1["ms"],
            "plain_ms": k1["plain_ms"],
            "launches_by_path": {path: c["lf_round"] for path, c in by_path.items()},
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
            "launches_by_path": {path: c["row_gather"] for path, c in by_path.items()},
            "rates": gathers,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
