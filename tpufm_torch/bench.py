"""Bench records of the port on one device: the reference's TIME: protocol
(the mean of N timed passes over a fixed read batch,
common/searchQueries.c:78-118) and one JSON-ready record per run.

Counterpart of tpufm/bench.py's single-device records, with its function
names, arguments, defaults and record schema (``metric``, ``value``,
``unit``, ``vs_baseline``, ``detail``): ``run_bench`` (:225),
``run_bench_genome`` (:347), ``run_bench_locate`` (:539),
``run_bench_search_locate`` (:610), ``run_bench_mismatch`` (:683),
``run_bench_seed`` (:767), ``run_bench_edit`` (:872) and
``run_bench_paired`` (:981), and of its mesh records ``run_bench_sharded``
(:458) and ``run_bench_multichip`` (:1086), over the pieces they share,
``gather_traffic_bytes`` (:108), ``_time_search`` (:123) and
``_verify_and_measure`` (:176). Where they differ:

- A record runs on one torch device, ``device`` (cuda unless the caller
  asks for the CPU; no fallback). Its detail adds ``device`` (the card's
  name, or "cpu"), ``power_limit_w`` (nvidia-smi's, or None),
  ``pass_seconds`` (every timed pass, each ending at a device barrier) and
  ``seconds_per_pass_median``; ``seconds_per_pass`` stays their mean, as
  the TIME: protocol defines it. ``run_bench`` on ``xla`` adds
  ``host_seconds_per_pass``: the mean of as many ``SearchEngine.search``
  passes, reads in host memory to intervals in host memory (the CLI's
  TIME: line), beside the device-resident pass.
- The full-batch check runs the port's plain rounds (a LUT-free engine on
  the bench's device, every round ``lf_round_reference``) and is reported
  as ``bit_exact_vs_plain_full``; tpufm's runs its CPU engine.
- The speed of light is against the H100's HBM, ``HBM_BYTES_PER_S``
  (``hbm_bytes_per_s`` in the detail).
- The port has no build of the reference's CPU binaries: every
  ``reference_cpu_*`` field is None and ``vs_baseline`` is the fraction of
  the speed of light, tpufm's own fallback when it finds none.
- The genome record builds its index on the card (tpufm_torch.index) when
  the device is CUDA and the reference fits ``MAX_DEVICE_BASES``, re-derived
  for the H100 (tpufm's 400 Mbase was sized for a 16 GB chip); else on the
  host.
- The naive scans of
  ``run_bench_mismatch``, ``run_bench_seed`` (``hamming_hits``) and
  ``run_bench_paired`` (``pair_oracle``'s occurrences) run on the bench's
  device.
- ``run_bench_edit`` checks each sampled site with the DP only over the
  window codes[s : s + L + E] (``windowed_edit_dist``), where tpufm runs
  its oracle over the whole text: the same <= E verdicts, as an alignment
  ending past the window costs more than E edits.
- ``run_bench``'s engines are tpufm's (:259-283): xla (with
  ``pad_words``), xla-split, xla-ac (the index made alternate-counters),
  xla-paired (``lut_m or 12``; ``repair_fraction`` from its
  ``last_repair_fraction``) and pallas, each a ``SearchEngine`` of that
  layout on the bench's device.

- ``run_bench_multichip``, ``run_bench_sharded`` and ``run_bench_locate``
  build their mesh with ``make_mesh(n_devices, device=device)``: the first n
  cards, or n CPU shards; their one-device denominator runs on a mesh of
  the first. Their detail adds the ``device`` fields of the mesh run and
  ``one_device_pass_seconds``. ``run_bench_locate`` on a mesh of one runs a
  ``LocateEngine`` and reports a scaling efficiency of 1.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from tpufm_torch.config import recommend_config
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.edit import EditExtendEngine, windowed_edit_dist
from tpufm_torch.engine.lf_round import lf_round_indexed, lf_round_reference
from tpufm_torch.engine.locate import LocateEngine
from tpufm_torch.engine.paired import PairedEndEngine, pair_oracle
from tpufm_torch.engine.search import SearchEngine
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.seed import SeedExtendEngine
from tpufm_torch.host.formats import load_store, save_store
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.layouts import make_alt_counters
from tpufm_torch.host.locate import build_locate, locate_hits, locate_oracle
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.seqio import generate_read_pairs, generate_reads
from tpufm_torch.host.suffix_array import suffix_array
from tpufm_torch.index.builder_device import build_index_device
from tpufm_torch.index.sa_device import MAX_DEVICE_BASES
from tpufm_torch.parallel import DataParallelEngine, DataParallelLocate, ShardedIndexEngine, make_mesh
from tpufm_torch.timer import timed_device_passes

#: HBM rate of one H100 SXM (NVIDIA's data sheet): the speed of light's rate
HBM_BYTES_PER_S = 3.35e12
#: reads of the oracle sample every search record checks
ORACLE_SAMPLE = 65536
#: the padded batch up to which ``_time_search`` keeps every wave on the device
WAVED_MAX_BYTES = 2 << 30
#: windows of the naive Hamming scan compared in one step (bounds its temporaries)
_SCAN_WINDOWS = 1 << 24


def power_limit_w(device: torch.device) -> float | None:
    """The card's power limit in watts, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it; None on
    the CPU or where nvidia-smi gives no number."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    if index >= len(out):
        return None
    try:
        return float(out[index].rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return None


def _device_fields(device: torch.device, pass_seconds: list) -> dict:
    """The detail fields every record of the port adds."""
    return {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "power_limit_w": power_limit_w(device),
        "pass_seconds": list(pass_seconds),
        "seconds_per_pass_median": statistics.median(pass_seconds),
    }


def _passes(fn, iterations: int):
    """(per-pass seconds, the last pass's result) of ``fn`` after one
    warm-up pass, each pass ending at a device barrier."""
    last = [None]

    def run():
        last[0] = fn()
        return last[0]

    _, _, times = timed_device_passes(run, iterations=iterations)
    return times, last[0]


def _host(t: torch.Tensor) -> np.ndarray:
    """Device int64 results holding uint32 values -> host uint32."""
    return t.cpu().numpy().astype(np.uint32)


def gather_traffic_bytes(eng, num_queries: int, query_len: int) -> int | None:
    """Payload bytes a fused-layout engine's k-step rounds read per pass: per
    round each interval end fetches one table row, as wide as the engine
    holds it on the device (``entries.shape[1]`` words, a multiple of 4,
    ``pad_words`` included), plus one 8 B LUT interval per read. None for
    another layout, or with a k=1 tail (tpufm/bench.py:108)."""
    if getattr(eng, "layout", None) != "fused" or getattr(eng, "tail_d", None):
        return None
    rounds = (query_len - eng.lut_m) // eng.k
    row_bytes = 4 * eng.entries.shape[1]
    return num_queries * (rounds * 2 * row_bytes + (8 if eng.lut_m else 0))


def _time_search(eng: SearchEngine, queries: np.ndarray, engine: str, iterations: int):
    """(per-pass seconds, uint32 [B, 2] host intervals) of ``iterations``
    passes after one warm-up pass (tpufm/bench.py:123). Up to one wave,
    ``search_device`` on reads already on the device (the paired layout's
    intervals before its repair, as tpufm's); past it, on ``xla``,
    ``search_device_waved`` on the reads zero-padded to whole waves, while
    they fit ``WAVED_MAX_BYTES``. Otherwise, and always for ``pallas``
    (rounds by ``lf_round_indexed``, as the CLI's ``--engine pallas``),
    ``engine.search`` from host reads to host intervals."""
    num_queries, query_len = queries.shape
    queries = np.require(queries, np.uint8, ["C", "W"])
    wave = eng.WAVE
    if engine != "pallas" and num_queries <= wave:
        qd = torch.from_numpy(queries).to(eng.device)
        times, out = _passes(lambda: eng.search_device(qd), iterations)
        return times, _host(out[0] if isinstance(out, tuple) else out)
    if engine == "xla":
        pad = -num_queries % wave
        if (num_queries + pad) * query_len <= WAVED_MAX_BYTES:
            qpad = np.concatenate([queries, np.zeros((pad, query_len), np.uint8)]) if pad else queries
            qd = torch.from_numpy(qpad).to(eng.device)
            times, out = _passes(lambda: eng.search_device_waved(qd), iterations)
            return times, _host(out[:num_queries])
    step = lf_round_indexed if engine == "pallas" else None
    return _passes(lambda: eng.search(queries, step=step), iterations)


def verify_full_plain(index, queries: np.ndarray, host_out: np.ndarray, device: torch.device) -> bool:
    """Bit-exactness of the whole result batch against the port's plain
    rounds: a LUT-free engine on ``device`` whose every round is
    ``lf_round_reference`` (the (L, R) contract does not depend on the LUT
    or the round's implementation)."""
    plain = SearchEngine(index, device).search(queries, step=lf_round_reference)
    return bool(np.array_equal(host_out, plain))


def _verify_and_measure(index, eng, queries, host_out, search_s, seed,
                        full_verify, k: int, query_len: int) -> dict:
    """The fields every search record shares (tpufm/bench.py:176): the
    oracle sample (``ORACLE_SAMPLE`` reads drawn with seed + 2 against the
    numpy oracle), the full batch against the plain rounds (unless
    ``full_verify`` is False, or None and TPUFM_BENCH_FULL_VERIFY=0), rates,
    the speed of light and the gathered bytes."""
    num_queries = queries.shape[0]
    n_oracle = min(num_queries, ORACLE_SAMPLE)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_queries, n_oracle, replace=False))
    exact_oracle = bool((host_out[vidx] == search_oracle(index, queries[vidx])).all())
    if full_verify is None:
        full_verify = os.environ.get("TPUFM_BENCH_FULL_VERIFY", "1") != "0"
    exact_full = verify_full_plain(index, queries, host_out, eng.device) if full_verify else None
    rounds = query_len // k
    steps_s = num_queries * rounds / search_s
    bytes_per_step = 2 * (4 + 4 * index.config.bitmap_words)
    sol_steps_s = HBM_BYTES_PER_S / bytes_per_step
    traffic = gather_traffic_bytes(eng, num_queries, query_len)
    return {
        "steps_per_s": steps_s,
        "sol_steps_per_s": sol_steps_s,
        "fields": {
            "reads_per_s": round(num_queries / search_s),
            "seconds_per_pass": search_s,
            "speed_of_light_steps_per_s": round(sol_steps_s),
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "fraction_of_sol": round(steps_s / sol_steps_s, 4),
            "achieved_hbm_gbps": round(traffic / search_s / 1e9, 2) if traffic else None,
            "gathered_bytes_per_pass": traffic,
            "bit_exact_vs_oracle": exact_oracle and exact_full is not False,
            "bit_exact_vs_oracle_sample": exact_oracle,
            "bit_exact_vs_plain_full": exact_full,
            "verified_reads": num_queries if full_verify else n_oracle,
            "verified_reads_oracle": n_oracle,
        },
    }


def _reference_codes(refsize: int, seed: int):
    """The seeded random reference and the generator that made it (the
    records draw further values from it, as tpufm's do)."""
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, 4, size=refsize, dtype=np.uint8)


def run_bench(
    refsize: int = 10_000_000,
    k: int = 2,
    d: int = 64,
    num_queries: int = 131072,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    engine: str = "xla",
    lut_m: int = 0,
    pad_words: int | None = None,
    compare_reference: bool = True,
    full_verify: bool | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """k-step backward-search steps/s on one device (tpufm/bench.py:225):
    a seeded random reference of ``refsize`` bases, its (k, d) index built on
    the host, ``num_queries`` reads of ``query_len`` sampled with seed + 1,
    ``iterations`` timed passes. ``engine``: "xla" (K1 loads its own rows;
    rows padded to ``pad_words``), "xla-split" (K8 on the split tables),
    "xla-ac" (K8 on the alternate counters, no LUT), "xla-paired" (K1's
    paired entry, ``lut_m or 12``; the record's ``repair_fraction`` is the
    share of reads its ``search`` searched again) or "pallas" (rows gathered
    by torch indexing, then K1's rows entry). ``compare_reference`` is
    tpufm's switch for its reference CPU run; the port has no build of the
    reference, so the reference fields are None either way."""
    if engine not in ("xla", "xla-ac", "xla-paired", "xla-split", "pallas"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    _, codes = _reference_codes(refsize, seed)
    t0 = time.perf_counter()
    index = build_index(codes, IndexConfig(k=k, d=d))
    build_s = time.perf_counter() - t0
    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)

    if engine == "xla-ac":
        eng = SearchEngine(make_alt_counters(index), dev)
    elif engine == "xla-paired":
        eng = SearchEngine(index, dev, layout="paired", lut_m=lut_m or 12)
    elif engine == "xla-split":
        eng = SearchEngine(index, dev, layout="split", lut_m=lut_m)
    else:
        eng = SearchEngine(index, dev, lut_m=lut_m, pad_words=pad_words if engine == "xla" else None)
    times, host_out = _time_search(eng, queries, engine, iterations)
    search_s = sum(times) / len(times)
    repair_fraction = None
    if engine == "xla-paired":
        # the timed value is the paired rounds; the repaired intervals are verified
        host_out = eng.search(queries)
        repair_fraction = eng.last_repair_fraction
    vm = _verify_and_measure(index, eng, queries, host_out, search_s, seed,
                             full_verify, k, query_len)
    steps_s, sol_steps_s = vm["steps_per_s"], vm["sol_steps_per_s"]
    detail = {
        **_device_fields(dev, times),
        "reference_cpu_seconds_per_pass": None,
        "reference_cpu_seconds_per_pass_node": None,
        "reference_cpu_cores": None,
        "reference_cpu_cores_node": None,
        "reference_protocol_node": "24-core OpenMP node (likwid -C 0-23)",
        "vs_baseline_single_core": None,
        "vs_baseline_node": None,
        "node_equivalent_caveat": (
            "no reference CPU run (the port has no build of the reference "
            "binaries): vs_baseline is the fraction of the HBM speed of "
            "light of one GPU"
        ),
        "build_seconds": round(build_s, 1),
        "repair_fraction": repair_fraction,
        "iterations": iterations,
    }
    if engine == "xla":
        detail["host_seconds_per_pass"], _, _ = timed_device_passes(
            lambda: eng.search(queries), iterations=iterations, warmup=0)
    detail.update(vm["fields"])
    if engine == "pallas":  # as tpufm's record: its PallasEngine counts no traffic
        detail.update(gathered_bytes_per_pass=None, achieved_hbm_gbps=None)
    return {
        "metric": f"k-step backward-search steps/s/chip (k={k}, d={d}, "
        f"{num_queries} reads x {query_len} bp, engine={engine})",
        "value": round(steps_s),
        "unit": "steps/s",
        "vs_baseline": round(steps_s / sol_steps_s, 4),
        "detail": detail,
    }


def run_bench_genome(
    refsize: int = 250_000_000,
    k: int | None = None,
    d: int | None = None,
    num_queries: int = 1 << 20,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int | None = None,
    compare_reference: bool = True,
    full_verify: bool | None = None,
    cache_dir=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Genome-scale record (tpufm/bench.py:347): a seeded random reference of
    ``refsize`` bases whose table does not stay in the card's L2; k, d and
    lut_m from ``recommend_config`` unless given. The index is built on the
    card (``build_index_device``) when ``device`` is a CUDA device and the
    reference is at most ``MAX_DEVICE_BASES``, else on the host (SA-IS), as
    tpufm builds on its accelerator (tpufm/bench.py:398-403);
    ``build_seconds`` is that build's, host to host. The index is cached
    with its prefix LUT under ``cache_dir`` (default .bench/genome) by
    tpufm's own names, ``idx_{refsize}_k{k}_d{d}_s{seed}.tpufm`` and
    ``lut_{refsize}_k{k}_d{d}_s{seed}_m{lut_m}.npz``, byte-compatible with
    tpufm's, so that either package reuses the other's cache."""
    dev = resolve_device(device)
    rec = recommend_config(refsize, query_len=query_len)
    k = rec["k"] if k is None else k
    d = d or rec["d"]
    lut_m = rec["lut_m"] if lut_m is None else lut_m
    cache = Path(cache_dir or Path(__file__).resolve().parent.parent / ".bench" / "genome")
    cache.mkdir(parents=True, exist_ok=True)
    _, codes = _reference_codes(refsize, seed)

    store = cache / f"idx_{refsize}_k{k}_d{d}_s{seed}.tpufm"
    cached = store.exists()
    t0 = time.perf_counter()
    if cached:
        index = load_store(store)
        build_s = 0.0
    else:
        if dev.type == "cuda" and refsize <= MAX_DEVICE_BASES:
            index = build_index_device(codes, IndexConfig(k=k, d=d), device=dev)
        else:
            index = build_index(codes, IndexConfig(k=k, d=d))
        build_s = time.perf_counter() - t0
        save_store(store, index)

    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)
    eng = SearchEngine(index, dev, lut_m=lut_m,
                       lut_cache=str(cache / f"lut_{refsize}_k{k}_d{d}_s{seed}_m{lut_m}"))
    times, host_out = _time_search(eng, queries, "xla", iterations)
    search_s = sum(times) / len(times)
    vm = _verify_and_measure(index, eng, queries, host_out, search_s, seed,
                             full_verify, k, query_len)
    steps_s, sol_steps_s = vm["steps_per_s"], vm["sol_steps_per_s"]
    detail = {
        **_device_fields(dev, times),
        "refsize": refsize,
        "d": d,
        "lut_m": lut_m,
        "reference_cpu_seconds_per_pass": None,
        "reference_cpu_cores": None,
        "vs_baseline_single_core": None,
        "reference_fed_tpufm_fmi_image": False,
        "build_seconds": round(build_s, 1),
        "index_cached": cached,
        "iterations": iterations,
    }
    detail.update(vm["fields"])
    return {
        "metric": f"genome-scale backward-search steps/s/chip (k={k}, d={d}, "
        f"{num_queries} reads x {query_len} bp, {refsize} bases, HBM regime)",
        "value": round(steps_s),
        "unit": "steps/s",
        "vs_baseline": round(steps_s / sol_steps_s, 4),
        "detail": detail,
    }


def run_bench_locate(
    refsize: int = 10_000_000,
    d: int = 128,
    sample_rate: int = 32,
    num_rows: int = 2 << 20,
    iterations: int = 5,
    seed: int = 0,
    n_devices: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """positions/s of the sampled-SA walk (K4) over ``num_rows`` random BWT
    rows already on the device (tpufm/bench.py:539). On one device
    (``make_mesh(n_devices)`` of one) a ``LocateEngine``, whose weak-scaling
    efficiency is 1 by definition; over more, ``DataParallelLocate`` and
    tpufm's weak-scaling efficiency, the per-device part of the rows timed
    on a one-device mesh."""
    dev = resolve_device(device)
    mesh = make_mesh(n_devices, device=dev)
    rng, codes = _reference_codes(refsize, seed)
    t0 = time.perf_counter()
    loc = build_locate(codes, sample_rate=sample_rate, d=d)
    build_s = time.perf_counter() - t0
    if mesh.size > 1:
        return _bench_locate_mesh(rng, loc, mesh, refsize, d, sample_rate, num_rows, iterations, seed, build_s)
    rows = rng.integers(0, refsize + 1, size=num_rows, dtype=np.uint32)

    eng = LocateEngine(loc, dev)
    rd = torch.from_numpy(rows.astype(np.int64)).to(dev)
    times, out = _passes(lambda: eng.walk(rd), iterations)
    loc_s = sum(times) / len(times)
    out = _host(out)
    n_verify = min(num_rows, ORACLE_SAMPLE)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_rows, n_verify, replace=False))
    exact = bool((out[vidx] == locate_oracle(loc, rows[vidx])).all())

    pos_s = num_rows / loc_s
    return {
        "metric": f"sampled-SA locate positions/s over 1 device(s) "
        f"(d={d}, s={sample_rate}, {num_rows} rows, {refsize} bases)",
        "value": round(pos_s),
        "unit": "positions/s",
        "vs_baseline": 1.0,
        "detail": {
            **_device_fields(dev, times),
            "devices": 1,
            "scaling_efficiency": 1.0,
            "positions_per_s_one_chip": round(pos_s),
            "positions_per_s_per_chip": round(pos_s),
            "seconds_per_pass": loc_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_oracle": exact,
            "verified_rows": n_verify,
        },
    }


def _bench_locate_mesh(rng, loc, mesh, refsize, d, sample_rate, num_rows, iterations, seed, build_s) -> dict:
    """``run_bench_locate`` over a mesh of more than one device
    (tpufm/bench.py:556-607)."""
    n_dev = mesh.size
    num_rows -= num_rows % n_dev
    rows = rng.integers(0, refsize + 1, size=num_rows, dtype=np.uint32)

    def timed_run(m, r):
        eng = DataParallelLocate(loc, m)
        placed = eng.place_rows(r)
        return _passes(lambda: eng.locate_device(placed), iterations)

    one_times, _ = timed_run(make_mesh(1, device=mesh.devices[0]), rows[: num_rows // n_dev])
    one_chip_pos_s = (num_rows // n_dev) / (sum(one_times) / len(one_times))
    times, out = timed_run(mesh, rows)
    loc_s = sum(times) / len(times)
    out = _host(out)
    n_verify = min(num_rows, ORACLE_SAMPLE)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_rows, n_verify, replace=False))
    exact = bool((out[vidx] == locate_oracle(loc, rows[vidx])).all())
    pos_s = num_rows / loc_s
    efficiency = pos_s / (n_dev * one_chip_pos_s)
    return {
        "metric": f"sampled-SA locate positions/s over {n_dev} device(s) "
        f"(d={d}, s={sample_rate}, {num_rows} rows, {refsize} bases)",
        "value": round(pos_s),
        "unit": "positions/s",
        "vs_baseline": round(efficiency, 4),
        "detail": {
            **_device_fields(mesh.devices[0], times),
            "one_device_pass_seconds": list(one_times),
            "devices": n_dev,
            "scaling_efficiency": round(efficiency, 4),
            "positions_per_s_one_chip": round(one_chip_pos_s),
            "positions_per_s_per_chip": round(pos_s / n_dev),
            "seconds_per_pass": loc_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_oracle": exact,
            "verified_rows": n_verify,
        },
    }


def _mesh_run(engine_of, place, refsize, k, d, num_queries, query_len, iterations, seed, n_devices,
              device) -> dict:
    """The weak-scaling protocol of tpufm's mesh records (tpufm/bench.py:458,
    :1086): the per-device part of the batch timed on a one-device mesh
    (the denominator), then the whole batch on ``make_mesh(n_devices)``, each
    pass on reads already placed and ending at a device barrier; the mesh
    run's last result checked on a sample of the oracle."""
    dev = resolve_device(device)
    _, codes = _reference_codes(refsize, seed)
    index = build_index(codes, IndexConfig(k=k, d=d))
    mesh = make_mesh(n_devices, device=dev)
    n_dev = mesh.size
    num_queries -= num_queries % n_dev
    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)

    def timed_run(m, q):
        eng = engine_of(index, m)
        placed = place(eng, q)
        return _passes(lambda: eng.search_device(placed), iterations)

    one_times, _ = timed_run(make_mesh(1, device=dev), queries[: num_queries // n_dev])
    one_chip_reads_s = (num_queries // n_dev) / (sum(one_times) / len(one_times))
    times, out = timed_run(mesh, queries)
    search_s = sum(times) / len(times)
    host_out = _host(out[0] if isinstance(out, tuple) else out)
    n_verify = min(num_queries, ORACLE_SAMPLE)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_queries, n_verify, replace=False))
    reads_s = num_queries / search_s
    return {
        "n_dev": n_dev, "num_queries": num_queries, "out": out, "search_s": search_s,
        "reads_s": reads_s, "one_chip_reads_s": one_chip_reads_s,
        "efficiency": reads_s / (n_dev * one_chip_reads_s),
        "exact": bool((host_out[vidx] == search_oracle(index, queries[vidx])).all()),
        "n_verify": n_verify,
        "device_fields": {**_device_fields(mesh.devices[0], times), "one_device_pass_seconds": list(one_times)},
    }


def run_bench_multichip(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    num_queries: int = 524288,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int = 0,
    n_devices: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Data-parallel scaling record (tpufm/bench.py:1086): the index
    replicated on every device of ``make_mesh(n_devices)``, the batch split
    over them; ``vs_baseline`` is the scaling efficiency reads_s(N) / (N *
    reads_s(1)), the per-device part of the batch timed on one device."""
    r = _mesh_run(lambda index, m: DataParallelEngine(index, m, lut_m=lut_m), lambda eng, q: eng.shard_queries(q),
                  refsize, k, d, num_queries, query_len, iterations, seed, n_devices, device)
    n_dev = r["n_dev"]
    return {
        "metric": f"data-parallel scaling efficiency over {n_dev} device(s) "
        f"(k={k}, d={d}, lut_m={lut_m}, {r['num_queries']} reads x {query_len} bp)",
        "value": round(r["reads_s"]),
        "unit": "reads/s",
        "vs_baseline": round(r["efficiency"], 4),
        "detail": {
            **r["device_fields"],
            "devices": n_dev,
            "scaling_efficiency": round(r["efficiency"], 4),
            "reads_per_s_one_chip": round(r["one_chip_reads_s"]),
            "reads_per_s_per_chip": round(r["reads_s"] / n_dev),
            "seconds_per_pass": r["search_s"],
            "bit_exact_vs_oracle": r["exact"],
            "verified_reads": r["n_verify"],
        },
    }


def run_bench_sharded(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    num_queries: int = 524288,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int = 0,
    routing: str = "allgather",
    n_devices: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Sharded-index scaling record (tpufm/bench.py:458): the entry table
    split over ``make_mesh(n_devices)``, lookups routed by ``routing``; the
    weak-scaling protocol of ``run_bench_multichip`` (on one device every
    routing answers at home), and the share of the last mesh pass's LF rounds
    that took the a2a fallback (``overflow_round_fraction``)."""
    r = _mesh_run(lambda index, m: ShardedIndexEngine(index, m, routing=routing, lut_m=lut_m),
                  lambda eng, q: eng.place_queries(q),
                  refsize, k, d, num_queries, query_len, iterations, seed, n_devices, device)
    n_dev = r["n_dev"]
    return {
        "metric": f"sharded-index ({routing}) scaling efficiency over {n_dev} "
        f"device(s) (k={k}, d={d}, lut_m={lut_m}, {r['num_queries']} reads x "
        f"{query_len} bp)",
        "value": round(r["reads_s"]),
        "unit": "reads/s",
        "vs_baseline": round(r["efficiency"], 4),
        "detail": {
            **r["device_fields"],
            "devices": n_dev,
            "routing": routing,
            "scaling_efficiency": round(r["efficiency"], 4),
            "reads_per_s_one_chip": round(r["one_chip_reads_s"]),
            "reads_per_s_per_chip": round(r["reads_s"] / n_dev),
            "seconds_per_pass": r["search_s"],
            "overflow_round_fraction": round(float(r["out"][1].mean()), 4),
            "bit_exact_vs_oracle": r["exact"],
            "verified_reads": r["n_verify"],
        },
    }


def run_bench_search_locate(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_queries: int = 1 << 20,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int = 0,
    max_hits: int = 4,
    device: str | torch.device = "cuda",
) -> dict:
    """Fused search + locate reads/s (``SearchLocateEngine.search_locate``,
    host reads to host positions; tpufm/bench.py:610), one suffix sort for
    the index and the locate tables; a uniform sample of 8,192 reads checked
    against the host oracles (``search_oracle``, then ``locate_hits``)."""
    dev = resolve_device(device)
    _, codes = _reference_codes(refsize, seed)
    t0 = time.perf_counter()
    sa = suffix_array(codes)
    index = build_index(codes, IndexConfig(k=k, d=d), sa=sa)
    loc = build_locate(codes, sample_rate=sample_rate, d=d, sa=sa)
    del sa
    build_s = time.perf_counter() - t0
    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)

    eng = SearchLocateEngine(index, loc, dev, max_hits=max_hits, lut_m=lut_m)
    times, (iv, pos) = _passes(lambda: eng.search_locate(queries), iterations)
    mean_s = sum(times) / len(times)

    n_verify = min(num_queries, 8192)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_queries, n_verify, replace=False))
    iv_o = search_oracle(index, queries[vidx])
    pos_o = locate_hits(loc, iv_o, max_hits=max_hits)
    exact = bool((iv[vidx] == iv_o).all() and (pos[vidx] == pos_o).all())

    reads_s = num_queries / mean_s
    return {
        "metric": f"fused search+locate reads/s (k={k}, d={d}, "
        f"s={sample_rate}, max_hits={max_hits}, lut={lut_m}, "
        f"{num_queries} x {query_len} bp, {refsize} bases)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,
        "detail": {
            **_device_fields(dev, times),
            "reads_per_s": round(reads_s),
            "positions_per_s": round(reads_s * max_hits),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_oracle": exact,
            "verified_reads": n_verify,
            "max_hits": max_hits,
        },
    }


def hamming_hits(codes: np.ndarray, reads: np.ndarray, dist: int, device: torch.device) -> list:
    """Per read, the ascending uint32 start positions of the text windows
    within Hamming distance ``dist`` of it, by the naive scan: every window
    against the read, on ``device`` (the scan tpufm's bench makes with
    numpy; no index involved)."""
    L = reads.shape[1]
    windows = torch.from_numpy(np.require(codes, np.uint8, ["C", "W"])).to(device).unfold(0, L, 1)
    reads = torch.from_numpy(np.ascontiguousarray(reads)).to(device)
    hits = [[] for _ in range(reads.shape[0])]
    for start in range(0, windows.shape[0], _SCAN_WINDOWS):
        part = windows[start:start + _SCAN_WINDOWS]
        for j, q in enumerate(reads):
            hits[j].append(((part != q).sum(dim=1) <= dist).nonzero()[:, 0] + start)
    return [torch.cat(h).cpu().numpy().astype(np.uint32) for h in hits]


def hamming1_counts(codes: np.ndarray, reads: np.ndarray, device: torch.device) -> np.ndarray:
    """uint32 [B] occurrences of each read within Hamming distance 1, by the
    naive scan (``hamming_hits``)."""
    return np.array([h.size for h in hamming_hits(codes, reads, 1, device)], dtype=np.uint32)


def run_bench_mismatch(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    num_queries: int = 1 << 16,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    error_rate: float = 1.0,
    device: str | torch.device = "cuda",
) -> dict:
    """Hamming <= 1 count reads/s (``SearchEngine.count(mismatches=1)``,
    each read's 3L+1 variants searched as lanes; tpufm/bench.py:683).
    ``error_rate``: the share of the reads given one planted substitution,
    which exact search misses and the count must recover; 512 reads checked
    against the naive scan (``hamming1_counts``)."""
    dev = resolve_device(device)
    rng, codes = _reference_codes(refsize, seed)
    t0 = time.perf_counter()
    index = build_index(codes, IndexConfig(k=k, d=d))
    build_s = time.perf_counter() - t0
    queries = np.array(generate_reads(codes, query_len, num_queries, seed=seed + 1))
    n_err = int(num_queries * error_rate)
    if n_err:
        pos = rng.integers(0, query_len, size=n_err)
        off = rng.integers(1, 4, size=n_err).astype(np.uint8)
        rows = np.arange(n_err)
        queries[rows, pos] = (queries[rows, pos] + off) & 3

    eng = SearchEngine(index, dev, lut_m=lut_m)
    times, cnt = _passes(lambda: eng.count(queries, mismatches=1), iterations)
    mean_s = sum(times) / len(times)

    n_verify = min(num_queries, 512)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_queries, n_verify, replace=False))
    exact = bool((cnt[vidx] == hamming1_counts(codes, queries[vidx], dev)).all())

    reads_s = num_queries / mean_s
    fan = 3 * query_len + 1
    return {
        "metric": f"Hamming<=1 count reads/s (k={k}, d={d}, lut={lut_m}, "
        f"{num_queries} x {query_len} bp, {refsize} bases, "
        f"{fan} variants/read)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,  # the reference has no approximate matching
        "detail": {
            **_device_fields(dev, times),
            "reads_per_s": round(reads_s),
            "variant_lanes_per_s": round(reads_s * fan),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_naive": exact,
            "verified_reads": n_verify,
            "planted_error_reads": n_err,
            "recovered": int((cnt > 0).sum()),
        },
    }


def _locate_setup(refsize: int, k: int, d: int, sample_rate: int, seed: int):
    """(generator, codes, index, locate tables, build seconds): the seeded
    reference and, from one suffix sort, its index and locate tables."""
    rng, codes = _reference_codes(refsize, seed)
    t0 = time.perf_counter()
    sa = suffix_array(codes)
    index = build_index(codes, IndexConfig(k=k, d=d), sa=sa)
    loc = build_locate(codes, sample_rate=sample_rate, d=d, sa=sa)
    return rng, codes, index, loc, time.perf_counter() - t0


def run_bench_seed(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_queries: int = 1 << 16,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    mismatches: int = 2,
    seed_hits: int = 32,
    max_hits: int = 4,
    error_rate: float = 1.0,
    device: str | torch.device = "cuda",
) -> dict:
    """Seed-and-extend locate reads/s (``SeedExtendEngine.locate_approx``,
    host reads to host positions; tpufm/bench.py:767). ``error_rate``: the
    share of the reads given exactly m planted substitutions (positions
    drawn without replacement), which exact search misses. 256 reads
    checked against the naive Hamming scan on the bench's device
    (``hamming_hits``): counts and positions equal, or for an
    overflow-flagged read every position real."""
    dev = resolve_device(device)
    m = mismatches
    rng, codes, index, loc, build_s = _locate_setup(refsize, k, d, sample_rate, seed)
    queries = np.array(generate_reads(codes, query_len, num_queries, seed=seed + 1))
    n_err = int(num_queries * error_rate)
    if n_err:
        pos = np.argsort(rng.random((n_err, query_len)), axis=1)[:, :m]
        off = rng.integers(1, 4, size=(n_err, m)).astype(np.uint8)
        rows = np.arange(n_err)[:, None]
        queries[rows, pos] = (queries[rows, pos] + off) & 3

    eng = SeedExtendEngine(index, loc, codes, mismatches=m, seed_hits=seed_hits, max_hits=max_hits,
                           lut_m=lut_m, device=dev)
    times, (positions, counts, overflow) = _passes(lambda: eng.locate_approx(queries), iterations)
    mean_s = sum(times) / len(times)

    n_verify = min(num_queries, 256)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_queries, n_verify, replace=False))
    exact = True
    for i, want in zip(vidx, hamming_hits(codes, queries[vidx], m, dev)):
        got = positions[i][positions[i] != 0xFFFFFFFF]
        if overflow[i]:  # a lower bound: every reported position is real
            exact &= bool(np.isin(got, want).all())
        else:
            exact &= int(counts[i]) == want.size and bool((got == want[:got.size]).all())

    reads_s = num_queries / mean_s
    return {
        "metric": f"seed-extend locate reads/s (m={m}, k={k}, d={d}, "
        f"lut={lut_m}, s={sample_rate}, seed_hits={seed_hits}, "
        f"{num_queries} x {query_len} bp, {refsize} bases)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,  # the reference has no approximate matching
        "detail": {
            **_device_fields(dev, times),
            "reads_per_s": round(reads_s),
            "seed_lanes_per_s": round(reads_s * (m + 1)),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_naive": exact,
            "verified_reads": n_verify,
            "planted_error_reads": n_err,
            "overflow_reads": int(overflow.sum()),
            "recovered": int((counts > 0).sum()),
        },
    }


def edit_reads(codes: np.ndarray, rng, L: int, E: int, num: int):
    """(reads uint8 [num, L], origins int64 [num]): windows of L + E bases
    at uniform origins, each given E random edits (substitution, deletion
    or insertion) and cut to L, drawn from ``rng`` in tpufm's order
    (tpufm/bench.py:907-920)."""
    origins = rng.integers(0, codes.shape[0] - L - E, size=num)
    reads = np.empty((num, L), np.uint8)
    for i, s0 in enumerate(origins):
        w = list(codes[s0:s0 + L + E])
        for _ in range(E):
            op = rng.integers(0, 3)
            p = int(rng.integers(0, len(w) - 1))
            if op == 0:
                w[p] = (w[p] + int(rng.integers(1, 4))) & 3
            elif op == 1:
                del w[p]
            else:
                w.insert(p, int(rng.integers(0, 4)))
        reads[i] = w[:L]
    return reads, origins


def edit_sites_check(codes: np.ndarray, reads: np.ndarray, positions: np.ndarray, overflow: np.ndarray,
                     origins: np.ndarray, E: int, device: torch.device):
    """(sound, sensitive) of an edit-distance site list: every reported
    site within E edits of its read, by ``windowed_edit_dist`` on
    ``device`` (the verdicts of tpufm's full ``edit_extend_oracle``), and
    every read not flagged ``overflow`` with a site within 2E of its
    origin (the verifier reports the leftmost least-distance start of a
    window, up to 2E left of the origin)."""
    valid = positions != 0xFFFFFFFF
    rows = np.repeat(np.arange(reads.shape[0]), valid.sum(axis=1))
    sound = True
    if rows.size:
        dist = windowed_edit_dist(
            torch.from_numpy(np.require(codes, np.uint8, ["C", "W"])).to(device),
            torch.from_numpy(reads[rows]).to(device),
            torch.from_numpy(positions[valid].astype(np.int64)).to(device), E)
        sound = bool((dist <= E).all())
    near = np.where(valid, np.abs(positions.astype(np.int64) - origins[:, None]), np.iinfo(np.int64).max)
    sensitive = bool(((near.min(axis=1) <= 2 * E) | overflow).all())
    return sound, sensitive


def run_bench_edit(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_queries: int = 1 << 14,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    edits: int = 2,
    seed_hits: int = 32,
    max_hits: int = 4,
    device: str | torch.device = "cuda",
) -> dict:
    """Edit-distance locate reads/s (``EditExtendEngine.locate_edits``, host
    reads to host sites; tpufm/bench.py:872). Every read carries E planted
    mixed edits (``edit_reads``). 128 reads checked: every site within E
    edits and a site within 2E of each origin not flagged
    (``edit_sites_check``). tpufm runs its full DP oracle over the whole
    text for the first; the windowed DP gives the same verdicts."""
    dev = resolve_device(device)
    E = edits
    rng, codes, index, loc, build_s = _locate_setup(refsize, k, d, sample_rate, seed)
    reads, origins = edit_reads(codes, rng, query_len, E, num_queries)

    eng = EditExtendEngine(index, loc, codes, edits=E, seed_hits=seed_hits, max_hits=max_hits,
                           lut_m=lut_m, device=dev)
    times, (positions, counts, overflow) = _passes(lambda: eng.locate_edits(reads), iterations)
    mean_s = sum(times) / len(times)

    n_verify = min(num_queries, 128)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_queries, n_verify, replace=False))
    sound, sensitive = edit_sites_check(codes, reads[vidx], positions[vidx], overflow[vidx],
                                        origins[vidx], E, dev)

    reads_s = num_queries / mean_s
    return {
        "metric": f"edit-distance locate reads/s (E={E}, k={k}, d={d}, "
        f"lut={lut_m}, s={sample_rate}, seed_hits={seed_hits}, "
        f"{num_queries} x {query_len} bp, {refsize} bases)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,  # the reference has no approximate matching
        "detail": {
            **_device_fields(dev, times),
            "reads_per_s": round(reads_s),
            "myers_lanes_per_s": round(reads_s * (E + 1) * seed_hits),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "sound_vs_dp_oracle": sound,
            "origin_recovered_sample": sensitive,
            "verified_reads": n_verify,
            "overflow_reads": int(overflow.sum()),
            "recovered": int((counts > 0).sum()),
        },
    }


def truth_pairs_found(pairs: np.ndarray, strand: np.ndarray, left, right, minus) -> int:
    """Read pairs whose true (left, right, strand) is among their pairs."""
    hit = ((pairs[..., 0] == np.asarray(left)[:, None]) & (pairs[..., 1] == np.asarray(right)[:, None])
           & (strand == np.asarray(minus).astype(np.uint8)[:, None]))
    return int(hit.any(axis=1).sum())


def pairs_match_oracle(pairs, strand, counts, overflow, want: list) -> bool:
    """tpufm's check of a pair sample against ``pair_oracle``: every pair
    real where overflow is set; else the count equal and, where it fits
    max_pairs, the pair set equal."""
    exact = True
    for row, triples in enumerate(want):
        got = {(int(l), int(r), int(s)) for (l, r), s in zip(pairs[row], strand[row]) if l != 0xFFFFFFFF}
        if overflow[row]:
            exact &= got <= set(triples)
        else:
            exact &= int(counts[row]) == len(triples)
            if counts[row] <= pairs.shape[1]:
                exact &= got == set(triples)
    return exact


def run_bench_paired(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_pairs: int = 1 << 17,
    query_len: int = 120,
    insert_min: int = 250,
    insert_max: int = 450,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    max_hits: int = 4,
    max_pairs: int = 4,
    device: str | torch.device = "cuda",
) -> dict:
    """Paired-end placement pairs/s (``PairedEndEngine.pair``, host reads to
    host pairs; tpufm/bench.py:981) on ``generate_read_pairs``' pairs with
    their truth: every true (left, right, strand) counted, and 64 pairs
    checked against ``pair_oracle`` (its scans on the bench's device)."""
    dev = resolve_device(device)
    _, codes, index, loc, build_s = _locate_setup(refsize, k, d, sample_rate, seed)
    r1, r2, (ls, rs, minus) = generate_read_pairs(codes, query_len, num_pairs, insert_min, insert_max,
                                                  seed=seed + 1, return_truth=True)
    eng = PairedEndEngine(index, loc, insert_min, insert_max, max_hits=max_hits, max_pairs=max_pairs,
                          lut_m=lut_m, device=dev)
    times, (pairs, strand, counts, overflow) = _passes(lambda: eng.pair(r1, r2), iterations)
    mean_s = sum(times) / len(times)

    truth_found = truth_pairs_found(pairs, strand, ls, rs, minus)
    n_verify = min(num_pairs, 64)
    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_pairs, n_verify, replace=False))
    want = pair_oracle(codes, r1[vidx], r2[vidx], insert_min, insert_max, device=dev)
    exact = pairs_match_oracle(pairs[vidx], strand[vidx], counts[vidx], overflow[vidx], want)

    pairs_s = num_pairs / mean_s
    return {
        "metric": f"paired-end placement pairs/s (k={k}, d={d}, "
        f"lut={lut_m}, insert [{insert_min}, {insert_max}], "
        f"{num_pairs} x 2 x {query_len} bp, {refsize} bases)",
        "value": round(pairs_s),
        "unit": "pairs/s",
        "vs_baseline": None,  # the reference has neither locate nor pairing
        "detail": {
            **_device_fields(dev, times),
            "pairs_per_s": round(pairs_s),
            "mate_reads_per_s": round(pairs_s * 2),
            "strand_lanes_per_s": round(pairs_s * 4),  # engine batch lanes
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "truth_pairs_recovered": truth_found,
            "bit_exact_vs_oracle": exact,
            "verified_pairs": n_verify,
            "properly_paired": int((counts > 0).sum()),
            "overflow_pairs": int(overflow.sum()),
        },
    }
