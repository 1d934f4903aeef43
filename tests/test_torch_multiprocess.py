"""The port across processes: 2 OS processes x 2 CPU shards join one
``torch.distributed`` group (gloo, one localhost coordinator) through
``initialize_distributed`` and run the mesh engines, the sharded build and
the collectives over the global 4-shard mesh that ``make_mesh()`` spans
(tests/torch_distworker.py, which imports the port only). The counterpart
of tests/test_multiprocess.py, at its sizes: a 4,096-base text, k=2 d=32,
64 x 24 bp reads, locate s=8, 21 seed reads at m=2. Every process's result
must equal tpufm's one-process oracle or builder; the search-and-locate,
Hamming <= 1, seed, edit, variable-length and paired sources equal tpufm's
engines on jax's CPU mesh of four devices on the workers' own inputs (and
the port's one-process mesh of four CPU shards); each collective equals the same op on ``make_mesh(4, device="cpu")`` in one
process, shard by shard, and logs the same bytes, with the cross-process
share its closed form. Integers throughout: tolerance 0.

Every spawn has a time limit that kills both workers, and the group its
own timeout (120 s) so that a lost peer fails the run."""

import datetime
import importlib.util
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

WORKER = Path(__file__).parent / "torch_distworker.py"
SCALE_WORKER = Path(__file__).parent / "torch_distworker_scale.py"
NPROC, SHARDS = 2, 2
D = NPROC * SHARDS


def _spawn(worker: Path, outdir, *extra, timeout: int = 240) -> None:
    """Run NPROC workers against one coordinator; fail, every worker
    killed, past ``timeout`` seconds or as soon as one exits non-zero (its
    peers would wait out the group's timeout). The coordinator's store is
    held here, on a port the system picks, for the workers' whole run, as
    torchrun's agent holds it (TORCHELASTIC_USE_AGENT_STORE): no port is
    freed and then bound again, so no other process can take it between."""
    store = torch.distributed.TCPStore("127.0.0.1", 0, world_size=NPROC, is_master=True, wait_for_workers=False,
                                       timeout=datetime.timedelta(seconds=timeout))
    coordinator = f"127.0.0.1:{store.port}"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    logs = [Path(outdir) / f"worker_{pid}.log" for pid in range(NPROC)]
    procs, start = [], time.monotonic()
    try:
        for pid, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(worker), coordinator, str(NPROC), str(pid), str(outdir), *extra],
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            assert time.monotonic() - start < timeout, f"workers ran past {timeout} s"
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed ({p.returncode}):\n{log.read_text()[-6000:]}"


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dist")
    _spawn(WORKER, out, "--shards", str(SHARDS), "--device", "cpu")
    return out


def _load(out, name: str, pid: int) -> np.ndarray:
    return np.load(Path(out) / f"{name}_{pid}.npy")


def _case():
    """The workers' workload, rebuilt here with tpufm (the same seeds)."""
    from tpufm.config import IndexConfig
    from tpufm.index.builder import build_index
    from tpufm.index.locate import build_locate
    from tpufm.io.genreads import generate_reads

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
    return (codes, build_index(codes, IndexConfig(k=2, d=32)), build_locate(codes, sample_rate=8, d=32),
            generate_reads(codes, 24, 64, seed=8))


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_distworker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_process_engines_and_build(cpu_run):
    from tpufm.engine.oracle import search_oracle
    from tpufm.engine.seed import seed_extend_oracle
    from tpufm.index.locate import locate_oracle
    from tpufm.index.suffix_array import suffix_array

    codes, index, loc, queries = _case()
    expect = search_oracle(index, queries)
    for pid in range(NPROC):
        np.testing.assert_array_equal(_load(cpu_run, "queries", pid), queries)
        np.testing.assert_array_equal(_load(cpu_run, "result", pid), expect)
        for routing in ("allgather", "ring", "a2a"):
            np.testing.assert_array_equal(_load(cpu_run, f"result_{routing}", pid), expect)
        rows = _load(cpu_run, "locate_rows", pid)
        np.testing.assert_array_equal(_load(cpu_run, "locate", pid), locate_oracle(loc, rows))
        # the sharded build across processes: tpufm's host build, and its searches
        np.testing.assert_array_equal(_load(cpu_run, "shbuild_occ", pid), np.asarray(index.occ, np.uint32))
        np.testing.assert_array_equal(_load(cpu_run, "shbuild_bitmaps", pid), np.asarray(index.bitmaps, np.uint32))
        for name in ("result_shbuild", "result_shtables", "result_store"):
            np.testing.assert_array_equal(_load(cpu_run, name, pid), expect)
        np.testing.assert_array_equal(_load(cpu_run, "sa_sharded", pid), suffix_array(codes))
        for name in ("samples", "mark_words", "mark_rank"):
            np.testing.assert_array_equal(_load(cpu_run, f"shloc_{name}", pid), np.asarray(getattr(loc, name)))
        # seed-and-extend: exact against the naive scan
        mut = _load(cpu_run, "seed_mut", pid)
        want_cnt, want_pos = seed_extend_oracle(codes, mut, 2)
        np.testing.assert_array_equal(_load(cpu_run, "seed_cnt", pid), want_cnt)
        for row, wrow in zip(_load(cpu_run, "seed_pos", pid), want_pos):
            keep = row != np.uint32(0xFFFFFFFF)
            np.testing.assert_array_equal(row[keep], wrow[: keep.sum()])
    # the per-shard store the two processes wrote together: tpufm's index
    # split four ways, file for file (tpufm/index/store.py:111-164)
    root = cpu_run / "sharded.tpufm"
    total = index.occ.shape[0]
    e_local = -(-total // D)
    pad = lambda a: np.pad(np.asarray(a, np.uint32), [(0, D * e_local - total)] + [(0, 0)] * (a.ndim - 1))
    occ, bitmaps = pad(index.occ), pad(index.bitmaps)
    for s in range(D):
        for name, arr in (("occ", occ), ("bitmaps", bitmaps)):
            assert (root / f"{name}.shard{s:04d}.npy").read_bytes() == _npy(arr[s * e_local:(s + 1) * e_local])
    for name in ("dollar_pos", "dollar_base"):
        assert (root / f"{name}.npy").read_bytes() == _npy(np.asarray(getattr(index, name), np.uint32))
    assert json.loads((root / "meta.json").read_text()) == {
        "kind": "kstep_sharded", "format": 1, "n_shards": D, "rows": D * e_local, "k": 2, "d": 32,
        "layout": "baseline", "bwtsize": int(index.bwtsize)}


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr))
    return buf.getvalue()


def test_two_process_sources_match_one_process(cpu_run):
    """search_varlen, count(mismatches=1), search_locate, locate_mismatch,
    locate_approx, locate_edits and the paired engine's three sources across
    processes, on the workers' own inputs: equal to tpufm's engines on jax's
    CPU mesh of four devices, and to the port's one-process mesh."""
    from tpufm.engine.paired import PairedEndEngine as JaxPaired
    from tpufm.index.builder import derive_tail as jax_derive_tail
    from tpufm.parallel import DataParallelEngine as JaxDPE
    from tpufm.parallel import DataParallelSearchLocate as JaxDPSL
    from tpufm.parallel import make_mesh as jax_make_mesh
    from tpufm_torch.engine.paired import PairedEndEngine
    from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
    from tpufm_torch.host.locate import build_locate
    from tpufm_torch.parallel import DataParallelEngine, DataParallelSearchLocate, make_mesh

    codes, jidx, jloc, queries = _case()
    mut, varlen = _load(cpu_run, "seed_mut", 0), _load(cpu_run, "varlen_in", 0)
    r1, r2 = _load(cpu_run, "pairs_r1", 0), _load(cpu_run, "pairs_r2", 0)
    sources = (("exact", {}), ("m2", {"mismatches": 2, "text": codes}), ("e1", {"edits": 1, "text": codes}))

    def run(dpe, dpsl, dpsl_lut, paired, tail):
        out = dict(zip(("sl_iv", "sl_pos"), dpsl_lut.search_locate(queries)))
        out["mm1_pos"] = dpsl.locate_mismatch(mut)
        out.update(zip(("seed_pos", "seed_cnt", "seed_ovf"), dpsl.locate_approx(mut, codes, mismatches=2,
                                                                                 seed_hits=64)))
        out.update(zip(("edit_pos", "edit_cnt", "edit_ovf"), dpsl.locate_edits(mut, codes, edits=2, seed_hits=64)))
        out["count_mm1"] = dpe(lut_m=0).count(queries, mismatches=1)
        out["varlen"] = dpe(lut_m=4, tail_index=tail).search_varlen(varlen)
        for name, kw in sources:
            for i, arr in enumerate(paired(**kw).pair(r1, r2)):
                out[f"paired_{name}_{i}"] = arr
        return {k: np.asarray(v) for k, v in out.items()}

    jmesh = jax_make_mesh(D)
    want = run(lambda **kw: JaxDPE(jidx, jmesh, **kw), JaxDPSL(jidx, jloc, jmesh, max_hits=8),
               JaxDPSL(jidx, jloc, jmesh, max_hits=8, lut_m=4),
               lambda **kw: JaxPaired(jidx, jloc, 60, 200, max_hits=8, mesh=jmesh, **kw), jax_derive_tail(jidx))
    index, loc = build_index(codes, IndexConfig(k=2, d=32)), build_locate(codes, sample_rate=8, d=32)
    mesh = make_mesh(D, device="cpu")
    one = run(lambda **kw: DataParallelEngine(index, mesh, **kw), DataParallelSearchLocate(index, loc, mesh, max_hits=8),
              DataParallelSearchLocate(index, loc, mesh, max_hits=8, lut_m=4),
              lambda **kw: PairedEndEngine(index, loc, 60, 200, max_hits=8, mesh=mesh, **kw), derive_tail(index))
    assert want["seed_cnt"].sum() > 0 and want["edit_cnt"].sum() > 0 and want["paired_exact_2"].sum() > 0
    for pid in range(NPROC):
        for name, arr in want.items():
            got = _load(cpu_run, name, pid)
            assert (got.dtype, got.shape) == (arr.dtype, arr.shape), name
            np.testing.assert_array_equal(got, arr, err_msg=name)
            np.testing.assert_array_equal(got, one[name], err_msg=name)


#: (bytes, cross) each op logs on 2 x 2 shards: all-gather and all-reduce
#: D(D-1)n and D(D-L)n; a permute its pairs, those between processes; an
#: all-to-all (D-1)n and (D-L)n; relayout the rows that change shard /
#: process (12 B a row); the ragged gather shards 1-3 onto shard 0, shards
#: 2-3 from the other process
LOGGED = {"all_gather": (720, 480), "psum": (720, 480), "psum64": (1440, 960), "pmax": (720, 480),
          "pmax64": (1440, 960), "ppermute_ring": (240, 120), "ppermute_back": (240, 120),
          "ppermute_pairs_ring": (240, 120), "ppermute_shift": (180, 60), "ppermute_swap": (120, 0),
          "ppermute_cross": (180, 180), "ppermute_none": (0, 0), "all_to_all": (96, 64),
          "relayout": (60, 24), "relayout_short": (60, 36), "gather": (72, 56)}


def test_two_process_collectives_match_one_process(cpu_run):
    from tpufm_torch.parallel import make_mesh
    from tpufm_torch.parallel import collectives as coll

    worker = _worker_module()
    one = make_mesh(D, device="cpu")
    saved = {}
    log = worker.run_collectives(one, lambda name, arr: saved.__setitem__(name, arr))
    names = list(LOGGED)
    assert [e["bytes"] for e in log] == [LOGGED[n][0] for n in names] and all(e["cross"] == 0 for e in log)
    for pid in range(NPROC):
        meta = json.loads((cpu_run / f"meta_{pid}.json").read_text())
        got = meta["log"]
        assert [(e["kind"], e["shape"], e["dtype"], e["bytes"]) for e in got] == [
            (e["kind"], e["shape"], e["dtype"], e["bytes"]) for e in log]
        assert {n: (e["bytes"], e["cross"]) for n, e in zip(names, got)} == LOGGED
        for name in names[:-1]:
            for s in range(pid * SHARDS, (pid + 1) * SHARDS):
                np.testing.assert_array_equal(_load(cpu_run, f"coll_{name}_{s}", pid), saved[f"coll_{name}_{s}"],
                                              err_msg=f"{name} shard {s}")
        np.testing.assert_array_equal(_load(cpu_run, "coll_gather", pid), saved["coll_gather"])
        # every routing's wave: the bytes of one process, split by the closed form
        for routing, t in meta["traffic"].items():
            assert t["bytes"] == t["within"] + t["across"] and (t["across"] > 0)
    assert coll.Collective("gather", (1,), torch.int32, 4).cross == 0


@pytest.mark.gpu
def test_two_processes_on_one_card(tmp_path):
    """Two processes sharing cuda:0 under gloo, two colocated shards each:
    the same results as the CPU run's oracles, every kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    # the card's machine has no jax: the port's own builder and oracle
    from tpufm_torch.host.index import IndexConfig, build_index
    from tpufm_torch.host.oracle import search_oracle
    from tpufm_torch.host.seqio import generate_reads

    _spawn(WORKER, tmp_path, "--shards", str(SHARDS), "--device", "cuda", timeout=600)
    codes = np.random.default_rng(7).integers(0, 4, size=4096, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32))
    expect = search_oracle(index, generate_reads(codes, 24, 64, seed=8))
    for pid in range(NPROC):
        assert json.loads((tmp_path / f"meta_{pid}.json").read_text())["device"] == "cuda:0"
        for name in ("result", "result_allgather", "result_ring", "result_a2a", "result_shbuild", "result_store"):
            np.testing.assert_array_equal(_load(tmp_path, name, pid), expect, err_msg=name)
        np.testing.assert_array_equal(_load(tmp_path, "shbuild_occ", pid), np.asarray(index.occ, np.uint32))


@pytest.mark.skipif(not os.environ.get("TPUFM_SCALE_TESTS"),
                    reason="set TPUFM_SCALE_TESTS=1 (several minutes: 100 Mbase build)")
def test_chromosome_scale_two_processes(tmp_path):
    """tpufm's chromosome-scale case: a 100 Mbase k=3 d=128 index in tpufm's
    mmap store, 2 processes x 2 CPU shards, DataParallelEngine lut 9 over
    8,192 x 120 bp reads streamed in waves of 2,048, every process's result
    equal to the oracle."""
    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.index.store import save_store
    from tpufm.io.genreads import generate_reads

    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=100_000_000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=3, d=128))
    save_store(tmp_path / "chrom.tpufm", index)
    queries = generate_reads(codes, 120, 8192, seed=12)
    np.save(tmp_path / "queries.npy", queries)
    expect = search_oracle(index, queries)
    _spawn(SCALE_WORKER, tmp_path, timeout=1200)
    for pid in range(NPROC):
        np.testing.assert_array_equal(np.load(tmp_path / f"chrom_result_{pid}.npy"), expect)
