"""The port's bench (tpufm_torch.bench, tpufm_torch.config, tpufm_torch.timer)
on the CPU against tpufm's (tpufm.bench, tpufm.config): the same seeds and
arguments through both packages. Times are not compared (a CPU time says
nothing of the card); every time-free field of a record is: the metric
string, the counts of verified, planted and recovered reads and the
gathered bytes, exactly (tolerance 0), and every bit-exactness field must
be true. Configurations and the waved search compare exactly as well."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm import bench as jax_bench
from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.config import recommend_config as jax_recommend_config
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.store import load_store as jax_load_store
from tpufm_torch import SearchEngine, bench
from tpufm_torch.config import recommend_config
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.timer import device_sync, timed_device_passes

#: detail fields every port record adds to tpufm's
ADDED = {"device", "power_limit_w", "pass_seconds", "seconds_per_pass_median"}
#: the search records' full-batch check: tpufm's CPU engine, the port's plain rounds
RENAMED = ({"bit_exact_vs_cpu_engine_full"}, {"bit_exact_vs_plain_full", "hbm_bytes_per_s"})
REFSIZE = 200_000


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("query_len", [24, 100, 120, 150, 151])
def test_recommend_config_equals_tpufm(query_len, serving):
    # each boundary of the ladder and the sizes on either side of it
    sizes = [1_000, 10_000_000, 40_319_999, 40_320_000, 67_199_999, 67_200_000, 250_000_000,
             999_999_999, 1_000_000_000, 1_000_000_001, 2_399_999_999, 2_400_000_000, 3_200_000_000, 4_000_000_000]
    for refsize in sizes:
        got = recommend_config(refsize, query_len=query_len, serving=serving)
        assert got == jax_recommend_config(refsize, query_len=query_len, serving=serving), refsize


@pytest.mark.parametrize("iterations", [1, 4])
def test_timed_device_passes_warms_up_and_lists_passes(iterations):
    calls = []
    mean, least, times = timed_device_passes(lambda: calls.append(1) or torch.ones(3), iterations=iterations)
    assert len(calls) == iterations + 1  # one warm-up pass
    assert len(times) == iterations and all(t >= 0 for t in times)
    assert mean == pytest.approx(sum(times) / iterations) and least == min(times)
    device_sync((torch.zeros(2), [torch.ones(1), np.zeros(1)], None))  # CPU: no barrier, no error


def _index_pair(k=2, d=64, n=6000, seed=17):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    return (codes, jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa_method="doubling"),
            build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling"))


@pytest.mark.parametrize("lut", [0, 4])
def test_search_device_waved_equals_tpufm(lut):
    codes, jidx, tidx = _index_pair()
    wave, L = 512, 24
    starts = np.random.default_rng(5).integers(0, codes.shape[0] - L, size=3 * wave)
    queries = codes[starts[:, None] + np.arange(L)]
    queries[::7] = np.random.default_rng(6).integers(0, 4, size=queries[::7].shape, dtype=np.uint8)
    want = np.asarray(XLAEngine(jidx, lut_m=lut).search_device_waved(jnp.asarray(queries), wave=wave))
    eng = SearchEngine(tidx, "cpu", lut_m=lut)
    got = eng.search_device_waved(torch.from_numpy(queries), wave=wave)
    assert got.dtype == torch.int64 and got.device == eng.device and tuple(got.shape) == (3 * wave, 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), eng.search(queries).astype(np.int64))


def test_search_device_waved_refuses_a_ragged_batch():
    _, jidx, tidx = _index_pair()
    q = np.zeros((1000, 24), np.uint8)
    with pytest.raises(ValueError, match="not a multiple of wave 512"):
        XLAEngine(jidx).search_device_waved(jnp.asarray(q), wave=512)
    with pytest.raises(ValueError, match="not a multiple of wave 512"):
        SearchEngine(tidx, "cpu").search_device_waved(torch.from_numpy(q), wave=512)


def test_gather_traffic_bytes_equals_tpufm():
    _, jidx, tidx = _index_pair()
    want = jax_bench.gather_traffic_bytes(XLAEngine(jidx, lut_m=4), 2048, 24)
    assert want == 2048 * (10 * 2 * 4 * 24 + 8)  # tests/test_bench.py:19's case
    assert bench.gather_traffic_bytes(SearchEngine(tidx, "cpu", lut_m=4), 2048, 24) == want
    assert bench.gather_traffic_bytes(object(), 10, 24) is None
    # a k=1 tail round reads another table: no count, as tpufm
    tail = build_index(_index_pair()[0], IndexConfig(k=1, d=64), sa_method="doubling")
    assert bench.gather_traffic_bytes(SearchEngine(tidx, "cpu", tail_index=tail), 8, 25) is None


def _check_record(got: dict, want: dict, added: set, fields: tuple) -> None:
    """Keys: tpufm's, renamed and added; every bit-exact field true; the
    time-free ``fields`` and the metric equal; JSON-serialisable."""
    gd, wd = got["detail"], want["detail"]
    removed, renamed = RENAMED if "bit_exact_vs_cpu_engine_full" in wd else (set(), set())
    assert set(got) == set(want)
    assert set(gd) == (set(wd) - removed) | renamed | ADDED | added
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    for name in fields:
        assert gd[name] == wd[name], name
    flags = [key for key in gd if key.startswith("bit_exact")]
    assert flags and all(gd[key] is True for key in flags), {key: gd[key] for key in flags}
    assert gd["device"] == "cpu" and gd["power_limit_w"] is None
    assert len(gd["pass_seconds"]) == gd.get("iterations", len(gd["pass_seconds"]))
    assert gd["seconds_per_pass"] == pytest.approx(sum(gd["pass_seconds"]) / len(gd["pass_seconds"]))
    json.dumps(got)


@pytest.mark.parametrize("engine", ["xla", "pallas", "xla-ac", "xla-split", "xla-paired"])
def test_run_bench_record_equals_tpufm(engine):
    kw = dict(refsize=REFSIZE, k=2, d=64, num_queries=2048, query_len=24, iterations=2,
              engine=engine, lut_m=4, compare_reference=False, full_verify=True)
    want = jax_bench.run_bench(**kw)
    got = bench.run_bench(**kw, device="cpu")
    added = {"host_seconds_per_pass"} if engine == "xla" else set()
    _check_record(got, want, added, ("verified_reads", "verified_reads_oracle", "gathered_bytes_per_pass",
                                     "iterations", "repair_fraction", "reference_cpu_seconds_per_pass"))
    assert got["detail"]["bit_exact_vs_plain_full"] is True
    assert got["detail"]["verified_reads"] == 2048
    assert got["detail"]["hbm_bytes_per_s"] == 3.35e12
    assert got["vs_baseline"] == pytest.approx(got["detail"]["fraction_of_sol"], abs=1e-4)


def test_run_bench_waved_and_host_paths(monkeypatch):
    """Past one wave: zero-padded whole waves on the device, and, past the
    waved byte limit, the host-to-host search; both verified in full."""
    monkeypatch.setattr(SearchEngine, "WAVE", 512)
    batches = []
    waved_fn = SearchEngine.search_device_waved
    monkeypatch.setattr(SearchEngine, "search_device_waved",
                        lambda self, q, wave=None: batches.append(q.shape[0]) or waved_fn(self, q, wave))
    kw = dict(refsize=20_000, k=2, d=64, num_queries=1300, query_len=24, iterations=1,
              lut_m=4, full_verify=True, device="cpu")
    waved = bench.run_bench(**kw)
    assert batches == [1536, 1536]  # the warm-up and the timed pass, padded to 3 waves
    monkeypatch.setattr(bench, "WAVED_MAX_BYTES", 0)
    host = bench.run_bench(**kw)
    assert len(batches) == 2
    for r in (waved, host):
        assert r["detail"]["bit_exact_vs_oracle"] and r["detail"]["bit_exact_vs_plain_full"]
        assert r["detail"]["verified_reads"] == 1300


def test_full_verify_off_by_environment(monkeypatch):
    monkeypatch.setenv("TPUFM_BENCH_FULL_VERIFY", "0")
    r = bench.run_bench(refsize=20_000, num_queries=256, query_len=24, iterations=1, device="cpu")
    assert r["detail"]["bit_exact_vs_plain_full"] is None
    assert r["detail"]["verified_reads"] == 256 and r["detail"]["bit_exact_vs_oracle"]


def test_run_bench_locate_record_equals_tpufm():
    kw = dict(refsize=REFSIZE, d=64, sample_rate=8, num_rows=4096, iterations=2, seed=3)
    want = jax_bench.run_bench_locate(**kw, n_devices=1)
    got = bench.run_bench_locate(**kw, device="cpu")
    _check_record(got, want, set(), ("verified_rows", "devices"))
    assert got["vs_baseline"] == 1.0 and got["detail"]["scaling_efficiency"] == 1.0


def test_run_bench_search_locate_record_equals_tpufm():
    kw = dict(refsize=REFSIZE, k=2, d=64, sample_rate=8, num_queries=2048, query_len=24,
              iterations=2, lut_m=4, max_hits=16)
    want = jax_bench.run_bench_search_locate(**kw)
    got = bench.run_bench_search_locate(**kw, device="cpu")
    _check_record(got, want, set(), ("verified_reads", "max_hits"))
    assert got["vs_baseline"] is None


def test_run_bench_mismatch_record_equals_tpufm():
    kw = dict(refsize=REFSIZE, k=2, d=64, num_queries=64, query_len=24, iterations=1, lut_m=4,
              error_rate=0.5)
    want = jax_bench.run_bench_mismatch(**kw)
    got = bench.run_bench_mismatch(**kw, device="cpu")
    _check_record(got, want, set(), ("verified_reads", "planted_error_reads", "recovered"))
    assert got["detail"]["planted_error_reads"] == 32 and got["detail"]["recovered"] == 64


def test_hamming1_counts_matches_a_loop():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    reads = np.stack([codes[s:s + 12] for s in rng.integers(0, 2988, size=20)])
    reads[::2, 3] = (reads[::2, 3] + 1) % 4
    want = [sum(int((codes[i:i + 12] != q).sum() <= 1) for i in range(3000 - 11)) for q in reads]
    np.testing.assert_array_equal(bench.hamming1_counts(codes, reads, torch.device("cpu")), want)


def test_run_bench_genome_cache_shared_with_tpufm(tmp_path):
    kw = dict(refsize=REFSIZE, num_queries=1024, query_len=120, iterations=1, lut_m=6,
              full_verify=True, cache_dir=tmp_path)
    first = bench.run_bench_genome(**kw, device="cpu")
    assert first["detail"]["index_cached"] is False
    second = bench.run_bench_genome(**kw, device="cpu")
    assert second["detail"]["index_cached"] is True and second["detail"]["build_seconds"] == 0.0
    for r in (first, second):
        assert r["detail"]["bit_exact_vs_oracle"] and r["detail"]["bit_exact_vs_plain_full"]
    assert (tmp_path / "lut_200000_k3_d192_s0_m6.npz").exists()
    # tpufm reads the port's store back equal, and its record reuses the cache
    codes = np.random.default_rng(0).integers(0, 4, size=REFSIZE, dtype=np.uint8)
    store = jax_load_store(tmp_path / "idx_200000_k3_d192_s0.tpufm")
    ref = jax_build_index(codes, JaxIndexConfig(k=3, d=192))
    for name in ("occ", "bitmaps", "dollar_pos", "dollar_base"):
        np.testing.assert_array_equal(getattr(store, name), getattr(ref, name))
    assert store.bwtsize == ref.bwtsize and store.config == ref.config
    want = jax_bench.run_bench_genome(**kw, compare_reference=False)
    assert want["detail"]["index_cached"] is True
    _check_record(second, want, set(), ("verified_reads", "gathered_bytes_per_pass", "d", "lut_m",
                                        "refsize", "index_cached"))


@pytest.mark.parametrize("engine", ["xla-ac", "xla-paired", "xla-split"])
def test_unported_engines_raise(engine):
    """The engines of ROADMAP Queue 1 item 5 raised until they were ported;
    each now gives its record, verified in full, and a name outside
    tpufm's engines still raises tpufm's text."""
    record = bench.run_bench(refsize=5000, num_queries=64, query_len=24, iterations=1, engine=engine,
                             lut_m=4, device="cpu")
    assert record["metric"].endswith(f"engine={engine})")
    assert record["detail"]["bit_exact_vs_oracle"] and record["detail"]["bit_exact_vs_plain_full"]
    assert (record["detail"]["repair_fraction"] is not None) == (engine == "xla-paired")
    with pytest.raises(ValueError, match=f"^unknown engine '{engine}-x'$"):
        bench.run_bench(refsize=1000, engine=f"{engine}-x", device="cpu")


def test_unported_options_raise():
    """pad_words (Queue 1 item 5) is ported: the record's gathered bytes are
    tpufm's 512 B rows; so is the multi-device locate record (item 6b), over
    two CPU shards."""
    kw = dict(refsize=20_000, k=2, d=64, num_queries=256, query_len=24, iterations=1, pad_words=128,
              compare_reference=False)
    want = jax_bench.run_bench(**kw)
    got = bench.run_bench(**kw, device="cpu")
    assert got["detail"]["gathered_bytes_per_pass"] == want["detail"]["gathered_bytes_per_pass"] == 256 * 12 * 2 * 512
    assert got["detail"]["bit_exact_vs_oracle"]
    with pytest.raises(ValueError, match="unknown engine"):
        bench.run_bench(refsize=1000, engine="tpu", device="cpu")
    record = bench.run_bench_locate(refsize=1000, num_rows=257, n_devices=2, device="cpu")
    assert record["detail"]["devices"] == 2 and record["detail"]["bit_exact_vs_oracle"] is True
    assert record["detail"]["verified_rows"] == 256 and len(record["detail"]["one_device_pass_seconds"]) == 5


def test_records_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_bench(refsize=1000, num_queries=8, query_len=24)


#: the approximate records' reference: their checks scan the whole text per
#: verified read in tpufm (numpy), so it is smaller than REFSIZE
APPROX_REFSIZE = 40_000


@pytest.mark.parametrize("lut,m", [(0, 2), (4, 3)])
def test_run_bench_seed_record_equals_tpufm(lut, m):
    kw = dict(refsize=APPROX_REFSIZE, k=2, d=64, sample_rate=8, num_queries=256, query_len=30, iterations=2,
              lut_m=lut, mismatches=m, max_hits=4)
    want = jax_bench.run_bench_seed(**kw)
    got = bench.run_bench_seed(**kw, device="cpu")
    _check_record(got, want, set(), ("verified_reads", "planted_error_reads", "overflow_reads", "recovered",
                                     "bit_exact_vs_naive"))
    assert got["detail"]["verified_reads"] == 256 and got["vs_baseline"] is None


@pytest.mark.parametrize("E", [1, 2])
def test_run_bench_edit_record_equals_tpufm(E):
    """No bit-exactness field in this record: its two checks (every site
    within E edits by the windowed DP, where tpufm runs the full oracle,
    and a site near each origin) must equal tpufm's and be true."""
    kw = dict(refsize=APPROX_REFSIZE, k=2, d=64, sample_rate=8, num_queries=128, query_len=30, iterations=2,
              lut_m=4, edits=E)
    want = jax_bench.run_bench_edit(**kw)
    got = bench.run_bench_edit(**kw, device="cpu")
    gd, wd = got["detail"], want["detail"]
    assert set(got) == set(want) and set(gd) == set(wd) | ADDED
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    for name in ("sound_vs_dp_oracle", "origin_recovered_sample", "verified_reads", "overflow_reads", "recovered"):
        assert gd[name] == wd[name], name
    assert gd["sound_vs_dp_oracle"] is True and gd["origin_recovered_sample"] is True
    assert gd["device"] == "cpu" and len(gd["pass_seconds"]) == 2
    json.dumps(got)


def test_run_bench_paired_record_equals_tpufm():
    kw = dict(refsize=APPROX_REFSIZE, k=2, d=64, sample_rate=8, num_pairs=512, query_len=30, insert_min=60,
              insert_max=200, iterations=2, lut_m=4, max_hits=4)
    want = jax_bench.run_bench_paired(**kw)
    got = bench.run_bench_paired(**kw, device="cpu")
    _check_record(got, want, set(), ("truth_pairs_recovered", "bit_exact_vs_oracle", "verified_pairs",
                                     "properly_paired", "overflow_pairs"))
    assert got["detail"]["truth_pairs_recovered"] == 512


def test_edit_sites_check_catches_a_wrong_site():
    """The edit record's checks fail on a site that is no alignment and on
    a read whose sites are all far from its origin."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    origins = np.array([100, 700])
    reads = np.stack([codes[s:s + 30] for s in origins])
    good = np.array([[100, 0xFFFFFFFF], [700, 0xFFFFFFFF]], np.uint32)
    flags = np.zeros(2, bool)
    cpu = torch.device("cpu")
    assert bench.edit_sites_check(codes, reads, good, flags, origins, 1, cpu) == (True, True)
    far = good.copy()
    far[1, 0] = 1500
    assert bench.edit_sites_check(codes, reads, far, flags, origins, 1, cpu) == (False, False)
    assert bench.edit_sites_check(codes, reads, far, np.array([False, True]), origins, 1, cpu)[1] is True


def test_hamming_hits_matches_a_loop():
    rng = np.random.default_rng(10)
    codes = rng.integers(0, 4, size=2500, dtype=np.uint8)
    reads = np.stack([codes[s:s + 9] for s in rng.integers(0, 2490, size=12)])
    reads[::2, 4] = (reads[::2, 4] + 1) % 4
    for m in (0, 1, 2):
        got = bench.hamming_hits(codes, reads, m, torch.device("cpu"))
        for q, g in zip(reads, got):
            want = [i for i in range(2500 - 8) if (codes[i:i + 9] != q).sum() <= m]
            assert g.dtype == np.uint32 and g.tolist() == want
