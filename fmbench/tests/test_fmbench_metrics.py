"""The metric arithmetic and the trace reduction on synthetic records."""

import statistics

import numpy as np
import pytest

from fmbench import registry, trace
from fmbench.derive import H100_HBM_BYTES_PER_S, Run, lf_round_bytes_per_read
from fmbench.trace import Event

MS = 1_000_000  # ns


def synthetic_trace():
    """A 100 ms window: two batches, kernels, copies, a memset and an
    annotation mirrored on the device, with host operators around the gaps."""
    ev = [
        Event("host", trace.WINDOW, 0, 100 * MS, 1),
        Event("host", trace.BATCH, 0, 50 * MS, 1),
        Event("host", trace.BATCH, 50 * MS, 100 * MS, 1),
        Event("host", "aten::to", 1 * MS, 21 * MS, 1),
        Event("host", "aten::nonzero", 60 * MS, 70 * MS, 1),
        Event("host", "cudaStreamSynchronize", 62 * MS, 69 * MS, 1),
        Event("host", "aten::elsewhere", 60 * MS, 70 * MS, 2),  # another thread: never a label
        Event("copy", "Memcpy HtoD (Pageable -> Device)", 2 * MS, 20 * MS),
        Event("kernel", "lf_round_pairs_kernel<3, 4>", 20 * MS, 30 * MS),
        Event("kernel", "lf_round_pairs_kernel<3, 4>", 25 * MS, 35 * MS),  # overlaps: busy once
        Event("kernel", "elementwise_kernel", 40 * MS, 45 * MS),
        Event("memset", "Memset (Device)", 45 * MS, 46 * MS),
        Event("copy", "Memcpy DtoD (Device -> Device)", 52 * MS, 53 * MS),
        Event("copy", "Memcpy DtoH (Device -> Pageable)", 70 * MS, 80 * MS),
        Event("kernel", "before_the_window", -5 * MS, -1 * MS),
    ]
    return trace.reduce(ev)


def test_trace_reduction():
    tr = synthetic_trace()
    assert tr.window_s == pytest.approx(0.1)
    # busy: 2-35, 40-46, 52-53, 70-80 ms
    assert tr.busy_s == pytest.approx((33 + 6 + 1 + 10) / 1e3)
    assert tr.kernel_s == pytest.approx((10 + 10 + 5) / 1e3)
    assert tr.copy_s == pytest.approx((18 + 10) / 1e3)  # host<->device only
    assert tr.launches == 3
    assert tr.kernel_time(("lf_round",)) == pytest.approx(0.02)
    # gaps 0-2 (aten::to), 35-40, 46-50 (batch 1), 50-52, 53-70 (nonzero: mid 61.5), 80-100
    assert tr.idle_s["aten::to"] == pytest.approx(0.002)
    assert tr.idle_s["aten::nonzero"] == pytest.approx(0.017)
    assert tr.idle_s[trace.BATCH] == pytest.approx((5 + 4 + 2 + 20) / 1e3)
    b = tr.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0].startswith("lf_round_pairs_kernel")
    assert b["idle_gaps"][0] == [trace.BATCH, pytest.approx(0.031)]


def run_record(**kw):
    config = {"k": 3, "lut_m": 12}
    traffic = {"read_len": 120, "batch_reads": 1 << 20}
    base = dict(config=config, traffic=traffic, seconds=10.0,
                batch_s=np.array([0.1, 0.2, 0.3, 0.4] * 25 + [1.0]), setup_s=12.5, index_build_s=2.5)
    base.update(kw)
    return Run(**base)


def test_rate_is_over_every_read_and_the_whole_window():
    run = run_record()
    assert registry.metric("reads_per_s")(run) == pytest.approx(101 * (1 << 20) / 10.0)
    assert registry.metric("reads_per_s.host_paced")(run) == pytest.approx(101 * (1 << 20) / 10.0)
    assert registry.metric("reads_per_s")(run_record(batch_s=np.array([]))) is None


def test_p95_is_over_every_batch():
    run = run_record()
    want = statistics.quantiles(run.batch_s.tolist(), n=20, method="inclusive")[18] * 1e3
    assert registry.metric("batch_p95_ms")(run) == pytest.approx(want)
    assert registry.metric("batch_p95_ms.host_paced")(run) == pytest.approx(want)
    assert registry.metric("batch_p95_ms")(run) == pytest.approx(np.percentile(run.batch_s, 95) * 1e3)


def test_setup_and_build_come_from_the_record():
    assert registry.metric("setup_s")(run_record()) == 12.5
    assert registry.metric("index_build_s")(run_record()) == 2.5


def test_lf_round_bytes():
    # 36 rounds of (8 + 8 + 1 + 4 + 24) B at k=3, lut12, 120 bp; no k=1 tail round
    assert lf_round_bytes_per_read({"k": 3, "lut_m": 12}, {"read_len": 120}) == 36 * 45
    # 151 bp: 46 rounds and one tail round of 29 B
    assert lf_round_bytes_per_read({"k": 3, "lut_m": 12}, {"read_len": 151}) == 46 * 45 + 29


def test_trace_metrics():
    tr = synthetic_trace()
    run = run_record(trace=tr, traced_reads=2_000_000)
    assert registry.metric("copy_ms_per_mread")(run) == pytest.approx(28 / 2)
    assert registry.metric("kernel_ms_per_mread")(run) == pytest.approx(25 / 2)
    assert registry.metric("launches_per_mread")(run) == pytest.approx(3 / 2)
    assert registry.metric("device_idle_pct")(run) == pytest.approx(50.0)
    for name in ("copy_ms_per_mread", "kernel_ms_per_mread", "launches_per_mread", "device_idle_pct"):
        assert registry.metric(name + ".host_paced")(run) == registry.metric(name)(run)
    want = 100 * 36 * 45 * 2_000_000 / H100_HBM_BYTES_PER_S / 0.02
    assert registry.metric("lf_round_sol_pct")(run) == pytest.approx(want)


def test_readers_without_a_trace_read_nothing():
    run = run_record()
    for name in ("copy_ms_per_mread", "kernel_ms_per_mread", "launches_per_mread", "device_idle_pct",
                 "lf_round_sol_pct"):
        assert registry.metric(name)(run) is None


def test_roofline_share_reads_nothing_without_its_kernels():
    tr = trace.reduce([Event("host", trace.WINDOW, 0, 10 * MS, 1), Event("kernel", "other", 1 * MS, 2 * MS)])
    assert registry.metric("lf_round_sol_pct")(run_record(trace=tr, traced_reads=1000)) is None
