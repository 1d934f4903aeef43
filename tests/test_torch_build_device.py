"""The device build of the port (tpufm_torch.index) against tpufm's device
builders (tpufm/index/sa_device.py, builder_device.py, JAX on the CPU) and
the port's host builders (SA-IS, ``build_index``, ``build_locate``) on the
same seeded texts: the suffix array, every index and locate array (values
and dtypes), K7's plain version against tpufm's ``_build_tables``, a
device-resident index driving the search, and ``build/locate/align
--on-device`` and ``build --sa device`` writing the host build's bytes.
Every value is an integer: tolerance 0. Here the device is the CPU, where
each wrapper takes its plain version."""

import jax
import numpy as np
import pytest
import torch

from tpufm import cli as jax_cli
from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.index import builder_device as jax_bd
from tpufm.index.sa_device import suffix_array_device as jax_suffix_array_device
from tpufm_torch import SearchEngine, cli as torch_cli
from tpufm_torch.engine.locate import LocateEngine
from tpufm_torch.engine.seed import pack_text_words
from tpufm_torch.engine.tables import lut_fingerprint
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
from tpufm_torch.host.locate import build_locate, locate_oracle
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.seqio import decode_bases, generate_reads, write_reads_fasta, write_reference
from tpufm_torch.host.suffix_array import suffix_array
from tpufm_torch.index import builder_device as bd
from tpufm_torch.index import sa_device

INDEX_FIELDS = ("occ", "bitmaps", "dollar_pos", "dollar_base")
LOCATE_FIELDS = ("samples", "mark_words", "mark_rank")


def _same_index(got, want):
    for f in INDEX_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.bwtsize == want.bwtsize and got.config.k == want.config.k and got.config.d == want.config.d


def _same_locate(got, want):
    for f in LOCATE_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.sample_rate == want.sample_rate
    _same_index(got.lf1, want.lf1)


def _texts():
    rng = np.random.default_rng(11)
    return {
        "random": rng.integers(0, 4, size=3001, dtype=np.uint8),
        "all-A": np.zeros(200, dtype=np.uint8),
        "ACGT": np.tile(np.arange(4, dtype=np.uint8), 100),
        "AAC": np.tile(np.array([0, 0, 1], dtype=np.uint8), 67),
        "seven": rng.integers(0, 7, size=500, dtype=np.uint8),
        **{f"{n}-base": rng.integers(0, 4, size=n, dtype=np.uint8) for n in range(1, 6)},
        "empty": np.zeros(0, dtype=np.uint8),
    }


@pytest.mark.parametrize("name", list(_texts()))
def test_suffix_array_matches_tpufm_and_sais(name):
    codes = _texts()[name]
    got = sa_device.suffix_array_device(codes, device="cpu")
    assert got.dtype == np.int64 and got.shape == (codes.shape[0] + 1,) and got[0] == codes.shape[0]
    np.testing.assert_array_equal(got, jax_suffix_array_device(codes))
    np.testing.assert_array_equal(got, suffix_array(codes, "native"))
    np.testing.assert_array_equal(got, suffix_array(codes, "device", device="cpu"))


def test_suffix_array_rounds_end_on_the_sorted_suffixes():
    """The rounds one by one (``initial``, ``step``): each leaves a rank that
    orders the suffixes by their first h symbols, and the last one the
    suffix array."""
    codes = np.tile(np.array([1, 0, 1, 0, 2], dtype=np.uint8), 40)  # repeats: many rounds
    n = codes.shape[0]
    rank, order, distinct = sa_device.initial(torch.from_numpy(codes))
    h, rounds = sa_device.PACK, 1
    text = bytes((codes + 1).tolist())
    while True:
        prefixes = [text[i:i + h] for i in range(n + 1)]
        want = np.unique(prefixes, return_inverse=True)[1]
        np.testing.assert_array_equal(rank.numpy(), want)
        if bool(distinct):
            break
        rank, order, distinct = sa_device.step(rank, h)
        h, rounds = 2 * h, rounds + 1
    assert rounds == 6
    np.testing.assert_array_equal(order.numpy(), suffix_array(codes, "native"))


def test_suffix_array_refuses_symbols_past_six():
    codes = np.array([0, 1, 7, 2], dtype=np.uint8)
    with pytest.raises(ValueError, match=r"\[0, 6\]"):
        sa_device.suffix_array_device(codes, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 6\]"):
        jax_suffix_array_device(codes)


@pytest.mark.parametrize("k,d", [(1, 32), (2, 64), (3, 32), (4, 32), (3, 128)])
def test_index_matches_tpufm_and_host(rng, k, d):
    codes = rng.integers(0, 4, size=3001, dtype=np.uint8)
    got = bd.build_index_device(codes, IndexConfig(k=k, d=d), device="cpu")
    _same_index(got, build_index(codes, IndexConfig(k=k, d=d)))
    _same_index(got, jax_bd.build_index_device(codes, JaxIndexConfig(k=k, d=d)))


@pytest.mark.parametrize("edge", ["two-blocks", "five-bases", "all-A", "ACGT"])
def test_index_edges_match_tpufm_and_host(rng, edge):
    codes = {
        "two-blocks": rng.integers(0, 4, size=63, dtype=np.uint8),  # bwtsize == 2d: no padding
        "five-bases": rng.integers(0, 4, size=5, dtype=np.uint8),
        "all-A": np.zeros(200, dtype=np.uint8),
        "ACGT": np.frombuffer(b"\x00\x01\x02\x03" * 100, np.uint8).copy(),
    }[edge]
    got = bd.build_index_device(codes, IndexConfig(k=2, d=32), device="cpu")
    _same_index(got, build_index(codes, IndexConfig(k=2, d=32)))
    _same_index(got, jax_bd.build_index_device(codes, JaxIndexConfig(k=2, d=32)))


@pytest.mark.parametrize("case", range(5))
def test_index_fuzz_matches_tpufm_and_host(case):
    rng = np.random.default_rng(100 + case)
    k, d, n = int(rng.integers(1, 5)), 32 * int(rng.integers(1, 5)), int(rng.integers(50, 4000))
    if case % 2:
        pat = rng.integers(0, 4, size=int(rng.integers(1, 6)), dtype=np.uint8)
        codes = np.tile(pat, -(-n // len(pat)))[:n].copy()
    else:
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    got = bd.build_index_device(codes, IndexConfig(k=k, d=d), device="cpu")
    _same_index(got, build_index(codes, IndexConfig(k=k, d=d)))
    _same_index(got, jax_bd.build_index_device(codes, JaxIndexConfig(k=k, d=d)))


@pytest.mark.parametrize("k,d,n", [(1, 32, 1000), (2, 64, 127), (3, 96, 2000), (4, 32, 31), (3, 32, 5),
                                   (5, 64, 300), (6, 32, 100)])
def test_k7_plain_version_matches_tpufm_build_tables(k, d, n):
    """``build_tables_reference`` against tpufm's ``_build_tables``
    (uncorrected counts, bit-planes, '$' positions) on the same suffix array;
    n + 1 a multiple of d where (n, d) = (127, 64) and (31, 32). Past k = 4
    tpufm's pass runs op by op (``jax.disable_jit``): its 4^k unrolled
    codes take minutes to compile at k = 6."""
    codes = np.random.default_rng(n).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes, "native")
    counts, bitmaps, dollar_pos = bd.build_tables(torch.from_numpy(codes), torch.from_numpy(sa.astype(np.int32)), k, d)
    with jax.disable_jit(k > 4):
        want_counts, want_bitmaps, want_dollar = (
            np.asarray(a) for a in jax_bd._build_tables(k, d)(codes, sa.astype(np.uint32)))
    assert counts.dtype == torch.int32 and bitmaps.dtype == torch.int32 and dollar_pos.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy().view(np.uint32), want_counts)
    np.testing.assert_array_equal(bitmaps.numpy().view(np.uint32), want_bitmaps)
    np.testing.assert_array_equal(dollar_pos.numpy(), want_dollar.astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 33, 1000, 4099])
def test_k7_text_pack_matches_numpy(n):
    """``pack_text_2bit`` (K7's text; on the CPU its plain version) against a
    numpy loop over the bases and against ``pack_text_words`` (the seed
    engines' layout), with codes past 3 masked to their two low bits."""
    codes = np.random.default_rng(n).integers(0, 7, size=n, dtype=np.uint8)
    got = bd.pack_text_2bit(torch.from_numpy(codes))
    assert got.dtype == torch.int32 and tuple(got.shape) == (-(-n // 16) + 1,)
    want = np.zeros(-(-n // 16) + 1, dtype=np.uint32)
    for j, c in enumerate(codes):
        want[j // 16] |= np.uint32(int(c) & 3) << np.uint32(30 - 2 * (j % 16))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, pack_text_words(codes & 3))


@pytest.mark.parametrize("bad", ["int64", "2-D", "strided", "meta"])
def test_k7_text_pack_checks_its_inputs(bad):
    """``pack_text_2bit`` takes a contiguous uint8 [n] on the CPU or a card
    and raises ValueError on anything else."""
    codes = {
        "int64": torch.zeros(32, dtype=torch.int64),
        "2-D": torch.zeros((2, 16), dtype=torch.uint8),
        "strided": torch.zeros(64, dtype=torch.uint8)[::2],
        "meta": torch.zeros(32, dtype=torch.uint8, device="meta"),
    }[bad]
    with pytest.raises(ValueError):
        bd.pack_text_2bit(codes)


def test_k7_wrapper_checks_its_inputs():
    codes = torch.zeros(10, dtype=torch.uint8)
    sa = torch.arange(11, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        bd.build_tables(codes, sa.to(torch.int64), 2, 32)
    with pytest.raises(ValueError, match=r"\[11\]"):
        bd.build_tables(codes, sa[:10], 2, 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        bd.build_tables(codes, sa, 2, 48)
    with pytest.raises(ValueError, match="k must be"):
        bd.build_tables(codes, sa, 9, 32)


@pytest.mark.parametrize("n,s,d", [(3001, 8, 32), (2048, 16, 64), (513, 4, 32)])
def test_locate_matches_tpufm_and_host(rng, n, s, d):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    got = bd.build_locate_device(codes, sample_rate=s, d=d, device="cpu")
    _same_locate(got, build_locate(codes, sample_rate=s, d=d))
    _same_locate(got, jax_bd.build_locate_device(codes, sample_rate=s, d=d))


def test_one_sort_serves_index_tail_and_locate(rng):
    codes = rng.integers(0, 4, size=2500, dtype=np.uint8)
    cd = sa_device.upload_text(codes, "cpu")
    order = sa_device.suffix_array_device_arr(cd)
    assert order.dtype == torch.int32
    index = bd.build_index_device(codes, IndexConfig(k=3, d=64), sa_dev=order, codes_dev=cd)
    tail = bd.build_index_device(codes, IndexConfig(k=1, d=64), sa_dev=order, codes_dev=cd)
    loc = bd.build_locate_device(codes, sample_rate=8, d=64, sa_dev=order, codes_dev=cd)
    sa = suffix_array(codes)
    _same_index(index, build_index(codes, IndexConfig(k=3, d=64), sa=sa))
    _same_index(tail, derive_tail(index))
    _same_locate(loc, build_locate(codes, sample_rate=8, d=64, sa=sa))
    with pytest.raises(ValueError, match="sa_dev has"):
        bd.build_index_device(codes, IndexConfig(k=3, d=64), sa_dev=order[:-1], codes_dev=cd)


def test_device_resident_index_drives_the_engines(rng):
    """``return_host=False``: the tables stay tensors (int32 bits), the
    engines take them as they lie, the intervals equal the numpy oracle's,
    the LUT fingerprint equals the host-built index's, and the walk equals
    the host oracle."""
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    host = build_index(codes, IndexConfig(k=2, d=64))
    dev = bd.build_index_device(codes, IndexConfig(k=2, d=64), return_host=False, device="cpu")
    tail = bd.build_index_device(codes, IndexConfig(k=1, d=64), return_host=False, device="cpu")
    assert isinstance(dev.occ, torch.Tensor) and dev.occ.dtype == torch.int32
    assert isinstance(dev.bitmaps, torch.Tensor) and isinstance(dev.dollar_pos, np.ndarray)
    np.testing.assert_array_equal(lut_fingerprint(dev, 4), lut_fingerprint(host, 4))
    queries = generate_reads(codes, 25, 64, seed=7)  # 25 - 4 is odd: a k=1 tail round
    eng = SearchEngine(dev, "cpu", lut_m=4, tail_index=tail)
    np.testing.assert_array_equal(eng.search(queries), search_oracle(host, queries, tail_index=derive_tail(host)))
    loc = bd.build_locate_device(codes, sample_rate=8, d=64, return_host=False, device="cpu")
    assert isinstance(loc.samples, torch.Tensor)
    rows = rng.integers(0, 20001, size=500)
    np.testing.assert_array_equal(LocateEngine(loc, "cpu").locate_rows(rows),
                                  locate_oracle(build_locate(codes, sample_rate=8, d=64), rows))


def test_size_guard(monkeypatch):
    monkeypatch.setattr(sa_device, "MAX_DEVICE_BASES", 100)
    codes = np.zeros(101, dtype=np.uint8)
    for build in (lambda: sa_device.suffix_array_device(codes, device="cpu"),
                  lambda: sa_device.suffix_array_device_arr(torch.from_numpy(codes)),
                  lambda: bd.build_index_device(codes, IndexConfig(k=2, d=32), device="cpu"),
                  lambda: bd.build_index_device(codes, IndexConfig(k=2, d=32),
                                                sa_dev=torch.zeros(102, dtype=torch.int32),
                                                codes_dev=torch.from_numpy(codes)),
                  lambda: bd.build_locate_device(codes, sample_rate=4, d=32, device="cpu")):
        with pytest.raises(ValueError, match="100"):
            build()
    assert sa_device.suffix_array_device(codes[:100], device="cpu").shape == (101,)
    assert sa_device.MAX_DEVICE_BASES < 2**31 - 1  # the key holds a rank in 32 bits


def test_the_card_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    codes = np.zeros(40, dtype=np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        bd.build_index_device(codes, IndexConfig(k=2, d=32))
    with pytest.raises(RuntimeError, match="cuda"):
        sa_device.suffix_array_device(codes)


@pytest.fixture
def ref(tmp_path):
    n = 5000
    codes = np.random.default_rng(23).integers(0, 4, size=n, dtype=np.uint8)
    path = tmp_path / "ref.fa"
    write_reference(path, decode_bases(codes))
    return codes, str(path), n


@pytest.mark.parametrize("flags,output", [
    (["--on-device"], "ref.fmi"), (["--on-device", "--tail"], "ref.fmi"), (["--sa", "device"], "ref.fmi"),
    (["--sa", "device", "--tail"], "ref.fmi"), (["--on-device", "--k", "1", "--tail"], "ref.fmi"),
    (["--on-device", "--tail"], "ref.npz")])
def test_build_on_device_writes_the_host_bytes(tmp_path, monkeypatch, ref, flags, output):
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)  # an .npz's zip members carry it
    _, fa, n = ref
    outs = {}
    for name, more in (("host", [a for a in flags if a not in ("--on-device", "--sa", "device")]),
                       ("device", [*flags, "--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        run = torch_cli.main(["build", fa, str(n), "--k", "3", "--d", "64", *more, "--output", str(d / output)])
        outs[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert outs["device"] == outs["host"]
    assert any(p.endswith(".tail.npz") for p in outs["device"]) == ("--tail" in flags)
    assert run.index.bwtsize == n + 1


@pytest.fixture
def reads(tmp_path, ref):
    codes, _, _ = ref
    path = tmp_path / "reads.qry"
    q, starts = generate_reads(codes, 31, 96, seed=3, return_starts=True)
    write_reads_fasta(path, q, starts)
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--fused", "--rc"], ["--store", "STORE"]])
def test_locate_on_device_writes_the_host_bytes(tmp_path, ref, reads, extra):
    """``locate --on-device --device cpu`` against the port's host build and
    ``tpufm locate --on-device``: the .pos files (and .rc, and the stores)
    byte for byte."""
    _, fa, n = ref
    common = [fa, str(n), reads, "31", "96", "--k", "3", "--d", "64", "--sample-rate", "8", "--lut", "6"]
    outs = {}
    for name, main, flags in (("host", torch_cli.main, ["--device", "cpu"]),
                              ("device", torch_cli.main, ["--on-device", "--device", "cpu"]),
                              ("tpufm", jax_cli.main, ["--on-device"])):
        d = tmp_path / name
        d.mkdir()
        more = [str(d / "S") if a == "STORE" else a for a in extra]
        main(["locate", *common, *more, *flags, "--output", str(d / "r.pos")])
        outs[name] = {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}
    assert outs["device"] == outs["host"] == outs["tpufm"]
    assert ("r.pos.rc" in outs["device"]) == ("--rc" in extra)


def test_align_on_device_writes_the_host_bytes(tmp_path, ref, capsys):
    codes, fa, _ = ref
    fq = tmp_path / "r.fq"
    q = generate_reads(codes, 40, 48, seed=5)
    fq.write_text("".join(f"@r{i}\n{decode_bases(r).decode()}\n+\n{'I' * 40}\n" for i, r in enumerate(q)))
    outs = {}
    for name, argv in (("host", ["--device", "cpu"]), ("device", ["--on-device", "--device", "cpu"])):
        torch_cli.main(["align", fa, str(fq), "--sample-rate", "8", "-o", str(tmp_path / f"{name}.sam"), *argv])
        outs[name] = (tmp_path / f"{name}.sam").read_bytes()
    jax_cli.main(["align", fa, str(fq), "--sample-rate", "8", "--on-device", "-o", str(tmp_path / "tpufm.sam")])
    assert outs["device"] == outs["host"] == (tmp_path / "tpufm.sam").read_bytes()
    assert outs["device"].count(b"\n@") >= 1


def _chip_smoke(monkeypatch):
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_suffix_array_check(monkeypatch):
    """chip_smoke's full check of a suffix array (a permutation whose
    neighbouring rows have increasing 32-base prefixes, ties compared to
    the end) passes the suffix array and fails it with two rows swapped
    or a row repeated, on repetitive and random texts."""
    chip_smoke = _chip_smoke(monkeypatch)
    rng = np.random.default_rng(9)
    for codes in (rng.integers(0, 4, size=3000, dtype=np.uint8), np.tile(np.array([0, 1], np.uint8), 150),
                  np.zeros(70, dtype=np.uint8)):
        sa = torch.from_numpy(suffix_array(codes).astype(np.int32))
        cd = torch.from_numpy(codes)
        assert chip_smoke.check_suffix_array(cd, sa) >= 0
        for i, j in ((5, 6), (0, codes.shape[0]), (40, 41)):
            bad = sa.clone()
            bad[[i, j]] = bad[[j, i]]
            with pytest.raises(AssertionError):
                chip_smoke.check_suffix_array(cd, bad)
        bad = sa.clone()
        bad[3] = bad[4]
        with pytest.raises(AssertionError):
            chip_smoke.check_suffix_array(cd, bad)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_chip_smoke_k7_sectors_count_the_text_reads(monkeypatch, k):
    """The 32-byte sectors of K7's text reads, against a loop: each position
    reads T[(SA[p] - 1 - i) mod (n + 1)] for i < k, nothing at the '$'."""
    chip_smoke = _chip_smoke(monkeypatch)
    codes = np.random.default_rng(k).integers(0, 4, size=300, dtype=np.uint8)
    sa = suffix_array(codes)
    n = codes.shape[0]
    want = 0
    for s in sa:
        sectors = {((s - 1 - i) % (n + 1)) // 32 for i in range(k) if (s - 1 - i) % (n + 1) != n}
        want += len(sectors)
    assert chip_smoke.k7_text_sectors(torch.from_numpy(sa.astype(np.int32)), n, k) == want


@pytest.mark.parametrize("k,d,n", [(1, 32, 0), (3, 192, 1000), (4, 64, 127), (6, 960, 2000)])
def test_chip_smoke_k7_bytes_are_the_wrappers_io(monkeypatch, k, d, n):
    """chip_smoke's bytes bound of K7 is what ``build_tables`` takes and
    gives: the byte text and the suffix array in, the counts, planes (row
    E included) and '$' positions out."""
    chip_smoke = _chip_smoke(monkeypatch)
    codes = torch.from_numpy(np.random.default_rng(n).integers(0, 4, size=n, dtype=np.uint8))
    sa = torch.from_numpy(suffix_array(codes.numpy()).astype(np.int32))
    io = codes.nbytes + sa.nbytes + sum(t.nbytes for t in bd.build_tables(codes, sa, k, d))
    assert chip_smoke.k7_bytes(n, k, d) == io


@pytest.mark.parametrize("k", [1, 3, 8])
def test_chip_smoke_k7_packed_sectors_count_the_window_reads(monkeypatch, k):
    """The 32-byte sectors of the 2-bit packed text (128 bases a sector)
    that K7's windows touch, against a loop: a position's symbols
    T[(SA[p] - 1 - i) mod (n + 1)], i < k, nothing at the '$'."""
    chip_smoke = _chip_smoke(monkeypatch)
    codes = np.random.default_rng(k).integers(0, 4, size=700, dtype=np.uint8)
    sa = suffix_array(codes)
    n = codes.shape[0]
    want = 0
    for s in sa:
        sectors = {((s - 1 - i) % (n + 1)) // 128 for i in range(k) if (s - 1 - i) % (n + 1) != n}
        want += len(sectors)
    assert chip_smoke.k7_text_sectors(torch.from_numpy(sa.astype(np.int32)), n, k, bases_per_sector=128) == want
