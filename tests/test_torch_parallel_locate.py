"""The port's mesh locate (tpufm_torch.parallel.locate) on CPU shards against
tpufm's on its virtual CPU devices (tests/conftest.py: 8), at small sizes:
``DataParallelLocate`` (``locate_rows``, ``locate_hits``) and
``DataParallelSearchLocate`` (``search_locate`` with and without a LUT,
``locate_mismatch``, ``locate_approx`` at m = 2 and 3, ``locate_edits`` at
E = 1 and 2) over meshes of 4 and 8, on batches of 0, fewer than the
shards, and off the mesh multiple; the text cache across an edit of the
text; ``PairedEndEngine(mesh=...)`` with every position source; and the
engines driven by tpufm's own replicated tables. The cases mirror
tests/test_parallel.py, test_seed.py, test_edit.py and test_paired.py.
Inputs come from numpy seeds; positions, intervals, counts and flags are
integers and compare exactly (tolerance 0). tpufm's results are computed
once a module (``functools.lru_cache``): its shard_map programs compile per
shape."""

import functools

import jax
import numpy as np
import pytest

from tpufm.config import IndexConfig as JaxConfig
from tpufm.engine.paired import PairedEndEngine as JaxPaired
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.locate import build_locate as jax_build_locate
from tpufm.index.suffix_array import suffix_array
from tpufm.parallel import DataParallelLocate as JaxDPL
from tpufm.parallel import DataParallelSearchLocate as JaxDPSL
from tpufm.parallel import make_mesh as jax_make_mesh
from tpufm.utils.encoding import reverse_complement
from tpufm_torch import tables_from_jax
from tpufm_torch.engine.edit import EditExtendEngine
from tpufm_torch.engine.locate import LocateEngine, locate_tables_from_jax
from tpufm_torch.engine.paired import PairedEndEngine
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.seed import SeedExtendEngine
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.locate import build_locate
from tpufm_torch.parallel import DataParallelLocate, DataParallelSearchLocate, make_mesh

N, K, D, S, L, B = 3000, 2, 64, 8, 30, 37
MAX_HITS, SEED_HITS = 8, 16
MESHES = [4, 8]


@functools.lru_cache(maxsize=None)
def _text():
    """(codes, tpufm's index and locate tables, the port's) of one seeded
    text, from one suffix sort."""
    codes = np.random.default_rng(11).integers(0, 4, size=N, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    return (codes, jax_build_index(codes, JaxConfig(k=K, d=D), sa=sa), jax_build_locate(codes, sample_rate=S, d=D, sa=sa),
            build_index(codes, IndexConfig(k=K, d=D), sa=sa), build_locate(codes, sample_rate=S, d=D, sa=sa))


def _reads(kind: str, n: int = B, seed: int = 2) -> np.ndarray:
    """n reads of L bp: windows of the text ("exact"), with one or two
    substitutions in every other read ("sub1", "sub2"), or with one or two
    mixed edits ("edit1", "edit2"); the last quarter random."""
    codes = _text()[0]
    rng = np.random.default_rng(seed)
    edits = int(kind[-1]) if kind != "exact" else 0
    starts = rng.integers(0, N - L - edits, size=n)
    reads = []
    for i, s0 in enumerate(starts):
        w = list(codes[s0:s0 + L + edits])
        for _ in range(edits if i % 2 == 0 else 0):
            p = int(rng.integers(0, len(w) - 1))
            op = 0 if kind.startswith("sub") else int(rng.integers(0, 3))
            if op == 0:
                w[p] = (w[p] + int(rng.integers(1, 4))) & 3
            elif op == 1:
                del w[p]
            else:
                w.insert(p, int(rng.integers(0, 4)))
        reads.append(w[:L])
    reads = np.asarray(reads, np.uint8).reshape(n, L)
    reads[3 * n // 4:] = rng.integers(0, 4, size=(n - 3 * n // 4, L), dtype=np.uint8)
    return reads


@functools.lru_cache(maxsize=None)
def _jax_dpsl(mesh: int, lut: int):
    _, jidx, jloc, _, _ = _text()
    return JaxDPSL(jidx, jloc, jax_make_mesh(mesh), max_hits=MAX_HITS, lut_m=lut)


@functools.lru_cache(maxsize=None)
def _torch_dpsl(mesh: int, lut: int):
    _, _, _, tidx, tloc = _text()
    return DataParallelSearchLocate(tidx, tloc, make_mesh(mesh, device="cpu"), max_hits=MAX_HITS, lut_m=lut)


@functools.lru_cache(maxsize=None)
def _want(mesh: int, lut: int, method: str, kind: str, n: int, dist: int = 0):
    """tpufm's result of ``method`` on ``_reads(kind, n)``, once a module."""
    codes, eng = _text()[0], _jax_dpsl(mesh, lut)
    q = _reads(kind, n)
    if method == "search_locate":
        return eng.search_locate(q)
    if method == "locate_mismatch":
        return eng.locate_mismatch(q)
    return getattr(eng, method)(q, codes, dist, seed_hits=SEED_HITS)


def _got(mesh: int, lut: int, method: str, kind: str, n: int, dist: int = 0):
    codes, eng = _text()[0], _torch_dpsl(mesh, lut)
    q = _reads(kind, n)
    if method in ("search_locate", "locate_mismatch"):
        return getattr(eng, method)(q)
    return getattr(eng, method)(q, codes, dist, seed_hits=SEED_HITS)


def _equal(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("n", [1001, 7, 0], ids=["off-multiple", "fewer-than-shards", "empty"])
def test_locate_rows_match_tpufm(mesh, n):
    _, _, jloc, _, tloc = _text()
    rows = np.random.default_rng(n).integers(0, N + 1, size=n, dtype=np.uint32)
    got = DataParallelLocate(tloc, make_mesh(mesh, device="cpu")).locate_rows(rows)
    if n:
        _equal(got, JaxDPL(jloc, jax_make_mesh(mesh)).locate_rows(rows))
    assert got.shape == (n,) and got.dtype == np.uint32


@pytest.mark.parametrize("mesh", MESHES)
def test_locate_rows_in_waves_and_hits(mesh):
    """Waves of 5 rows a shard (the last padded with row 0), then the hits
    of tpufm's intervals, equal to tpufm's and to the one-device walk."""
    _, _, jloc, _, tloc = _text()
    rows = np.random.default_rng(5).integers(0, N + 1, size=203, dtype=np.uint32)
    dpl = DataParallelLocate(tloc, make_mesh(mesh, device="cpu"))
    want = LocateEngine(tloc, "cpu").locate_rows(rows)
    _equal(dpl.locate_rows(rows, wave=5 * mesh + 1), want)
    _equal(dpl.locate_rows(rows), JaxDPL(jloc, jax_make_mesh(mesh)).locate_rows(rows))
    iv = _want(mesh, 0, "search_locate", "exact", B)[0]
    _equal(dpl.locate_hits(iv, MAX_HITS), JaxDPL(jloc, jax_make_mesh(mesh)).locate_hits(iv, MAX_HITS))
    _equal(dpl.locate_hits(iv, MAX_HITS), _want(mesh, 0, "search_locate", "exact", B)[1])
    with pytest.raises(ValueError, match=f"batch 7 not divisible by mesh size {mesh}"):
        dpl.place_rows(rows[:7])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("lut", [0, 2])
@pytest.mark.parametrize("n", [B, 3, 0], ids=["off-multiple", "fewer-than-shards", "empty"])
def test_search_locate_matches_tpufm(mesh, lut, n):
    _equal(_got(mesh, lut, "search_locate", "exact", n), _want(mesh, lut, "search_locate", "exact", n))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("n", [B, 3, 0], ids=["off-multiple", "fewer-than-shards", "empty"])
def test_locate_mismatch_matches_tpufm(mesh, n):
    _equal(_got(mesh, 2, "locate_mismatch", "sub1", n), _want(mesh, 2, "locate_mismatch", "sub1", n))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("n", [B, 3, 0], ids=["off-multiple", "fewer-than-shards", "empty"])
def test_locate_approx_matches_tpufm(mesh, m, n):
    got = _got(mesh, 0, "locate_approx", "sub2", n, m)
    _equal(got, _want(mesh, 0, "locate_approx", "sub2", n, m))
    if n == B:
        _, _, _, tidx, tloc = _text()
        one = SeedExtendEngine(tidx, tloc, _text()[0], mismatches=m, seed_hits=SEED_HITS, max_hits=MAX_HITS,
                               device="cpu")
        _equal(got, one.locate_approx(_reads("sub2")))
        assert got[1].sum() > 0


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("n", [B, 3, 0], ids=["off-multiple", "fewer-than-shards", "empty"])
def test_locate_edits_matches_tpufm(mesh, E, n):
    got = _got(mesh, 2, "locate_edits", f"edit{E}", n, E)
    _equal(got, _want(mesh, 2, "locate_edits", f"edit{E}", n, E))
    if n == B:
        _, _, _, tidx, tloc = _text()
        one = EditExtendEngine(tidx, tloc, _text()[0], edits=E, seed_hits=SEED_HITS, max_hits=MAX_HITS, lut_m=2,
                               device="cpu")
        _equal(got, one.locate_edits(_reads(f"edit{E}")))
        assert got[1].sum() > 0


@pytest.mark.parametrize("method", ["locate_approx", "locate_edits"])
def test_text_edited_between_calls(method):
    """One base of the text edited in place between two calls of the same
    key: the second call verifies against the edited text (a new cache
    entry, its CRC32 differs), as tpufm's does; the colocated shards of a
    device share one engine; the cache holds at most four entries."""
    codes = _text()[0].copy()
    q = _reads("sub2" if method == "locate_approx" else "edit2")
    eng = DataParallelSearchLocate(*_text()[3:], make_mesh(4, device="cpu"), max_hits=MAX_HITS)
    jeng = _jax_dpsl(4, 0)
    first = getattr(eng, method)(q, codes, 2, seed_hits=SEED_HITS)
    _equal(first, getattr(jeng, method)(q, codes, 2, seed_hits=SEED_HITS))
    codes[:] = (codes + 1) & 3  # every base edited, in the same array
    edited = getattr(eng, method)(q, codes, 2, seed_hits=SEED_HITS)
    _equal(edited, getattr(jeng, method)(q, codes, 2, seed_hits=SEED_HITS))
    assert edited[1].sum() < first[1].sum()
    assert len(eng._approx_cache) == 2
    engines = next(iter(eng._approx_cache.values()))
    assert len(engines) == 4 and all(e is engines[0] for e in engines)
    assert engines[0].search_engine is eng.engines[0].search_engine
    for sh in range(1, 4):
        getattr(eng, method)(q[:5], codes, 2, seed_hits=SEED_HITS + sh)
    assert len(eng._approx_cache) == 1  # cleared at four entries, then the new one


@functools.lru_cache(maxsize=None)
def _pairs(seed: int = 4, n: int = 13, L1: int = L, L2: int = L, imin: int = 60, imax: int = 200):
    """FR pairs on alternating strands, the R1 of every third pair with one
    substitution."""
    codes = _text()[0]
    rng = np.random.default_rng(seed)
    r1 = np.empty((n, L1), np.uint8)
    r2 = np.empty((n, L2), np.uint8)
    for i in range(n):
        f = int(rng.integers(max(imin, L1, L2), imax + 1))
        s0 = int(rng.integers(0, N - f))
        if i % 2 == 0:
            r1[i], r2[i] = codes[s0:s0 + L1], reverse_complement(codes[s0 + f - L2:s0 + f][None])[0]
        else:
            r1[i] = reverse_complement(codes[s0 + f - L1:s0 + f][None])[0]
            r2[i] = codes[s0:s0 + L2]
    r1[::3, L1 // 2] = (r1[::3, L1 // 2] + 1) % 4
    return r1, r2


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("source", [{}, {"mismatches": 1}, {"mismatches": 2}, {"edits": 1}],
                         ids=["exact", "hamming1", "seed-m2", "edit-e1"])
def test_paired_mesh_source_matches_tpufm(mesh, source):
    codes, jidx, jloc, tidx, tloc = _text()
    r1, r2 = _pairs()
    text = codes if source.get("mismatches", 0) >= 2 or source.get("edits") else None
    kw = dict(max_hits=MAX_HITS, max_pairs=4, lut_m=2, seed_hits=SEED_HITS, text=text, **source)
    want = JaxPaired(jidx, jloc, 60, 200, mesh=jax_make_mesh(mesh), **kw).pair(r1, r2)
    eng = PairedEndEngine(tidx, tloc, 60, 200, mesh=make_mesh(mesh, device="cpu"), **kw)
    got = eng.pair(r1, r2)
    _equal(got, want)
    _equal(got, PairedEndEngine(tidx, tloc, 60, 200, device="cpu", **kw).pair(r1, r2))
    assert got[2].sum() > 0 and eng.device.type == "cpu"


def test_paired_mesh_mates_of_two_lengths():
    codes, jidx, jloc, tidx, tloc = _text()
    r1, r2 = _pairs(seed=6, n=9, L2=L + 5)
    want = JaxPaired(jidx, jloc, 60, 200, mesh=jax_make_mesh(4), max_hits=MAX_HITS, lut_m=2).pair(r1, r2)
    _equal(PairedEndEngine(tidx, tloc, 60, 200, mesh=make_mesh(4, device="cpu"), max_hits=MAX_HITS,
                           lut_m=2).pair(r1, r2), want)


@pytest.mark.parametrize("mesh", MESHES)
def test_engines_from_tpufm_replicated_tables(mesh):
    """The port's mesh engines on tpufm's own replicated state
    (``jax.device_get`` of its engine's tables, LUT included): the same
    positions as tpufm's engine."""
    jeng = _jax_dpsl(mesh, 2)
    tables = tables_from_jax(jax.device_get(jeng.tables))
    loc_tables = locate_tables_from_jax(jax.device_get(jeng.loc_tables), d=D, sample_rate=S)
    eng = DataParallelSearchLocate(tables, loc_tables, make_mesh(mesh, device="cpu"), max_hits=MAX_HITS)
    assert eng.lut_m == 2 and all(e.search_engine.lut_m == 2 for e in eng.engines)
    _equal(eng.search_locate(_reads("exact")), _want(mesh, 2, "search_locate", "exact", B))
    _equal(eng.locate_mismatch(_reads("sub1")), _want(mesh, 2, "locate_mismatch", "sub1", B))
    _equal(DataParallelLocate(loc_tables, make_mesh(mesh, device="cpu")).locate_hits(
        _want(mesh, 2, "search_locate", "exact", B)[0], MAX_HITS), _want(mesh, 2, "search_locate", "exact", B)[1])


def test_one_table_set_a_device_and_the_waves():
    """Colocated shards share one engine (and its LUT, built once); the
    waves of a small ``wave`` give the one-device engine's results; the
    refusals are tpufm's words."""
    codes, _, _, tidx, tloc = _text()
    eng = DataParallelSearchLocate(tidx, tloc, make_mesh(4, device="cpu"), max_hits=MAX_HITS, lut_m=2)
    assert all(e is eng.engines[0] for e in eng.engines) and eng.WAVE_PER_CHIP == 1 << 15
    assert (eng.bwtsize, eng.config.k, eng.config.d, eng.k, eng.d) == (N + 1, K, D, K, D)
    one = SearchLocateEngine(tidx, tloc, "cpu", max_hits=MAX_HITS, lut_m=2)
    q = _reads("exact", 61)
    _equal(eng.search_locate(q, wave=9), one.search_locate(q))
    _equal(eng.locate_mismatch(q, wave=9), one.locate_mismatch(q))
    _equal(eng.locate_approx(q, codes, 2, seed_hits=SEED_HITS, wave=9),
           SeedExtendEngine(tidx, tloc, codes, mismatches=2, seed_hits=SEED_HITS, max_hits=MAX_HITS, lut_m=2,
                            device="cpu").locate_approx(q))
    with pytest.raises(ValueError, match="^lut_m=3 must be a multiple of k=2$"):
        DataParallelSearchLocate(tidx, tloc, make_mesh(2, device="cpu"), lut_m=3)
    with pytest.raises(ValueError, match="^lut_m=3 must be a multiple of k=2$"):
        JaxDPSL(_text()[1], _text()[2], jax_make_mesh(2), lut_m=3)
