"""K1's pair entry (``lf_round_pairs``: one read per thread, both ends under
one code) and the device-side row padding, against the JAX package.

The pair entry's plain path goes against the Pallas round kernel
make_lf_round in interpret mode (on the flattened ends, each read's code
repeated) and against lf_step_fused, XLAEngine's round on [B, 2] intervals;
the engines that run on the padded device rows (k=3 d=32 search tables, 70
words padded to 72; locate rows, 3*nb + 5 words padded to a multiple of 4)
go against XLAEngine, LocateEngine and SearchLocateEngine. Inputs are made
with numpy from a seed and handed to both sides; results are integers and
compare exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine import xla
from tpufm.engine.pallas_kernel import make_lf_round
from tpufm.index import locate as jloc
from tpufm.index import store as jstore
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.suffix_array import suffix_array
from tpufm_torch import SearchEngine
from tpufm_torch.engine import lf_round as lf_mod
from tpufm_torch.engine.locate import LocateEngine
from tpufm_torch.engine.search import _rows
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.tables import tables_from_index
from tpufm_torch.host import formats
from tpufm_torch.host import locate as host_loc
from tpufm_torch.host.index import IndexConfig, build_index


def pair_ends(rng, bwtsize: int, d: int, dollar_pos, dollar_base, k: int, n: int):
    """Seeded reads (lo, hi) over [0, bwtsize] and one code each: a third
    with both ends in one block (a few with lo == hi), a third in two
    blocks, and, first, reads around each '$' (both ends in its block, one
    before and one after it, the '$' k-mer as code), plus a read ending at
    bwtsize."""
    lo = rng.integers(0, bwtsize + 1, size=n)
    span = rng.integers(0, d, size=n)
    same = np.minimum(lo - lo % d + span, bwtsize)  # in lo's block (or at bwtsize)
    far = rng.integers(0, bwtsize + 1, size=n)
    kind = np.arange(n) % 3
    hi = np.where(kind == 0, same, np.where(kind == 1, far, np.maximum(lo, same)))
    hi[:: 7] = lo[:: 7]
    code = rng.integers(0, 4**k, size=n)
    j = 0
    for pos, base in zip(np.asarray(dollar_pos, np.int64), np.asarray(dollar_base)):
        start = pos // d * d
        lo[j], hi[j] = start + rng.integers(0, pos - start + 1), min(pos + 1 + rng.integers(0, d), start + d - 1, bwtsize)
        code[j] = base
        j += 1
    lo[j], hi[j] = max(bwtsize - 3, 0), bwtsize
    iv = np.stack([np.minimum(lo, hi), np.maximum(lo, hi)], axis=1)
    return iv.astype(np.int64), code.astype(np.int64)


@pytest.mark.parametrize("d", [32, 64, 192])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_lf_round_pairs_matches_pallas_and_xla(rng, k, d):
    codes = rng.integers(0, 4, size=13 * d - 1, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")
    t = tables_from_index(index)
    n = 131  # odd
    iv, code = pair_ends(rng, index.bwtsize, d, index.dollar_pos, index.dollar_base, k, n)
    entries = _rows(t.entries, torch.device("cpu"))  # the engine's padded device copy
    before = lf_mod.PAIRS_LAUNCHES
    got = lf_mod.lf_round_pairs(entries, torch.from_numpy(iv), torch.from_numpy(code),
                                torch.from_numpy(t.dollar.astype(np.int64)), k, d).numpy()
    assert lf_mod.PAIRS_LAUNCHES == before  # the plain path on the CPU
    assert got.shape == (n, 2)

    flat = iv.reshape(-1).astype(np.uint32)
    pallas = make_lf_round(k, d, tile=64, interpret=True)(
        jnp.asarray(t.entries[flat // d]), jnp.asarray(flat),
        jnp.asarray(np.repeat(code, 2).astype(np.uint32)), jnp.asarray(t.dollar),
    )
    np.testing.assert_array_equal(got.reshape(-1), np.asarray(pallas))
    jt = {
        "entries": jnp.asarray(t.entries),
        "dollar_pos": jnp.asarray(index.dollar_pos),
        "dollar_base": jnp.asarray(index.dollar_base),
        "dollar_block": jnp.asarray(index.dollar_block.astype(np.uint32)),
    }
    fused = lf_step_fused_pairs(jt, k, d, iv, code)
    np.testing.assert_array_equal(got, fused)

    # the reads reach what they are meant to: both kinds of pair, and a '$'
    # correction that fires
    same = iv[:, 0] // d == iv[:, 1] // d
    assert same.any() and (~same).any() and (iv[:, 0] == iv[:, 1]).any()
    hits = (
        ((iv // d)[..., None] == index.dollar_block)
        & (code[:, None, None] == index.dollar_base)
        & (iv[..., None] > index.dollar_pos)
    )
    assert hits.any()


def lf_step_fused_pairs(jt, k, d, iv, code):
    return np.asarray(xla.lf_step_fused(jt, (k, d, d // 32), jnp.asarray(iv.astype(np.uint32)),
                                        jnp.asarray(code.astype(np.uint32))))


def test_lf_round_pairs_rejects_bad_shapes():
    entries = torch.zeros((5, 24), dtype=torch.int32)
    dollar = torch.zeros((3, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        lf_mod.lf_round_pairs(entries, torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64),
                              dollar, 2, 64)
    with pytest.raises(ValueError, match=r"code \[N\], got \(8, 2\) and \(16,\)"):
        lf_mod.lf_round_pairs(entries, torch.zeros((8, 2), dtype=torch.int64), torch.zeros(16, dtype=torch.int64),
                              dollar, 2, 64)
    with pytest.raises(ValueError, match="one end per code"):
        lf_mod.lf_round(entries, torch.zeros((8, 2), dtype=torch.int64), torch.zeros(8, dtype=torch.int64),
                        dollar, 2, 64)
    out = lf_mod.lf_round_pairs(entries, torch.zeros((0, 2), dtype=torch.int64), torch.zeros(0, dtype=torch.int64),
                                dollar, 2, 64)
    assert out.shape == (0, 2) and out.dtype == torch.int64


def _text(n, seed=5):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    return codes, suffix_array(codes, method="doubling")


def _reads(codes, L, n, seed):
    starts = np.random.default_rng(seed).integers(0, len(codes) - L, size=n)
    return np.stack([codes[s : s + L] for s in starts])


@pytest.mark.parametrize("L,lut_m", [(24, 0), (25, 6)])
def test_padded_search_rows_give_xla_intervals(L, lut_m):
    """k=3 d=32 rows are 70 words on the host and 72 on the device."""
    codes, sa = _text(3000)
    ours = build_index(codes, IndexConfig(k=3, d=32), sa=sa)
    theirs = jax_build_index(codes, JaxIndexConfig(k=3, d=32), sa=sa)
    tail = host_loc.build_locate(codes, sample_rate=8, d=32, sa=sa).lf1 if L % 3 else None
    engine = SearchEngine(ours, "cpu", lut_m=lut_m, tail_index=tail)
    assert tables_from_index(ours).entries.shape[1] == 70
    assert engine.entries.shape[1] == 72 and not engine.entries[:, 70:].any()
    queries = _reads(codes, L, 40, seed=L)
    jtail = jloc.build_locate(codes, 8, 32, sa=sa).lf1 if L % 3 else None
    np.testing.assert_array_equal(engine.search(queries),
                                  xla.XLAEngine(theirs, lut_m=lut_m, tail_index=jtail).search(queries))


@pytest.mark.parametrize("d", [32, 192])
def test_padded_locate_rows_give_jax_positions(d):
    """Locate rows are 3*nb + 5 words on the host (8 at d=32, 23 at d=192)
    and a multiple of 4 on the device; the walk, the fused search+locate
    (the rows as its k=1 tail) and the Hamming <= 1 locate give tpufm's
    positions."""
    codes, sa = _text(4000, seed=d)
    jidx = jax_build_index(codes, JaxIndexConfig(k=3, d=192), sa=sa)
    idx = build_index(codes, IndexConfig(k=3, d=192), sa=sa)
    jl = jloc.build_locate(codes, sample_rate=8, d=d, sa=sa)
    loc = host_loc.build_locate(codes, sample_rate=8, d=d, sa=sa)
    walker = LocateEngine(loc, "cpu")
    width = 3 * (d // 32) + 5
    assert walker.rows.shape[1] == -(-width // 4) * 4 and not walker.rows[:, width:].any()
    rows = np.random.default_rng(d).permutation(4001).astype(np.uint32)
    np.testing.assert_array_equal(walker.locate_rows(rows), xla.LocateEngine(jl).locate_rows(rows))
    queries = _reads(codes, 31, 30, seed=d)  # 31 % 3: one tail round on the locate rows
    engine = SearchLocateEngine(idx, loc, "cpu", max_hits=5)
    jengine = xla.SearchLocateEngine(jidx, jl, max_hits=5)
    for ours, theirs in zip(engine.search_locate(queries), jengine.search_locate(queries)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(engine.locate_mismatch(queries[:, :10]), jengine.locate_mismatch(queries[:, :10]))


def test_save_store_unchanged_by_device_padding(tmp_path):
    """The padding lives only in the engines' device copies: the stores the
    port writes after building its engines are byte-identical to tpufm's."""
    codes, sa = _text(2000)
    idx = build_index(codes, IndexConfig(k=3, d=32), sa=sa)
    loc = host_loc.build_locate(codes, sample_rate=8, d=192, sa=sa)
    SearchLocateEngine(idx, loc, "cpu", max_hits=4)
    jidx = jax_build_index(codes, JaxIndexConfig(k=3, d=32), sa=sa)
    jl = jloc.build_locate(codes, sample_rate=8, d=192, sa=sa)
    for name, ours, theirs in (("search", idx, jidx), ("locate", loc, jl)):
        a = formats.save_store(tmp_path / f"port_{name}", ours)
        b = jstore.save_store(tmp_path / f"tpufm_{name}", theirs)
        assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
        for f in a.iterdir():
            assert f.read_bytes() == (b / f.name).read_bytes(), f.name
