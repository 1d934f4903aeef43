"""The port's SearchEngine on the CPU against the JAX engine
(XLAEngine.search) and the numpy oracle (search_oracle). Inputs are made
with numpy from a seed and handed to both; intervals are integers and
compare exactly (tolerance 0)."""

import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index, derive_tail
from tpufm.index.layouts import make_alt_counters
from tpufm_torch import SearchEngine

_D = {1: 32, 2: 64, 3: 192}


def _mk(rng, k, d, n=1500):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    return codes, build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")


def _queries(rng, codes, L, hits=80, misses=20):
    starts = rng.integers(0, len(codes) - L, size=hits)
    sampled = np.stack([codes[s : s + L] for s in starts])
    return np.concatenate([sampled, rng.integers(0, 4, size=(misses, L), dtype=np.uint8)])


@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_search_matches_xla_and_oracle(rng, k, lut):
    codes, index = _mk(rng, k, _D[k])
    lut_m = 2 * k if lut else 0
    queries = _queries(rng, codes, 24)
    want = XLAEngine(index, lut_m=lut_m).search(queries)
    np.testing.assert_array_equal(want, search_oracle(index, queries))

    engine = SearchEngine(index, "cpu", lut_m=lut_m)
    got = engine.search(queries)
    assert got.dtype == np.uint32 and got.shape == (100, 2)
    np.testing.assert_array_equal(got, want)
    assert (got[:80, 1] > got[:80, 0]).all()
    assert (got[80:, 1] == got[80:, 0]).any()  # absent patterns: L == R
    # any batch size, and batches streamed in several ragged waves
    for n in (1, 33):
        np.testing.assert_array_equal(engine.search(queries[:n]), want[:n])
    np.testing.assert_array_equal(engine.search(queries, wave=16), want)


def test_search_device_stays_on_device(rng):
    codes, index = _mk(rng, 2, 64)
    engine = SearchEngine(index, torch.device("cpu"), lut_m=4)
    q = torch.from_numpy(_queries(rng, codes, 24))
    iv = engine.search_device(q)
    assert isinstance(iv, torch.Tensor) and iv.dtype == torch.int64
    assert iv.device == engine.device and tuple(iv.shape) == (100, 2)
    np.testing.assert_array_equal(iv.numpy(), search_oracle(index, q.numpy()))


@pytest.mark.parametrize(
    "k,d,L,lut_m,tail_d",
    [(3, 64, 13, 0, None), (2, 32, 11, 0, None), (3, 32, 31, 6, None),
     (3, 192, 151, 6, None), (3, 64, 17, 0, 128)],
)
def test_any_length_matches_xla_and_oracle(rng, k, d, L, lut_m, tail_d):
    codes, index = _mk(rng, k, d)
    tail = (
        derive_tail(index)
        if tail_d is None
        else build_index(codes, IndexConfig(k=1, d=tail_d), sa_method="doubling")
    )
    queries = _queries(rng, codes, L, hits=48, misses=16)
    got = SearchEngine(index, "cpu", lut_m=lut_m, tail_index=tail).search(queries, wave=20)
    np.testing.assert_array_equal(got, search_oracle(index, queries, tail_index=tail))
    np.testing.assert_array_equal(
        got, XLAEngine(index, lut_m=lut_m, tail_index=tail).search(queries)
    )
    assert (got[:48, 1] > got[:48, 0]).all()


def test_alt_counters_index_searches_its_base(rng):
    """An alternate-counters index gives its base's intervals; the engine
    searches it on its slim counters, as XLAEngine does (it searched the
    base's fused rows until the alternate-counters rounds were ported)."""
    codes, index = _mk(rng, 2, 64)
    queries = _queries(rng, codes, 24)
    engine = SearchEngine(make_alt_counters(index), "cpu")
    assert engine.alt_counters and engine.entries is None
    got = engine.search(queries)
    np.testing.assert_array_equal(got, search_oracle(make_alt_counters(index), queries))


def test_search_argument_errors(rng):
    codes, index = _mk(rng, 3, 64)
    with pytest.raises(ValueError, match="multiple of k"):
        SearchEngine(index, "cpu", lut_m=4)
    with pytest.raises(ValueError, match="k=1"):
        SearchEngine(index, "cpu", tail_index=index)
    _, other = _mk(rng, 1, 64, n=1400)
    with pytest.raises(ValueError, match="bwtsize"):
        SearchEngine(index, "cpu", tail_index=other)
    engine = SearchEngine(index, "cpu", lut_m=6)
    with pytest.raises(ValueError, match="tail_index"):
        engine.search(_queries(rng, codes, 13))
    with pytest.raises(ValueError, match="shorter than lut_m"):
        engine.search(_queries(rng, codes, 3))
    with pytest.raises(ValueError, match="uint8"):
        engine.search_device(torch.zeros((2, 12), dtype=torch.int64))
    with pytest.raises(ValueError, match="device"):
        SearchEngine(index, "meta")


def test_cuda_request_without_gpu_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the request is legitimate here")
    _, index = _mk(rng, 2, 64, n=300)
    with pytest.raises(RuntimeError, match="cuda"):
        SearchEngine(index, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        SearchEngine(index, torch.device("cuda", 0))
