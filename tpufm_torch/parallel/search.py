"""Multi-device search engines over a 1-D mesh (tpufm_torch.parallel.mesh).

Counterparts of tpufm/parallel/search.py, bit-identical to its engines:

``DataParallelEngine`` (:68-264): the index replicated on every shard, the
query batch split along the mesh; each shard runs a ``SearchEngine`` on its
part (K1's pair entry on the fused rows, or K8's alternate-counters entry on
``occ_slim`` for an alternate-counters index, tpufm's ``layout="split"``
branch), and the per-shard (lo, hi) results are merged at the end, 8 B a
read, every process getting the whole: the replicated out-sharding. Colocated
shards (one device repeated) share one engine and its tables, which no
search writes.

``ShardedIndexEngine`` (:500-799): the split tables cut along the entry axis
(``shard_tables``); every LF round stacks both interval ends of every read
into one request block per shard, (block, code, interval) as three uint32
words, and routes it to the shard that owns the block, whose owner answer is
K9 (``lf_answer_owned``; tpufm's ``_answer_owned``, :267-290):
- "allgather" (``_sharded_lf_step``, :293): every shard gathers all
  requests, answers its own (0 for the rest), a psum combines;
- "ring" (``_sharded_lf_step_ring``, :318): two half-blocks circulate the
  ring one hop a tick, phase-shifted, each answered by every shard on its
  way (here one after the other: the overlap of transit and answer that the
  schedule allows is not taken);
- "a2a" (``_sharded_lf_step_a2a``, :408): each shard sorts its requests by
  owner (stable), sends each owner a bucket of C = ceil(slack * B / D)
  rows, answers what it receives and sends the answers back; where a bucket
  overflows anywhere (a pmax), that round takes the allgather step. Unlike
  JAX's on-device ``lax.cond``, the branch is taken on the host: one
  device-to-host read of the flag a round.
The k=1 tail rounds run shard-locally on a replicated tail table (K1), and
the prefix LUT is built by the engine's own LUT-less sharded search.

Batches are padded to a mesh multiple by cycling their own reads (pad_cycle),
never with zeros, which would crowd one a2a bucket. The collectives
(tpufm_torch.parallel.collectives) take and return one tensor per shard.

Across processes (a mesh of ``initialize_distributed``) both engines run
SPMD: every process passes the same host batch (and builds or loads the
same index), places the parts of the shards it owns (``put_global``'s
counterpart, tpufm/parallel/search.py:55), runs their rounds, and gets the
whole result. Shard ids stay global (K9's owner test, the query split);
"the first shard" is this process's first. Each process builds its own
copy of a data-parallel prefix LUT, bit-identical to the others'; the
sharded engine's LUT comes from its own sharded search, which every
process runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpufm_torch.bitops import from_u32_bits, to_u32_bits
from tpufm_torch.engine.codes import decode_prefix_codes, fuse_prefix_codes, fuse_round_codes
from tpufm_torch.engine.lf_round import lf_answer_owned
from tpufm_torch.engine.search import (
    SearchEngine,
    _fused_round,
    _int64,
    _rounds,
    _rows,
    _words,
    mesh_wave,
    pad_cycle,
    stream_waves,
)
from tpufm_torch.engine.tables import ShardTables, is_alt_counters, shard_tables, with_tail
from tpufm_torch.host.index import IndexConfig, KStepFMIndex
from tpufm_torch.host.seqio import VARLEN_PAD
from tpufm_torch.parallel import collectives as coll
from tpufm_torch.parallel.mesh import Mesh


def _split(queries: np.ndarray, mesh: Mesh) -> list:
    """A host batch [B, L], B a mesh multiple, cut into one part a shard,
    the parts of this process's shards each on its shard's device."""
    q = np.require(queries, np.uint8, ["C", "W"])
    per = q.shape[0] // mesh.size
    return [torch.from_numpy(q[s * per:(s + 1) * per]).to(dev) for s, dev in zip(mesh.local_shards, mesh.devices)]


def _merge(parts: list, mesh: Mesh) -> torch.Tensor:
    """Per-shard int64 results (uint32 values) -> one int64 tensor of every
    shard's, in shard order, on this process's first shard's device (every
    process gets the whole); 4 B a value cross between shards."""
    return from_u32_bits(coll.gather([to_u32_bits(p) for p in parts], mesh))


def _per_device(devices, make) -> list:
    """``make(device)`` once a distinct device, one entry a shard: colocated
    shards share read-only tables."""
    made = {}
    return [made[dev] if dev in made else made.setdefault(dev, make(dev)) for dev in devices]


class DataParallelEngine:
    """Replicated-index, batch-split search over a 1-D mesh.

    lut_m > 0 starts every read lut_m characters in from one prefix LUT,
    loaded from ``lut_cache`` (shared with tpufm and ``SearchEngine``) or
    built once on the first shard's device, and copied to the others.
    ``pad_words`` pads the fused rows; ``tail_index`` (a k=1 index over the
    same text) finishes any read length."""

    def __init__(self, index, mesh: Mesh, lut_m: int = 0, lut_cache: str | None = None,
                 pad_words: int | None = None, tail_index: KStepFMIndex | None = None):
        self.alt_counters = is_alt_counters(index)
        base = index.base if self.alt_counters else index
        if lut_m and (self.alt_counters or lut_m % base.config.k):
            raise ValueError("lut_m requires the fused layout and lut_m % k == 0")
        if tail_index is not None:
            if self.alt_counters:
                raise ValueError("tail_index is not supported with alt-counters")
            if tail_index.config.k != 1 or tail_index.bwtsize != base.bwtsize:
                raise ValueError("tail_index must be a k=1 index over the same text")
        self.mesh = mesh
        self.config = base.config
        self.k, self.d, self.bwtsize = base.config.k, base.config.d, int(base.bwtsize)
        self.lut_m = lut_m
        self._tail_d = None if tail_index is None else tail_index.config.d
        pad_words = None if self.alt_counters else pad_words
        first = []

        def make(dev):
            if first:  # the LUT is built (or loaded) once, then copied
                eng = SearchEngine(index, dev, pad_words=pad_words, tail_index=tail_index)
                if lut_m:
                    eng.lut, eng.lut_m = first[0].lut.to(dev), lut_m
                return eng
            first.append(SearchEngine(index, dev, lut_m=lut_m, lut_cache=lut_cache, pad_words=pad_words,
                                      tail_index=tail_index))
            return first[0]

        self.engines = _per_device(mesh.devices, make)

    def shard_queries(self, queries) -> list:
        """A uint8 [B, L] host batch split along the mesh, one part a shard on
        its device. B must divide evenly by the mesh size (pad the tail)."""
        n = self.mesh.size
        queries = np.asarray(queries, np.uint8)
        if queries.shape[0] % n:
            raise ValueError(f"batch {queries.shape[0]} not divisible by mesh size {n}; pad it")
        return _split(queries, self.mesh)

    def _padded(self, queries) -> tuple:
        queries = np.asarray(queries, np.uint8)
        return pad_cycle(queries, -queries.shape[0] % self.mesh.size), queries.shape[0]

    def search_device(self, queries_sharded: list, step=None) -> torch.Tensor:
        """Per-shard reads (``shard_queries``) -> int64 [B, 2] intervals on
        the first shard's device, no host sync. ``step`` as
        ``SearchEngine``'s."""
        return _merge([e.search_device(q, step) for e, q in zip(self.engines, queries_sharded)], self.mesh)

    def search(self, queries, step=None) -> np.ndarray:
        """uint8 [B, L] -> uint32 [B, 2]. A batch not divisible by the mesh
        size is padded by cycling its own reads and the answers trimmed."""
        queries, B = self._padded(queries)
        out = self.search_device(self.shard_queries(queries), step)
        return out.cpu().numpy().astype(np.uint32)[:B]

    def search_varlen(self, queries, step=None) -> np.ndarray:
        """Variable-length twin of ``search``: a right-aligned
        ``VARLEN_PAD``-padded mixed-length batch, split over the mesh, each
        shard running ``search_varlen_device`` on its part."""
        if self.alt_counters:
            raise ValueError("variable-length search rides the baseline fused layout")
        if self.k > 1 and self._tail_d is None:
            raise ValueError(
                "variable-length search needs a tail_index (k=1) — every "
                "length mix has reads with L mod k != 0"
            )
        queries = np.asarray(queries, np.uint8)
        lengths = (queries != VARLEN_PAD).sum(axis=1)
        if (lengths == 0).any():
            raise ValueError("empty read in variable-length batch")
        if self.lut_m and int(lengths.min()) < self.lut_m:
            raise ValueError(f"shortest read ({int(lengths.min())}) is below lut_m={self.lut_m}")
        queries, B = self._padded(queries)
        parts = [e.search_varlen_device(q, step) for e, q in zip(self.engines, self.shard_queries(queries))]
        return _merge(parts, self.mesh).cpu().numpy().astype(np.uint32)[:B]

    def count(self, queries, mismatches: int = 0, step=None) -> np.ndarray:
        """Occurrence counts per read over the mesh, uint32 [B]: exact, or
        within Hamming distance 1, each shard fanning its part out to the
        3L+1 variants, in waves of max(1, 2^20 // (3L+1)) reads a shard."""
        queries = np.asarray(queries, np.uint8)
        if mismatches == 0:
            iv = self.search(queries, step)
            return (iv[:, 1] - iv[:, 0]).astype(np.uint32)
        if mismatches != 1:
            raise NotImplementedError("mismatches must be 0 or 1")
        if self.alt_counters:
            raise ValueError("count(mismatches=1) requires the fused layout")
        n = self.mesh.size
        L = queries.shape[1]
        # pre-pad to a mesh multiple: the waves pad only a last wave
        queries, B = self._padded(queries)
        wave = max(1, (1 << 20) // (3 * L + 1)) * n

        def counts(q):
            return _merge([e.count_mismatch_device(p, step) for e, p in zip(self.engines, self.shard_queries(q))],
                          self.mesh)

        return stream_waves(queries, wave, counts, None)[:B]


class ShardedIndexEngine:
    """Entry-table-sharded search for indexes larger than one device.

    index: a KStepFMIndex (host numpy, or device tensors from
    ``build_index_device(return_host=False)``, cut where they lie), or
    ``ShardTables`` already cut for this mesh (e.g. ``shards_from_jax``,
    whose LUT and tail come with them). routing: "allgather" (default),
    "ring" or "a2a" (see the module docstring). lut_m > 0 starts every read
    lut_m characters in from a LUT built by this engine's own sharded
    search. Batches larger than ``wave`` stream through the mesh in waves of
    ``WAVE_PER_CHIP`` reads a shard."""

    #: reads a shard per wave; a whole wave is WAVE_PER_CHIP * mesh size
    WAVE_PER_CHIP = 1 << 17

    def __init__(self, index, mesh: Mesh, routing: str = "allgather", lut_m: int = 0,
                 tail_index: KStepFMIndex | None = None):
        if is_alt_counters(index):
            raise NotImplementedError(
                "sharded-index mode uses the baseline counter layout "
                "(a deliberate decision — docs/DISTRIBUTED.md 'Why sharded "
                "mode is baseline-layout only'); rebuild with layout="
                "'baseline' for identical results"
            )
        self.mesh = mesh
        D = mesh.size
        if tail_index is not None and (tail_index.config.k != 1 or tail_index.bwtsize != index.bwtsize):
            raise ValueError("tail_index must be a k=1 index over the same text")
        if isinstance(index, ShardTables):
            tables = index
            if tables.n_shards != D:
                raise ValueError(f"tables of {tables.n_shards} shards on a mesh of {D}")
            if tables.lut is not None:
                lut_m = (tables.lut.shape[0].bit_length() - 1) // 2
            if tail_index is not None and tables.tail_d is None:  # e.g. a per-shard store's
                tables = with_tail(tables, tail_index)
        k = index.k if isinstance(index, ShardTables) else index.config.k
        if lut_m and lut_m % k:
            raise ValueError(f"lut_m={lut_m} must be a multiple of k={k}")
        if not isinstance(index, ShardTables):
            tables = shard_tables(index, D, tail_index)
        if routing not in ("allgather", "ring", "a2a"):
            raise ValueError(f"unknown routing {routing!r}")
        self.routing = routing
        self.k, self.d, self.bwtsize, self.e_local = tables.k, tables.d, tables.bwtsize, tables.e_local
        self.config = IndexConfig(k=self.k, d=self.d)
        self.lut_m = lut_m
        devs, mine = mesh.devices, mesh.local_shards
        self.occ = [_words(tables.occ[s], dev) for s, dev in zip(mine, devs)]
        self.bitmaps = [_rows(tables.bitmaps[s], dev) for s, dev in zip(mine, devs)]
        self.dollar = _per_device(devs, lambda dev: _int64(tables.dollar, dev))
        # the k=1 tail, replicated: its rounds run on each shard's own reads
        self.tail_d = tables.tail_d
        self.tail_entries = _per_device(devs, lambda dev: _rows(tables.tail_entries, dev))
        self.tail_dollar = _per_device(devs, lambda dev: _int64(tables.tail_dollar, dev))
        #: bool [rounds]: the rounds of the last search that took the a2a
        #: fallback, ORed over its waves (all False for the other routings);
        #: last_overflow_waves: the flags of each of its waves
        self.last_overflow_rounds = None
        self.last_overflow_waves = []
        #: seconds the LUT build took (None: no LUT built here)
        self.lut_build_seconds = None
        self.lut = [None] * len(devs)
        if tables.lut is not None:
            self.lut = _per_device(devs, lambda dev: _words(tables.lut, dev))
        elif lut_m:
            t0 = time.perf_counter()
            lut = self._build_lut(lut_m)
            self.lut = _per_device(devs, lambda dev: lut.to(dev))
            for dev in set(devs):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.lut_build_seconds = time.perf_counter() - t0

    # -- one LF round, by routing: per-shard interval ends int64 [B] and
    # codes int64 [B] -> (new ends, whether the round took the a2a fallback)

    def _requests(self, ends: list, codes: list) -> list:
        """(block, code, interval) of every end, int32 [B, 3] (uint32 bits)."""
        return [to_u32_bits(torch.stack([e // self.d, c, e], dim=1)) for e, c in zip(ends, codes)]

    def _answer(self, i: int, req: torch.Tensor) -> torch.Tensor:
        """The owner answers of this process's i-th shard (global shard
        ``mesh.local_shards[i]``) to the requests ``req`` (K9)."""
        return lf_answer_owned(self.bitmaps[i], self.occ[i], req, self.mesh.local_shards[i], self.e_local,
                               self.dollar[i], self.k, self.d)

    def _step_allgather(self, ends, codes, answer):
        mesh = self.mesh
        D = mesh.size
        reqs = self._requests(ends, codes)
        B = reqs[0].shape[0]
        gathered = coll.all_gather(reqs, mesh)  # [D, B, 3] on every shard
        answers = [answer(i, g.view(D * B, 3)).view(D, B) for i, g in enumerate(gathered)]
        return [from_u32_bits(c[s]) for s, c in zip(mesh.local_shards, coll.psum(answers, mesh))], False

    def _step_ring(self, ends, codes, answer):
        D = self.mesh.size
        reqs = self._requests(ends, codes)
        B = reqs[0].shape[0]
        half = (B + 1) // 2
        if 2 * half - B:  # an odd block: one zero request row
            reqs = [torch.cat([r, r.new_zeros((1, 3))]) for r in reqs]
        ans = [r.new_zeros(2 * half) for r in reqs]

        def compute(h):  # every shard (of this process) answers half h where it lies, in place
            part = slice(h * half, (h + 1) * half)
            for i in range(len(reqs)):
                ans[i][part] += answer(i, reqs[i][part])

        def transit(h):  # half h, requests and answers, one hop along the ring
            part = slice(h * half, (h + 1) * half)
            moved_r = coll.ppermute([r[part] for r in reqs], 1, self.mesh)
            moved_a = coll.ppermute([a[part] for a in ans], 1, self.mesh)
            for i in range(len(reqs)):
                reqs[i][part], ans[i][part] = moved_r[i], moved_a[i]

        if D == 1:  # the degenerate ring: answer everything at home
            compute(0)
            compute(1)
        else:
            # tpufm's schedule: H0 and H1 start at home; each tick moves one
            # half and answers the other; H0 is home after tick 2(D-1), H1's
            # last answer and its ride home are the epilogue
            compute(0)
            transit(0)
            compute(1)
            for t in range(2, 2 * D - 1):
                transit(1 - t % 2)
                compute(t % 2)
            transit(0)
            compute(1)
            transit(1)
        return [from_u32_bits(a[:B]) for a in ans], False

    def _step_a2a(self, ends, codes, answer, slack: float = 2.0):
        D = self.mesh.size
        if D == 1:
            return self._step_allgather(ends, codes, answer)
        reqs = self._requests(ends, codes)
        B = reqs[0].shape[0]
        C = max(1, int(-(-B * slack // D)))
        owners = [(e // self.d // self.e_local).clamp(max=D - 1) for e in ends]
        counts = [torch.bincount(o, minlength=D) for o in owners]
        # a bucket overflows somewhere (every shard's copy is the same: read the first)
        if bool(coll.pmax([c.max() for c in counts], self.mesh)[0] > C):
            return self._step_allgather(ends, codes, answer)[0], True
        rows = torch.arange(C, device=reqs[0].device)
        perms, offs, send = [], [], []
        for s in range(len(reqs)):  # this process's shards
            perm = torch.argsort(owners[s], stable=True)
            off = torch.cumsum(counts[s], 0) - counts[s]
            # destination j gets rows off[j] .. off[j] + C of the sorted
            # stream; rows past cnt[j] belong to the next buckets (their
            # receivers do not own them and answer 0)
            stream = torch.cat([reqs[s][perm], reqs[s].new_zeros((C, 3))])
            send.append(stream[off[:, None] + rows.to(stream.device)])
            perms.append(perm)
            offs.append(off)
        recv = coll.all_to_all(send, self.mesh)  # recv[s][j]: shard j's bucket for s
        answers = [answer(s, r.view(D * C, 3)).view(D, C) for s, r in enumerate(recv)]
        back = coll.all_to_all(answers, self.mesh)  # back[s][j]: owner j's answers to s
        out = []
        for s in range(len(reqs)):
            # write back in destination order: bucket j + 1 starts at
            # off[j] + cnt[j] and overwrites bucket j's rows past its count
            # (the trailing C slots take the last bucket's)
            ordered = back[s].new_zeros(B + C)
            at = rows.to(ordered.device)
            for j in range(D):
                ordered[offs[s][j] + at] = back[s][j]
            o = back[s].new_zeros(B)
            o[perms[s]] = ordered[:B]
            out.append(from_u32_bits(o))
        return out, False

    def _step(self, ends, codes):
        return {"allgather": self._step_allgather, "ring": self._step_ring, "a2a": self._step_a2a}[
            self.routing](ends, codes, self._answer)

    def place_queries(self, queries) -> list:
        """A uint8 [B, L] host batch, B a mesh multiple, split along the mesh."""
        queries = np.asarray(queries, np.uint8)
        if queries.shape[0] % self.mesh.size:
            raise ValueError(f"batch {queries.shape[0]} not divisible by mesh size {self.mesh.size}; pad it")
        return _split(queries, self.mesh)

    def search_device(self, queries_sharded: list, use_lut: bool = True):
        """Per-shard reads (``place_queries``) -> (int64 [B, 2] intervals on
        the first shard's device, bool [rounds] numpy: the rounds that took the a2a
        fallback). The owner answers are K9's and the tail rounds K1's.
        ``use_lut=False`` starts from the full interval."""
        B, L = queries_sharded[0].shape
        k, m = self.k, (self.lut_m if use_lut else 0)
        r = (L - m) % k if m else L % k
        if r and self.tail_d is None:
            raise ValueError(
                f"query length {L} leaves {r} leftover character(s) "
                f"at k={k}; supply a tail_index (k=1) to search any "
                "length"
            )
        heads = [q[:, :r] for q in queries_sharded]
        bodies = [q[:, r:] for q in queries_sharded]
        if m:
            starts = [from_u32_bits(lut[fuse_prefix_codes(b, m)]) for lut, b in zip(self.lut, bodies)]
            ends = [iv.T.reshape(-1) for iv in starts]  # lo of every read, then hi
            bodies = [b[:, : b.shape[1] - m] for b in bodies]
        else:
            ends = [torch.cat([torch.zeros(B, dtype=torch.int64, device=b.device),
                               torch.full((B,), self.bwtsize, dtype=torch.int64, device=b.device)])
                    for b in bodies]
        codes = [fuse_round_codes(b, k) for b in bodies]
        overflow = []
        for j in range(codes[0].shape[0]):
            ends, ov = self._step(ends, [c[j].repeat(2) for c in codes])
            overflow.append(ov)
        ivs = [e.view(2, B).T.contiguous() for e in ends]
        if r:
            # the leftover leading characters, right to left, on each shard's
            # own reads: the replicated k=1 tail needs no collective
            ivs = [_rounds(iv, h.flip(1).to(torch.int64).T.contiguous(),
                           _fused_round(te, td, 1, self.tail_d, None))
                   for iv, h, te, td in zip(ivs, heads, self.tail_entries, self.tail_dollar)]
        return _merge(ivs, self.mesh), np.asarray(overflow, dtype=bool)

    def _build_lut(self, m: int) -> torch.Tensor:
        """int32 [4^m, 2] (uint32 bits) on the first shard's device: the SA interval
        of every m-mer from this engine's LUT-less sharded search, in waves
        of a mesh multiple of codes (the last padded with code 0, its rows
        dropped), each shard decoding its codes on its own device."""
        D = self.mesh.size
        n = 4**m
        wave = -(-min(n, self.WAVE_PER_CHIP * D) // D) * D
        per = wave // D
        parts = []
        for start in range(0, n, wave):
            shards = []
            for s, dev in zip(self.mesh.local_shards, self.mesh.devices):
                codes = torch.arange(start + s * per, start + (s + 1) * per, dtype=torch.int64, device=dev)
                shards.append(decode_prefix_codes(torch.where(codes < n, codes, 0), m))
            out, _ = self.search_device(shards, use_lut=False)
            parts.append(to_u32_bits(out[: min(wave, n - start)]))
        return torch.cat(parts)

    def search(self, queries, wave: int | None = None, step=None) -> np.ndarray:
        """uint8 [B, L] -> uint32 [B, 2]. A batch not divisible by the mesh
        size is padded by cycling its own reads (trimmed from the answers);
        batches beyond ``wave`` (default WAVE_PER_CHIP * mesh size, rounded
        down to a mesh multiple) stream in waves, the last padded by cycling
        its own reads. ``last_overflow_rounds`` ORs the a2a fallback flags
        over every wave of the call. ``step`` is there for the CLI's call
        shared with the other engines and must be None: the sharded rounds
        have no other implementation."""
        if step is not None:
            raise ValueError("ShardedIndexEngine runs its own kernels; step must be None")
        n = self.mesh.size
        queries = np.asarray(queries, np.uint8)
        B = queries.shape[0]
        queries = pad_cycle(queries, -B % n)
        wave = mesh_wave(wave or self.WAVE_PER_CHIP * n, n)
        if wave <= 0:
            raise ValueError(f"wave must be >= mesh size {n}")
        overflow = []

        def run(chunk):
            out, ov = self.search_device(self.place_queries(chunk))
            overflow.append(ov)
            return out

        out = stream_waves(queries, wave, run, None, (2,))
        self.last_overflow_waves = overflow
        if overflow:
            self.last_overflow_rounds = np.logical_or.reduce(overflow)
        return out[:B]
