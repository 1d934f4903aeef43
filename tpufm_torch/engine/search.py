"""Exact k-step backward search on one device.

Counterpart of ``make_search_fn`` (tpufm/engine/xla.py:395-546), ``_tail_scan``
(:279), ``build_prefix_lut`` (:909), ``make_search_varlen_fn`` (:312-392) and
``XLAEngine`` (:549-906: ``search`` with the paired layout's repair :711-831,
``search_device_waved`` :837, ``count`` :866). A batch starts from the
m-mer prefix LUT (or the full interval), takes (L - m) / k rounds on the
k-step table and L mod k rounds on the k=1 tail table; every round is one LF
round over both interval ends of every read. A variable-length batch is
right-aligned and masks each round per read. ``count`` gives occurrence
counts, exact or within Hamming distance 1 (each read's 3L+1 variants
searched as lanes of one batch).

Layouts (``layout``), as ``XLAEngine``'s:
- "fused" (the default): one table row a block, planes then counters
  (padded to ``pad_words``). The k-step rounds run one of two ways
  (``gather``): "fused", K1's pair entry loading its own rows
  (``lf_round_pairs``, one read per thread); or "dma", the counterpart of
  ``XLAEngine(gather="dma")``: K3 (``row_gather``) gathers every end's row
  into one buffer, then K1 computes on the gathered rows (``lf_round_rows``).
- "split": the planes and the counters in tables of their own, K8's split
  entry (``lf_round_split``); the LUT is built with the same rounds.
- the alternate-counters index (the default for an ``AltCountersIndex``,
  whose layout is "split"): K8's alternate-counters entry (``lf_round_ac``)
  on ``occ_slim``, a fixed-length search of lengths k divides from the full
  interval, without LUT or tail.
- "paired": K1's paired entry (``lf_round_paired``) on the paired table,
  after a LUT start (required; built with fused rounds); ``search``
  searches reads whose interval ever spanned more than two blocks again on
  the fused table, in waves of ``REPAIR_WAVE``.
The LUT build of the fused and paired layouts and the k=1 tail rounds take
``lf_round_pairs``. The device copies of the tables are padded to rows of a
multiple of 4 words (``_rows``); the host ``Tables`` keep JAX's widths.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpufm_torch.bitops import FULL, from_u32_bits, to_u32_bits
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.codes import (
    decode_prefix_codes,
    fuse_prefix_codes,
    fuse_round_codes,
)
from tpufm_torch.engine.lf_round import (
    lf_round_ac,
    lf_round_ac_reference,
    lf_round_pairs,
    lf_round_paired,
    lf_round_paired_reference,
    lf_round_rows,
    lf_round_split,
    lf_round_split_reference,
)
from tpufm_torch.engine.mismatch import variants1
from tpufm_torch.engine.row_gather import row_gather
from tpufm_torch.engine.tables import (
    Tables,
    build_paired_entries,
    is_alt_counters,
    load_lut_cache,
    lut_fingerprint,
    save_lut_cache,
    tables_from_index,
)
from tpufm_torch.host.index import AltCountersIndex, KStepFMIndex
from tpufm_torch.host.seqio import VARLEN_PAD
from tpufm_torch.profiling import span


def _words(a: np.ndarray | torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    """uint32 numpy table -> int32 tensor with the same bits on ``device``;
    an int32 tensor of such bits moves there as it is (not copied when it
    lies there already)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:  # e.g. a view of a JAX array; torch wants to own it
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def _rows(a: np.ndarray | torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    """A uint32 table [E, W] (numpy, or an int32 tensor of its bits) -> its
    device copy, int32 [E, W rounded up to a multiple of 4], the extra words
    0: every row then starts 16-byte aligned, as the kernels' vector loads
    want (no kernel reads a row past its counters and mark columns). The
    host tables keep JAX's widths."""
    if isinstance(a, torch.Tensor):
        a = torch.nn.functional.pad(a, (0, -a.shape[1] % 4))
    elif a is not None and a.shape[1] % 4:
        a = np.pad(np.asarray(a, dtype=np.uint32), ((0, 0), (0, -a.shape[1] % 4)))
    return _words(a, device)


def _int64(a: np.ndarray | None, device: torch.device) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(a.astype(np.int64)).to(device)


def _fused_round(entries, dollar, k: int, d: int, step=None):
    """The LF round of both ends of a read on a fused table, (iv [B, 2],
    code [B]) -> iv: K1's pair entry, or ``step`` on every end when given."""
    if step is None:
        return lambda iv, code: lf_round_pairs(entries, iv, code, dollar, k, d)
    return lambda iv, code: step(entries, iv.reshape(-1), code.repeat_interleave(2), dollar, k, d).view(-1, 2)


def _rounds(iv, codes, round_fn, keep=None):
    """Apply ``round_fn`` (iv [B, 2], code [B]) -> iv once per row of
    ``codes`` [rounds, B]; where ``keep`` [rounds, B] is False a read keeps
    its interval."""
    for j, code in enumerate(codes):
        new = round_fn(iv, code)
        iv = new if keep is None else torch.where(keep[j, :, None], new, iv)
    return iv


class SearchEngine(torch.nn.Module):
    """Device-resident tables plus the batch search over them.

    index: a KStepFMIndex, an AltCountersIndex (searched on its slim
    counters; ``XLAEngine`` takes the same), or ready ``Tables`` (e.g. from
    ``tables_from_jax``), whose layout, LUT and tail table come with them.
    lut_m > 0 starts every read lut_m characters in from a 4^lut_m x 2
    interval LUT, loaded from ``lut_cache`` (an .npz shared with the JAX
    engine) when it matches the index, else built on the device with this
    engine's own rounds. tail_index: a k=1 index over the same text, for
    reads whose length leaves L mod k characters. layout: "fused" (default),
    "split" (the default for an AltCountersIndex) or "paired" (see the
    module docstring); pad_words pads the fused rows to that many words.
    gather: how the fused layout's k-step rounds reach their rows, "fused"
    (K1 loads them) or "dma" (K3 gathers them into a buffer first). The
    combinations ``XLAEngine`` refuses raise its ValueError, word for word.

    ``step`` of the search methods: None runs this engine's own kernels; a
    fused round function ``step(entries, iv, code, dollar, k, d)``, such as
    the plain ``lf_round_reference``, replaces every fused round, and the
    split, alternate-counters and paired rounds take their plain versions.
    """

    #: reads per wave of ``search`` (the JAX engine's wave; not tuned here)
    WAVE = 1 << 20
    #: reads per wave of the paired layout's repair search (xla.py:800)
    REPAIR_WAVE = 1 << 16

    def __init__(
        self,
        index: KStepFMIndex | AltCountersIndex | Tables,
        device: str | torch.device,
        lut_m: int = 0,
        lut_cache: str | None = None,
        tail_index: KStepFMIndex | None = None,
        gather: str = "fused",
        layout: str | None = None,
        pad_words: int | None = None,
    ):
        super().__init__()
        if gather not in ("fused", "dma"):
            raise ValueError(f"unknown gather {gather!r} (use 'fused' or 'dma')")
        self.gather = gather
        device = resolve_device(device)
        #: seconds the device LUT build took (None: no LUT built here)
        self.lut_build_seconds = None
        #: share of the last paired ``search``'s reads searched again
        self.last_repair_fraction = None
        if isinstance(index, Tables):
            self._load(index, device)
            return
        # XLAEngine.__init__'s checks, in its order (xla.py:583-596, :642-656,
        # then make_search_fn's, :423-477)
        ac = is_alt_counters(index)
        layout = layout or ("split" if ac else "fused")
        base = getattr(index, "base", index)
        if lut_m and ac:
            raise ValueError("lut_m is not supported with alt-counters")
        if lut_m and lut_m % base.config.k:
            raise ValueError(f"lut_m={lut_m} must be a multiple of k={base.config.k}")
        if gather == "dma" and layout != "fused":
            raise ValueError("gather='dma' requires the fused layout")
        if tail_index is not None and ac:
            raise ValueError("tail_index is not supported with alt-counters")
        tables = tables_from_index(index, tail_index, layout, pad_words)
        if layout not in ("fused", "split", "paired"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "paired" and ac:
            raise ValueError("paired layout supports baseline counters only")
        if layout == "paired" and not lut_m:
            raise ValueError(
                "paired layout requires a prefix LUT (lut_m > 0): without "
                "one every search starts at the full [0, bwtsize) interval "
                "and the first rounds would all take the repair path"
            )
        if ac and layout != "split":
            raise ValueError(
                "alt-counters uses the split layout (its counter may live in "
                "the next entry, so rows cannot be fused)"
            )
        self._load(tables, device)
        if lut_m:
            fp = lut_fingerprint(base, lut_m)
            host = load_lut_cache(lut_cache, fp) if lut_cache else None
            if host is not None:
                self.lut = _words(host, self.device)
            else:
                t0 = time.perf_counter()
                self.lut = self.build_prefix_lut(lut_m)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.lut_build_seconds = time.perf_counter() - t0
                if lut_cache:
                    save_lut_cache(lut_cache, self.lut.cpu().numpy().view(np.uint32), fp)
            self.lut_m = lut_m

    def _load(self, tables: Tables, device: torch.device) -> None:
        self.k, self.d, self.bwtsize, self.tail_d = (
            tables.k, tables.d, tables.bwtsize, tables.tail_d,
        )
        self.alt_counters = tables.layout == "alt_counters"
        self.layout = "split" if self.alt_counters else tables.layout
        self.register_buffer("dollar", _int64(tables.dollar, device))
        self.register_buffer("entries", _rows(tables.entries, device))
        # the paired table from the device rows: halves of a multiple of 4 words
        paired = None if tables.entries_paired is None else build_paired_entries(self.entries)
        self.register_buffer("entries_paired", paired)
        self.register_buffer("bitmaps", _rows(tables.bitmaps, device))
        self.register_buffer("occ", _words(tables.occ, device))
        self.register_buffer("occ_slim", _words(tables.occ_slim, device))
        self.register_buffer("tail_entries", _rows(tables.tail_entries, device))
        self.register_buffer("tail_dollar", _int64(tables.tail_dollar, device))
        self.register_buffer("lut", _words(tables.lut, device))
        self.lut_m = 0
        if tables.lut is not None:
            n = tables.lut.shape[0]
            self.lut_m = (n.bit_length() - 1) // 2
            if 4**self.lut_m != n:
                raise ValueError(f"LUT of {n} rows is not 4^m rows")

    @property
    def device(self) -> torch.device:
        return self.dollar.device

    def use_tail(self, entries: torch.Tensor, dollar: torch.Tensor, d: int) -> None:
        """Take ``entries`` (int32 [E+1, W >= 2*nb + 4] on this engine's
        device, shared, not copied) with its '$' metadata ``dollar`` (int64
        [3, 1]) as the k=1 tail table at sample distance ``d``: the fused
        locate rows are one, as the JAX search+locate functions use them
        (xla.py:1183-1189; the LF round never reads their mark columns)."""
        if entries.device != self.device or dollar.device != self.device:
            raise ValueError(f"tail table on {entries.device}, engine on {self.device}")
        self.tail_d = d
        self.tail_entries, self.tail_dollar = entries, dollar

    def _full_interval(self, n: int) -> torch.Tensor:
        iv = torch.zeros((n, 2), dtype=torch.int64, device=self.device)
        iv[:, 1] = self.bwtsize
        return iv

    def _layout_round(self, step, plain_fn, fn, *tables):
        """The round of the split, alternate-counters or paired tables:
        ``fn`` (its kernel), or its plain version ``plain_fn`` when a
        ``step`` is given."""
        f = fn if step is None else plain_fn
        return lambda iv, code: f(*tables, iv, code, self.dollar, self.k, self.d)

    def _kround(self, step, n: int):
        """The k-step round function for ``n`` interval ends, (iv [B, 2], code
        [B]) -> iv, on this engine's layout (the paired layout's returns
        (iv, ok)): K8 on the split or the alternate-counters tables; K1's
        paired entry; on the fused table ``step`` when given, else K1's pair
        entry on its own rows ("fused"), or K3 into one [n, W] row buffer
        that every round of the call reuses, then K1 on the rows ("dma")."""
        if self.alt_counters:
            return self._layout_round(step, lf_round_ac_reference, lf_round_ac, self.bitmaps, self.occ_slim)
        if self.layout == "split":
            return self._layout_round(step, lf_round_split_reference, lf_round_split, self.bitmaps, self.occ)
        if self.layout == "paired":
            return self._layout_round(step, lf_round_paired_reference, lf_round_paired, self.entries_paired)
        if step is not None or self.gather == "fused":
            return _fused_round(self.entries, self.dollar, self.k, self.d, step)
        rows = torch.empty((n, self.entries.shape[1]), dtype=torch.int32, device=self.device)

        def gathered(iv, code):
            flat = iv.reshape(-1)
            rows_ = row_gather(self.entries, flat // self.d, out=rows)
            return lf_round_rows(rows_, flat, code.repeat_interleave(2), self.dollar, self.k, self.d).view(-1, 2)

        return gathered

    def _tail_round(self, step):
        return _fused_round(self.tail_entries, self.tail_dollar, 1, self.tail_d, step)

    def build_prefix_lut(self, m: int, step=None) -> torch.Tensor:
        """int32 [4^m, 2] (uint32 bits): the SA interval of every m-mer, from
        this engine's rounds (``step``, as in ``search_device``; the split
        layout's own, the paired layout's on its fused table, xla.py:666-669),
        wave by wave straight into one device tensor."""
        n = 4**m
        wave = min(n, 1 << 20)
        round_fn = self._kround(step, 2 * wave) if self.layout == "split" else self._fused_k(step)
        lut = torch.empty((n, 2), dtype=torch.int32, device=self.device)
        for start in range(0, n, wave):
            codes = torch.arange(start, start + wave, dtype=torch.int64, device=self.device)
            q = decode_prefix_codes(codes, m)
            iv = _rounds(self._full_interval(wave), fuse_round_codes(q, self.k), round_fn)
            lut[start:start + wave] = to_u32_bits(iv)
        return lut

    def _check_queries(self, queries: torch.Tensor) -> None:
        if queries.dtype != torch.uint8 or queries.dim() != 2:
            raise ValueError(f"queries must be uint8 [B, L], got {queries.dtype} {tuple(queries.shape)}")
        if queries.device != self.device:
            raise ValueError(f"queries on {queries.device}, engine on {self.device}")

    def _search_ac(self, queries: torch.Tensor, step=None) -> torch.Tensor:
        """The alternate-counters search (xla.py:479-503): every round from
        the full interval, lengths k divides only."""
        if queries.shape[1] % self.k:
            raise ValueError(
                f"alt-counters requires query length divisible by k={self.k} "
                "(the any-length tail extension is fused/split-layout only)"
            )
        iv = self._full_interval(queries.shape[0])
        return _rounds(iv, fuse_round_codes(queries, self.k), self._kround(step, 2 * queries.shape[0]))

    def _search_paired(self, queries: torch.Tensor, step=None):
        """The paired search (xla.py:439-468): (int64 [B, 2] intervals, bool
        [B] ok), ok False for the reads whose interval spanned more than two
        blocks in some round (their intervals are not the search's)."""
        L, k, m = queries.shape[1], self.k, self.lut_m
        r = (L - m) % k
        if r and self.tail_d is None:
            raise ValueError(
                f"query length {L} minus lut_m {m} not divisible by "
                f"k={k}; supply a tail_index (k=1) to search any length"
            )
        head, body = queries[:, :r], queries[:, r:]
        iv = from_u32_bits(self.lut[fuse_prefix_codes(body, m)])
        ok = torch.ones(queries.shape[0], dtype=torch.bool, device=self.device)
        if body.shape[1] > m:
            round_fn = self._kround(step, 2 * queries.shape[0])
            for code in fuse_round_codes(body[:, : body.shape[1] - m], k):
                iv, ok2 = round_fn(iv, code)
                ok &= ok2
        if r:
            iv = _rounds(iv, head.flip(1).to(torch.int64).T.contiguous(), self._tail_round(step))
        return iv, ok

    def search_device(self, queries: torch.Tensor, step=None, use_lut: bool = True):
        """uint8 [B, L] 2-bit codes on this engine's device -> int64 [B, 2]
        SA intervals (L, R), left on the device (the paired layout: the
        intervals and the ok mask bool [B], as ``XLAEngine.search_device``;
        only ``search`` repairs the reads that are not ok).
        ``use_lut=False`` starts every read from the full interval on the
        same tables, as a search built without the LUT (the seed scan's
        short seeds, seed.py:154; the paired layout's fused table)."""
        self._check_queries(queries)
        if self.alt_counters:
            return self._search_ac(queries, step)
        if self.layout == "paired":
            if use_lut:
                return self._search_paired(queries, step)
            return self._search_fixed(queries, 0, self._fused_k(step), step)
        return self._search_fixed(queries, self.lut_m if use_lut else 0,
                                  self._kround(step, 2 * queries.shape[0]), step)

    def _fused_k(self, step):
        return _fused_round(self.entries, self.dollar, self.k, self.d, step)

    def _search_fixed(self, queries: torch.Tensor, m: int, round_fn, step=None) -> torch.Tensor:
        """The fixed-length search of the fused and split layouts
        (xla.py:505-546): the m-mer LUT start (m > 0) or the full interval,
        ``round_fn`` for the k-step rounds, the k=1 tail rounds last."""
        L, k = queries.shape[1], self.k
        r = (L - m) % k if m else L % k
        if r and self.tail_d is None:
            raise ValueError(
                f"query length {L} leaves {r} leftover character(s) at k={k}"
                + (f" (after the {m}-mer LUT)" if m else "")
                + "; supply a tail_index (k=1) to search any length"
            )
        head, body = queries[:, :r], queries[:, r:]
        if m and body.shape[1] < m:
            raise ValueError(f"query length {L} shorter than lut_m={m}")
        with span("tpufm.search.start"):
            if m:
                iv = from_u32_bits(self.lut[fuse_prefix_codes(body, m)])
                body = body[:, : body.shape[1] - m]
            else:
                iv = self._full_interval(queries.shape[0])
        if body.shape[1]:
            with span("tpufm.search.codes"):
                codes = fuse_round_codes(body, k)
            with span("tpufm.search.rounds"):
                iv = _rounds(iv, codes, round_fn)
        if r:
            # the leftover leading characters, right to left, one per round
            with span("tpufm.search.tail"):
                iv = _rounds(iv, head.flip(1).to(torch.int64).T.contiguous(), self._tail_round(step))
        return iv

    def search_device_waved(self, queries: torch.Tensor, wave: int | None = None):
        """uint8 [B, L] reads on this engine's device, B a multiple of
        ``wave`` (default ``WAVE``) -> int64 [B, 2] intervals on the device
        (the paired layout: and the ok mask bool [B]): ``search_device``
        wave by wave into one output, so that a round's temporaries stay at
        wave size (``XLAEngine.search_device_waved``, xla.py:837). Nothing
        goes through the host."""
        wave = wave or self.WAVE
        B = queries.shape[0]
        if B % wave:
            raise ValueError(f"batch {B} not a multiple of wave {wave}")
        self._check_queries(queries)
        out = torch.empty((B, 2), dtype=torch.int64, device=self.device)
        ok = torch.empty(B, dtype=torch.bool, device=self.device) if self.layout == "paired" else None
        for start in range(0, B, wave):
            res = self.search_device(queries[start:start + wave])
            if ok is None:
                out[start:start + wave] = res
            else:
                out[start:start + wave], ok[start:start + wave] = res
        return out if ok is None else (out, ok)

    def _need_varlen_tail(self) -> None:
        if self.layout != "fused":
            raise ValueError(
                "variable-length search rides the baseline fused layout "
                "(alt-counters/split/paired are fixed-length engines)"
            )
        if self.k > 1 and self.tail_d is None:
            raise ValueError(
                "variable-length search needs a tail_index (k=1) — every "
                "length mix has reads with L mod k != 0"
            )

    def search_varlen_device(self, queries: torch.Tensor, step=None) -> torch.Tensor:
        """uint8 [B, L] reads right-aligned, ``VARLEN_PAD`` on the left, on
        this engine's device -> int64 [B, 2] SA intervals, each read searched
        at its own length (its non-pad count); the fused layout only.

        k-step round j of a read is real iff (j+1)*k <= len - lut_m, so each
        round is masked per read; the (len - lut_m) mod k leftover leading
        characters finish as up to k-1 masked rounds on the k=1 tail table,
        each reading its own column. An empty read, or one shorter than
        lut_m, raises (one device-to-host read of the shortest length)."""
        self._check_queries(queries)
        self._need_varlen_tail()
        k, m = self.k, self.lut_m
        B = queries.shape[0]
        # left-pad so that the k-step rounds tile the non-LUT columns exactly
        pad = -(queries.shape[1] - m) % k
        q = torch.cat([queries.new_full((B, pad), VARLEN_PAD), queries], dim=1)
        Lp = q.shape[1]
        is_pad = q == VARLEN_PAD
        lengths = (~is_pad).sum(dim=1)
        shortest = int(lengths.min()) if B else None
        if shortest == 0:
            raise ValueError("empty read in variable-length batch")
        if shortest is not None and shortest < m:
            raise ValueError(
                f"shortest read ({shortest}) is below "
                f"lut_m={m}; rebuild the engine with a smaller LUT"
            )
        qc = q.masked_fill(is_pad, 0)
        iv = from_u32_bits(self.lut[fuse_prefix_codes(qc, m)]) if m else self._full_interval(B)
        left = lengths - m  # characters left after the LUT start
        if Lp > m:
            codes = fuse_round_codes(qc[:, : Lp - m], k)
            ends = k * torch.arange(1, codes.shape[0] + 1, device=self.device)
            iv = _rounds(iv, codes, self._kround(step, 2 * B), ends[:, None] <= left)
        if k > 1:
            rem = left % k
            t = torch.arange(k - 1, device=self.device)[:, None]
            # clipped: a lane masked off by t >= rem may point left of column 0
            col = (Lp - lengths + rem - 1 - t).clamp(0, Lp - 1)
            chars = qc.gather(1, col.T).T.to(torch.int64).contiguous()
            iv = _rounds(iv, chars, self._tail_round(step), t < rem)
        return iv

    def _stream(self, queries, wave: int | None, fn, cols: tuple = (2,)) -> np.ndarray:
        """uint32 [B, *cols] host results of ``fn`` over host queries, in
        waves of ``wave`` reads (default ``WAVE``)."""
        # torch.from_numpy wants a writable buffer (read-only ones are copied)
        queries = np.require(queries, np.uint8, ["C", "W"])
        return stream_waves(queries, wave or self.WAVE, fn, self.device, cols)

    def search(self, queries, wave: int | None = None, step=None) -> np.ndarray:
        """uint8 [B, L] host queries -> uint32 [B, 2] host intervals, in
        waves of ``wave`` reads. The paired layout searches the reads whose
        interval spanned more than two blocks again on the fused table, in
        waves of ``REPAIR_WAVE``, and records their share in
        ``last_repair_fraction`` (xla.py:711-731)."""
        with span("tpufm.search"):
            if self.layout != "paired":
                return self._stream(queries, wave, lambda q: self.search_device(q, step))

            def with_ok(q):
                iv, ok = self.search_device(q, step)
                return torch.cat([iv, ok[:, None].to(torch.int64)], dim=1)

            out3 = self._stream(queries, wave, with_ok, (3,))
            iv = np.ascontiguousarray(out3[:, :2])
            bad = np.flatnonzero(out3[:, 2] == 0)
            self.last_repair_fraction = bad.size / max(1, out3.shape[0])
            if bad.size:
                queries = np.require(queries, np.uint8, ["C", "W"])
                fused = self._fused_k(step)
                iv[bad] = self._stream(queries[bad], self.REPAIR_WAVE,
                                       lambda q: self._search_fixed(q, self.lut_m, fused, step))
            return iv

    def search_varlen(self, queries, wave: int | None = None, step=None) -> np.ndarray:
        """Right-aligned ``VARLEN_PAD``-padded host reads (the shape
        ``load_queries_varlen`` gives) -> uint32 [B, 2] host intervals, each
        read searched at its own length, in waves of ``wave`` reads."""
        self._need_varlen_tail()
        return self._stream(queries, wave, lambda q: self.search_varlen_device(q, step))

    def count_mismatch_device(self, queries: torch.Tensor, step=None) -> torch.Tensor:
        """uint8 [W, L] reads on this engine's device -> int64 [W] counts of
        their occurrences within Hamming distance 1: the 3L+1 variants of
        every read (``variants1``) ride one search as 3L+1 lanes each, and
        their intervals, pairwise disjoint, sum to the count
        (``make_count_mismatch_fn``, xla.py:944); the fused layout only."""
        if self.layout != "fused":
            raise ValueError("count(mismatches=1) requires the fused layout")
        self._check_queries(queries)
        W, L = queries.shape
        with span("tpufm.count.variants"):
            lanes = variants1(queries).reshape(-1, L)
        iv = self.search_device(lanes, step).view(W, 3 * L + 1, 2)
        with span("tpufm.count.sum"):
            return (iv[..., 1] - iv[..., 0]).sum(dim=-1) & FULL

    def count(self, queries, mismatches: int = 0, wave: int | None = None, step=None) -> np.ndarray:
        """uint32 [B] occurrence count of every read: R - L of its exact
        search (mismatches=0), or its occurrences within Hamming distance 1
        (mismatches=1, the fused layout only), in waves of ``wave`` reads; a
        Hamming wave defaults to WAVE // (3L + 1) reads, so that it searches
        about WAVE lanes (``XLAEngine.count``, xla.py:866)."""
        with span("tpufm.count"):
            queries = np.require(queries, np.uint8, ["C", "W"])
            if mismatches == 0:
                iv = self.search(queries, wave=wave, step=step)
                return (iv[:, 1] - iv[:, 0]).astype(np.uint32)
            if mismatches != 1:
                raise NotImplementedError(
                    f"mismatches={mismatches}: only 0 and 1 are supported (the "
                    "variant fan-out grows as (3L)^e — distance 2 at L=120 is "
                    "~65K variants/read; use a seed-and-verify pipeline instead)"
                )
            if self.layout != "fused":
                raise ValueError("count(mismatches=1) requires the fused layout")
            wave = wave or max(1, self.WAVE // (3 * queries.shape[1] + 1))
            return self._stream(queries, wave, lambda q: self.count_mismatch_device(q, step), ())


def pad_cycle(arr: np.ndarray, pad: int) -> np.ndarray:
    """``arr`` with ``pad`` rows appended by cycling its own rows, also past
    len(arr) (a tiny batch on a large mesh), as tpufm/utils/waves.py:14."""
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.resize(arr, (pad,) + arr.shape[1:])])


def mesh_wave(wave: int, n: int) -> int:
    """``wave`` rounded down to a multiple of the mesh size ``n``: a mesh
    engine's wave splits into equal shards (tpufm/parallel/search.py:777-778)."""
    return wave - wave % n


def stream_waves(items: np.ndarray, wave: int, fn, device: torch.device | None, cols: tuple = ()) -> np.ndarray:
    """uint32 [B, *cols] host results of ``fn`` (up to ``wave`` items -> a
    device tensor of their results) over the host array ``items`` [B, ...],
    streamed wave by wave, the next wave queued before the previous one is
    copied back (tpufm/utils/waves.py:25 with two waves in flight).
    ``fn`` gets each wave as a tensor on ``device``: there the last wave
    stays short, since nothing is compiled per shape here. Where ``device``
    is None (a mesh engine, which places its shards itself), ``fn`` gets
    host numpy and a short last wave is padded to a whole one with its own
    items, as tpufm's ``pad_mode="cycle"`` (a sharded engine's last wave
    keeps the bucket statistics of real traffic); the pad's results are
    dropped. A batch of at most one wave goes through as it is.

    Under a profiler each wave's steps are spans: ``tpufm.wave.upload`` (the
    copy to ``device``), ``tpufm.wave.enqueue`` (``fn``), then for the wave
    before it ``tpufm.wave.readback`` (the copy to the host, which for a CUDA
    result first waits for the stream's queued rounds, and the uint32
    store)."""
    if wave <= 0:
        raise ValueError(f"wave must be positive, got {wave}")
    B = items.shape[0]
    out = np.empty((B, *cols), dtype=np.uint32)
    pending = None
    for start in range(0, B, wave):
        chunk = items[start:start + wave]
        real = chunk.shape[0]
        if device is None and B > wave and real < wave:
            chunk = pad_cycle(chunk, wave - real)
        if device is not None:
            with span("tpufm.wave.upload"):
                chunk = torch.from_numpy(chunk).to(device)
        with span("tpufm.wave.enqueue"):
            res = fn(chunk)
        if pending is not None:
            _read_back(out[pending[0]:start], pending[1])
        pending = (start, res)
    if pending is not None:
        _read_back(out[pending[0]:], pending[1])
    return out


def _read_back(dst: np.ndarray, res: torch.Tensor) -> None:
    """The first len(dst) rows of the wave result ``res`` into the host
    rows ``dst``."""
    with span("tpufm.wave.readback"):
        dst[...] = res[:len(dst)].cpu().numpy()
