"""The k-step FM-index on the host: configuration, construction, k=1 tail.

Counterparts of tpufm/config.py (``Layout`` :15, ``IndexConfig`` :59),
tpufm/index/builder.py (``KStepFMIndex`` :50, ``normalize_reference``
:95, ``build_index`` :106, ``derive_tail`` :225, ``derive_bwts`` :290) and the ``AltCountersIndex`` record of
tpufm/index/layouts.py:30. The arrays are bit-identical to tpufm's:

  occ      uint32 [E+1, 4^k]: per block, C[c] plus the '$'-exclusive count
           of k-mer c before the block; row E is the end-of-text sentinel.
  bitmaps  uint32 [E+1, k, 2, d/32]: per block and BWT level, two bit-planes
           (plane 0 the low code bit) of MSB-first 32-position windows, '$'
           encoded as 'A'; row E is zero.
  dollar_pos / dollar_base  uint32 [k]: where level i's '$' is and the
           k-mer code read there.

The k levels come straight from the suffix array: BWT_i[j] = T[SA[j]-1-i].
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from tpufm_torch.host.bitplanes import block_kmer_counts
from tpufm_torch.host.seqio import decode_bases, encode_bases
from tpufm_torch.host.suffix_array import suffix_array


class Layout(enum.Enum):
    """Entry-table packing of an .fmi image (tags 100, 101, 200, 201)."""

    BASELINE = "baseline"
    INTERLEAVED = "interleaved"
    ALT_COUNTERS = "alt_counters"
    INTERLEAVED_ALT_COUNTERS = "interleaved_alt_counters"

    @property
    def fmi_tag(self) -> int:
        return {"baseline": 100, "interleaved": 101,
                "alt_counters": 200, "interleaved_alt_counters": 201}[self.value]

    @property
    def interleaved(self) -> bool:
        return self.value.startswith("interleaved")

    @property
    def has_slim_counters(self) -> bool:
        return self.value.endswith("alt_counters")

    @staticmethod
    def from_fmi_tag(tag: int) -> "Layout":
        for layout in Layout:
            if layout.fmi_tag == tag:
                return layout
        raise ValueError(f"unknown .fmi index tag {tag}")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """k: LF steps fused per round (1..8); d: block size in positions (a
    positive multiple of 32); layout: the .fmi packing it was read from."""

    k: int = 2
    d: int = 64
    layout: Layout = Layout.BASELINE

    def __post_init__(self):
        if not 1 <= self.k <= 8:
            raise ValueError(f"k must be in [1, 8], got {self.k}")
        if self.d <= 0 or self.d % 32:
            raise ValueError(f"d must be a positive multiple of 32, got {self.d}")

    @property
    def num_counters(self) -> int:
        return 4**self.k

    @property
    def num_slim_counters(self) -> int:
        return 4**self.k // 2

    @property
    def words_per_plane(self) -> int:
        return self.d // 32

    @property
    def bitmap_words(self) -> int:
        return 2 * self.k * self.words_per_plane

    def num_entries(self, bwtsize: int) -> int:
        return -(-bwtsize // self.d)


@dataclasses.dataclass
class KStepFMIndex:
    config: IndexConfig
    bwtsize: int
    occ: np.ndarray
    bitmaps: np.ndarray
    dollar_pos: np.ndarray
    dollar_base: np.ndarray

    @property
    def nentries(self) -> int:
        """Real entries, without the sentinel row."""
        return self.occ.shape[0] - 1

    @property
    def dollar_block(self) -> np.ndarray:
        return self.dollar_pos // np.uint32(self.config.d)


@dataclasses.dataclass
class AltCountersIndex:
    """An alternate-counters image (tag 200/201) as read: the full logical
    ``base`` index, which is what the port searches (its intervals are
    identical), and the stored half-counter rows ``occ_slim``."""

    base: KStepFMIndex
    occ_slim: np.ndarray

    @property
    def config(self) -> IndexConfig:
        return self.base.config

    @property
    def bwtsize(self) -> int:
        return self.base.bwtsize


def c_array(totals: np.ndarray, dollar_base, k: int) -> np.ndarray:
    """C[c] = count of k-mers below c, plus one per level i for every
    c >= level i's '$' k-mer with its lower i levels cleared."""
    acc = np.zeros(totals.shape[0], dtype=np.int64)
    acc[1:] = np.cumsum(totals)[:-1]
    for i in range(k):
        acc[int(dollar_base[i]) & ~((1 << (2 * i)) - 1):] += 1
    return acc


def _pack_words(bits: np.ndarray) -> np.ndarray:
    """[..., 32] 0/1 bits -> uint32 words, position p at bit 31 - p."""
    by = np.packbits(bits.astype(np.uint8), axis=-1).astype(np.uint32)
    return (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]


def normalize_reference(reference) -> np.ndarray:
    """ACGT str/bytes or uint8 codes (2-bit codes, or ASCII bytes when any
    value exceeds 3) -> 2-bit codes, as every builder sees them."""
    if isinstance(reference, (str, bytes, bytearray)):
        return encode_bases(reference)
    codes = np.asarray(reference, dtype=np.uint8)
    if codes.size and codes.max() > 3:
        codes = encode_bases(codes)
    return codes


def build_index(reference, config: IndexConfig = IndexConfig(),
                sa_method: str = "native", sa: np.ndarray | None = None) -> KStepFMIndex:
    """The k-step FM-index of ``reference`` (see ``normalize_reference``).
    ``sa``: its suffix array when already computed (int64 [n+1], sa[0] ==
    n), so that one suffix sort serves several indexes and the locate
    tables."""
    codes = normalize_reference(reference)
    k, d, nb = config.k, config.d, config.words_per_plane
    n = int(codes.shape[0])
    bwtsize = n + 1
    E = config.num_entries(bwtsize)
    if sa is None:
        sa = suffix_array(codes, sa_method)
    elif sa.shape[0] != bwtsize:
        raise ValueError(f"sa has {sa.shape[0]} entries, expected {bwtsize}")

    text = np.zeros(bwtsize, dtype=np.uint8)  # '$' read as 'A'
    text[:n] = codes
    dollar_pos = np.empty(k, dtype=np.int64)
    small = np.flatnonzero(sa < k)
    dollar_pos[sa[small]] = small

    # level codes per BWT position, in d-aligned chunks to bound temporaries
    chunk = max(d, (1 << 27) // d * d)
    levels = np.empty((k, bwtsize), dtype=np.uint8)
    for start in range(0, bwtsize, chunk):
        sl = sa[start:start + chunk]
        for i in range(k):
            prev = sl - (1 + i)
            prev[prev < 0] += bwtsize
            levels[i, start:start + chunk] = text[prev]
    del sa
    dollar_base = np.zeros(k, dtype=np.uint32)
    for i in range(k):
        dollar_base |= levels[i, dollar_pos].astype(np.uint32) << np.uint32(2 * i)

    counts = np.zeros((E, 4**k), dtype=np.int64)
    bitmaps = np.zeros((E + 1, k, 2, nb), dtype=np.uint32)
    for start in range(0, bwtsize, chunk):
        stop = min(start + chunk, bwtsize)
        b0, nblk = start // d, -(-(stop - start) // d)
        km = np.zeros(stop - start, dtype=np.int64)
        for i in range(k):
            km |= levels[i, start:stop].astype(np.int64) << (2 * i)
        km += (np.arange(stop - start, dtype=np.int64) // d) * 4**k
        for dp in dollar_pos:  # a '$' position counts as no k-mer
            if start <= dp < stop:
                km[dp - start] = -1
        counts[b0:b0 + nblk] += np.bincount(
            km[km >= 0], minlength=nblk * 4**k
        ).reshape(nblk, 4**k)
        seg = np.zeros((k, nblk * d), dtype=np.uint8)
        seg[:, :stop - start] = levels[:, start:stop]
        for plane in range(2):
            words = _pack_words(((seg >> plane) & 1).reshape(k, nblk, nb, 32))
            bitmaps[b0:b0 + nblk, :, plane, :] = words.transpose(1, 0, 2)

    occ = np.zeros((E + 1, 4**k), dtype=np.int64)
    np.cumsum(counts, axis=0, out=occ[1:])
    occ += c_array(counts.sum(axis=0), dollar_base, k)
    return KStepFMIndex(
        config=config,
        bwtsize=bwtsize,
        occ=occ.astype(np.uint32),
        bitmaps=bitmaps,
        dollar_pos=dollar_pos.astype(np.uint32),
        dollar_base=dollar_base,
    )


def derive_tail(index: KStepFMIndex) -> KStepFMIndex:
    """The k=1 index of the same text, from the level-0 bit-planes alone
    (they hold BWT_0 with '$' as 'A'): the table that finishes reads whose
    length leaves L mod k characters."""
    cfg = index.config
    if cfg.k == 1:
        return index
    d, E, bwtsize = cfg.d, index.nentries, index.bwtsize
    dp0 = int(index.dollar_pos[0])
    planes = np.ascontiguousarray(index.bitmaps[:, :1])
    counts = np.zeros((E, 4), dtype=np.int64)
    step = max(1, (1 << 27) // d)
    for b0 in range(0, E, step):
        b1 = min(b0 + step, E)
        counts[b0:b1] = block_kmer_counts(planes[b0:b1], 1)
    # drop the trailing padding of the last block and the '$', both read as 'A'
    counts[E - 1, 0] -= E * d - bwtsize
    counts[dp0 // d, 0] -= 1
    occ = np.zeros((E + 1, 4), dtype=np.int64)
    np.cumsum(counts, axis=0, out=occ[1:])
    occ += c_array(counts.sum(axis=0), [0], 1)
    return KStepFMIndex(
        config=IndexConfig(k=1, d=d),
        bwtsize=bwtsize,
        occ=occ.astype(np.uint32),
        bitmaps=planes,
        dollar_pos=np.asarray([dp0], dtype=np.uint32),
        dollar_base=np.asarray([0], dtype=np.uint32),
    )



def derive_bwts(codes: np.ndarray, k: int, sa: np.ndarray | None = None):
    """The k BWT level strings (bytes, '$' at each level's '$' position) and
    the '$' positions: the debugging view ``dumpbwt`` prints (the
    reference's INDEX_DGB=1 dump). Not used by the search path."""
    codes = np.asarray(codes, dtype=np.uint8)
    bwtsize = codes.shape[0] + 1
    if sa is None:
        sa = suffix_array(codes)
    dollar_pos = np.empty(k, dtype=np.int64)
    small = np.flatnonzero(sa < k)
    dollar_pos[sa[small]] = small
    t_codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    bwts = []
    for i in range(k):
        prev = sa - (1 + i)
        prev[prev < 0] += bwtsize
        s = bytearray(decode_bases(t_codes[prev]))
        s[dollar_pos[i]] = ord("$")
        bwts.append(bytes(s))
    return bwts, dollar_pos
