"""The record map of a multi-FASTA reference: absolute positions in the
concatenated text to (record, offset).

Counterpart of tpufm/io/contigs.py (``ContigMap`` :23, ``resolve`` :28,
``format`` :48, ``read_contigs`` :61, ``_header_name`` :102). The index is
built over the concatenation of every record's sequence, so a position is
an offset into that concatenation; users want ``chrN:offset``. A match that
runs past the end of its record is an artifact of the concatenation, not an
occurrence in any one sequence: ``resolve`` flags it, the ``.pos`` lines
label it ``:spans`` and the SAM writers drop it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufm_torch.host.seqio import _open

_SENTINEL = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class ContigMap:
    names: list[str]  # one a FASTA record, in file order
    starts: np.ndarray  # int64 [C]: each record's start in the concatenation
    total: int  # the concatenated length the map covers

    def resolve(self, positions, query_len=None):
        """uint32 positions [...] -> (record int32, offset int64, spans bool),
        record -1 at the 0xFFFFFFFF sentinel; spans marks a ``query_len``-long
        match that crosses into the next record (all False without
        ``query_len``, which may be an array broadcast against the positions)."""
        p = np.asarray(positions)
        valid = p != _SENTINEL
        pos = p.astype(np.int64)
        idx = np.searchsorted(self.starts, pos, side="right") - 1
        idx = np.where(valid, idx, -1).astype(np.int32)
        off = np.where(valid, pos - self.starts[np.maximum(idx, 0)], 0)
        if query_len is None:
            spans = np.zeros(p.shape, dtype=bool)
        else:
            ends = np.append(self.starts[1:], self.total)
            spans = valid & (pos + query_len > ends[np.maximum(idx, 0)])
        return idx, off, spans

    def format(self, positions, query_len=None) -> list:
        """'name:offset' for each position, with ':spans' where the match
        crosses its record's end, None at the sentinel."""
        idx, off, spans = self.resolve(positions, query_len)
        return [None if i < 0 else f"{self.names[i]}:{o}" + (":spans" if s else "")
                for i, o, s in zip(idx.reshape(-1).tolist(), off.reshape(-1).tolist(),
                                   spans.reshape(-1).tolist())]


def read_contigs(path, refsize: int | None = None) -> ContigMap:
    """The record starts of a (multi-)FASTA file, optionally gzipped, in
    concatenated space, by ``read_reference``'s rules: every non-header
    line's characters count, the scan stops once ``refsize`` bases are seen
    (the last record cut there), and a record with no sequence before that
    is not listed. A record's name is the first token of its header (the
    size for the '> <size>' header ``write_reference`` writes), ``seq<i>``
    where it has none."""
    names, starts, total = [], [], 0
    with _open(path) as fp:
        first = fp.readline()
        if not first.startswith(b">"):
            raise ValueError(f"{path}: not a FASTA file (missing '>' header)")
        pending = _header_name(first, 0)
        for line in fp:
            if line.startswith(b">"):
                pending = _header_name(line, len(names))
                continue
            seq = line.strip()
            if not seq:
                continue
            if pending is not None:
                names.append(pending)
                starts.append(total)
                pending = None
            total += len(seq)
            if refsize is not None and total >= refsize:
                total = refsize
                break
    return ContigMap(names=names, starts=np.asarray(starts, dtype=np.int64), total=total)


def _header_name(line: bytes, index: int) -> str:
    toks = line[1:].split()
    return toks[0].decode("ascii", "replace") if toks else f"seq{index}"
