"""Resumable query-stream search and locate: ``search --resume`` and
``locate --resume``.

Counterpart of tpufm/io/stream.py (``_fingerprint`` :31, ``_default_wave``
:43, ``search_resumable`` :52, ``locate_resumable`` :73,
``_stream_resumable`` :94). Reads go through the engine in fixed waves;
each completed wave's rows append to a raw ``<out>.partial`` file beside a
JSON sidecar ``<out>.progress`` recording the progress, so a killed run
re-invoked with the same arguments skips the finished waves and continues.
On completion the partial file holds exactly one row a read and both files
are removed. The checkpoints are tpufm's, byte for byte: either package
continues the other's.

The sidecar carries a fingerprint: the CRC32 of the query bytes and of the
index's ``(bwtsize, k, d)``, then of the row width. A re-invocation against
other reads, or an index of another size, k or d, restarts from zero
instead of splicing stale waves into the result (as in tpufm, the text
itself is not hashed, so another text of the same size, k and d is not
told apart). tpufm's engines hold k and d in
``.config``; the port's ``SearchEngine`` holds them as attributes, and
``SearchLocateEngine`` in its ``search_engine``, from which the same triple
is read; the mesh engines (tpufm_torch.parallel) hold them as attributes too.

A mesh engine (one with a ``mesh``) takes batches of a mesh multiple: as in
tpufm (:44-48, :99-145), a sharded engine's wave is its ``WAVE_PER_CHIP``
times the mesh size and the wave is rounded down to a mesh multiple (the
engine pads a last chunk off the mesh multiple by cycling its own reads and
drops the pad's rows), so a ``search --mesh N --resume`` run writes tpufm's
checkpoints.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from pathlib import Path

import numpy as np

from tpufm_torch.engine.search import mesh_wave


def _index_identity(engine) -> tuple:
    """(bwtsize, k, d) of the index ``engine`` searches, as Python ints."""
    inner = getattr(engine, "search_engine", engine)
    return tuple(int(getattr(inner, name, 0)) for name in ("bwtsize", "k", "d"))


def _fingerprint(engine, queries: np.ndarray) -> int:
    """CRC32 of the query bytes and the engine's index identity."""
    crc = zlib.crc32(np.ascontiguousarray(queries))
    return zlib.crc32(repr(_index_identity(engine)).encode(), crc)


def _default_wave(engine) -> int:
    """The engine's own wave: 2^20 reads for ``SearchEngine`` and
    ``DataParallelEngine``, 2^18 for ``SearchLocateEngine``,
    ``WAVE_PER_CHIP`` times the mesh size for ``ShardedIndexEngine``, as
    tpufm's engines."""
    per_chip = getattr(engine, "WAVE_PER_CHIP", None)
    if per_chip is not None:
        return per_chip * engine.mesh.size
    return getattr(engine, "WAVE", 1 << 20)


def search_resumable(engine, queries: np.ndarray, out_path, wave: int | None = None,
                     stats: dict | None = None, step=None) -> np.ndarray:
    """Stream ``queries`` through ``engine.search`` wave by wave,
    checkpointing to ``<out_path>.partial`` / ``.progress``. Returns the
    full uint32 [B, 2] result (waves completed by an earlier run read back
    from the checkpoint). ``step`` goes on to ``engine.search``.

    If ``stats`` is given, ``stats['search_s']`` gets the search seconds of
    this invocation, checkpoint writes excluded: the number ``TIME:``
    reports. Each wave's result is on the host when its clock stops.
    """
    return _stream_resumable(
        lambda chunk: np.asarray(engine.search(chunk, step=step), dtype=np.uint32),
        engine, queries, out_path, 2, wave, stats,
    )


def locate_resumable(engine, queries: np.ndarray, out_path, wave: int | None = None,
                     stats: dict | None = None) -> np.ndarray:
    """Positions twin of ``search_resumable``: ``engine`` is a
    ``SearchLocateEngine``; each completed wave checkpoints its uint32
    [W, engine.max_hits] position rows. The row width comes from the engine
    itself."""
    return _stream_resumable(
        lambda chunk: np.ascontiguousarray(np.asarray(engine.search_locate(chunk)[1], dtype=np.uint32)),
        engine, queries, out_path, engine.max_hits, wave, stats,
    )


def _stream_resumable(run, engine, queries, out_path, row_words, wave, stats):
    """The wave-checkpointed loop: run(chunk) -> uint32 [len(chunk),
    row_words]; rows append to .partial, with an atomically replaced
    .progress sidecar (fingerprinted, safe against a torn write)."""
    wave = wave or _default_wave(engine)
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:  # the engine pads a chunk to a mesh multiple itself
        wave = max(mesh.size, mesh_wave(wave, mesh.size))
    out_path = Path(out_path)
    part = out_path.with_suffix(out_path.suffix + ".partial")
    prog = out_path.with_suffix(out_path.suffix + ".progress")

    B = queries.shape[0]
    row_bytes = 4 * row_words
    n_waves = -(-B // wave)
    fp_now = zlib.crc32(repr(row_words).encode(), _fingerprint(engine, queries))
    state = {"total": B, "wave": wave, "done_waves": 0, "fingerprint": fp_now}
    if prog.exists() and part.exists():
        try:
            prev = json.loads(prog.read_text())
        except (json.JSONDecodeError, OSError):
            prev = {}  # torn sidecar (crash mid-write): restart from zero
        if (
            prev.get("total") == B
            and prev.get("wave") == wave
            and prev.get("fingerprint") == fp_now
            and 0 < prev.get("done_waves", 0) <= n_waves
            and part.stat().st_size == min(prev["done_waves"] * wave, B) * row_bytes
        ):
            state = prev

    search_s = 0.0
    start_wave = state["done_waves"]
    with open(part, "r+b" if start_wave else "wb") as fp:
        fp.seek(min(start_wave * wave, B) * row_bytes)
        for w in range(start_wave, n_waves):
            t0 = time.perf_counter()
            res = run(queries[w * wave:(w + 1) * wave])
            search_s += time.perf_counter() - t0
            fp.write(np.ascontiguousarray(res).tobytes())
            fp.flush()
            os.fsync(fp.fileno())
            state["done_waves"] = w + 1
            # a crash mid-write must leave the old or the new sidecar, never torn JSON
            tmp = prog.with_suffix(prog.suffix + ".tmp")
            tmp.write_text(json.dumps(state))
            os.replace(tmp, prog)

    if stats is not None:
        stats["search_s"] = search_s
    out = np.fromfile(part, dtype=np.uint32).reshape(B, row_words)
    part.unlink()
    prog.unlink()
    return out
