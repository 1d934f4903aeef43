"""K8 and K9 of this checkout against an earlier build on one card, in turns.

    python3 scripts/k89_ab.py OLD_lf_round_split.cu [--rounds R] [--no-genome]

OLD is a ``tpufm_torch/csrc/lf_round_split.cu`` of an earlier tree, beside
its own headers (its includes resolve from OLD's directory); it exports the
same three launchers as the checkout's (``tpufm_lf_round_split``,
``tpufm_lf_round_ac``, ``tpufm_lf_answer_owned``; argument types
``kernels.SIGNATURES["lf_round_split"]``). Built with nvcc by
``kernel_ab.builds`` (into ``tpufm_torch/_build/``): OLD as ``old`` and the
checkout's ``csrc/lf_round_split.cu`` as ``new``; ptxas's registers and
spill stores of each K=3 instance are printed.

Shapes, each on the same inputs for every build (10 Mbase text of
``chip_smoke.SEED``, k=3 d=192, 1,048,576 x 120 bp reads of
``chip_smoke.py`` phase 4, the index built on the card):
  * K8 split and K8 AC at rounds 1 and 18 of phase 4's first wave, the
    (iv, code) of ``chip_smoke.layout_rounds`` (split: the lut12 start, AC:
    the full interval), the rounds replayed by the plain versions;
  * K9 on the request streams ``chip_smoke.capture_requests`` keeps on four
    colocated shards of the card (lut12, shard 0 timed): allgather at 2^20
    requests (rounds 1 and 18), a2a at D x C = 2^19 (round 1), ring at 2^17
    (a half-block, call 1) and the same half copied to an odd row offset
    (a stream base off 16 bytes);
  * unless ``--no-genome``, K9's allgather stream at 250 Mbase (round 18;
    ``bench --genome``'s text, ``recommend_config``'s k and d, built on the
    card): its table does not fit L2.
Both outputs are held equal to each other and to the plain version (every
word), then each build is timed in turns, old, new, new, old, R times
(default 3; ``kernel_ab.in_turns``, each time ``chip_smoke.graph_ms``: a
CUDA graph of 20 launches, median of 7 replays), beside the shape's bound
(``chip_smoke``'s byte counts over 3.35 TB/s). Prints the card's name and power limit (nvidia-smi), a line a
shape, then one JSON line of every time. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import kernel_ab  # noqa: E402
from chip_smoke import K, D, LUT_M, READ_LEN  # noqa: E402
from tpufm_torch import SearchEngine, bench  # noqa: E402
from tpufm_torch.bitops import from_u32_bits  # noqa: E402
from tpufm_torch.config import recommend_config  # noqa: E402
from tpufm_torch.engine import lf_round as lf_mod  # noqa: E402
from tpufm_torch.engine.codes import fuse_prefix_codes, fuse_round_codes  # noqa: E402
from tpufm_torch.host.index import IndexConfig  # noqa: E402
from tpufm_torch.host.layouts import make_alt_counters  # noqa: E402
from tpufm_torch.host.seqio import generate_reads  # noqa: E402
from tpufm_torch.index.builder_device import build_index_device  # noqa: E402
from tpufm_torch.index.sa_device import suffix_array_device_arr, upload_text  # noqa: E402
from tpufm_torch.parallel import Mesh, ShardedIndexEngine  # noqa: E402

ENTRIES = {"split": "tpufm_lf_round_split", "ac": "tpufm_lf_round_ac", "owned": "tpufm_lf_answer_owned"}


def label(line: str):
    """The name of a K=3 kernel instance from ptxas's "Compiling entry
    function" line, else None."""
    m = re.search(r"(lf_round_split_kernel|lf_answer_owned_kernel)I((?:Li\d+E)+)(Lb(\d)E)?", line)
    if not (m and m.group(2).startswith("Li3E")):
        return None
    kind = "owned" if m.group(1) == "lf_answer_owned_kernel" else ("ac" if m.group(4) == "1" else "split")
    return f"{kind} " + " ".join(f"{p}{x}" for p, x in zip(("k", "v", "nb", "g"), re.findall(r"Li(\d+)E", m.group(2))))


def launcher(lib, entry: str, args: tuple):
    """A call of ``entry`` of ``lib`` on the current stream with the
    wrapper's arguments ``args``, into an output of its own: (run, out)."""
    if entry == "owned":
        bitmaps, occ, req, shard, e_local, dollar, k, d = args
        out = torch.empty(req.shape[0], dtype=torch.int32, device=req.device)
        call = (bitmaps.data_ptr(), bitmaps.shape[0], bitmaps.shape[1], occ.data_ptr(), occ.shape[0], occ.shape[1],
                k, d // 32, req.data_ptr(), shard, e_local, dollar.data_ptr(), out.data_ptr(), req.shape[0])
    else:
        bitmaps, occ, iv, code, dollar, k, d = args
        out = torch.empty_like(iv)
        call = (bitmaps.data_ptr(), bitmaps.shape[0], bitmaps.shape[1], occ.data_ptr(), occ.shape[0], occ.shape[1],
                k, d // 32, iv.data_ptr(), code.data_ptr(), dollar.data_ptr(), out.data_ptr(), iv.shape[0])
    return kernel_ab.runner(lib, ENTRIES[entry], call), out


def case(label: str, entry: str, args: tuple, bound_bytes: int, libs: dict, rounds: int, **info) -> dict:
    runs = {name: launcher(lib, entry, args) for name, (lib, _) in libs.items()}
    plain = {"split": lf_mod.lf_round_split_reference, "ac": lf_mod.lf_round_ac_reference,
             "owned": lf_mod.lf_answer_owned_reference}[entry](*args)
    return kernel_ab.in_turns(label, runs, plain, bound_bytes, rounds, entry=entry, **info)


def owned_case(label: str, eng, req: torch.Tensor, libs: dict, rounds: int, **info) -> dict:
    args = (eng.bitmaps[0], eng.occ[0], req, 0, eng.e_local, eng.dollar[0], eng.k, eng.d)
    owned = int((from_u32_bits(req[:, 0]) // eng.e_local == 0).sum())
    return case(label, "owned", args, chip_smoke.k9_bytes(req, 0, eng.e_local, eng.k, eng.d), libs, rounds,
                requests=int(req.shape[0]), owned=owned, offset_bytes=req.data_ptr() % 16, **info)


def measure(libs: dict, dev: torch.device, R: int, genome: bool) -> list:
    """Every shape's row (see the module docstring) on ``dev``."""
    rows = []

    codes = np.random.default_rng(chip_smoke.SEED).integers(0, 4, chip_smoke.REF_BASES, dtype=np.uint8)
    index = build_index_device(codes, IndexConfig(k=K, d=D), device=dev)
    reads = generate_reads(codes, READ_LEN, chip_smoke.READS, seed=chip_smoke.SEED)
    wave = SearchEngine.WAVE
    q = torch.from_numpy(reads[:wave]).to(dev)
    capture = chip_smoke.CAPTURED_ROUNDS

    split = SearchEngine(index, dev, layout="split", lut_m=LUT_M)
    start = from_u32_bits(split.lut[fuse_prefix_codes(q, LUT_M)])
    kept = kernel_ab.replay(lf_mod.lf_round_split_reference, (split.bitmaps, split.occ), split.dollar, start,
                            fuse_round_codes(q[:, : READ_LEN - LUT_M], K), capture, K, D)
    for j, (iv, code) in kept.items():
        rows.append(case(f"K8 split round {j}", "split", (split.bitmaps, split.occ, iv, code, split.dollar, K, D),
                         40 * iv.shape[0] + chip_smoke.k1_table_bytes(iv, code, K, D, split.bitmaps.shape[0]),
                         libs, R, round=j, reads=int(iv.shape[0])))
    del split, kept
    ac = SearchEngine(make_alt_counters(index), dev)
    kept = kernel_ab.replay(lf_mod.lf_round_ac_reference, (ac.bitmaps, ac.occ_slim), ac.dollar,
                            ac._full_interval(wave), fuse_round_codes(q, K), capture, K, D)
    for j, (iv, code) in kept.items():
        rows.append(case(f"K8 AC round {j}", "ac", (ac.bitmaps, ac.occ_slim, iv, code, ac.dollar, K, D),
                         40 * iv.shape[0] + chip_smoke.ac_table_bytes(iv, code, K, D, ac.bitmaps.shape[0],
                                                                      ac.occ_slim.shape[0]),
                         libs, R, round=j, reads=int(iv.shape[0])))
    del ac, kept
    torch.cuda.empty_cache()

    mesh = Mesh([dev] * chip_smoke.MESH_SHARDS)
    mesh_wave = ShardedIndexEngine.WAVE_PER_CHIP * mesh.size
    for routing, calls in (("allgather", capture), ("a2a", capture[:1]), ("ring", (1,))):
        eng = ShardedIndexEngine(index, mesh, routing=routing, lut_m=LUT_M)
        (_, _), streams = chip_smoke.capture_requests(eng, eng.place_queries(reads[:mesh_wave]), calls)
        for j in calls:
            req = streams[j, 0]
            rows.append(owned_case(f"K9 {routing} call {j}", eng, req, libs, R, routing=routing, call=j))
            if routing == "ring":  # the same half at an odd row offset: a base off 16 bytes
                buf = torch.zeros((req.shape[0] + 1, 3), dtype=req.dtype, device=dev)
                buf[1:] = req
                rows.append(owned_case(f"K9 ring call {j}, odd row offset", eng, buf[1:], libs, R,
                                       routing=routing, call=j))
        del eng, streams
        torch.cuda.empty_cache()
    del index

    if genome:
        _, gcodes = bench._reference_codes(chip_smoke.GENOME_BASES, 0)
        rec = recommend_config(chip_smoke.GENOME_BASES)
        gcd = upload_text(gcodes, dev)
        gidx = build_index_device(gcodes, IndexConfig(k=rec["k"], d=rec["d"]), return_host=False,
                                  sa_dev=suffix_array_device_arr(gcd), codes_dev=gcd)
        del gcd
        torch.cuda.empty_cache()
        greads = generate_reads(gcodes, READ_LEN, mesh_wave, seed=chip_smoke.SEED + 19)
        eng = ShardedIndexEngine(gidx, mesh, routing="allgather", lut_m=LUT_M)
        (_, _), streams = chip_smoke.capture_requests(eng, eng.place_queries(greads), capture[-1:])
        rows.append(owned_case(f"K9 allgather call {capture[-1]}, {chip_smoke.GENOME_BASES} bases", eng,
                               streams[capture[-1], 0], libs, R, routing="allgather", call=capture[-1],
                               bases=chip_smoke.GENOME_BASES, k=rec["k"], d=rec["d"]))
    return rows


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("old", type=Path)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--no-genome", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k89_ab: needs a GPU")
    print(kernel_ab.card(), flush=True)
    libs = kernel_ab.builds(args.old.resolve(), "lf_round_split", label)
    for name, (_, regs) in libs.items():
        print(f"{name}: {json.dumps(regs)}", flush=True)
    rows = measure(libs, torch.device("cuda", 0), args.rounds, not args.no_genome)
    print(json.dumps({"registers": {name: regs for name, (_, regs) in libs.items()}, "k89_ab": rows}))


if __name__ == "__main__":
    main()
