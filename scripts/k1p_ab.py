"""K1's paired entry of this checkout against an earlier build on one card,
in turns.

    python3 scripts/k1p_ab.py OLD_lf_round.cu [--rounds R]

OLD is a ``tpufm_torch/csrc/lf_round.cu`` of an earlier tree, beside its own
headers (its includes resolve from OLD's directory); it exports the same
launchers as the checkout's (argument types ``kernels.SIGNATURES
["lf_round"]``). Built with nvcc by ``kernel_ab.builds`` (into
``tpufm_torch/_build/``): OLD as ``old`` and the checkout's
``csrc/lf_round.cu`` as ``new``; ptxas's registers and spill stores of the
K=3 instances of the paired and the pair entry are printed.

Shapes, each on the same inputs for every build (10 Mbase text of
``chip_smoke.SEED``, k=3 d=192, 1,048,576 x 120 bp reads of
``chip_smoke.py`` phase 4, the index built on the card):
  * ``tpufm_lf_round_paired`` at rounds 1 and 18 of phase 4's first wave
    on the paired layout (``chip_smoke.py`` phase 18(c)): the lut12 start,
    the rounds replayed by the plain version;
  * ``tpufm_lf_round_paired`` on 1,048,576 reads whose ends lie in
    consecutive blocks, the 32 blocks of a warp distinct (``next_block_reads``),
    round 18's codes: every lane takes a next half, 32 distinct ones a warp
    (the worst case for the hi slots; on no path);
  * ``tpufm_lf_round_pairs`` (K1's pair entry) at round 18 of phase 4's
    first wave on the fused rows, a control: its code is the same in both
    builds.
Both outputs (and the paired entry's ok) are held equal to each other and
to the plain version (every word), then each build is timed in turns, old,
new, new, old, R times (default 3; ``kernel_ab.in_turns``, each time
``chip_smoke.graph_ms``: a CUDA graph of 20 launches, median of 7
replays), beside the shape's bound (``chip_smoke``'s byte counts over 3.35
TB/s: the reads' iv, code, out and ok, and the table words their ends
need). Prints the card's name and power limit (nvidia-smi), a line a shape,
then one JSON line of every time. Needs a GPU.
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
from tpufm_torch import SearchEngine  # noqa: E402
from tpufm_torch.bitops import from_u32_bits  # noqa: E402
from tpufm_torch.engine import lf_round as lf_mod  # noqa: E402
from tpufm_torch.engine.codes import fuse_prefix_codes, fuse_round_codes  # noqa: E402
from tpufm_torch.host.index import IndexConfig  # noqa: E402
from tpufm_torch.host.seqio import generate_reads  # noqa: E402
from tpufm_torch.index.builder_device import build_index_device  # noqa: E402

ENTRIES = {"paired": "tpufm_lf_round_paired", "pairs": "tpufm_lf_round_pairs"}


def label(line: str):
    """The name of a K=3 instance of the paired or the pair entry's kernel
    from ptxas's "Compiling entry function" line, else None."""
    m = re.search(r"(lf_round_paired_kernel|lf_round_pairs_kernel)I((?:Li\d+E)+)", line)
    if not (m and m.group(2).startswith("Li3E")):
        return None
    kind = "paired" if m.group(1) == "lf_round_paired_kernel" else "pairs"
    return f"{kind} " + " ".join(f"{p}{x}" for p, x in zip(("k", "v", "nb"), re.findall(r"Li(\d+)E", m.group(2))))


def launcher(lib, entry: str, args: tuple):
    """A call of ``entry`` of ``lib`` on the current stream with the
    wrapper's arguments ``args`` (table, iv, code, dollar, k, d), into
    outputs of its own: (run, out) or (run, (out, ok))."""
    table, iv, code, dollar, k, d = args
    out = torch.empty_like(iv)
    ok = torch.empty(iv.shape[0], dtype=torch.bool, device=iv.device)
    extra = (ok.data_ptr(),) if entry == "paired" else ()
    call = (table.data_ptr(), table.shape[0], table.shape[1], k, d // 32, iv.data_ptr(), code.data_ptr(),
            dollar.data_ptr(), out.data_ptr(), *extra, iv.shape[0])
    return kernel_ab.runner(lib, ENTRIES[entry], call), ((out, ok) if entry == "paired" else out)


def case(name: str, entry: str, args: tuple, bound_bytes: int, libs: dict, rounds: int, **info) -> dict:
    runs = {build: launcher(lib, entry, args) for build, (lib, _) in libs.items()}
    plain = {"paired": lf_mod.lf_round_paired_reference, "pairs": lf_mod.lf_round_pairs_reference}[entry](*args)
    iv = args[1]
    blocks = iv // D
    delta = (blocks[:, 1] - blocks[:, 0]) & 0xFFFFFFFF
    return kernel_ab.in_turns(name, runs, plain, bound_bytes, rounds, entry=entry, reads=int(iv.shape[0]),
                              next_block_share=float((delta == 1).double().mean()),
                              same_block_share=float((delta == 0).double().mean()), **info)


def next_block_reads(rng, nrows: int, n: int, dev) -> torch.Tensor:
    """int64 [n, 2] reads (the second shape of the module docstring):
    lo in block b, hi in block b + 1, b running through a permutation of
    the first multiple of 32 below nrows - 2 blocks, so that the 32 reads of
    a warp lie in 32 distinct pairs."""
    P = (nrows - 2) // 32 * 32
    b = np.tile(rng.permutation(P), -(-n // P))[:n]
    lo = b * D + rng.integers(0, D, size=n)
    hi = (b + 1) * D + rng.integers(0, D, size=n)
    return torch.from_numpy(np.stack([lo, hi], axis=1)).to(dev)


def measure(libs: dict, dev: torch.device, R: int) -> list:
    """Every shape's row (see the module docstring) on ``dev``."""
    codes = np.random.default_rng(chip_smoke.SEED).integers(0, 4, chip_smoke.REF_BASES, dtype=np.uint8)
    index = build_index_device(codes, IndexConfig(k=K, d=D), device=dev)
    reads = generate_reads(codes, READ_LEN, chip_smoke.READS, seed=chip_smoke.SEED)
    q = torch.from_numpy(reads[:SearchEngine.WAVE]).to(dev)
    capture = chip_smoke.CAPTURED_ROUNDS
    eng = SearchEngine(index, dev, layout="paired", lut_m=LUT_M)
    start = from_u32_bits(eng.lut[fuse_prefix_codes(q, LUT_M)])
    body = fuse_round_codes(q[:, : READ_LEN - LUT_M], K)
    nrows = eng.entries.shape[0]

    def bound(iv, code, ok_bytes):
        return 40 * iv.shape[0] + ok_bytes + chip_smoke.k1_table_bytes(iv, code, K, D, nrows)

    rows = []
    kept = kernel_ab.replay(lf_mod.lf_round_paired_reference, (eng.entries_paired,), eng.dollar, start, body,
                            capture, K, D)
    for j, (iv, code) in kept.items():
        rows.append(case(f"K1 paired round {j}", "paired", (eng.entries_paired, iv, code, eng.dollar, K, D),
                         bound(iv, code, iv.shape[0]), libs, R, round=j))
    iv18, code18 = kept[capture[-1]]
    iv = next_block_reads(np.random.default_rng(chip_smoke.SEED + 1), eng.entries_paired.shape[0], iv18.shape[0],
                          dev)
    rows.append(case("K1 paired, every read's ends in consecutive blocks, distinct in a warp", "paired",
                     (eng.entries_paired, iv, code18, eng.dollar, K, D), bound(iv, code18, iv.shape[0]), libs, R,
                     round=capture[-1]))
    kept = kernel_ab.replay(lf_mod.lf_round_pairs_reference, (eng.entries,), eng.dollar, start, body,
                            capture[-1:], K, D)
    iv, code = kept[capture[-1]]
    rows.append(case(f"K1 pair entry round {capture[-1]} (control)", "pairs", (eng.entries, iv, code, eng.dollar, K, D),
                     bound(iv, code, 0), libs, R, round=capture[-1]))
    return rows


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("old", type=Path)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1p_ab: needs a GPU")
    print(kernel_ab.card(), flush=True)
    libs = kernel_ab.builds(args.old.resolve(), "lf_round", label)
    for name, (_, regs) in libs.items():
        print(f"{name}: {json.dumps(regs)}", flush=True)
    rows = measure(libs, torch.device("cuda", 0), args.rounds)
    print(json.dumps({"registers": {name: regs for name, (_, regs) in libs.items()}, "k1p_ab": rows}))


if __name__ == "__main__":
    main()
