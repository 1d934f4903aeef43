"""Multi-process SPMD worker of the port for tests/test_torch_multiprocess.py.

Each process joins one ``torch.distributed`` group (gloo, over a localhost
TCP coordinator) through ``initialize_distributed``, owns ``--shards`` CPU
shards (or shards on one card with ``--device cuda``) of the global mesh
that ``make_mesh()`` then spans, builds the same small index from the same
seeds, runs every mesh engine and the sharded build over the global mesh,
and writes its own view of each (replicated) result, then each collective's
result for the shards it owns and the collectives' logs. It imports the
port only (no jax, no tpufm). Run:

    python torch_distworker.py COORDINATOR NPROC PID OUTDIR [--shards 2] [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpufm_torch.engine.paired import PairedEndEngine  # noqa: E402
from tpufm_torch.host.formats import load_store_sharded, save_store_sharded  # noqa: E402
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail  # noqa: E402
from tpufm_torch.host.locate import build_locate  # noqa: E402
from tpufm_torch.host.seqio import generate_read_pairs, generate_reads  # noqa: E402
from tpufm_torch.index.builder_sharded import build_index_sharded, build_locate_sharded  # noqa: E402
from tpufm_torch.index.sa_sharded import suffix_array_sharded  # noqa: E402
from tpufm_torch.parallel import (  # noqa: E402
    DataParallelEngine,
    DataParallelLocate,
    DataParallelSearchLocate,
    ShardedIndexEngine,
    assert_collective_model,
    initialize_distributed,
    make_mesh,
    shutdown_distributed,
)
from tpufm_torch.parallel import collectives as coll  # noqa: E402

#: the collectives' inputs: rows of shard s's tensors, and the perm forms
COLL_ROWS = 5
PERMS = {"ring": 1, "back": -1, "pairs_ring": "ring", "shift": "shift", "swap": [(0, 1), (1, 0), (2, 2)],
         "cross": [(0, 3), (3, 0), (1, 2)], "none": []}


def perm_of(name: str, D: int):
    p = PERMS[name]
    if p == "ring":
        return [(i, (i + 1) % D) for i in range(D)]
    if p == "shift":
        return [(i, i + 1) for i in range(D - 1)]
    return p


def shard_input(s: int, dtype=np.int32, rows: int = COLL_ROWS) -> torch.Tensor:
    """Shard s's collective input: uint32-range words as int32 bits (the
    sums wrap), or int64."""
    rng = np.random.default_rng(100 + s)
    if dtype == np.int32:
        return torch.from_numpy(rng.integers(0, 2**32, size=(rows, 3), dtype=np.uint64).astype(np.uint32).view(np.int32))
    return torch.from_numpy(rng.integers(-2**40, 2**40, size=(rows, 3), dtype=np.int64))


def run_collectives(mesh, save) -> list:
    """Every collective on this process's shards; returns the log."""
    D, dev = mesh.size, mesh.devices[0]
    mine = mesh.local_shards
    xs = [shard_input(s).to(d) for s, d in zip(mine, mesh.devices)]
    wide = [shard_input(s, np.int64).to(d) for s, d in zip(mine, mesh.devices)]
    a2a = [torch.from_numpy(np.arange(D * 2, dtype=np.int32).reshape(D, 2) + 100 * s).to(d)
           for s, d in zip(mine, mesh.devices)]
    ragged = [torch.arange(s + 1, dtype=torch.int64, device=d) * 10 + s for s, d in zip(mine, mesh.devices)]
    with coll.recording() as log:
        outs = {"all_gather": coll.all_gather(xs, mesh), "psum": coll.psum(xs, mesh),
                "psum64": coll.psum(wide, mesh), "pmax": coll.pmax(xs, mesh), "pmax64": coll.pmax(wide, mesh),
                **{f"ppermute_{name}": coll.ppermute(xs, perm_of(name, D), mesh) for name in PERMS},
                "all_to_all": coll.all_to_all(a2a, mesh),
                "relayout": coll.relayout(xs, 17, 6, mesh), "relayout_short": coll.relayout(xs, 9, 3, mesh)}
        gathered = coll.gather(ragged, mesh)
    for name, out in outs.items():
        for s, x in zip(mine, out):
            assert x.device == mesh.devices[s - mine[0]]
            save(f"coll_{name}_{s}", x.cpu().numpy())
    assert gathered.device == dev
    save("coll_gather", gathered.cpu().numpy())
    return [{"kind": c.kind, "shape": list(c.shape), "dtype": str(c.dtype), "bytes": c.bytes, "cross": c.cross}
            for c in log]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("coordinator")
    ap.add_argument("nproc", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    pid, out = args.pid, args.outdir

    def save(name, arr):
        np.save(os.path.join(out, f"{name}_{pid}.npy"), np.asarray(arr))

    cuda = args.device == "cuda"
    initialize_distributed(args.coordinator, num_processes=args.nproc, process_id=pid, backend="gloo",
                           timeout=120, local_device_ids=[0] * args.shards if cuda else None)
    mesh = make_mesh(args.shards * args.nproc, device=args.device)
    assert (mesh.size, mesh.process_count, mesh.process_index) == (args.shards * args.nproc, args.nproc, pid)
    assert mesh.local_shards == tuple(range(pid * args.shards, (pid + 1) * args.shards))
    dev = mesh.devices[0]

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32))
    queries = generate_reads(codes, 24, 64, seed=8)
    save("queries", queries)

    # data-parallel: every process searches the same batch, each its shards' part
    save("result", DataParallelEngine(index, mesh, lut_m=4).search(queries))
    varlen = queries.copy()
    varlen[::3, :5] = 0xFF  # every third read 19 bp, right-aligned
    save("varlen_in", varlen)
    save("varlen", DataParallelEngine(index, mesh, lut_m=4, tail_index=derive_tail(index)).search_varlen(varlen))
    save("count_mm1", DataParallelEngine(index, mesh).count(queries, mismatches=1))
    traffic = {"dp": assert_collective_model(DataParallelEngine(index, mesh), queries)}
    # sharded-index mode: the entry table split over the global mesh, every
    # routing's lookups crossing both processes
    for routing in ("allgather", "ring", "a2a"):
        sh = ShardedIndexEngine(index, mesh, routing=routing, lut_m=2)
        save(f"result_{routing}", sh.search(queries))
        traffic[routing] = assert_collective_model(ShardedIndexEngine(index, mesh, routing=routing), queries)

    # locate: replicated tables, a row batch off the mesh multiple
    loc = build_locate(codes, sample_rate=8, d=32)
    rows = rng.integers(0, len(codes) + 1, size=101, dtype=np.uint32)
    save("locate", DataParallelLocate(loc, mesh).locate_rows(rows))
    save("locate_rows", rows)

    # the sharded build across processes, and a sharded search of its index
    idx_sh = build_index_sharded(codes, IndexConfig(k=2, d=32), mesh)
    save("shbuild_occ", np.asarray(idx_sh.occ, np.uint32))
    save("shbuild_bitmaps", np.asarray(idx_sh.bitmaps, np.uint32))
    save("result_shbuild", ShardedIndexEngine(idx_sh, mesh).search(queries))
    tables = build_index_sharded(codes, IndexConfig(k=2, d=32), mesh, return_host=False)
    assert [s for s, x in enumerate(tables.occ) if x is not None] == list(mesh.local_shards)
    save("result_shtables", ShardedIndexEngine(tables, mesh, routing="a2a").search(queries))
    root = save_store_sharded(os.path.join(out, "sharded.tpufm"), tables)
    loaded = load_store_sharded(root, mesh)
    assert [s for s, x in enumerate(loaded.occ) if x is not None] == list(mesh.local_shards)
    save("result_store", ShardedIndexEngine(loaded, mesh).search(queries))
    save("sa_sharded", suffix_array_sharded(codes, mesh))
    sloc = build_locate_sharded(codes, sample_rate=8, d=32, mesh=mesh)
    for name in ("samples", "mark_words", "mark_rank"):
        save(f"shloc_{name}", getattr(sloc, name))

    # search-and-locate, Hamming <= 1, seed-and-extend and edits across processes
    mut = np.stack([codes[s:s + 24].copy() for s in rng.integers(0, 4000, 21)])
    for i in range(21):
        for p in rng.choice(24, size=2, replace=False):
            mut[i, p] = (mut[i, p] + rng.integers(1, 4)) & 3
    save("seed_mut", mut)
    dpsl = DataParallelSearchLocate(index, loc, mesh, max_hits=8)
    spos, scnt, sovf = dpsl.locate_approx(mut, codes, mismatches=2, seed_hits=64)
    save("seed_pos", spos)
    save("seed_cnt", scnt)
    save("seed_ovf", sovf)
    iv, pos = DataParallelSearchLocate(index, loc, mesh, max_hits=8, lut_m=4).search_locate(queries)
    save("sl_iv", iv)
    save("sl_pos", pos)
    save("mm1_pos", dpsl.locate_mismatch(mut))
    epos, ecnt, eovf = dpsl.locate_edits(mut, codes, edits=2, seed_hits=64)
    save("edit_pos", epos)
    save("edit_cnt", ecnt)
    save("edit_ovf", eovf)
    r1, r2 = generate_read_pairs(codes, 24, 19, 60, 200, seed=9)
    save("pairs_r1", r1)
    save("pairs_r2", r2)
    for name, kw in (("exact", {}), ("m2", {"mismatches": 2, "text": codes}), ("e1", {"edits": 1, "text": codes})):
        got = PairedEndEngine(index, loc, 60, 200, max_hits=8, mesh=mesh, **kw).pair(r1, r2)
        for i, arr in enumerate(got):
            save(f"paired_{name}_{i}", arr)

    log = run_collectives(mesh, save)
    with open(os.path.join(out, f"meta_{pid}.json"), "w") as f:
        json.dump({"log": log, "traffic": {k: {f: v[f] for f in ("bytes", "within", "across")}
                                           for k, v in traffic.items()},
                   "device": str(dev)}, f)
    shutdown_distributed()
    print(f"worker {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
