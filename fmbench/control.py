"""The control of a cell: the plain reference with one guarantee broken, put
in the program's place, must come out as not correct.

    python3 fmbench/control.py --workload <cell> --seeds <n> <n> <n>

makes each seed's text and pool of batches exactly as a run does, answers
every batch with the cell's entry's ``control`` (exact search: the read's
last round, its first k bases, left out; Hamming <= 1 counts: the
substitutions left out, exact counts) and compares those answers with the
reference's, as a run compares the program's. It prints one JSON line a seed
with each number compared beside its limit. The program is not run or
imported.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def control_readings(config: dict, traffic: dict, entry, seed: int, device) -> dict:
    """{number compared: the control's reading} for one seed."""
    from fmbench import gen, harness

    text = gen.make_text(config["text_bases"], seed, device)
    pool = gen.make_pool(text, traffic, seed)
    text_host = text.cpu().numpy()
    del text
    wrong, _ = harness.check(entry, [None] * len(pool), pool, text_host, config, traffic, device,
                             answers=entry.control)
    return wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from fmbench import registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    traffic = registry.traffic(cell["traffic"])
    config = registry.config(bench, cell["config"])
    entry = registry.entry(traffic["entry"])
    for seed in args.seeds:
        t = time.perf_counter()
        wrong = control_readings(config, traffic, entry, seed, torch.device(args.device))
        reads = traffic["batch_reads"] * traffic["pool_batches"]
        print(json.dumps({"workload": args.workload, "seed": seed, "reads": reads, "seconds": time.perf_counter() - t,
                          "correct": all(v <= 0 for v in wrong.values()),
                          "checks": {n: {"value": v, "limit": 0} for n, v in wrong.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
