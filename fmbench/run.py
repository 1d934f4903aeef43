"""Run one cell of BENCHMARK.json on one card and print its result line.

    python3 fmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
with the reference beside its limit (also the last lines of standard error).
Exits non-zero, printing no result, without as many CUDA devices as the cell
asks for, without the program beside this folder, or when a module of jax,
jaxlib, flax or tpufm is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_interop_threads(1)
    from fmbench import harness, registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"fmbench: {args.workload} needs {cell['chips']} CUDA device(s); torch sees {have}",
              file=sys.stderr)
        return 3
    try:
        import tpufm_torch  # noqa: F401
    except ImportError as e:
        print(f"fmbench: the program is not beside the benchmark: {e}", file=sys.stderr)
        return 4
    metrics = registry.metrics(bench, cell["name"], bool(args.trace))
    readers = {m["name"]: registry.metric(m["name"]) for m in metrics}
    traffic = registry.traffic(cell["traffic"])
    result = harness.run(registry.config(bench, cell["config"]), traffic, metrics, readers,
                         registry.entry(traffic["entry"]), args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    harness.log(f"setup {json.dumps(result['setup_stages'])}; batches {json.dumps(result['batches'])}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
