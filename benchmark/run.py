"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  It
draws the weights and inputs from ``--seed`` on the card, warms up every
shape of the cell (set-up), measures for ``--seconds`` seconds, with
``--trace 1`` then traces a short window under ``torch.profiler``, checks
the outputs against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; the compared numbers beside their
limits come last in it and on standard error.  Without the cell's cards it
exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]
# Python's bytecode is a compile cache like the kernels': written inside the
# checkout, at a fixed path, even where the environment forbids writing it
# beside the sources, so that only a checkout's first run compiles torch's
# modules from source (some 15 s of a train cell's set-up on the card).
sys.pycache_prefix = str(ROOT / "build" / "benchmark_cache" / "pycache")
sys.dont_write_bytecode = False

from benchmark.harness.runtime import (  # noqa: E402
    forbidden_loaded, set_cache_env)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_cache_env()
    from benchmark.harness.session import NoCard, log, run_cell
    try:
        result, checked = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), T_START)
    except NoCard as err:
        print(f"[bench] {err}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_loaded()
    if found:
        print(f"[bench] the process holds {found}: the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr, flush=True)
        return 3
    for name, value, limit in checked:
        log(f"checked {name} = {value!r} (limit {limit!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
