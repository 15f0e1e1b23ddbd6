"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds 2] [--controls]

For each seed, in one process: the cell's set-up, a short window at its
own load (serving: long enough to fill the run's sample of requests), and
the numbers its check compares (the program's readings).  With
``--controls`` also the readings of the reference put in the program's
place one precision below the cell's (``controls``: bfloat16 for a float32
cell, the driver's ``control_dtype`` for a bfloat16 one), for a training
cell of the reference on half of each batch, and for a float32 cell of the
program with its own bfloat16 path switched on (``compute_dtype``).
One JSON line a seed on standard output.  Not part of a benchmark run: the runs' limits
live in the traffic files and are set from these readings.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from benchmark.harness.runtime import Cell, set_cache_env  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--controls", action="store_true")
    args = parser.parse_args(argv)
    set_cache_env()
    import torch
    from benchmark.harness.session import require_cards, serve_window
    cell = Cell(args.workload)
    require_cards(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    low = Cell(args.workload)
    low.config["model_config"]["compute_dtype"] = "bfloat16"

    def readings(cell, seed):
        """(work, the program's readings, seconds of the check)."""
        work = cell.driver.build(cell, seed, "cuda")
        sample = []
        if work.kind == "serve":
            _, _, _, sample = serve_window(
                work, args.seconds, int(cell.traffic["sample_batches"]),
                seed, "cuda")
        work.release()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        got = {n: v for n, v, _ in work.check(sample)}
        return work, sample, got, time.perf_counter() - t

    for seed in args.seeds:
        t0 = time.perf_counter()
        work, sample, got, check_s = readings(cell, seed)
        line = {"seed": seed, "program": got, "check_s": check_s}
        if args.controls:
            line.update(work.controls(sample, getattr(
                work, "control_dtype", torch.bfloat16)))
            del work, sample
            torch.cuda.empty_cache()
            if "compute_dtype" not in cell.traffic:
                line["program_bf16"] = readings(low, seed)[2]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
