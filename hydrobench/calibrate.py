"""Readings that the correctness limits are set from, for one cell, in one
process on the card:

    python3 hydrobench/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        --seconds 3 [--out FILE]

For each seed: a whole run of the cell (set-up, a closed-loop window of
``--seconds``, the judge) and then the control on the same kept units: the
plain reference computed in bfloat16 in the program's place, judged
against the float32 reference.  One JSON line per seed holds the
program's numbers and the control's for every kept unit.  The lower
reading of a number is the largest that the program gives over the
seeds, its upper reading the smallest that the control gives.  The
benchmark's own runs never run the control.
"""

import time

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from hydrobench import harness
    if not torch.cuda.is_available():
        harness.log("hydrobench: no CUDA device is visible")
        return 2
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run(manifest, ROOT, args.workload, seed, args.seconds,
                        False, "cuda:0", t0, control=True)
        line = json.dumps(dict(workload=args.workload, seed=seed,
                               correct=r["correct"], checks=r["checks"],
                               control=r["control"], metrics=r["metrics"],
                               seconds=time.perf_counter() - t0))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
