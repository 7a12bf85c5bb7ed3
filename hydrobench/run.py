"""Run one cell of the benchmark of troute_torch once, from the root of a
checkout:

    python3 hydrobench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result (one JSON object); the
numbers the correctness check compared, each with its limit, are the last
lines of standard error.  Without a CUDA device, or with fewer than the
cell asks for, or without the program beside it, the run exits with a
code other than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import os  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# kernel caches at fixed paths inside the checkout (the program builds its
# own CUDA kernels under build/troute_torch/), so that a checkout's later
# runs find them
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ.setdefault(_var, str(ROOT / "build" / "hydrobench" / _sub))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hydrobench import harness, measure
    try:
        manifest = harness.load_json(ROOT / "BENCHMARK.json")
        wl, _, _ = harness.cell(manifest, args.workload, ROOT)
        import torch
        if not torch.cuda.is_available():
            raise harness.RunError("no CUDA device is visible")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise harness.RunError(
                f"{args.workload} needs {wl['chips']} CUDA devices, "
                f"{torch.cuda.device_count()} visible")
        try:
            import troute_torch  # noqa: F401
        except ImportError as e:
            raise harness.RunError(f"the program is missing: {e}")
        harness.log(measure.smi_query("name,power.limit,clocks.max.sm"))
        result = harness.run(manifest, ROOT, args.workload, args.seed,
                             args.seconds, bool(args.trace), "cuda:0",
                             T_START)
        foreign = measure.foreign_modules()
        if foreign:
            raise harness.RunError("foreign modules loaded: "
                                   + ", ".join(foreign))
    except harness.RunError as e:
        harness.log(f"hydrobench: {e}")
        return 2
    for c, v in result["checks"].items():
        harness.log(f"check {c}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
