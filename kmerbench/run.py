"""Run one cell of the benchmark once and print its result line.

    python3 kmerbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Needs a CUDA card (as many as the cell asks
for); exits with a code other than 0, and prints no result, without one,
or when a forbidden module (JAX, the JAX package) is loaded once the
window has closed. The last line of standard output is one JSON object;
the numbers compared for ``correct`` are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from kmerbench.harness import forbidden_modules, run_cell
    from kmerbench.spec import Spec

    chips = int(Spec(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kmerbench: {args.workload} needs {chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    power = card_power_limit()
    print(f"kmerbench: card {result['device']['kind']}, power limit {power}", file=sys.stderr)
    result["device"]["power_limit"] = power
    result["checks"] = result.pop("checks")
    found = forbidden_modules()
    if found:
        print(f"kmerbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
