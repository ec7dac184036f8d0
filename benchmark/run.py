"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the CUDA card it is started on and nowhere else: without a card
(or with fewer than the cell asks for) it exits 2 and prints no result.
With ``--trace 0`` it reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled stretch of frames.
Either way it checks frames the window produced against the plain
reference and prints, last on standard error and last in the result
line, each compared number beside its limit. The last line of standard
output is the result: correct, attempted, failed, metrics, device (and
breakdown when traced).
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.core import cell, registry

    bench = registry.load_benchmark()
    chips = registry.find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    cell.clean_environment()
    result = cell.run(bench, args.workload, args.seed & (2**64 - 1), args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START)
    bad = cell.forbidden_modules()
    if bad:
        print(f"error: JAX or the JAX package is loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = card
    print(f"result on [{card}]: correct {result['correct']}, attempted "
          f"{result['attempted']}, failed {result['failed']}", flush=True)
    for name, n in result["checks"].items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
