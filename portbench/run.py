"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is
the result's JSON object; the last lines of standard error are the
numbers the check compared, each beside its limit. Without a CUDA card
(or with fewer than the cell asks for), without the port's package in
the checkout, or with JAX loaded once the window has closed, it prints
no result and exits with a code other than 0.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root in place of this script's folder, whose module
# names would shadow the standard library's.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.env_for_caches()

    def fail(msg: str, code: int) -> int:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)
        return code

    try:
        bench = harness.load_bench()
        chips = harness._named(bench["workloads"], args.workload,
                               "workload")["chips"]
    except (OSError, ValueError, harness.SetupError) as e:
        return fail(f"cannot read the cell: {e}", 2)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"needs {chips} CUDA device(s); "
                    f"{torch.cuda.device_count()} visible", 2)
    try:
        import pilosa_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the port's package is not in this checkout: {e}", 3)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda", t0=T0)
    except harness.SetupError as e:
        return fail(str(e), 4)
    found = harness.jax_modules()
    if found:
        return fail(f"JAX or the JAX package is loaded: {found}", 5)
    for name, v in result["checked"].items():
        print(f"check: {name} {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(f"check: correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
