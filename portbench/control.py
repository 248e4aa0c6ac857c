"""The control of a cell's check: the plain reference put in the
program's place in its lower-resolution form (``control=True``), its
answers served as the server serialises them and judged by the
harness's own check (``harness.check_answers`` and ``verdict``).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        --requests <n> [--device cuda]

For each seed it makes the configuration's data and the first ``n``
requests of the window's stream (as a run sends them), and prints one
JSON line with what the check read: ``correct``, which a sound check
gives as false here, and the numbers compared beside their limits. The
benchmark's own runs never run this; it imports nothing of the program.
"""

import argparse
import importlib
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402
from portbench.gen import Traffic, load_mix  # noqa: E402


def readings(workload: str, seed: int, n_requests: int, device: str,
             overrides: dict = None) -> dict:
    bench = harness.load_bench()
    wl = harness._named(bench["workloads"], workload, "workload")
    centry = harness._named(bench["configs"], wl["config"], "configuration")
    with open(harness.ROOT / centry["file"]) as f:
        cfg = json.load(f)
    cfg.update(overrides or {})
    mix = load_mix(str(harness.BENCH_DIR / "traffic"
                       / f"{wl['traffic']}.json"))
    sizes = {k: v for k, v in cfg.items() if isinstance(v, int)}
    dataset = importlib.import_module(f"portbench.datasets.{cfg['kind']}")
    refmod = importlib.import_module(f"portbench.reference.{cfg['kind']}")
    t0 = time.monotonic()
    data = dataset.generate(cfg, seed, device)
    traffic = Traffic(mix, sizes, seed)
    texts = [traffic.request("window", 0, i)[0] for i in range(n_requests)]
    ctl = refmod.Reference(cfg, data, device, control=True)
    records = [{"pql": t, "status": 200, "calls": 1,
                "body": json.dumps({"results": ctl.answer(t)})}
               for t in texts]
    del ctl
    checked = harness.check_answers(refmod.Reference(cfg, data, device),
                                    records)
    correct, shown = harness.verdict(checked)
    return {"workload": workload, "seed": seed, "requests": n_requests,
            "correct": correct, "checked": shown,
            "seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.requests,
                                  args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
