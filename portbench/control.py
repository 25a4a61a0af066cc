"""Readings that a cell's comparison limits are set from, on the card:
each seed's run of the program (the lower readings) and, on the same
inputs, the reference computed in TF32 in the program's place (the
control, the upper readings), all in one process.

    python3 portbench/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

One JSON line a seed, then a summary line: per number the largest
reading of the program and the smallest of the control, beside the
cell's limit. The benchmark's own runs do not run the control."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    program, control, limits = {}, {}, {}
    t0 = T_START
    for seed in args.seeds:
        out = run.run_cell(args.workload, seed, args.seconds, False, dev, t0,
                           control=True)
        t0 = time.perf_counter()
        res, notes = out["result"], out["notes"]
        got = {k: c["value"] for k, c in res["checks"].items()}
        limits = {k: c["limit"] for k, c in res["checks"].items()}
        for k, v in got.items():
            v = float("inf") if v is None else v
            program[k] = max(program.get(k, 0.0), v)
        for k, v in notes["control"].items():
            control[k] = min(control.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": got, "control": notes["control"],
                          "metrics": res["metrics"],
                          "route": notes["route"]}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": program, "upper": control,
                      "limits": limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
