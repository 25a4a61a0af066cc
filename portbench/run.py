"""Run one cell of the benchmark on the card and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``workloads/<cell>.json``) names its configuration
(``configs/<name>.json``), its traffic kind (``traffic/<kind>.py``), its
entry into the program (``entries/<name>.py``), its metrics and the limits
of its comparison. Nothing here names a cell, a configuration, a traffic
kind, an entry or a metric.

A run: load the files; build the program's objects; make the inputs from
the seed and warm up the cell's shapes (set-up, ``setup_s``, from process
start); measure for ``--seconds``; with ``--trace 1`` profile the first
``trace_seconds`` of the window and read the cell's per-layer metrics from
it; compare what the timed path produced with the plain reference; print
notes, then each compared number beside its limit on standard error, and
the result as the last line of standard output.

Exits 2 without a result where CUDA is missing or the card count is below
the cell's ``chips``, and 3 where ``jax``, ``jaxlib``, ``flax`` or
``melspec_tpu`` is loaded in this process once the window has closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.lib.device import sync  # noqa: E402
from portbench.lib.registry import load_json, load_module  # noqa: E402
from portbench.lib.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "melspec_tpu")


@dataclasses.dataclass
class Run:
    """What a traffic module is handed: the seed, the window's length, the
    device, the cell's parameters and the tracer."""

    seed: int
    seconds: float
    device: torch.device
    params: dict
    tracer: Tracer


def forbidden_modules(names=None) -> list:
    """Modules of ``names`` (default: those loaded) whose top-level name is
    one of ``FORBIDDEN``, compared whole (``melspec_tpu_torch`` is not
    ``melspec_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _card_notes() -> str:
    """The card's name, power limit, clocks and temperature, as
    ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def _judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limit has its number, finite and at
    most the limit. A number that could not be measured (infinite: other
    shapes or validity, a value that is not finite) is written as null."""
    ok = set(numbers) == set(limits)
    checks = {}
    for k, lim in limits.items():
        v = numbers.get(k, math.inf)
        ok = ok and math.isfinite(v) and v <= lim
        checks[k] = {"value": v if math.isfinite(v) else None, "limit": lim}
    return ok, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, overrides=None,
             control: bool = False) -> dict:
    """One run of cell ``name`` on ``device``. Returns ``{"result": the
    result line's dict, "notes": dict}``; with ``control`` the notes also
    hold the numbers of the reference's TF32 control on the same inputs.
    ``overrides`` replaces parameters of the cell (the tests' small
    sizes)."""
    cell = load_json("workloads", name)
    config = load_json("configs", cell["config"])
    params = {**cell["params"], **(overrides or {})}
    traffic = load_module("traffic", cell["traffic"])
    entry = load_module("entries", cell["entry"])
    sut = entry.build(config, params, device)
    tracer = Tracer(trace, params["trace_seconds"], sut.counters,
                    sut.kernel_shapes(), device)
    run = Run(int(seed), float(seconds), device, params, tracer)
    load = traffic.prepare(sut, run)
    sync(device)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        # the peak of the window: what set-up made only to generate the
        # traffic is not the program's
        torch.cuda.reset_peak_memory_stats(device)
    window = traffic.drive(sut, load, run)
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    notes = {"cell": name, "seed": seed, "route": sut.route,
             "setup_s": setup_s, **window["notes"]}
    del sut, load
    if device.type == "cuda":
        torch.cuda.empty_cache()

    truth = entry.reference(config, params, window["inputs"], "float64")
    numbers = entry.compare(config, params, window["outputs"], truth)
    correct, checks = _judge(numbers, cell["limits"])
    if control:
        tf32 = entry.reference(config, params, window["inputs"], "tf32")
        notes["control"] = entry.compare(config, params, tf32, truth)

    if trace:
        view = tracer.view
        metrics = {}
        for m in cell["per_layer"]:
            reader = load_module("metrics", m)
            value = reader.read(view)
            if value is not None:
                metrics[m] = {"value": value, "unit": reader.UNIT}
    else:
        measured = {"setup_s": (setup_s, "s"), **window["metrics"]}
        metrics = {m: {"value": measured[m][0], "unit": measured[m][1]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=view.busy_s(), window_s=view.window_s)
        result["breakdown"] = view.breakdown()
        notes["trace"] = {"units": view.units, "counters": view.counters}
    result["checks"] = checks
    return {"result": result, "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = load_json("workloads", args.workload)["chips"]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < chips:
        print(f"portbench: needs {chips} CUDA device(s), found {count}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    notes = dict(out["notes"], card=_card_notes())
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for k, c in out["result"]["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
