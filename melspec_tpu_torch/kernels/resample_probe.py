"""K3/K4 on the card: one build of ``csrc/resample.cu`` against another,
and where the kernel's time goes.

    PYTHONPATH=<tree> python3 melspec_tpu_torch/kernels/resample_probe.py \\
        dump <dir>
    python3 -m melspec_tpu_torch.kernels.resample_probe compare <dir>...
    python3 -m melspec_tpu_torch.kernels.resample_probe cuts

``dump`` drives K3 and K4 of the ``melspec_tpu_torch`` package on the
path (its public API only, so the package of another checkout, an earlier
commit's, can be driven by this file) on inputs made from fixed seeds:
every case of ``chip_smoke.py``'s ``k3_k4_vs_plain`` phase, the serving
bulk shape (256 streams x 500 hops of 48 kHz), the 4-hop and 1-hop ticks
of the 256-stream 48 kHz fleet and the 4-hop tick of the 64-stream 8 kHz
fleet, in both precisions. It writes each output's SHA-256 and the
kernels' device times per launch (and per call, host included) to
``<dir>/dump.json``. ``compare`` holds the hashes of every dump equal,
case by case (bit-equal outputs), prints the times side by side, and
exits non-zero where any output differs. Run dumps in turns (one tree,
the other, the other, the one) on one card to compare times.

``cuts`` builds ``csrc/resample.cu`` once as it is and once with each of
its parts cut out (the span's copies; the output stores; all but one
window's FMAs), each
timed per launch at the bulk shape. A cut's output is not the function
any more; its time only shows what the part it removes costs. Each cut
must match the source exactly once, which a CPU test checks.

Every mode exits non-zero without a card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "resample.cu"
# variant -> (the text it cuts, what replaces it)
CUTS = {
    "no_span_copies": (
        "  for (; u < na; next()) cp_async4(dst + d, pa + u, true);\n"
        "  for (; u < nv; next()) cp_async4(dst + d, pb + u, true);\n"
        "  for (; u < p.span; next()) cp_async4(dst + d, p.out, false);",
        "  (void)pa, (void)pb, (void)nv, (void)na, (void)next;"),
    "no_output_stores": (
        "  if (p.vec && wb + R <= p.q) {",
        "  float sum = 0.0f;  // every window's sum stays live\n"
        "#pragma unroll\n"
        "  for (int r = 0; r < R; ++r)\n"
        "#pragma unroll\n"
        "    for (int ph = 0; ph < UP; ++ph) sum += acc[r][ph];\n"
        "  if (sum != 1.25e-38f) {\n"
        "  } else if (p.vec && wb + R <= p.q) {"),
    "one_window_fmas": (
        "        for (int r = 0; r < R; ++r) {\n"
        "          const int u = (m + r) * DOWN + c;",
        "        for (int r = 0; r < 1; ++r) {\n"
        "          const int u = (m + r) * DOWN + c;"),
}
FUNCTIONS = ("melspec_resample", "melspec_resample_error_string")
SEED = 0
BULK_S, BULK_HOPS = 256, 500
# (name, kernel, (up, down), streams, hops): the serving ticks
TICKS = [("tick_4hop_48k", "K4", (1, 3), 256, 4),
         ("tick_1hop_48k", "K3", (1, 3), 256, 1),
         ("tick_4hop_8k", "K4", (2, 1), 64, 4)]


def _timing():
    """This checkout's ``utils/timing.py``, loaded by path: ``dump`` may
    drive another checkout's package, which need not have
    ``per_launch_ms``."""
    path = Path(__file__).resolve().parents[1] / "utils" / "timing.py"
    spec = importlib.util.spec_from_file_location("_probe_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _signal(rng, s, n, dev):
    return torch.from_numpy(
        (rng.normal(size=(s, n)) * 0.2).astype(np.float32)).to(dev)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def cases(dev):
    """``(name, kernel, launch)`` for every case, inputs from fixed
    seeds; ``launch()`` returns the kernel's output."""
    from melspec_tpu_torch.kernels import resample as kres
    from melspec_tpu_torch.streaming.resample import MultiStreamResampler

    def state_len(up, down, s, precision):
        return MultiStreamResampler(up, down, s, align=160, impl="kernel",
                                    precision=precision, device=dev)._len

    out = []

    def add(name, up, down, buf, chunks, q, precision):
        sig = torch.cat([buf, chunks], dim=1)
        out.append((f"{name}/K3/{precision}", "K3",
                    lambda: kres.resample(sig, up, down, q,
                                          precision=precision)))
        if chunks.shape[1] >= buf.shape[1]:
            out.append((f"{name}/K4/{precision}", "K4",
                        lambda: kres.resample_pair(buf, chunks, up, down, q,
                                                   precision=precision)))

    # chip_smoke.py's k3_k4_vs_plain cases (its seed and signals)
    rng = np.random.default_rng(SEED + 2)
    for up, down in [(1, 3), (2, 1), (1, 2)]:
        hop_src = 160 * down // up
        for precision in ("highest", "bf3"):
            length = state_len(up, down, 1, precision)
            for s in (1, 7, 256):
                for hops in (1, 50):
                    n = hops * hop_src
                    buf = _signal(rng, s, length, dev)
                    chunks = _signal(rng, s, n, dev)
                    add(f"vs_plain_{up}_{down}_s{s}_h{hops}", up, down, buf,
                        chunks, n // down, precision)
    rng = np.random.default_rng(SEED + 30)
    for name, _, (up, down), s, hops in [("bulk_48k", None, (1, 3), BULK_S,
                                          BULK_HOPS)] + TICKS:
        n = hops * 160 * down // up
        for precision in ("highest", "bf3"):
            buf = _signal(rng, s, state_len(up, down, s, precision), dev)
            chunks = _signal(rng, s, n, dev)
            add(name, up, down, buf, chunks, n // down, precision)
    return out


def timed(name: str) -> bool:
    """The cases whose times a dump records: the bulk shape in both
    precisions and each tick's serving kernel in ``highest``."""
    shape, kernel, precision = name.split("/")
    if shape == "bulk_48k":
        return True
    return precision == "highest" and any(
        shape == t[0] and kernel == t[1] for t in TICKS)


def dump(out_dir: Path, dev) -> dict:
    from melspec_tpu_torch.kernels import resample as kres

    timing = _timing()
    rows = {}
    for name, kernel, launch in cases(dev):
        before = kres.launches[kernel]
        y = launch()
        torch.cuda.synchronize()
        if kres.launches[kernel] != before + 1:
            raise AssertionError(f"{name}: {kernel} did not launch once")
        row = dict(sha256=_digest(y), shape=list(y.shape),
                   finite=bool(torch.isfinite(y).all()))
        if timed(name):
            row.update(ms=timing.per_launch_ms(launch),
                       call_ms=timing.device_time_ms(launch))
        rows[name] = row
        del y
    import melspec_tpu_torch

    result = dict(package=str(Path(melspec_tpu_torch.__file__).parent),
                  device=torch.cuda.get_device_name(0), cases=rows)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "dump.json").write_text(json.dumps(result, indent=1))
    return result


def compare(dirs) -> int:
    dumps = [json.loads((Path(d) / "dump.json").read_text()) for d in dirs]
    names = list(dumps[0]["cases"])
    differ = [n for n in names
              if len({d["cases"].get(n, {}).get("sha256") for d in dumps})
              != 1]
    times = {n: [(d["cases"][n].get("ms"), d["cases"][n].get("call_ms"))
                 for d in dumps]
             for n in names if "ms" in dumps[0]["cases"][n]}
    print(json.dumps(dict(dumps=[str(d) for d in dirs],
                          packages=[d["package"] for d in dumps],
                          n_cases=len(names), n_equal=len(names) - len(differ),
                          differ=differ, times_ms_and_call_ms=times)),
          flush=True)
    return 1 if differ else 0


def variant_source(name: str, text: str | None = None) -> str:
    """``resample.cu`` with variant ``name``'s cut (``"full"``: as it is);
    raises unless the cut's text occurs exactly once."""
    from melspec_tpu_torch.kernels import build

    cuts = [] if name == "full" else [CUTS[name]]
    return build.edited(SOURCE, cuts, f"resample_probe cut {name!r}", text)


def run_cuts(dev) -> list:
    """Each variant's K3 time per launch at the bulk shape (K3 over the
    concat), in both precisions."""
    from melspec_tpu_torch.kernels import build
    from melspec_tpu_torch.kernels import resample as kres

    timing = _timing()
    names = ["full", *CUTS]
    libs = build.build_variants("resample_probe", "resample", {
        name: {SOURCE.name: variant_source(name)} for name in names})
    rng = np.random.default_rng(SEED + 30)
    sig = _signal(rng, BULK_S, 510 + BULK_HOPS * 480, dev)
    q = BULK_HOPS * 160
    rows = []
    for precision in ("highest", "bf3"):
        for name in names:
            with build.bound_to(kres, libs[name], FUNCTIONS):
                ms = timing.per_launch_ms(lambda: kres.resample(
                    sig, 1, 3, q, precision=precision))
            rows.append(dict(variant=name, precision=precision, ms=ms))
    for r in rows:
        full = next(f for f in rows if f["variant"] == "full"
                    and f["precision"] == r["precision"])
        r["saves_ms"] = full["ms"] - r["ms"]
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("resample_probe: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["dump"] and len(argv) == 2:
        r = dump(Path(argv[1]), dev)
        print(json.dumps(dict(package=r["package"], device=r["device"],
                              n_cases=len(r["cases"]))), flush=True)
        return 0
    if argv[:1] == ["compare"] and len(argv) >= 3:
        return compare(argv[1:])
    if argv == ["cuts"]:
        for r in run_cuts(dev):
            print(json.dumps(r), flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
