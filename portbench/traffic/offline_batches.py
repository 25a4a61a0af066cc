"""Offline batches, closed loop: one caller issues call after call back to
back, as an offline pipeline does, with no synchronise between calls; the
window opens and closes with ``torch.cuda.synchronize()`` and lasts until
``seconds`` have passed and every batch of the ring has been called.

Parameters (the cell's ``params``): ``batch`` clips of ``clip_seconds`` at
``sample_rate``; ``ring``, the distinct batches that the calls walk in
turn, each made on the device from the seed by the signal it names
(``lib/signals.py``: ``speechlike`` noise, ``recorded`` speech); and
``keep_early`` calls among the first ``keep_from`` whose outputs are kept
for the check, drawn from the seed, besides the last call on each batch
of the ring, so that every signal of the ring is checked.

End-to-end metric: ``audio_x_realtime``, the seconds of audio of every
call completed in the window over the window's wall seconds.

``TINY``: the parameters that the benchmark's CPU tests put in place of
the cell's own, for a run at a small size."""

from __future__ import annotations

import time

import numpy as np

from portbench.lib.device import sync
from portbench.lib.signals import generator, make

TINY = {"batch": 2, "clip_seconds": 1.0, "trace_seconds": 0.2}


def prepare(sut, run) -> dict:
    p = run.params
    n = int(round(p["clip_seconds"] * p["sample_rate"]))
    g = generator(run.seed, run.device)
    ring = [make(g, spec, p["batch"], n, p["sample_rate"], run.device)
            for spec in p["ring"]]
    for x in ring:                       # every shape of the window, warm
        sut.call(x)
    sync(run.device)
    rng = np.random.default_rng(run.seed)
    keep = set(rng.choice(p["keep_from"], size=p["keep_early"],
                          replace=False).tolist())
    return {"ring": ring, "keep": keep}


def drive(sut, load: dict, run) -> dict:
    p, ring, keep = run.params, load["ring"], load["keep"]
    kept, last = {}, {}
    tracer = run.tracer
    sync(run.device)
    tracer.begin()
    t0 = time.perf_counter()
    n = 0
    while True:
        with tracer.span("call"):
            out = sut.call(ring[n % len(ring)])
        if n in keep:
            kept[n] = out
        last[n % len(ring)] = (n, out)
        n += 1
        if tracer.due():
            tracer.end(n)
        if n >= len(ring) and time.perf_counter() - t0 >= run.seconds:
            break
    tracer.end(n)
    sync(run.device)
    wall = time.perf_counter() - t0
    kept.update(dict(last.values()))
    audio = n * p["batch"] * p["clip_seconds"]
    return {
        "attempted": n, "failed": 0,
        "metrics": {"audio_x_realtime": (audio / wall, "x")},
        "inputs": [ring[i % len(ring)] for i in sorted(kept)],
        "outputs": [kept[i] for i in sorted(kept)],
        "notes": {"calls": n, "window_s": wall, "checked_calls": sorted(kept)},
    }
