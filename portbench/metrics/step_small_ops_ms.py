"""Device milliseconds a step in operations other than K1 and K2: the
step's composition in PyTorch (NeMo's preemphasis, pad and per-feature
normalisation, Kaldi's CMN, the VAD's smoothing and aggregates, the u8
quantisation). Layer: frontend step composition. Moves
``audio_x_realtime``."""

from portbench.lib.registry import load_module

UNIT = "ms"


def read(view):
    if not view.ops or not view.units:
        return None
    kernels = load_module("roofline", "k1").KERNELS + load_module(
        "roofline", "k2").KERNELS
    rest = [o for o in view.ops if not any(k in o[0] for k in kernels)]
    return sum(e - s for _, s, e in rest) / 1e6 / view.units
