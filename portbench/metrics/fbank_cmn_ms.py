"""Mean device ms a call of Kaldi fbank's CMN, the program's span
``fbank.cmn`` (``ops/fbank.py::Fbank.compute`` on the ``"sig"`` route:
each bin's mean over the clip and its subtraction, and the card's idle
time between them). Layer: Kaldi fbank: CMN. Moves ``audio_x_realtime``.
None where the program records no such span."""

from portbench.lib.spans import stage_ms

UNIT = "ms"


def read(view):
    return stage_ms(view, ("fbank.cmn",))
