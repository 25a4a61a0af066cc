"""Mean device ms a call of NeMo log-mel's pad, the program's span
``logmel.pad`` (``ops/batch_logmel.py::BatchLogMel.compute``: the
preemphasis and the centre or exact pad, and the card's idle time between
them). Layer: NeMo log-mel: pad. Moves ``audio_x_realtime``. None where
the program records no such span."""

from portbench.lib.spans import stage_ms

UNIT = "ms"


def read(view):
    return stage_ms(view, ("logmel.pad",))
