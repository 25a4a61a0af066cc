"""Mean device ms a call of the frontend step's last two stages together,
the program's spans ``frontend_step.vad`` (the VAD's smoothing, the
valid-frame mask and the aggregates) and ``frontend_step.quant`` (the u8
quantisation of the mel block and its range). Layer: frontend step: VAD
aggregates and u8. Moves ``audio_x_realtime``."""

from portbench.lib.spans import stage_ms

UNIT = "ms"


def read(view):
    return stage_ms(view, ("frontend_step.vad", "frontend_step.quant"))
