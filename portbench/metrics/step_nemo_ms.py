"""Mean device ms a call of the frontend step's NeMo stage, the program's
span ``frontend_step.nemo`` (preemphasis, pads, K1, per-feature
normalisation, and the card's idle time between them). Layer: frontend
step: NeMo stage. Moves ``audio_x_realtime``."""

from portbench.lib.spans import stage_ms

UNIT = "ms"


def read(view):
    return stage_ms(view, ("frontend_step.nemo",))
