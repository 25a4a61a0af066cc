"""Mean device ms a call of the frontend step's K2 stage, the program's
span ``frontend_step.spectral`` (``WhisperKaldiFused.compute_with_vad``:
K2, the VAD's raw fix-up, Kaldi's CMN, and the card's idle time between
them). Layer: frontend step: K2 stage. Moves ``audio_x_realtime``."""

from portbench.lib.spans import stage_ms

UNIT = "ms"


def read(view):
    return stage_ms(view, ("frontend_step.spectral",))
