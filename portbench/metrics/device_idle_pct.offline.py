"""Share of the traced window in which no operation ran on the device
(kernels and copies, their intervals' union). Layer: device. Moves
``audio_x_realtime``."""

UNIT = "%"


def read(view):
    if not view.ops:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
