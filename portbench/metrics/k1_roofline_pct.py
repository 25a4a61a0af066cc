"""K1's share of its roofline: the least time of one launch by
``roofline/k1.py`` against the mean device time of K1's launches in the
trace. Layer: kernel K1. Moves ``audio_x_realtime``."""

from portbench.lib.roofline import share_pct

UNIT = "%"


def read(view):
    return share_pct(view, "k1")
