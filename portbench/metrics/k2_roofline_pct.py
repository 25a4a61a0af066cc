"""K2's share of its roofline: the least time of one launch by
``roofline/k2.py`` against the mean device time of K2's launches in the
trace. Layer: kernel K2. Moves ``audio_x_realtime``."""

from portbench.lib.roofline import share_pct

UNIT = "%"


def read(view):
    return share_pct(view, "k2")
