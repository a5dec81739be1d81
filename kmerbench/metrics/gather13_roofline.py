"""gather13_roofline (%, device trace): K3 gather13's share of its
roofline over the traced window (``roofline/gather13.py``)."""

from kmerbench.roofline import share


def read(run):
    return share(run, "gather13")
