"""mphfwalk_roofline (%, device trace): K11 mphfwalk's share of its
roofline over the traced window (``roofline/mphfwalk.py``)."""

from kmerbench.roofline import share


def read(run):
    return share(run, "mphfwalk")
