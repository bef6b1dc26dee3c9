"""Percent of the scan's roofline: the least time for the work of each
traced ``eval_block`` call (counted from its tuples, snippets, dimensions
and measures by ``bench.roofline.work.scan``) over the device time of every
kernel launched inside those calls."""
from bench.roofline import work
from bench.trace import roofline_share


def read(run):
    return roofline_share(run, "scan", work.scan)
