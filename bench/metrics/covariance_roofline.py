"""Percent of the covariance builds' roofline: the least time for the work
of each traced build (``repro_torch.core.covariance.numeric_factors``,
counted from its two sides' sizes and dimensions by
``bench.roofline.work.covariance``) over the device time of every kernel
launched inside it."""
from bench.roofline import work
from bench.trace import roofline_share


def read(run):
    return roofline_share(run, "cov", work.covariance)
