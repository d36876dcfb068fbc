"""The load generator's lag: the 95th percentile over every scheduled
picture of how late its client fed it, in milliseconds (open loop
only)."""
from .. import stats


def read(run):
    if not run.lags:
        return None
    return stats.tail(run.lags) * 1e3
