"""compress_p95_ms: the 95th percentile of every compress call's wall in the
window, ms (statistics.quantiles, inclusive method)."""

import statistics


def read(r):
    walls = [(c.t1 - c.t0) / 1e6 for c in r.of("compress")]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
