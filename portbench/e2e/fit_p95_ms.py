"""``fit_p95_ms``: the 95th percentile of every fit's host-clock latency in
the window, interpolated between order statistics (Python's
``statistics.quantiles(..., n=20, method="inclusive")``)."""

import statistics


def read(window, traffic: dict) -> float:
    lat = window.latencies
    if len(lat) < 2:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
