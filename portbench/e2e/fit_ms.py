"""``fit_ms``: the window's whole time over the fits completed in it (host
clock; each fit ends with alpha on the device and a synchronize)."""


def read(window, traffic: dict) -> float:
    return window.seconds / window.requests * 1e3
