"""``train_step_ms``: the window's whole time over the Adam steps completed
in it.  Each request is ``iterations`` steps and one final objective, which
the window's time holds but the count of steps does not."""


def read(window, traffic: dict) -> float:
    return window.seconds / window.steps * 1e3
