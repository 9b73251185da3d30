"""Loop ``closed``: one client sends its next request when the last one has
returned and the device has finished it (``sync``), for as long as the
window lasts.  The window opens before the first request and closes when
the first request that ends after ``seconds`` have passed returns, so every
request in it is whole and every second of it belongs to some request."""

from __future__ import annotations

import time
from typing import Callable, Optional

from portbench.core.window import Window


def run(request: Callable[[int], object], sync: Callable[[], None], seconds: float,
        steps_per_request: int, first: int = 0, span: Optional[Callable] = None) -> Window:
    """Run ``request(i)`` for i = first, first + 1, ... one after another until
    ``seconds`` have passed; ``span(name)``, where given, is a context manager
    that marks each request in a trace."""
    latencies, answers, failed = [], [], 0
    i = first
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        ts = time.perf_counter()
        try:
            if span is None:
                answer = request(i)
            else:
                with span("portbench.request"):
                    answer = request(i)
        except (RuntimeError, ValueError) as exc:  # a request the program refused
            answer, failed = exc, failed + 1
        sync()
        te = time.perf_counter()
        latencies.append(te - ts)
        answers.append(answer)
        i += 1
        if te >= deadline:
            return Window(t0, te, latencies, answers, failed, steps_per_request)
