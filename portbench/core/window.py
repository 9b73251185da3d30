"""What a measured window gives: its span on the host clock and every
request's latency and answer.  A traffic file names its ``loop``, the file
``portbench/loops/<loop>.py`` whose ``run`` drives the requests and returns
a ``Window``."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Window:
    t0: float                 # host clock when the window opened (s)
    t1: float                 # host clock when it closed (s)
    latencies: List[float]    # each request's host-clock latency (s)
    answers: list             # what each request returned, in order
    failed: int               # requests that raised
    steps_per_request: int    # optimizer steps (or 1) in one request

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def requests(self) -> int:
        return len(self.latencies)

    @property
    def steps(self) -> int:
        return self.requests * self.steps_per_request
