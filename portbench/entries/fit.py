"""Request kind ``fit``: one exact GP fit, ``gpr_tpu_torch.fit(kernel, X, Y,
sigma)``, on dataset i mod ``datasets``; the fit ends with alpha on the
device.  Its answer is alpha and the diagonal of the factor L, from which
the log-determinant follows.

Judged against the reference's float64 fit of the same dataset (every
answer of the window):

  alpha_gap   max |alpha - alpha_ref| / max |alpha_ref|
  logdet_gap  |2 sum log diag L - logdet_ref| / |logdet_ref|

which covers the factor with its jitter loop and the solve.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.core.port import kernel_of


@dataclasses.dataclass
class Answer:
    dataset: int
    alpha: torch.Tensor   # (n, q)
    diag: torch.Tensor    # (n,) the factor's diagonal
    route: str = "reference"


def steps(traffic: dict) -> int:
    return 1


class Requests:
    """The timed path: ``self(i)`` runs request i."""

    def __init__(self, port, cfg: dict, traffic: dict, datasets: list):
        self.port, self.cfg, self.datasets = port, cfg, datasets
        self.kernel = kernel_of(port, cfg)
        self.sigma = float(cfg["sigma"])

    def warmup(self, traffic: dict) -> None:
        for i in range(int(traffic.get("warmup_requests", 1))):
            self(i)

    def __call__(self, i: int) -> Answer:
        k = i % len(self.datasets)
        X, Y = self.datasets[k]
        gp = self.port.fit(self.kernel, X, Y, sigma=self.sigma)
        return Answer(k, gp.alpha, gp.L.diagonal().clone(), gp.route)


def reference_answer(ref, cfg: dict, traffic: dict, k: int, X, Y, precision: str) -> Answer:
    """The reference's answer to a request on dataset k, in ``precision``."""
    form, (ls, sc) = cfg["kernel"]["form"], cfg["kernel"]["params"]
    with ref.precision(precision) as dtype:
        alpha, diag = ref.fit(form, X.to(dtype), Y.to(dtype), ls, sc, float(cfg["sigma"]),
                              precision=precision)
    return Answer(k, alpha, diag)


def _logdet(diag: torch.Tensor) -> float:
    return float(2.0 * torch.log(diag.to(torch.float64)).sum())


def judge(answers: list, ref, cfg: dict, traffic: dict, datasets: list):
    """({number: reading}, answers that failed): each answer against the
    float64 reference of its dataset.  A reading is None where no answer
    could be read."""
    refs = {}
    alpha_gap = logdet_gap = None
    bad = 0
    for a in answers:
        if not isinstance(a, Answer) or not (torch.isfinite(a.alpha).all() and torch.isfinite(a.diag).all()):
            bad += 1
            continue
        if a.dataset not in refs:
            X, Y = datasets[a.dataset]
            r = reference_answer(ref, cfg, traffic, a.dataset, X, Y, "float64")
            refs[a.dataset] = (r.alpha, float(r.alpha.abs().max()), _logdet(r.diag))
        alpha_ref, alpha_max, logdet_ref = refs[a.dataset]
        ga = float((a.alpha.to(torch.float64) - alpha_ref).abs().max()) / alpha_max
        gl = abs(_logdet(a.diag) - logdet_ref) / abs(logdet_ref)
        alpha_gap = ga if alpha_gap is None else max(alpha_gap, ga)
        logdet_gap = gl if logdet_gap is None else max(logdet_gap, gl)
    return {"alpha_gap": alpha_gap, "logdet_gap": logdet_gap}, bad
