"""Request kind ``fit_mle``: hyperparameter training,
``gpr_tpu_torch.fit_mle(kernel0, X, Y, sigma, iterations, learning_rate)``
from the configuration's kernel every time, on dataset i mod ``datasets``.
Each of its ``iterations`` Adam steps is one MLL value and gradient; the
call's final objective at the returned parameters is one more value, which
the window counts but not as a step.  Its answer is the objective at the
start of each step (``OptResult.trace``), the final objective, the
parameters, and the gradient that the optimizer was given at its first
step, read from the optimizer as it steps (a global step hook of
``torch.optim``: ``fit_mle`` returns no optimizer state).

Judged against the reference's float64 Adam from the same start on the
same dataset (every answer of the window):

  loss_gap   the largest |v - v_ref| / |v_ref| over the steps' objectives
             and the final one
  param_gap  the largest |p - p_ref| / |p_ref - p0| over the parameters:
             the gap in what training moved, against how far the reference
             moved them
  grad_gap   the largest |g - g_ref| over the parameters (each one leaf,
             in the log space that Adam steps in) of the first step's
             gradient, against the larger of |g_ref| of that parameter and
             the median over the parameters

Adam's step does not change when a gradient is scaled by a constant, so a
backward off by a steady factor leaves the objectives and the parameters
as they were: ``grad_gap`` is what sees it.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from portbench.core.port import kernel_of


@dataclasses.dataclass
class Answer:
    dataset: int
    trace: List[float]
    final: float
    params: torch.Tensor  # float64, natural space
    grad: torch.Tensor    # float64, the first step's gradient as Adam got it
    route: str = "reference"


def steps(traffic: dict) -> int:
    return int(traffic["iterations"])


_FIRST = {}  # the first step's gradients of the request that runs now
_HOOK = []


def _first_grad(optimizer, args, kwargs) -> None:
    if "grad" not in _FIRST:
        _FIRST["grad"] = [p.grad.detach().clone() for g in optimizer.param_groups for p in g["params"]]


class Requests:
    def __init__(self, port, cfg: dict, traffic: dict, datasets: list):
        self.port, self.cfg, self.datasets = port, cfg, datasets
        self.kernel = kernel_of(port, cfg)
        self.sigma = float(cfg["sigma"])
        self.iterations = int(traffic["iterations"])
        self.lr = float(traffic["learning_rate"])
        if not _HOOK:
            from torch.optim.optimizer import register_optimizer_step_post_hook

            _HOOK.append(register_optimizer_step_post_hook(_first_grad))

    def warmup(self, traffic: dict) -> None:
        """Requests of ``warmup_iterations`` steps: the shapes of a step and of
        the final value are those of every step."""
        it = int(traffic.get("warmup_iterations", self.iterations))
        for i in range(int(traffic.get("warmup_requests", 1))):
            X, Y = self.datasets[i % len(self.datasets)]
            self.port.fit_mle(self.kernel, X, Y, self.sigma, iterations=it, learning_rate=self.lr)

    def __call__(self, i: int) -> Answer:
        k = i % len(self.datasets)
        X, Y = self.datasets[k]
        _FIRST.clear()
        _, res = self.port.fit_mle(self.kernel, X, Y, self.sigma, iterations=self.iterations,
                                   learning_rate=self.lr)
        first = _FIRST.get("grad", [torch.empty(0)])  # empty where no optimizer stepped
        grad = torch.cat([g.reshape(-1) for g in first]).to("cpu", torch.float64)
        return Answer(k, [float(v) for v in res.trace], float(res.value),
                      res.params.detach().to("cpu", torch.float64), grad, res.route)


def reference_answer(ref, cfg: dict, traffic: dict, k: int, X, Y, precision: str) -> Answer:
    form, params0 = cfg["kernel"]["form"], cfg["kernel"]["params"]
    with ref.precision(precision) as dtype:
        trace, final, p, g = ref.adam_mle(form, X.to(dtype), Y.to(dtype), params0, float(cfg["sigma"]),
                                          int(traffic["iterations"]), float(traffic["learning_rate"]),
                                          precision=precision)
    return Answer(k, trace, final, p.detach().to("cpu", torch.float64), g.detach().to("cpu", torch.float64))


def _finite(a) -> bool:
    return (isinstance(a, Answer) and all(v == v and abs(v) != float("inf") for v in a.trace + [a.final])
            and bool(torch.isfinite(a.params).all()) and bool(torch.isfinite(a.grad).all()))


def judge(answers: list, ref, cfg: dict, traffic: dict, datasets: list):
    refs = {}
    p0 = torch.tensor(cfg["kernel"]["params"], dtype=torch.float64)
    loss_gap = param_gap = grad_gap = None
    bad = 0
    for a in answers:
        if not _finite(a):
            bad += 1
            continue
        if a.dataset not in refs:
            X, Y = datasets[a.dataset]
            refs[a.dataset] = reference_answer(ref, cfg, traffic, a.dataset, X, Y, "float64")
        r = refs[a.dataset]
        gl = max(abs(v - w) / abs(w) for v, w in zip(a.trace + [a.final], r.trace + [r.final]))
        gp = float(((a.params - r.params).abs() / (r.params - p0).abs()).max())
        loss_gap = gl if loss_gap is None else max(loss_gap, gl)
        param_gap = gp if param_gap is None else max(param_gap, gp)
        if a.grad.shape == r.grad.shape:  # else no gradient was read: grad_gap stays None
            scale = torch.clamp(r.grad.abs(), min=float(r.grad.abs().median()))
            gg = float(((a.grad - r.grad).abs() / scale).max())
            grad_gap = gg if grad_gap is None else max(grad_gap, gg)
    return {"loss_gap": loss_gap, "param_gap": param_gap, "grad_gap": grad_gap}, bad
