"""Faults planted in the program, and the control put in its place, for the
readings that set each limit (calibrate.py, on the card at a cell's own
size) and for the tests that see ``correct`` come out false
(tests/test_portbench_faults.py, on the CPU at a tiny size).

  unchanged   every Adam step returns the parameters unchanged
  half_batch  the likelihood over the first half of the rows, doubled: half
              of the batch left out, the mean taken over the rest
  altered     an answer altered where it is produced: alpha[0, 0] of a fit
              moved by 10 % of max |alpha|; the final objective of a
              training run moved by 10 %
  scaled_grad the gradient of the objective that Adam steps on doubled, its
              value kept: a backward off by a steady factor
  control     the plain reference, in TF32, put in the program's place

Each patches the already imported port in this process and is not undone.
"""

from __future__ import annotations

FAULTS = ("unchanged", "half_batch", "altered", "scaled_grad")


def plant(name: str) -> None:
    import torch

    import gpr_tpu_torch
    from gpr_tpu_torch.gp import exact, likelihood
    from gpr_tpu_torch.inference import optimize

    if name == "unchanged":
        torch.optim.Adam.step = lambda self, closure=None: None
    elif name == "half_batch":
        terms = likelihood._terms

        def half(kernel, X, Y, sigma):
            h = X.shape[0] // 2
            df, cp, ct = terms(kernel, X[:h], Y[:h], sigma)
            return 2 * df, 2 * cp, 2 * ct

        likelihood._terms = half
    elif name == "altered":
        fit, adam = exact.fit, optimize._run_adam

        def altered_fit(*args, **kwargs):
            gp = fit(*args, **kwargs)
            gp.alpha[0, 0] += 0.1 * gp.alpha.abs().max()
            return gp

        def altered_adam(*args, **kwargs):
            x, final, trace = adam(*args, **kwargs)
            return x, final * 1.1, trace

        gpr_tpu_torch.fit = altered_fit
        optimize._run_adam = altered_adam
    elif name == "scaled_grad":
        adam = optimize._run_adam

        def doubled(objective):
            def obj(x):
                value = objective(x)
                return value + (value - value.detach())  # the same value, twice the gradient
            return obj

        optimize._run_adam = lambda objective, *args, **kwargs: adam(doubled(objective), *args, **kwargs)
    else:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")


def control(cell) -> None:
    """Put the reference in TF32 in place of the cell's requests: each
    request's answer is then the reference's, as the program would give it."""
    entry, ref = cell.entry, cell.reference

    class Control(entry.Requests):
        def warmup(self, traffic):
            pass

        def __call__(self, i):
            k = i % len(self.datasets)
            X, Y = self.datasets[k]
            return entry.reference_answer(ref, cell.cfg, cell.traffic, k, X, Y, "tf32")

    entry.Requests = Control
