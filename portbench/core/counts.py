"""Operation counts of exact GP regression, from the shapes alone, shared by
the metrics that read them (bench.py:155-157's model of the fit, and the
training step's backward, written out below).

Per fit of n points, d features, q outputs:
  Gram      2 n^2 d    (the cross term of every distance)
  factor    n^3 / 3    (Cholesky)
  solve     2 n^2 q    (two triangular solves, q right-hand sides)

Per step of training (one MLL value and its gradient in the kernel's
parameters), the forward above and Murray's backward of the factor
(A_bar = L^-T phi(L^T L_bar) L^-1): the product of the triangular L^T and
the lower-triangular L_bar, kept lower, n^3 / 3, and two triangular solves
with n right-hand sides, n^3 each: 7 n^3 / 3.  The backward's O(n^2 d) and
O(n^2 q) terms (the Gram's and the solve's pullbacks) are left out, so the
count is a floor of the work.
"""


def fit_flop(n: int, d: int, q: int) -> float:
    return 2.0 * n * n * d + n ** 3 / 3.0 + 2.0 * n * n * q


def backward_flop(n: int) -> float:
    return 7.0 * n ** 3 / 3.0


def train_request_flop(n: int, d: int, q: int, iterations: int) -> float:
    """``iterations`` values with gradients, then the final value."""
    return iterations * (fit_flop(n, d, q) + backward_flop(n)) + fit_flop(n, d, q)
