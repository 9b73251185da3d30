"""``launches_per_fit``: device operations (kernels, copies, fills: each one
launch from the host; this path captures no graph) in the traced window,
per fit.  ``cho_solve_panels`` steps its 2 x n / 128 panel products from
the host, so most of them are its."""


def read(ctx):
    return ctx["trace"].launches / ctx["traced"].requests
