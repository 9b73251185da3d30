"""``library_ms.train``: device time of the kernels that no map in
``kernels/`` claims (cuBLAS's and cuSOLVER's: the backward's products and
triangular solves, the leaves, and PyTorch's own element-wise kernels) per
training step of the traced window."""


def read(ctx):
    win, s = ctx["traced"], ctx["trace"]
    return s.module_ns.get("library", 0) * 1e-6 / win.steps
