"""``idle_share.train``: the share of the traced window in which the device ran
nothing (no kernel, copy or fill), over the window's training steps.  The
profiler's cost on the host is in it: where the host paces the device, the
traced window idles more than an untraced one."""


def read(ctx):
    s = ctx["trace"]
    return 100.0 * (1.0 - s.busy_ns / s.window_ns)
