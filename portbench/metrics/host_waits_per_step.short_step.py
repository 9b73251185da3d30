"""``host_waits_per_step.short_step``: the port's ``host_wait.*`` counters
over its ``adam.steps``, summed over the whole process (set-up, both
windows).  Each ``host_wait`` is one point where the host waits for the
card: a read of a device value (the factor's check, the trace's entry, the
final value) or a blocking copy between host and card (the noise to the
card, each gradient back to the host-side hyperparameters).  Every request
trains from the configuration's start, so the ratio is each request's.
None where the port keeps no counters, or counted no step."""


def read(ctx):
    try:
        from gpr_tpu_torch.utils.profiling import counters
    except ImportError:  # a port without counters
        return None
    c = counters()
    steps = c.get("adam.steps", 0)
    if not steps:
        return None
    return sum(v for k, v in c.items() if k.startswith("host_wait.")) / steps
