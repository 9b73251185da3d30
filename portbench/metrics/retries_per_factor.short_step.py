"""``retries_per_factor.short_step``: the port's ``retry.*`` counters over its
``factor.*`` counters, summed over the whole process: the share of
factorizations that were jitter retries of ``safe_cholesky`` (and of the
fused, fleet and sharded factors, where they run).  None where the port
keeps no counters, or counted no factorization."""


def read(ctx):
    try:
        from gpr_tpu_torch.utils.profiling import counters
    except ImportError:  # a port without counters
        return None
    c = counters()
    factors = sum(v for k, v in c.items() if k.startswith("factor."))
    if not factors:
        return None
    return sum(v for k, v in c.items() if k.startswith("retry.")) / factors
