"""The same-call timing pieces that chip_tools' A/B scripts share.

An A/B script times the gpr_tpu_torch package under one root per run, on one
CUDA card, with these functions, and saves its outputs so that two trees can
be compared bit for bit with `compare`.  Import it from a script in this
directory (`from ab_harness import ...`); the script's own directory is on
sys.path when it runs.
"""

import numpy as np
import torch


def timed(fn, sleep=False):
    """One call of fn in ms by CUDA events; with sleep, queued behind a device
    sleep, so that the host's enqueue is not timed."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if sleep:  # the device waits while the host enqueues a, the launch and b
        torch.cuda._sleep(300_000)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def runs(fn, k, sleep=False):
    """k timed calls of fn after one untimed warm-up."""
    return [timed(fn, sleep) for _ in range(k + 1)][1:]


def med(v):
    """The median of the times v and the times themselves, as text."""
    return f"{float(np.median(v)):.4f} ({', '.join(f'{x:.4f}' for x in v)})"


def rounds(fns, count, sleep):
    """Each of the calls fns (name -> fn) timed count times in turns, the
    order reversed every round, after one warm-up call each."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for i in range(count):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            times[k].append(timed(fns[k], sleep))
    return "; ".join(f"{k} {med(v)}" for k, v in times.items())


def device_split(fn):
    """The device time in ms and the launches of each kernel that one call of
    fn runs, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            key = e.name.split("(")[0].replace("void ", "").replace("gpr::", "")
            t, c = per.get(key, (0.0, 0))
            per[key] = (t + (e.time_range.end - e.time_range.start) / 1e3, c + 1)
    return "; ".join(f"{k} {t:.4f} ({c} launches)" for k, (t, c) in sorted(per.items()))


def compare(a_path, b_path) -> int:
    """Print, for every output two trees saved (a dict of tensors or sha256
    digests), whether they are equal bit for bit, else the largest difference
    relative to the largest entry."""
    a, b = torch.load(a_path), torch.load(b_path)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, str):
            print(f"{k}: {'bit-identical' if x == y else 'differs (digest)'}")
        elif torch.equal(x, y):
            print(f"{k}: bit-identical")
        else:
            d = float((x.double() - y.double()).nan_to_num().abs().max() / y.double().nan_to_num().abs().max())
            print(f"{k}: differs, max |a - b| / max |b| = {d:.3g}")
    return 0
