"""The trace reduction on made-up events: busy time as a union, idle gaps
charged to the host event that began last, kernel time by module."""

import pytest

from portbench.core import trace


class Ev:
    """An event as the profiler's raw results give it: the device it ran on,
    its name and its interval."""

    def __init__(self, device, name, start, end):
        self.d, self._name, self.s, self.e = device, name, start, end

    def device_type(self):
        return f"DeviceType.{self.d}"

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s


def test_summary():
    events = [
        Ev("CPU", trace.WINDOW, 0, 100_000),
        Ev("CPU", trace.REQUEST, 0, 100_000),
        Ev("CPU", "aten::mm", 10_000, 40_000),
        Ev("CPU", "cudaLaunchKernel", 12_000, 14_000),
        Ev("CUDA", "void gpr::panel_products_kernel(float const*)", 5_000, 20_000),
        Ev("CUDA", "sm80_xmma_gemm_f32", 15_000, 30_000),   # overlaps the first
        Ev("CUDA", "gpr::panel_solve_kernel(float*)", 8_000, 12_000),  # inside the first
        Ev("CUDA", "Memcpy DtoD (Device -> Device)", 50_000, 60_000),
        Ev("CUDA", trace.WINDOW, 0, 100_000),  # not device work
        Ev("CUDA", "outside", 100_000, 120_000),             # after the window
    ]
    s = trace.summarize(events, trace.KernelMap({"panel_products_kernel": "ops.fullchol",
                                                 "panel_solve_kernel": "ops.fullchol"}))
    assert s.window_ns == 100_000
    assert s.busy_ns == 25_000 + 10_000
    assert s.launches == 4
    assert s.module_ns == {"ops.fullchol": 15_000, "library": 15_000}  # a union, not a sum
    assert dict(s.device_ops)["ops.fullchol:panel_solve_kernel"] == 4_000
    gaps = dict(s.idle_gaps)
    # [0, 5k) and [60k, 100k) under the request span only, [30k, 50k) under aten::mm
    # (its middle, 40k, is where aten::mm ends)
    assert gaps == {"python": 5_000 + 40_000, "aten::mm": 20_000}
    b = s.breakdown()
    assert b["device_ops"][0][1] == 15_000e-9 and len(b["idle_gaps"]) == 2


@pytest.mark.parametrize("device,name,kind", [
    ("CUDA", "gpr::x", "kernel"),
    ("CUDA", "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
    ("CUDA", "Memset (Device)", "gpu_memset"),
    ("CUDA", trace.WINDOW, "gpu_user_annotation"),
    ("CPU", "aten::mm", "host"),
    ("CPU", "cudaLaunchKernel", "host"),
    ("CPU", trace.WINDOW, "host"),
])
def test_kind(device, name, kind):
    assert trace._kind(Ev(device, name, 0, 1)) == kind
