"""Build a CUDA source of gpr_tpu_torch/csrc for the CPU with the host's g++
against tests/cuda_emu/emu.h, the shim that runs every thread as a fiber
(tests/test_torch_*_source.py)."""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EMU = ROOT / "tests" / "cuda_emu"
CSRC = ROOT / "gpr_tpu_torch" / "csrc"


def host_source(src: str, seen=None) -> str:
    """A .cu source for the shim: its headers (the CUDA runtime, cluster.cuh,
    flags.cuh) as emu.h, the other headers of csrc/ inlined once each, <<<...>>>
    launches as emu::launch calls, the dynamic shared memory as the running
    block's buffer."""
    seen = set() if seen is None else seen
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    for name in ("cluster.cuh", "flags.cuh"):
        src = src.replace(f'#include "{name}"', f"// {name}: emu.h")

    def header(m):
        name = m.group(1)
        if name in seen:
            return f"// {name}: above"
        seen.add(name)
        return host_source((CSRC / name).read_text(), seen).replace("#pragma once", "")

    src = re.sub(r'#include "(\w+\.cuh)"', header, src)

    def launch(m):
        depth, cfg, cur = 0, [], ""
        for ch in m.group(2):
            depth += ch in "([" and 1 or ch in ")]" and -1 or 0
            if ch == "," and depth == 0:
                cfg.append(cur)
                cur = ""
            else:
                cur += ch
        cfg.append(cur)
        return f"emu::launch(dim3({cfg[0]}), dim3({cfg[1]}), [&] {{ {m.group(1)}({m.group(3)}); }});"

    src = re.sub(r"([\w:]+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
    return re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];", r"float* \1 = emu::dyn_smem;", src)


def build(out: Path, source: str, main: str) -> Path:
    """gpr_tpu_torch/csrc/<source> and tests/cuda_emu/<main> as the program
    out/<main's stem>; skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    host = out / (Path(source).stem + "_host.cpp")
    host.write_text(host_source((CSRC / source).read_text()))
    exe = out / Path(main).stem
    subprocess.run([gxx, "-O1", "-std=c++17", "-fno-strict-aliasing", f"-I{EMU}", str(EMU / "emu.cpp"),
                    str(host), str(EMU / main), "-o", str(exe)], check=True, capture_output=True)
    return exe
