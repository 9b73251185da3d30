"""Real-time serving loop: watch a directory for ultrasound frames, emit
predicted DVF features and fields with per-frame latency accounting.

Mirrors gpr_tpu/apps/serve.py:1-198 (``Server``, ``watch``, ``main``), the
production form of the reference's per-frame timing loop (reference
apps/GaussianProcessPredict.cpp:185-194), with the same command line and
artifacts (``dvf%05d.npy``, the trailing-comma
``{prefix}-latestInferenceTime.txt``):

    python -m gpr_tpu_torch.apps.serve <config_model.json> gpr_prefix watch_dir out_dir
        [--poll 0.02] [--max-frames N] [--features-only]

The model loads once with ``exact.load`` and ``pca.load_pca`` in
``config.default_dtype()`` (float32 under the ``fast`` policy) on
``device``, the card unless given ``device="cpu"``.  The whole per-frame
program (PCA reduction, GP mean, credible interval, inverse-PCA
reconstruction) is one function returning one packed vector, as JAX's one
jitted program (serve.py:52-76).  On the card that function is one
``torch.cuda.CUDAGraph``, captured at warm-up after warm-up runs on a side
stream; a frame is one copy into the graph's static input, one replay, and
one host read of the packed output (into pinned memory, copied out before
the next replay).  A frame of another size gets a graph of its own, as jit
would compile a new program.  A capture that fails raises: nothing falls
back to the eager program on the card.  On the CPU the same function runs
eagerly.

The frame's whitened input basis (the first ``n_inputModes`` columns of
U diag(sigma)^-1) and the output basis (U diag(sigma))[:, :n_outputModes]
are formed once when the server starts: the per-frame program takes the
``n_inputModes`` features and ``n_outputModes`` weights it uses, where
``PCAModel.reduce`` would form every mode and slice.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Set

import numpy as np
import torch


class _FrameGraph:
    """The per-frame program for one frame size, captured in a CUDA graph:
    static input and output buffers on the card, pinned host buffers for the
    one copy in and the one read out."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], col: np.ndarray,
                 dtype: torch.dtype, device: torch.device):
        self.host_in = torch.empty(col.size, dtype=dtype, pin_memory=True)
        self.host_in.numpy()[:] = col.reshape(-1)
        self.static_in = self.host_in.to(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(3):  # allocator and library warm-up outside the capture
                fn(self.static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.static_out = fn(self.static_in)
        except RuntimeError as e:
            raise RuntimeError(f"serve: capturing the per-frame program in a CUDA graph failed: {e}") from e
        self.host_out = torch.empty(self.static_out.shape, dtype=self.static_out.dtype, pin_memory=True)

    def run(self, col: np.ndarray) -> np.ndarray:
        self.host_in.numpy()[:] = col.reshape(-1)
        self.static_in.copy_(self.host_in, non_blocking=True)
        self.graph.replay()
        self.host_out.copy_(self.static_out, non_blocking=True)
        torch.cuda.current_stream(self.static_in.device).synchronize()
        return self.host_out.numpy().copy()


class Server:
    def __init__(self, config_model: dict, gpr_prefix: str, out_dir: str,
                 features_only: bool = False, device=None):
        from ..gp import exact
        from ..pipeline import pca as pcamod
        from ..utils import config

        self.n_input_modes = int(config_model["n_inputModes"])
        self.n_output_modes = int(config_model["n_outputModes"])
        self.out_dir = out_dir
        self.features_only = features_only
        self.prefix = gpr_prefix
        self.device = config.resolve_device(device)
        self.dtype = config.default_dtype()
        np_dtype = config.default_numpy_dtype()

        self.gp = exact.load(gpr_prefix, np_dtype, self.device)
        self.in_pca = pcamod.load_pca(gpr_prefix + "-input", np_dtype, self.device)
        self.out_pca = pcamod.load_pca(gpr_prefix + "-output", np_dtype, self.device)
        self._in_basis = self.in_pca.basis(self.n_input_modes).T.contiguous()  # (n_in, d)
        k = self.n_output_modes
        self._out_basis = (self.out_pca.U[:, :k] * self.out_pca.sigma[None, :k]).contiguous()
        self.latencies: list = []
        self.replays = 0  # CUDA-graph replays
        self._graphs: Dict[int, _FrameGraph] = {}
        os.makedirs(out_dir, exist_ok=True)

    def _pipeline(self, col: torch.Tensor) -> torch.Tensor:
        """The per-frame program (serve.py:63-72): features, GP mean, credible
        interval and, unless ``features_only``, the reconstructed DVF, packed
        [mean..., ci, dvf...]."""
        feats = self._in_basis @ (col - self.in_pca.mean)
        mean = self.gp.predict(feats)
        ci = self.gp.credible_interval(feats)
        parts = [mean.reshape(-1), ci.reshape(1)]
        if not self.features_only:
            n_out = self.n_output_modes
            parts.append(self._out_basis @ mean[:n_out] + self.out_pca.mean)
        dt = parts[0].dtype
        for p in parts[1:]:
            dt = torch.promote_types(dt, p.dtype)
        return torch.cat([p.to(dt) for p in parts])

    @staticmethod
    def _frame_col(frame: np.ndarray) -> np.ndarray:
        return frame.reshape(-1, 1).astype(np.float64) / 255.0

    def _graph(self, col: np.ndarray) -> _FrameGraph:
        g = self._graphs.get(col.size)
        if g is None:
            g = self._graphs[col.size] = _FrameGraph(self._pipeline, col, self.dtype, self.device)
        return g

    def warmup(self, example_frame: np.ndarray) -> None:
        """Capture the frame size's graph on the card (run once on the CPU),
        outside any timed path."""
        col = self._frame_col(example_frame)
        if self.device.type == "cuda":
            self._graph(col)
        else:
            self.run_eager(example_frame)

    def run_eager(self, frame: np.ndarray) -> np.ndarray:
        """The per-frame program without a graph: one copy in, the eager
        launches, one host read.  The CPU's path; on the card it is the
        reference the graph is held to, never a fallback."""
        col = torch.as_tensor(self._frame_col(frame).reshape(-1), dtype=self.dtype, device=self.device)
        return self._pipeline(col).cpu().numpy()

    def run(self, frame: np.ndarray) -> np.ndarray:
        """The packed output of one frame: one graph replay on the card."""
        if self.device.type != "cuda":
            return self.run_eager(frame)
        col = self._frame_col(frame)
        out = self._graph(col).run(col)
        self.replays += 1
        return out

    def handle_frame(self, frame: np.ndarray, index: int):
        """One frame through the pipeline; returns (mean_features, ci, dt)."""
        t0 = time.perf_counter()
        out = self.run(frame)
        if self.features_only:
            mean, ci = out[:-1], float(out[-1])
        else:
            d_out = int(self.out_pca.mean.shape[0])
            mean = out[: out.size - 1 - d_out]
            ci = float(out[out.size - 1 - d_out])
            dvf = out[out.size - d_out:]
            np.save(os.path.join(self.out_dir, f"dvf{index:05d}.npy"), dvf)
        dt = time.perf_counter() - t0
        self.latencies.append(dt)
        return mean, ci, dt

    def flush_latencies(self) -> None:
        with open(self.prefix + "-latestInferenceTime.txt", "a") as f:
            for dt in self.latencies:
                f.write(f"{dt},")
        self.latencies.clear()


def watch(server: Server, watch_dir: str, poll: float = 0.02, max_frames: Optional[int] = None,
          idle_timeout: float = 10.0) -> int:
    """Poll ``watch_dir`` for new image files, serve them in arrival order
    (serve.py:115-172).  Returns the number of frames served (stops after
    ``max_frames`` or ``idle_timeout`` seconds without new files)."""
    from ..pipeline import imageio

    seen: Set[str] = set()
    served = 0
    warmed = False
    last_new = time.monotonic()
    try:
        while True:
            files = sorted(
                f for f in os.listdir(watch_dir)
                if f not in seen and f.endswith((".vtk", ".png", ".mha"))
            )
            if files:
                last_new = time.monotonic()
            for f in files:
                path = os.path.join(watch_dir, f)
                try:
                    frame = imageio.read_image(path).data
                except Exception:
                    # acquisition may still be writing the file; retry once
                    # after a settle instead of killing the serving loop
                    time.sleep(max(poll, 0.05))
                    try:
                        frame = imageio.read_image(path).data
                    except Exception as e:
                        print(f"serve: skipping unreadable frame {f}: {e}", file=sys.stderr)
                        seen.add(f)
                        continue
                seen.add(f)
                arr = np.asarray(frame)
                if not warmed:
                    # capture outside the timed path: frame 0's latency must
                    # not hold the one-time warm-up and capture
                    server.warmup(arr)
                    warmed = True
                server.handle_frame(arr, served)
                served += 1
                if max_frames is not None and served >= max_frames:
                    return served
            if time.monotonic() - last_new > idle_timeout:
                return served
            time.sleep(poll)
    finally:
        # a crash mid-session must not lose the accumulated timings
        server.flush_latencies()


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 4:
        print(
            "Usage: serve <config_model.json> gpr_prefix watch_dir out_dir"
            " [--poll s] [--max-frames N] [--features-only]"
        )
        return -1
    with open(argv[0]) as f:
        config_model = json.load(f)
    gpr_prefix, watch_dir, out_dir = argv[1:4]
    poll = float(argv[argv.index("--poll") + 1]) if "--poll" in argv else 0.02
    max_frames = int(argv[argv.index("--max-frames") + 1]) if "--max-frames" in argv else None
    server = Server(config_model, gpr_prefix, out_dir, features_only="--features-only" in argv,
                    device=device)
    n = watch(server, watch_dir, poll=poll, max_frames=max_frames)
    print(f"served {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
