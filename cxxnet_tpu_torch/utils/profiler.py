"""Step / pipeline profiler (own copy of cxxnet_tpu/utils/profiler.py).

Two levels:
- `profile = 1`: per-round summaries of the step time against the host
  data time (p50 / p99 / images per second), printed to stderr beside
  the metrics. Step timing ends in a device synchronise, so the times
  are the card's, not the enqueue's.
- `profile_dir = <path>`: besides, ONE profiled round is traced with
  torch.profiler (CPU and, on the card, CUDA activities) and written as
  a Chrome trace, `<path>/trace_round<N>.json` (open it in
  chrome://tracing or Perfetto). `trace_round = N` picks WHICH profiled
  round (1-based, default 1); round 1 holds the first launches' set-up
  (cuDNN autotuning, kernel loads), so steady-state traces want N >= 2.

The telemetry plane (telemetry/) reuses this accumulator for its
per-round records even when profile = 0 (NetTrainer.round_stats).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


class StepProfiler:
    """Accumulates step and data timings for one round at a time.
    `cuda` adds the CUDA activity to the trace (a trainer on the card)."""

    def __init__(self, trace_dir: str = "", trace_round: int = 1,
                 cuda: bool = False):
        self.trace_dir = trace_dir
        # which profiled round gets the trace (1-based count of
        # round_start calls); exactly one round is ever traced
        self.trace_round = max(1, int(trace_round))
        self.cuda = cuda
        self.trace_path = ""
        self._round_idx = 0
        self._prof = None
        self._traced_once = False
        self.reset()

    def reset(self) -> None:
        self.step_s: List[float] = []
        self.data_s: List[float] = []
        self.examples = 0

    # -- hooks -------------------------------------------------------------
    def round_start(self) -> None:
        self.reset()
        self._round_idx += 1
        if (self.trace_dir and not self._traced_once
                and self._round_idx == self.trace_round):
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()

    def round_end(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            # leaving the profiler synchronises the card, so the
            # round's kernels are in the trace
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.trace_path = os.path.join(
                self.trace_dir, f"trace_round{self._round_idx}.json")
            prof.export_chrome_trace(self.trace_path)
            self._traced_once = True

    def add_step(self, seconds: float, n_examples: int) -> None:
        self.step_s.append(seconds)
        self.examples += n_examples

    def add_data(self, seconds: float) -> None:
        self.data_s.append(seconds)

    def add_chunk(self, seconds: float, n_steps: int,
                  n_examples: int) -> None:
        """One fused chunk of n_steps microsteps (update_chunk):
        recorded as n_steps equal per-step entries, so stats() and
        summary() keep reporting per-step p50 / p99 and images per
        second comparable across steps_per_dispatch settings (the
        chunk's total is kept: the entries sum to `seconds`)."""
        n = max(1, int(n_steps))
        per = seconds / n
        self.step_s.extend([per] * n)
        self.examples += n_examples

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Optional[Dict[str, float]]:
        """Round stats as a JSON-ready dict (None when no steps ran);
        an empty data_s (staged paths) and zero examples are fine."""
        if not self.step_s:
            return None
        s = np.asarray(self.step_s, dtype=np.float64)
        data_total = float(sum(self.data_s))
        total = float(s.sum()) + data_total
        return {
            "steps": len(self.step_s),
            "examples": self.examples,
            "step_p50_ms": float(np.percentile(s, 50)) * 1e3,
            "step_p99_ms": float(np.percentile(s, 99)) * 1e3,
            "step_total_s": float(s.sum()),
            "data_total_ms": data_total * 1e3,
            "images_per_sec": (self.examples / total if total > 0
                               else float("nan")),
        }

    def summary(self) -> str:
        st = self.stats()
        if st is None:
            return "\tprofile: no steps"
        out = (f"\tprofile: {st['steps']} steps, "
               f"step p50 {st['step_p50_ms']:.2f} ms "
               f"p99 {st['step_p99_ms']:.2f} ms, "
               f"data {st['data_total_ms']:.1f} ms total, "
               f"{st['images_per_sec']:.1f} images/sec")
        if self.trace_dir:
            out += f", trace -> {self.trace_dir}"
        return out
