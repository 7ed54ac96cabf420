"""Training monitor (mirror of ``pctrans_tpu/utils/monitor.py``): every loss
term and the LR to ``metrics.jsonl`` every ``MONITOR.ITERATION_NUM[0]``
iterations, eval records beside them, TensorBoard when its writer imports,
and a console line with the marginal time per iteration and the ETA.

``MONITOR.PROFILE_ITERS [start, stop]``: :meth:`Monitor.profile_steps`
traces iterations ``start .. stop - 1`` with ``torch.profiler`` (CPU and,
on a card, CUDA activity) and writes a Chrome trace under
``OUTPUT_PATH/profile/``.  A run resumed past ``start`` still traces what is
left of the window.  The trainer builds the monitor on rank 0 only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch


class Monitor:
    def __init__(self, output_dir: str, log_every: int = 20,
                 use_tensorboard: bool = True, profile_iters: Optional[tuple] = None):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.log_every = max(1, log_every)
        self.jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=os.path.join(output_dir, "tb"))
            except Exception:          # no tensorboard package: JSONL only
                self.tb = None
        self._last = time.perf_counter()
        self._last_iter: Optional[int] = None
        self.profile_iters = tuple(int(i) for i in profile_iters) if profile_iters else None
        self._profiler = None
        self._window: Optional[tuple] = None      # the traced (start, stop)
        self.trace_path: Optional[str] = None

    def profile_steps(self, iteration: int) -> None:
        """Start or stop the profiler window; call once per iteration,
        before its step.  ``>= start``, not ``== start``: a resumed run
        still traces the rest of the window."""
        if self.profile_iters is None:
            return
        start, stop = self.profile_iters
        if start <= iteration < stop and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.__enter__()
            self._window = (iteration, stop)
            print(f"[profiler] tracing iterations {iteration}..{stop - 1}")
        elif iteration >= stop and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._profiler.__exit__(None, None, None)
        trace_dir = os.path.join(self.output_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        start, stop = self._window
        self.trace_path = os.path.join(trace_dir, f"trace_{start:06d}_{stop:06d}.json")
        self._profiler.export_chrome_trace(self.trace_path)
        self._profiler = None
        print(f"[profiler] Chrome trace -> {self.trace_path}")

    def load_info(self, cfg) -> None:
        if self.tb is not None:
            self.tb.add_text("config", f"```\n{cfg.dump()}\n```")

    def update(self, iteration: int, scalars: Dict[str, float], lr: float,
               total_iters: Optional[int] = None) -> None:
        """Log at every ``log_every``-th iteration; ``scalars`` may be 0-d
        tensors, read only then."""
        if iteration % self.log_every:
            return
        now = time.perf_counter()
        values = {k: float(v) for k, v in scalars.items()}
        self.jsonl.write(json.dumps({"iter": iteration, "lr": float(lr), **values}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar("lr", lr, iteration)
            for k, v in values.items():
                self.tb.add_scalar(k, v, iteration)
        # the rate since the previous log line; the first line anchors here
        d_iter = iteration - self._last_iter if self._last_iter is not None else 1
        avg = (now - self._last) / max(d_iter, 1)
        self._last_iter, self._last = iteration, now
        eta_h = avg * max((total_iters or 0) - iteration, 0) / 3600.0
        print(f"[Iteration {iteration:05d}] loss: {values.get('loss', float('nan')):.4f}, "
              f"lr: {lr:.3e}, avg iter: {avg:.3f}s, ETA: {eta_h:.2f}h", flush=True)

    def add_eval(self, iteration: int, metrics: Dict[str, float]) -> None:
        rec = {"iter": iteration, "eval": {k: float(v) for k, v in metrics.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"eval/{k}", float(v), iteration)

    def close(self) -> None:
        if self._profiler is not None:      # the window outlasted the run
            self._stop_profile()
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def build_monitor(cfg) -> Monitor:
    log_every = cfg.MONITOR.ITERATION_NUM[0] if cfg.MONITOR.ITERATION_NUM else 20
    profile = cfg.MONITOR.get("PROFILE_ITERS", None)
    return Monitor(cfg.DATASET.OUTPUT_PATH, log_every=log_every,
                   use_tensorboard=bool(cfg.MONITOR.get("TENSORBOARD", True)),
                   profile_iters=tuple(profile) if profile else None)
