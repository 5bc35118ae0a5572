"""Tracing hooks: a profiler trace of a chosen block, and a step timer.

Port of ``patchgan_tpu/utils/profiling.py``: ``maybe_trace`` is a
``torch.profiler.profile`` (CPU activity, plus CUDA when a card is
present) whose Chrome trace is written into the directory on exit, for
Perfetto or chrome://tracing; ``StepTimer`` is the host's wall clock
over counted steps.
"""

import contextlib
import os
import time


@contextlib.contextmanager
def maybe_trace(trace_dir, enabled=True):
    """Profile the block into ``trace_dir``/trace_<pid>_<ns>.json when
    ``trace_dir`` is set and ``enabled``; otherwise do nothing."""
    if not (trace_dir and enabled):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


class StepTimer:
    """Lightweight rolling step timer (host wall clock)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n=1):
        self.steps += n

    @property
    def elapsed(self):
        return time.perf_counter() - self._t0

    def rate(self, per=1):
        e = self.elapsed
        return (self.steps * per / e) if e > 0 else 0.0
