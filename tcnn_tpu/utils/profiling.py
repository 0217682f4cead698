"""Performance observability (SURVEY.md 5.1).

The reference's observability is throughput printouts + allocation byte
counts; the equivalents here are a step timer with samples/s, a
jax.profiler trace capture, and `device_time` which reduces such a trace
to the device's busy time and the time of each kernel.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import time

import jax


class StepTimer:
    """Throughput meter: wrap training steps, read .steps_per_sec /
    .samples_per_sec. Forces device sync only when read."""

    def __init__(self, batch_size: int):
        self.batch_size = int(batch_size)
        self.reset()

    def reset(self):
        self._t0 = None
        self._steps = 0
        self._last = None

    def step(self, result=None):
        """Count one step; pass the step's output to enable sync-on-read."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._steps = 0
        self._steps += 1
        self._last = result
        return result

    def _elapsed(self):
        if self._last is not None:
            jax.block_until_ready(self._last)
        return time.perf_counter() - (self._t0 or time.perf_counter())

    @property
    def steps_per_sec(self) -> float:
        dt = self._elapsed()
        return self._steps / dt if dt > 0 else 0.0

    @property
    def samples_per_sec(self) -> float:
        dt = self._elapsed()
        return self._steps * self.batch_size / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (view with xprof/tensorboard):

        with tcnn_tpu.utils.profiling.trace("/tmp/trace"):
            for _ in range(10):
                trainer.training_step(x, y)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time(logdir: str, device_prefix: str = "/device:GPU:") -> dict:
    """Reduce the newest trace under `logdir` to device metrics.

    Returns {"window_ns", "busy_ns", "idle_share", "kernels_ns"}: the span
    from the first to the last device event, the union of the intervals in
    which any event runs on a device plane, 1 - busy/window, and the summed
    device duration per event (kernel) name, largest first."""
    from jax.profiler import ProfileData

    paths = glob.glob(
        os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")
    )
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    intervals = []
    kernels = collections.Counter()
    for plane in data.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                intervals.append((ev.start_ns, ev.end_ns))
                kernels[ev.name] += ev.duration_ns
    if not intervals:
        raise ValueError(f"no {device_prefix} events in the trace at {logdir}")
    intervals.sort()
    busy, (cur_s, cur_e) = 0, intervals[0]
    for s_, e_ in intervals[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return {
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window,
        "kernels_ns": dict(kernels.most_common()),
    }
