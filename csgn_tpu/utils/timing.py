"""Timing: stopwatch (reference Timer parity) + device timing.

The reference's only observability is a chrono stopwatch
(reference src/Timer.{h,cpp}); `Timer` reproduces that surface.
`device_median_time` times work on the device: JAX dispatch is asynchronous,
so every timed call waits for its result with `jax.block_until_ready`.
"""

from __future__ import annotations

import time

__all__ = ["Timer", "device_median_time"]


class Timer:
    """Stopwatch with ms resolution (reference src/Timer.cpp:21-48 parity)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._t0: float | None = None
        self._elapsed_ms = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Stop and return elapsed milliseconds since start()."""
        if self._t0 is None:
            raise RuntimeError("Timer.stop() without start()")
        self._elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        return self._elapsed_ms

    def stop_and_print(self) -> float:
        ms = self.stop()
        print(f"{self.name}: {ms:.3f} ms")
        return ms

    @property
    def elapsed_ms(self) -> float:
        return self._elapsed_ms


def device_median_time(fn, reps: int = 7) -> float:
    """Median seconds of ``fn()`` with its result ready on the device.

    The first call (compilation, warm-up) is not timed."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2]
