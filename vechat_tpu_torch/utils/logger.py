"""Stage timing + progress logging (parity with racon::Logger,
reference: src/logger.cpp) plus throughput counters for the GPU build
(windows/sec, GCUPS) that the reference lacks."""

from __future__ import annotations

import sys
import time
from typing import Dict


class Logger:
    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self.time_ = 0.0
        self._tick = None
        self.bar_ = 0
        self.counters: Dict[str, float] = {}

    def tick(self) -> None:
        """Accumulate elapsed time and restart the stopwatch
        (reference: src/logger.cpp:20-26)."""
        now = time.monotonic()
        if self._tick is not None:
            self.time_ += now - self._tick
        self._tick = now

    def log(self, msg: str = "") -> None:
        """Print a stage line with elapsed seconds
        (reference: src/logger.cpp:28-32)."""
        now = time.monotonic()
        elapsed = now - self._tick if self._tick is not None else 0.0
        if msg:
            print(
                f"[vechat_tpu::] {msg} {elapsed:.6f} s", file=self.stream
            )
        self.time_ += elapsed
        self._tick = now

    def bar(self, msg: str) -> None:
        """20-bin progress bar (reference: src/logger.cpp:34-48)."""
        self.bar_ += 5
        eq = self.bar_ // 5
        print(
            f"\r[vechat_tpu::] {msg} [{'=' * eq}>{' ' * (20 - eq)}] {self.bar_}%",
            end="" if self.bar_ < 100 else "\n",
            file=self.stream,
        )
        if self.bar_ >= 100:
            self.bar_ = 0

    def total(self, msg: str) -> None:
        """reference: src/logger.cpp:50-55."""
        self.tick()
        print(f"[vechat_tpu::] {msg} {self.time_:.6f} s", file=self.stream)

    def count(self, key: str, value: float) -> None:
        self.counters[key] = self.counters.get(key, 0.0) + value


class PhaseBar:
    """Maps `total` units of batch-first work onto the 20-bin Logger.bar so
    the hot phases show the reference's progress bar (src/polisher.cpp:477-488
    and :549-558 tick once per 1/20 of completed futures; our unit of progress
    is a completed batch stage instead of a thread future)."""

    def __init__(self, logger: Logger, msg: str, total: int):
        self.logger = logger
        self.msg = msg
        self.total = max(1, total)
        self.done = 0
        self.emitted = 0

    def step(self, k: int = 1) -> None:
        self.done += k
        want = min((20 * self.done) // self.total, 20)
        while self.emitted < want:
            self.logger.bar(self.msg)
            self.emitted += 1

    def finish(self) -> None:
        while self.emitted < 20:
            self.logger.bar(self.msg)
            self.emitted += 1
