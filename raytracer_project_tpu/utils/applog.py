"""Structured engine log + live metrics.

JAX-native equivalent of the reference's AppLog (/root/reference/main.cpp:51-177):
timestamped ring log with tag-based severity ([Error]/[Config]/[Render]/
[System]/[Debug]), a frame-time ring with FPS, and two rays/s throughput
metrics: rays_per_second() reproduces the reference's W·H·spp·max_depth/Δt
upper-bound *estimator* (main.cpp:96-113); measured_rays_per_second() turns
the pooled wavefront's actual traced-segment counter (ops/wavefront.py
stats) into a true throughput number.
"""

from __future__ import annotations

import collections
import time

RING_CAPACITY = 500       # main.cpp:58 (500-entry ring)
FRAME_RING = 90           # main.cpp:53 (90-frame plot)

SEVERITY_TAGS = ("[Error]", "[Config]", "[Render]", "[System]", "[Debug]")


class AppLog:
    """Timestamped ring log with printf-style formatting."""

    def __init__(self, capacity: int = RING_CAPACITY, echo: bool = False):
        self.entries: collections.deque[str] = collections.deque(maxlen=capacity)
        self.echo = echo
        self.frame_times: collections.deque[float] = collections.deque(maxlen=FRAME_RING)
        self._last_frame: float | None = None

    def add_log(self, fmt: str, *args) -> str:
        msg = fmt % args if args else fmt
        stamp = time.strftime("[%H:%M:%S]")
        line = f"{stamp} {msg}"
        self.entries.append(line)
        if self.echo:
            print(line, flush=True)
        return line

    def error(self, fmt, *args):
        return self.add_log("[Error] " + fmt, *args)

    def config(self, fmt, *args):
        return self.add_log("[Config] " + fmt, *args)

    def render(self, fmt, *args):
        return self.add_log("[Render] " + fmt, *args)

    def system(self, fmt, *args):
        return self.add_log("[System] " + fmt, *args)

    def debug(self, fmt, *args):
        return self.add_log("[Debug] " + fmt, *args)

    @staticmethod
    def severity_of(line: str) -> str:
        for tag in SEVERITY_TAGS:
            if tag in line:
                return tag.strip("[]")
        return "Info"

    # Frame-time metrics (main.cpp:80-93).

    def tick_frame(self) -> None:
        now = time.perf_counter()
        if self._last_frame is not None:
            self.frame_times.append(now - self._last_frame)
        self._last_frame = now

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        avg = sum(self.frame_times) / len(self.frame_times)
        return 1.0 / avg if avg > 0 else 0.0


def rays_per_second(width: int, height: int, samples: int, max_depth: int,
                    elapsed_s: float) -> float:
    """The reference's throughput estimator (main.cpp:101-113):
    W*H*samples*max_depth / dt — an upper bound on traced rays (paths
    terminate well before max_depth on average)."""
    if elapsed_s <= 0:
        return 0.0
    return width * height * samples * max_depth / elapsed_s


def measured_rays_per_second(segments: float, elapsed_s: float) -> float:
    """True throughput from the pooled wavefront's traced-segment counter
    (ops/wavefront.py `with_stats`): actually-traced rays / dt."""
    if elapsed_s <= 0:
        return 0.0
    return float(segments) / elapsed_s
