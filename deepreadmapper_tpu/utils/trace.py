"""Tracing / profiling.

The reference wraps every stage in std::chrono spans with printed prefixes
(main.cpp:88-421) and counts distance computations in hnswm
(enableProfiling/getCountDistCalc, hnsw.cpp:18-39).  Here:

  * ``stage``/``Tracer`` — wall-clock stage spans, nested, with a summary
    table; used by the pipelines.
  * ``device_trace`` — context manager around jax.profiler for device
    traces (tensorboard-viewable), the deep-profiling analog.
  * ``Counters`` — named work counters (distance evaluations, expanded beam
    nodes) the engines can bump.
"""

from __future__ import annotations

import collections
import contextlib
import time


class Tracer:
    def __init__(self):
        self.spans: list[tuple[str, float]] = []
        self.counters = collections.Counter()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.spans.append((name, time.time() - t0))

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def summary(self) -> str:
        total = sum(d for _, d in self.spans)
        lines = [f"{'stage':<24}{'seconds':>10}{'share':>8}"]
        for name, d in self.spans:
            share = (d / total * 100) if total else 0.0
            lines.append(f"{name:<24}{d:>10.3f}{share:>7.1f}%")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name:<24}{v:>10}")
        return "\n".join(lines)


_GLOBAL = Tracer()


@contextlib.contextmanager
def stage(name: str, tracer: Tracer | None = None):
    with (tracer or _GLOBAL).span(name):
        yield


def global_tracer() -> Tracer:
    return _GLOBAL


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax profiler trace (open with tensorboard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
