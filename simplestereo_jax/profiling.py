"""
profiling
=========

Lightweight observability for the dense pipelines — the tracing/metrics
layer the reference lacks entirely (SURVEY §5: its only introspection is
``plot=True`` debug windows and ``print`` statements).

- :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable device trace (op-level timeline, HBM usage).
- :class:`Throughput` — wall-clock throughput meter: it times *full host
  readbacks* of each result and reports medians.
- :func:`device_memory` — current per-device HBM allocation stats.

Example
-------
>>> meter = Throughput("asw", unit="Mpix*disp")
>>> for frame in frames:
...     with meter.measure(H * W * D / 1e6):
...         out = np.asarray(asw_disparity(frame, right))
>>> print(meter.report())   # {"median_s": ..., "Mpix*disp_per_s": ...}
"""

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(logdir, perfetto=True):
    """Profile the enclosed block with ``jax.profiler.trace``.

    View with TensorBoard (``tensorboard --logdir <logdir>``); with
    ``perfetto=True`` (default) a standalone Perfetto trace file is also
    written into ``logdir``. Host-side TraceMe annotations (see
    :func:`annotate`) are always recorded.
    """
    import jax

    with jax.profiler.trace(str(logdir), create_perfetto_link=False,
                            create_perfetto_trace=perfetto):
        yield


@contextlib.contextmanager
def annotate(name):
    """Label the enclosed host code region in profiler timelines."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class Throughput:
    """Throughput meter: median wall-clock over measured units of work."""

    def __init__(self, name, unit="items"):
        self.name = name
        self.unit = unit
        self.samples = []  # (seconds, units)

    @contextlib.contextmanager
    def measure(self, units=1.0):
        t0 = time.perf_counter()
        yield
        self.samples.append((time.perf_counter() - t0, float(units)))

    def report(self):
        if not self.samples:
            return {"name": self.name, "samples": 0}
        ts = np.array([s for s, _ in self.samples])
        us = np.array([u for _, u in self.samples])
        med = float(np.median(ts))
        return {
            "name": self.name,
            "samples": len(ts),
            "median_s": round(med, 6),
            f"{self.unit}_per_s": round(float(np.median(us / ts)), 3),
            "total_s": round(float(ts.sum()), 6),
        }


def device_memory():
    """Per-device memory stats (bytes in use / peak / limit where known)."""
    import jax

    out = {}
    for d in jax.devices():
        try:
            ms = d.memory_stats() or {}
        except Exception:
            ms = {}
        out[str(d)] = {
            "bytes_in_use": ms.get("bytes_in_use"),
            "peak_bytes_in_use": ms.get("peak_bytes_in_use"),
            "bytes_limit": ms.get("bytes_limit"),
        }
    return out


__all__ = ["trace", "annotate", "Throughput", "device_memory"]
