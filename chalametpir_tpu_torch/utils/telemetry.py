"""Tracing for the port.

Silent by default. `CHALAMETPIR_TRACE=1` (or `set_trace(True)`) prints
span timings and one-off events to stderr, the same `[trace]` lines under
the same names as the JAX package's chalametpir_tpu/utils/telemetry.py,
of which these are the port's own copies. `profile_to` wraps
torch.profiler where the JAX module wraps jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

_ENABLED = os.environ.get("CHALAMETPIR_TRACE", "") not in ("", "0")


def set_trace(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = enabled


class _NullRusage:
    """Zero-valued stand-in where per-thread rusage is unavailable
    (RUSAGE_THREAD is Linux-only): attribution stats must never take down
    the API being measured."""

    ru_stime = 0.0
    ru_utime = 0.0
    ru_minflt = 0
    ru_majflt = 0


def thread_rusage():
    """Per-thread getrusage snapshot, or a zeroed stand-in off Linux."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_THREAD)
    except (ImportError, AttributeError, OSError):
        return _NullRusage()


def trace_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a phase; prints `[trace] name: 1.234s k=v ...` when enabled."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[trace] {name}: {dt:.3f}s {extra}".rstrip(), file=sys.stderr, flush=True)


def trace_event(name: str, **fields) -> None:
    """One-off trace line (no timing) when tracing is enabled."""
    if not _ENABLED:
        return
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[trace] {name}: {extra}".rstrip(), file=sys.stderr, flush=True)


@contextlib.contextmanager
def profile_to(logdir: str):
    """torch.profiler trace around a block: CPU activity, and CUDA
    activity where there is a card; on exit the timeline is written to
    `logdir/trace.json` as a Chrome trace (chrome://tracing, Perfetto).
    Yields the profiler, for `key_averages()`, or None. Non-fatal, as in
    the JAX package: a profiler that cannot start or stop is reported on
    stderr and the block runs unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except Exception as e:  # backend-dependent
        print(f"[trace] profiler unavailable: {e!r}", file=sys.stderr)
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception as e:  # backend-dependent
                print(f"[trace] profiler stop failed: {e!r}", file=sys.stderr)
