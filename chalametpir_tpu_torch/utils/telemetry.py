"""Tracing for the port.

The spans, one-off events and the `CHALAMETPIR_TRACE` switch are the JAX
package's (chalametpir_tpu/utils/telemetry.py), imported, so both
packages print the same `[trace]` lines under the same names. Only the
profiler differs: `profile_to` wraps torch.profiler where the JAX module
wraps jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from chalametpir_tpu.utils.telemetry import (  # noqa: F401  (re-exported)
    set_trace,
    span,
    trace_event,
)


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
