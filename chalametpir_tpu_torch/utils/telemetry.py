"""Tracing for the port: spans kept in memory, and `[trace]` lines.

Silent by default, and then `span()` costs one flag test: it returns one
shared no-op context manager, with no clock read. Two switches turn it on:

* `start_recording()` keeps every span in a bounded in-memory buffer
  until `take_spans()` hands them over (spans past MAX_SPANS are counted,
  `dropped_spans()`, not kept);
* `CHALAMETPIR_TRACE=1` (or `set_trace(True)`) prints span timings and
  one-off events to stderr, the same `[trace]` lines under the same names
  as the JAX package's chalametpir_tpu/utils/telemetry.py, of which these
  are the port's own copies.

A span is timed on the host clock, `time.perf_counter()`, and never waits
on the device: the device's own time comes from a profiler trace, matched
to the spans by the launches inside them. Its parent is the span open
around it in the same thread or asyncio task (a context variable, which
`asyncio.to_thread` carries into its worker thread); a root span and all
its descendants share the root's request id. A span holds its name, its
times, counts (bytes, rows, queries) and the class name of an exception
that left it: never a key, a secret, a query or response word, nor an
array. `profile_to` wraps torch.profiler where the JAX module wraps
jax.profiler.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import numbers
import os
import sys
import threading
import time
from typing import NamedTuple

import torch

_ENABLED = os.environ.get("CHALAMETPIR_TRACE", "") not in ("", "0")
_RECORDING = False
# kept spans at most, between two take_spans(): a 30 s window of 2^20
# lookups keeps ~15k, so the bound only stops a process that never takes
# them
MAX_SPANS = 1 << 18

_lock = threading.Lock()
_kept: list = []
_dropped = 0
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("chalametpir_span", default=None)


class Span(NamedTuple):
    """One recorded span: host seconds on `time.perf_counter()`'s clock."""

    name: str
    start: float
    end: float
    thread: int  # threading.get_ident() of the thread that closed it
    id: int
    parent: int | None
    request: int  # the root span's id, shared by all its descendants
    error: str | None  # the class name of the exception that left the span
    fields: dict  # counts: name -> int or float


def set_trace(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = enabled


def trace_enabled() -> bool:
    return _ENABLED


def start_recording() -> None:
    """Keep every span from now on, in a buffer emptied first."""
    global _RECORDING, _dropped
    with _lock:
        _kept.clear()
        _dropped = 0
        _RECORDING = True


def stop_recording() -> None:
    global _RECORDING
    _RECORDING = False


def take_spans() -> list[Span]:
    """The spans kept since the last call (or since start_recording), in
    the order they closed; empties the buffer and records on."""
    global _kept
    with _lock:
        out, _kept = _kept, []
    return out


def dropped_spans() -> int:
    """Spans not kept since start_recording, the buffer being full."""
    return _dropped


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


def _counts(fields: dict) -> dict:
    for k, v in fields.items():
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise TypeError(f"span field {k}={type(v).__name__}: a span holds counts only")
    return fields


def _close(name: str, t0: float, t1: float, sid: int, parent, error: str | None, fields: dict) -> None:
    global _dropped
    if _RECORDING:
        request = parent.request if parent is not None else sid
        span = Span(name, t0, t1, threading.get_ident(), sid, parent.id if parent is not None else None,
                    request, error, fields)
        with _lock:
            if len(_kept) < MAX_SPANS:
                _kept.append(span)
            else:
                _dropped += 1
    if _ENABLED:
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[trace] {name}: {t1 - t0:.3f}s {extra}".rstrip(), file=sys.stderr, flush=True)


class _NoSpan:
    """What span() returns while nothing records or prints."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **fields) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "fields", "id", "request", "parent", "token", "t0")

    def __init__(self, name: str, fields: dict):
        self.name, self.fields = name, _counts(fields)

    def __enter__(self):
        self.parent = _current.get()
        self.id = next(_ids)
        self.request = self.parent.request if self.parent is not None else self.id
        self.token = _current.set(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        _current.reset(self.token)
        _close(self.name, self.t0, t1, self.id, self.parent, exc_type.__name__ if exc_type else None,
               self.fields)
        return False

    def set(self, **fields) -> None:
        """Add counts known only inside the span (bytes read back)."""
        self.fields.update(_counts(fields))


def span(name: str, **fields):
    """A context manager that times its block as the span `name`, with
    `fields` (counts) and more from its `set(**fields)`; kept while
    recording, printed as `[trace] name: 1.234s k=v ...` while tracing."""
    if not (_RECORDING or _ENABLED):
        return _NO_SPAN
    return _Span(name, fields)


def add_span(name: str, t0: float, t1: float, **fields) -> None:
    """A span already timed, from t0 to t1 on `time.perf_counter()`'s
    clock, a child of the span open here: for a phase whose clock reads
    the caller takes anyway (set-up's per-chunk phases), or whose start
    was read elsewhere (a query's wait in a queue)."""
    if not (_RECORDING or _ENABLED):
        return
    _close(name, t0, t1, next(_ids), _current.get(), None, _counts(fields))


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
