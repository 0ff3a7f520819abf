"""Reductions that several per-layer readers share. Each takes the run's
record (harness.record) and returns None when it has nothing to read:
no such spans, or no device trace (an untraced run, or the CPU)."""

from __future__ import annotations

import statistics

from . import trace, workcount


def median_wall_ms(rec: dict, span: str):
    rows = rec["spans"].get(span)
    return statistics.median((s1 - s0) / 1e3 for s0, s1, _ in rows) if rows else None


def _assigned(rec: dict, span: str, keep) -> tuple[list, list] | None:
    rows = rec["spans"].get(span)
    if not rows or rec["device"] is None:
        return None
    events = [(e0, e1, launch) for e0, e1, name, launch in rec["device"] if keep(name)]
    return rows, trace.device_ms_by_span([(s0, s1) for s0, s1, _ in rows], events)


def busy_ms_per_span(rec: dict, span: str):
    """Device-busy ms inside each span (the union of every kernel, copy and
    memset interval there), averaged over the spans."""
    rows = rec["spans"].get(span)
    if not rows or rec["device"] is None:
        return None
    busy = rec["busy"]
    total = 0.0
    for s0, s1, _ in rows:
        total += sum(min(b1, s1) - max(b0, s0) for b0, b1 in busy if b1 > s0 and b0 < s1)
    return total / len(rows) / 1e3


def upload_ms_per_query(rec: dict, span: str):
    """Device ms of the host-to-device copies the spans launched, over the
    queries in them."""
    found = _assigned(rec, span, lambda name: name.startswith("Memcpy HtoD"))
    if found is None:
        return None
    rows, ms = found
    return sum(ms) / sum(q for _, _, q in rows)


def roofline_percent(rec: dict, span: str):
    """The frozen least time of each respond call in the spans, at its own
    number of queries, summed, over the device time of the kernels the
    spans launched (copies and memsets left out), in percent."""
    found = _assigned(rec, span, lambda name: not trace.is_copy(name))
    if found is None:
        return None
    rows, ms = found
    if not sum(ms):
        return None
    g = rec["geometry"]
    least = sum(workcount.bound_ms(q, g["m"], g["c_pad"], g["plane_bytes"], g["b"])[0] for _, _, q in rows)
    return 100.0 * least / sum(ms)


def idle_percent(rec: dict):
    """The share of the window in which the device ran nothing, in percent."""
    if rec["device"] is None:
        return None
    return 100.0 * (1.0 - sum(b1 - b0 for b0, b1 in rec["busy"]) / rec["window_us"])
