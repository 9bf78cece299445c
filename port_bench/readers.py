"""Arithmetic the per-layer metrics' readers share (``metrics/*.py``).

A reader takes the run's record (the driver's ``record``) and returns its
metric, or None where the record holds nothing for it to read: another kind
of run, a kernel the cell does not launch, a trace with no device time.
"""

from __future__ import annotations

from port_bench.flops import PEAK_FLOPS, bound_s
from port_bench.trace import kernel_seconds


def roofline(record: dict, kind: str, kernel: str):
    """Percent: the least time for ``kernel``'s launches in the traced
    window at the fixed peaks (their sites' bound, times the calls traced)
    over the kernel's summed device time there."""
    if record.get("kind") != kind:
        return None
    bound = sum(bound_s(f, b) for k, _, f, b in record["sites"] if k == kernel)
    device = kernel_seconds(record.get("trace") or {}, kernel)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound * record["traced_calls"] / device


def mfu(record: dict, kind: str):
    """Percent: the model FLOPs completed in the untraced window over the
    window and the fixed peak."""
    if record.get("kind") != kind or record["window_s"] <= 0:
        return None
    return 100.0 * record["model_flops"] / record["window_s"] / PEAK_FLOPS


def idle_share(record: dict, kind: str):
    """Percent of the traced window in which the device ran nothing: one
    less the union of the device operations' intervals there over the
    window's length, both from the one trace."""
    trace = record.get("trace") if record.get("kind") == kind else None
    if not trace or trace["busy_s"] <= 0 or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def host_ms(record: dict, kind: str):
    """Mean host time of the calls into the port (from the call until it
    returns, before the synchronize), untraced window."""
    if record.get("kind") != kind or not record["calls"]:
        return None
    return 1e3 * record["host_call_s"] / record["calls"]
