"""Spans inside the port, on the clock of a ``torch.profiler`` trace.

``span(name)`` opens the range ``dse.<name>`` while a torch profiler records,
and is one shared null context otherwise; ``spanned(name)`` is its decorator
form, which decides at each call. The ranges go into whatever trace is being
taken (a benchmark's traced window, an operator's own profile), beside the
kernels and on their clock. The program keeps no registry and writes nothing
out. A dispatch or a training step runs on one host thread, so its spans
nest: a span's parent is the innermost span that encloses it.

Whether a profiler records is read from ``torch.autograd.profiler``'s
module flag, which the profiler sets for the whole process on start: one
attribute read, and true on every thread (``torch._C._autograd.
_profiler_enabled()`` is per thread and costs twice as much).

A range is a function-scope ``RecordFunction`` (``_RecordFunctionFast``),
not ``record_function``'s user annotation. CUPTI mirrors a user annotation
onto the device as an event over the kernels launched inside it, which a
reader that takes every CUDA-typed event counts as device time; a
function-scope range leaves the device's side of the trace as it was. It
also costs less under the profiler (0.9 against 7.4 us a span on a CPU).

``is_device_op`` tells the device's own work from such mirrored
annotations; ``span_table`` reduces a trace's events to each span's calls,
host time, self time and the device time of the work launched inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import re

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import DeviceType
from torch.autograd import profiler as _profiler

PREFIX = "dse."
NULL = contextlib.nullcontext()
# a CUDA API call on the host (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): it shares its correlation id with the device work it
# enqueued
_RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")


def span(name: str):
    """The range ``dse.<name>`` while a profiler records, else :data:`NULL`."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(PREFIX + name)
    return NULL


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``. The
    wrapper keeps the function's name and module; attributes set on it
    afterwards (a wrapper's ``launches``) live on the wrapper, which the
    function's own body finds under its module-level name."""
    full = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _RecordFunctionFast(full):
                return fn(*args, **kwargs)

        return call

    return wrap


def is_device_op(event) -> bool:
    """True for a profiler event that is work on the card (a kernel, a copy,
    a set): CUDA-typed and not a user annotation mirrored onto the device."""
    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def _union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def span_table(events):
    """``({name: {"calls", "host_s", "self_s", "device_s"}}, unlinked)`` of
    the ``dse.`` spans among a profiler's ``events()``, in seconds.

    ``host_s`` sums the spans' durations; ``self_s`` is that less the part
    their child spans (on the same thread) cover; ``device_s`` is the union
    of the intervals of the device operations launched while a span of the
    name was open, its children's included. A device operation is
    attributed by the host time of its launch (the runtime call that shares
    its correlation id), on whichever thread that ran: autograd launches a
    backward's kernels from its own thread while the caller waits inside its
    span. ``unlinked`` counts device operations whose launch the trace does
    not hold."""
    ops, launch_at, spans = [], {}, []
    for e in events:
        if is_device_op(e):
            ops.append((e.id, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith(PREFIX):
                spans.append((e.thread, e.time_range.start, -e.time_range.end, e.name))
            elif _RUNTIME_CALL.match(e.name):
                launch_at[e.id] = e.time_range.start
    launched = sorted((launch_at[i], a, b) for i, a, b in ops if i in launch_at)
    times = [t for t, _, _ in launched]
    rows, device = {}, {}
    stack: list = []
    for thread, a, neg_b, name in sorted(spans):
        b = -neg_b
        while stack and (stack[-1][0] != thread or stack[-1][2] <= a):
            stack.pop()
        row = rows.setdefault(name, {"calls": 0, "host_s": 0.0, "self_s": 0.0})
        row["calls"] += 1
        row["host_s"] += (b - a) * 1e-6
        row["self_s"] += (b - a) * 1e-6
        if stack:
            rows[stack[-1][3]]["self_s"] -= (b - a) * 1e-6
        stack.append((thread, a, b, name))
        lo, hi = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
        device.setdefault(name, []).extend((s, e) for _, s, e in launched[lo:hi])
    for name, row in rows.items():
        row["device_s"] = _union_length(device[name]) * 1e-6
    return rows, len(ops) - len(launched)
