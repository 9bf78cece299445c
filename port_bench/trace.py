"""What the benchmark reads from the program and the device: the port's
launch counters, spans on the benchmark's own calls, and the reduction of a
``torch.profiler`` trace to busy time, kernel times and idle gaps.

Spans are ``torch.profiler.record_function`` ranges that the drivers open
around their calls into the port (``upload``, ``enqueue``, ``download``,
``sync``, ``step``); in a traced window they land in the trace beside the
device's kernels, on one clock.
"""

from __future__ import annotations

import contextlib
import sys

import torch

PORT = "dl_speech_enhancement_tpu_torch"
SPANS = ("upload", "enqueue", "download", "sync", "step")


def launch_counters() -> dict:
    """``{"module.function": launches}`` of every kernel wrapper of the port
    loaded in this process: each function that keeps an int ``launches``."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == PORT or name.startswith(PORT + ".")):
            continue
        for attr, fn in vars(mod).items():
            count = getattr(fn, "launches", None)
            if callable(fn) and isinstance(count, int) and fn.__module__ == name:
                out[f"{name}.{attr}"] = count
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def span(name: str, traced: bool):
    return torch.profiler.record_function(name) if traced else contextlib.nullcontext()


def profile(device):
    """A profiler over the host and ``device``'s kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals):
    """Merged ``[(start, end)]`` of possibly overlapping intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events, spans=SPANS, top: int = 10) -> dict:
    """Reduce profiler events to what the per-layer metrics read.

    ``events`` are ``(kind, name, start_us, end_us)``, kind ``"device"`` for
    an operation on the device (kernel, copy, set) and ``"span"`` for one of
    the benchmark's spans. The traced window runs from the first span's
    start to the last span's end. Returns its length, the time in it that
    some device operation covered (the union of their intervals: kernels
    that overlap count once), each device operation's summed time by name,
    the ``top`` longest of those (names cut to 80 characters), and the
    ``top`` longest idle gaps, each named by the span open at its middle
    (the innermost, the latest started; ``between`` where none is: the
    benchmark's own loop between two calls), all in seconds."""
    span_iv = sorted((a, b, n) for k, n, a, b in events if k == "span" and n in spans)
    if not span_iv:
        return {}
    w0, w1 = span_iv[0][0], max(b for _, b, _ in span_iv)
    device = [(max(a, w0), min(b, w1), n) for k, n, a, b in events
              if k == "device" and n not in spans and b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in device])
    by_name: dict = {}
    for a, b, n in device:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    short: dict = {}
    for n, s in by_name.items():
        short[n[:80]] = short.get(n[:80], 0.0) + s
    gaps, at = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)

    def open_span(t):
        inside = [(a, n) for a, b, n in span_iv if a <= t <= b]
        return max(inside)[1] if inside else "between"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [((b - a) * 1e-6, open_span((a + b) / 2)) for a, b in longest]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernel_s": by_name,
            "device_ops": sorted(([n, s] for n, s in short.items()), key=lambda p: -p[1])[:top],
            "idle_gaps": [[n, s] for s, n in idle],
            "device_records": len(device)}


def profiler_events(prof) -> list:
    """``(kind, name, start_us, end_us)`` of a finished profiler's events."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if e.device_type == cuda:
            out.append(("device", e.name, e.time_range.start, e.time_range.end))
        elif e.name in SPANS:
            out.append(("span", e.name, e.time_range.start, e.time_range.end))
    return out


def kernel_seconds(trace: dict, kernel: str) -> float:
    """Summed device time of the port kernel ``kernel`` in a reduced trace:
    every operation whose name holds ``<kernel>_kernel``."""
    return sum(s for n, s in trace.get("kernel_s", {}).items() if f"{kernel}_kernel" in n)
