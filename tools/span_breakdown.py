"""Where a benchmark cell's traced window goes, by the port's own spans.

    python3 tools/span_breakdown.py --workload v1.fleet64.n1 --seed 7 [--seconds 10]

from the root of a checkout, on the card. Runs the cell once through
``port_bench.run`` with ``--trace 1``, keeps the profiler's events of the
traced window, and prints the harness's result line and then one JSON line:

- ``program_spans``: per traced call, each ``dse.`` span's calls and its
  host, self and device milliseconds (utils/trace.py::span_table);
- ``unlinked_device_records``: device operations whose launch the trace
  does not hold (0 expected);
- ``idle_gaps``: the ``top`` longest idle gaps of the harness's window,
  each named ``<harness span>/<innermost program span>`` (the harness's
  name alone where no program span is open at the gap's middle);
- ``harness_span_ms``: the mean host duration of each of the harness's own
  spans, ``busy_ms``: the traced busy time a call;
- ``metrics``: ``wrapper_host_ms.serve`` (summed self time of the
  ``dse.launch.*`` spans a dispatch), ``glue_host_ms.serve`` (self time of
  ``dse.dispatch`` and ``dse.half.*``), ``device_ms.train_gen`` and
  ``device_ms.train_disc`` (the device time launched inside
  ``dse.course.gen`` / ``dse.course.disc`` a step).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def window_gaps(events, harness_spans):
    """``(window_us, gaps, outer, inner)`` of a traced window: its length
    from the first harness span's start to the last one's end, its idle
    gaps as the harness finds them (between the union of the device
    operations' intervals), and the harness's spans and the ``dse.`` spans
    as ``(start, end, name)``, the latter without ``dse.``."""
    from torch.autograd import DeviceType

    from dl_speech_enhancement_tpu_torch.utils.trace import PREFIX, is_device_op

    outer, inner, device = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if is_device_op(e):
            device.append((a, b))
        elif e.device_type != DeviceType.CPU:  # a span mirrored onto the device
            continue
        elif e.name in harness_spans:
            outer.append((a, b, e.name))
        elif e.name.startswith(PREFIX):
            inner.append((a, b, e.name[len(PREFIX):]))
    if not outer:
        return 0.0, [], outer, inner
    w0, w1 = min(a for a, _, _ in outer), max(b for _, b, _ in outer)
    gaps, at = [], w0
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    return w1 - w0, gaps, outer, inner


def named_gaps(gaps, outer, inner, top: int = 10) -> list:
    """``[[name, seconds]]`` of the ``top`` longest ``gaps``, each named by
    the innermost harness span (``outer``) and the innermost program span
    (``inner``) open at its middle: ``enqueue/launch.hifigan_unit``, or the
    harness's name alone (``between`` where none is open)."""

    def open_span(spans, t, default):
        inside = [(a, n) for a, b, n in spans if a <= t <= b]
        return max(inside)[1] if inside else default

    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        name = open_span(outer, mid, "between")
        program = open_span(inner, mid, None)
        out.append([name if program is None else f"{name}/{program}", (b - a) * 1e-6])
    return out


def breakdown(events, traced_calls: int, harness_spans) -> dict:
    """The JSON line's fields (see the module's docstring) from the traced
    window's profiler events and its count of calls."""
    from dl_speech_enhancement_tpu_torch.utils.trace import span_table

    table, unlinked = span_table(events)
    per = {name: {"calls": row["calls"] / traced_calls,
                  **{k[:-2] + "_ms": 1e3 * row[k] / traced_calls
                     for k in ("host_s", "self_s", "device_s")}}
           for name, row in sorted(table.items())}
    window_us, gaps, outer, inner = window_gaps(events, harness_spans)
    harness = {}
    for a, b, name in outer:
        harness.setdefault(name, []).append(b - a)

    def self_ms(match):
        rows = [r for n, r in per.items() if match(n)]
        return sum(r["self_ms"] for r in rows) if rows else None

    def device_ms(name):
        return per[name]["device_ms"] if name in per else None

    return {
        "traced_calls": traced_calls,
        "program_spans": per,
        "unlinked_device_records": unlinked,
        "idle_gaps": named_gaps(gaps, outer, inner),
        "harness_span_ms": {n: 1e-3 * sum(d) / len(d) for n, d in sorted(harness.items())},
        "busy_ms": 1e-3 * (window_us - sum(b - a for a, b in gaps)) / traced_calls,
        "metrics": {
            "wrapper_host_ms.serve": self_ms(lambda n: n.startswith("dse.launch.")),
            "glue_host_ms.serve": self_ms(
                lambda n: n == "dse.dispatch" or n.startswith("dse.half.")),
            "device_ms.train_gen": device_ms("dse.course.gen"),
            "device_ms.train_disc": device_ms("dse.course.disc"),
        },
    }


def run(argv, device=None) -> tuple:
    """One traced run of a cell through ``port_bench.run.main``: its exit
    code, its result line and the breakdown (None without a result)."""
    import port_bench.run as bench_run
    from port_bench import trace as bench_trace
    from port_bench.drivers import fleet, train

    kept = []

    def keeping(read):
        def events(prof):
            kept.append(list(prof.events()))
            return read(prof)
        return events

    originals = {mod: mod.profiler_events for mod in (fleet, train)}
    for mod, read in originals.items():
        mod.profiler_events = keeping(read)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench_run.main([*argv, "--trace", "1"], device=device)
    finally:
        for mod, read in originals.items():
            mod.profiler_events = read
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    if result is None or not kept:
        return rc, result, None
    return rc, result, breakdown(kept[-1], result["window"]["traced_calls"],
                                 bench_trace.SPANS)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0,
                        help="the untraced window before the traced one")
    args = parser.parse_args()
    rc, result, parts = run(["--workload", args.workload, "--seed", str(args.seed),
                             "--seconds", str(args.seconds)])
    if result is not None:
        print(json.dumps(result))
    if parts is not None:
        print(json.dumps(dict(parts, workload=args.workload, seed=args.seed)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
