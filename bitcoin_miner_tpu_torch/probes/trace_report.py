"""Reader of the card's trace: where does the device time go, and what did
the host do while the card idled?

It stands in place of the reference's ``benchmarks/trace_report.py``,
which parses XLA xplane protobufs. This one reads the Chrome-trace JSON
that ``torch.profiler`` exports (``bench --profile DIR`` writes
``DIR/bench.<pid>.pt.trace.json``) with the standard library alone:

- **device self-time by kernel family**: the trace's ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events, each event's time less that of
  the events nested in it on its line, grouped as ``scan_tile``,
  ``rescan_steps``, ``scan_hitbuf``, ``int_probe`` (by the kernel's
  function name, whatever its template arguments and the library's build
  suffixes), ``memcpy``, ``memset`` and ``other``: launches, total ms,
  mean ms a launch and share of the profiled window;
- **the card's busy share** of the profiled window (the profiler's own
  ``Trace`` span where it has one, else first event to last), from the
  union of the device events;
- **the five longest idle gaps between device events**, each labelled
  with the host activity the profiler recorded over it on its own clock:
  the ``user_annotation`` range (``record_function``: the pipeline's
  ``device_dispatch``, ``ring_collect``, ``feeder_slice``, ``cpu_verify``,
  ``submit``) that overlaps it most, else the ``cuda_runtime`` or
  ``cuda_driver`` call that does, else ``no host event``. Correlation ids
  are not needed (kernels launched through a library's own runtime may
  have none).

Run: ``python -m bitcoin_miner_tpu_torch.probes.trace_report DIR [--md]
[--md-out FILE] [--evidence FILE] [--top N]``. It prints one JSON line; a
directory without a trace, or a trace it cannot read, gives a line with
``error`` and rc 1.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

#: device event categories of a torch.profiler Chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host categories a gap is labelled from, in order of preference.
ANNOTATION_CATS = ("user_annotation",)
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
#: kernel families by function name, the first match wins.
KERNEL_FAMILIES = (("rescan_steps", re.compile(r"rescan_steps")),
                   ("scan_hitbuf", re.compile(r"scan_hitbuf")),
                   ("scan_tile", re.compile(r"scan_tile")),
                   ("int_probe", re.compile(r"int_probe")))
NO_HOST_EVENT = "no host event"
#: the idle gaps listed, longest first.
GAPS = 5


def find_traces(root: str) -> List[str]:
    return sorted(glob.glob(os.path.join(root, "**", "*.pt.trace.json"),
                            recursive=True))


def family(event: dict) -> str:
    """The family of a device event: a kernel's by its name, else the
    copy or set it is, else ``other``."""
    cat = event.get("cat")
    if cat == "gpu_memcpy":
        return "memcpy"
    if cat == "gpu_memset":
        return "memset"
    name = str(event.get("name", ""))
    for fam, pattern in KERNEL_FAMILIES:
        if pattern.search(name):
            return fam
    return "other"


def self_times(events: List[dict]) -> List[Tuple[dict, float]]:
    """(event, self µs) for complete events on one line: each event's
    duration less its direct children's, through an interval stack."""
    out: List[Tuple[dict, float]] = []
    stack: list = []  # [end, children µs, event]
    for ev in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1][0] <= ev["ts"]:
            end, children, parent = stack.pop()
            out.append((parent, max(0.0, parent["dur"] - children)))
        if stack:
            stack[-1][1] += ev["dur"]
        stack.append([ev["ts"] + ev["dur"], 0.0, ev])
    while stack:
        end, children, parent = stack.pop()
        out.append((parent, max(0.0, parent["dur"] - children)))
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _host_label(a: float, b: float, events: List[dict]) -> str:
    """The event of ``events`` that overlaps ``[a, b]`` most, or None."""
    best, most = None, 0.0
    for ev in events:
        overlap = min(b, ev["ts"] + ev["dur"]) - max(a, ev["ts"])
        if overlap > most:
            best, most = ev["name"], overlap
    return best


def _complete(trace: dict) -> List[dict]:
    return [e for e in trace.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") == "X"
            and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]


def trace_stats(paths: List[str], top: int = 15) -> dict:
    """The report's body over the traces at ``paths``: their windows,
    device time and gaps summed or ranked together (each trace's gaps on
    its own timeline)."""
    window_us = busy_us = span_us = 0.0
    fams: Dict[str, dict] = {}
    kernels: Dict[str, dict] = {}
    annotations: Dict[str, dict] = {}
    gaps: list = []
    n_device = n_events = 0
    device_name = None
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            trace = json.load(fh)
        props = trace.get("deviceProperties")
        if props and device_name is None:
            device_name = props[0].get("name")
        events = _complete(trace)
        n_events += len(events)
        if not events:
            continue
        spans = [e for e in events if e.get("cat") == "Trace"]
        if spans:
            window_us += sum(e["dur"] for e in spans)
        else:
            window_us += (max(e["ts"] + e["dur"] for e in events)
                          - min(e["ts"] for e in events))
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        n_device += len(device)
        lines: Dict[tuple, list] = {}
        for ev in device:
            lines.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
        for line in lines.values():
            for ev, self_us in self_times(line):
                fam = family(ev)
                f = fams.setdefault(fam, {"launches": 0, "us": 0.0})
                f["launches"] += 1
                f["us"] += self_us
                k = kernels.setdefault(str(ev.get("name")), {
                    "family": fam, "launches": 0, "us": 0.0})
                k["launches"] += 1
                k["us"] += self_us
        for ev in events:
            if ev.get("cat") in ANNOTATION_CATS:
                a = annotations.setdefault(ev["name"], {"count": 0, "us": 0.0})
                a["count"] += 1
                a["us"] += ev["dur"]
        busy = union([(e["ts"], e["ts"] + e["dur"]) for e in device])
        busy_us += sum(b - a for a, b in busy)
        if busy:
            span_us += busy[-1][1] - busy[0][0]
        by_start = sorted(device, key=lambda e: e["ts"])
        host_notes = [e for e in events if e.get("cat") in ANNOTATION_CATS]
        runtime = [e for e in events if e.get("cat") in RUNTIME_CATS]
        for (_a0, a1), (b0, _b1) in zip(busy, busy[1:]):
            gaps.append((b0 - a1, a1, b0, path, host_notes, runtime,
                         by_start))
    if not n_events:
        return {}
    gaps.sort(key=lambda g: -g[0])
    ranked_gaps = []
    for gap_us, a, b, path, host_notes, runtime, by_start in gaps[:GAPS]:
        label = _host_label(a, b, host_notes)
        source = "user_annotation"
        if label is None:
            label, source = _host_label(a, b, runtime), "cuda_runtime"
        if label is None:
            label, source = NO_HOST_EVENT, None
        before = max((e for e in by_start if e["ts"] + e["dur"] <= a),
                     key=lambda e: e["ts"] + e["dur"], default=None)
        after = next((e for e in by_start if e["ts"] >= b), None)
        ranked_gaps.append({
            "ms": round(gap_us / 1e3, 4),
            "at_ms": round((a - min(e["ts"] for e in by_start)) / 1e3, 3),
            "after": family(before) if before else None,
            "before": family(after) if after else None,
            "host": label, "host_source": source,
            "trace": os.path.basename(path),
        })
    window = window_us or 1.0
    return {
        "device_name": device_name,
        "window_ms": round(window_us / 1e3, 3),
        "device": {
            "events": n_device,
            "busy_ms": round(busy_us / 1e3, 3),
            "busy_share": round(busy_us / window, 4),
            "span_ms": round(span_us / 1e3, 3),
            "busy_share_of_span": round(busy_us / span_us, 4)
            if span_us else None,
            "families": {
                fam: {"launches": f["launches"],
                      "ms": round(f["us"] / 1e3, 3),
                      "mean_ms": round(f["us"] / 1e3 / f["launches"], 5),
                      "share": round(f["us"] / window, 4)}
                for fam, f in sorted(fams.items(), key=lambda kv: -kv[1]["us"])
            },
            "top_kernels": [
                {"name": name[:120], "family": k["family"],
                 "launches": k["launches"], "ms": round(k["us"] / 1e3, 3),
                 "mean_ms": round(k["us"] / 1e3 / k["launches"], 5)}
                for name, k in sorted(kernels.items(),
                                      key=lambda kv: -kv[1]["us"])[:top]
            ],
            "gaps": ranked_gaps,
        },
        "host_annotations": {
            name: {"count": a["count"], "ms": round(a["us"] / 1e3, 3)}
            for name, a in sorted(annotations.items(),
                                  key=lambda kv: -kv[1]["us"])
        },
    }


def markdown(stats: dict) -> str:
    dev = stats["device"]
    lines = [
        f"### Card trace — {stats.get('device_name') or 'no card'} "
        f"({stats['window_ms']} ms profiled, busy {dev['busy_share']:.2%})",
        "",
        "| family | launches | ms | mean ms | share of window |",
        "|---|---|---|---|---|",
    ]
    lines += [f"| {fam} | {f['launches']} | {f['ms']} | {f['mean_ms']} | "
              f"{f['share']:.2%} |" for fam, f in dev["families"].items()]
    lines += ["", "Longest idle gaps:", "",
              "| ms | at ms | after | before | host |", "|---|---|---|---|---|"]
    lines += [f"| {g['ms']} | {g['at_ms']} | {g['after']} | {g['before']} | "
              f"`{g['host']}` |" for g in dev["gaps"]]
    return "\n".join(lines) + "\n"


def run(profile_dir: str, top: int = 15, md_out: Optional[str] = None,
        evidence: Optional[str] = None) -> Tuple[int, dict]:
    """(rc, the JSON line) over ``profile_dir``; with ``md_out`` the
    markdown section is written there, with ``evidence`` the line is also
    appended to that JSONL file with the time it was measured."""
    traces = find_traces(profile_dir)
    if not traces:
        return 1, {"metric": "trace_report",
                   "error": f"no *.pt.trace.json under {profile_dir}"}
    try:
        stats = trace_stats(traces, top)
    except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
        return 1, {"metric": "trace_report",
                   "error": f"{type(e).__name__}: {e}"[:300],
                   "traces": [os.path.basename(t) for t in traces]}
    if not stats:
        return 1, {"metric": "trace_report",
                   "error": "traces parsed but empty",
                   "traces": [os.path.basename(t) for t in traces]}
    rec = {"metric": "trace_report", "profile_dir": profile_dir,
           "n_traces": len(traces), **stats}
    if evidence:
        from datetime import datetime, timezone

        with open(evidence, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(dict(rec, measured=datetime.now(
                timezone.utc).strftime("%Y-%m-%dT%H:%MZ"))) + "\n")
    if md_out:
        with open(md_out, "w", encoding="utf-8") as fh:
            fh.write(markdown(stats))
    return 0, rec


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.probes.trace_report",
        description=__doc__.splitlines()[0])
    p.add_argument("profile_dir")
    p.add_argument("--top", type=int, default=15,
                   help="kernels listed by self time (default %(default)s)")
    p.add_argument("--md", action="store_true",
                   help="also print the markdown section")
    p.add_argument("--md-out", default=None, metavar="FILE",
                   help="write the markdown section to FILE")
    p.add_argument("--evidence", default=None, metavar="FILE",
                   help="append the JSON line to this JSONL file")
    args = p.parse_args(argv)
    rc, rec = run(args.profile_dir, args.top, args.md_out, args.evidence)
    print(json.dumps(rec), flush=True)
    if rc == 0 and args.md:
        print("\n" + markdown(rec), end="")
    return rc


if __name__ == "__main__":
    sys.exit(main())
