"""Thread-safe labeled metric registry.

Counterpart of ``bitcoin_miner_tpu/telemetry/metrics.py``, which has no
JAX in it; the port keeps its own copy, so the two render the same
exposition text byte for byte. Prometheus-shaped counters, gauges and
fixed-bucket histograms, each optionally labeled, behind a registry that
renders conformant exposition format (``# HELP``/``# TYPE``, ``_total``
counter suffixes, ``_bucket``/``_sum``/``_count`` histogram series).

- **Cheap on the hot path.** One ``observe``/``inc`` is a lock, a bisect
  and a few adds; the ring observes once per dispatch (milliseconds
  apart).
- **Get-or-create.** Asking for an existing family name returns that
  family (kind and labelnames must match), so the dispatcher, the ring
  and the bench land on one series.
- **No dependencies.** No prometheus_client.

Histograms keep exact ``sum``/``count``/``min``/``max`` beside the fixed
buckets; quantiles are bucket-interpolated, as PromQL's
``histogram_quantile`` would give on the scraped series.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds): spans sub-ms dispatch gaps on a
#: saturated ring through multi-second pool round-trips on a wedged link.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')
    )


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, float) and value != value:  # NaN
        return "NaN"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value)


def _render_labels(
    labelnames: Sequence[str], labelvalues: Sequence[str],
    extra: Optional[Tuple[str, str]] = None,
) -> str:
    pairs = [
        f'{n}="{_escape_label_value(str(v))}"'
        for n, v in zip(labelnames, labelvalues)
    ]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter:
    """Monotonic counter. Rendered with the ``_total`` suffix."""

    kind = "counter"

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (occupancy, window depth, ratios)."""

    kind = "gauge"

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with exact sum/count/min/max sidecars.

    Buckets are *upper bounds* (``le``), cumulative at render time per the
    Prometheus text format; a ``+Inf`` bucket is implicit. ``quantile``
    interpolates within the bucket the way PromQL's ``histogram_quantile``
    does, clamped by the exact observed min/max so tiny sample counts
    don't report a bucket edge nothing ever reached."""

    kind = "histogram"

    def __init__(
        self, lock: threading.Lock,
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> None:
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b != b or b == math.inf for b in bounds):
            raise ValueError("bucket bounds must be finite (no NaN/+Inf)")
        self._lock = lock
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        with self._lock:
            return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        with self._lock:
            return self._max if self._count else 0.0

    def cumulative_counts(self) -> List[int]:
        """Per-``le`` cumulative counts, final entry = ``+Inf`` = count."""
        with self._lock:
            out, acc = [], 0
            for c in self._counts:
                acc += c
                out.append(acc)
            return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate, q in [0, 1]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q * self._count
            acc = 0
            lo = 0.0
            for idx, c in enumerate(self._counts):
                prev_acc = acc
                acc += c
                if acc >= rank and c:
                    hi = (
                        self.bounds[idx]
                        if idx < len(self.bounds) else self._max
                    )
                    if idx > 0:
                        lo = self.bounds[idx - 1]
                    frac = (rank - prev_acc) / c
                    est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    # Exact extrema beat bucket edges nothing reached.
                    return max(self._min, min(self._max, est))
            return self._max


_KIND_CLASSES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: labelnames + a child per label-value set.

    A family declared WITHOUT labelnames proxies the metric methods
    (``inc``/``set``/``observe``/…) straight to its single anonymous
    child, so unlabeled metrics read naturally at call sites."""

    def __init__(
        self, name: str, kind: str, help: str,
        labelnames: Sequence[str] = (), **child_kwargs: Any,
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        if kind == "histogram" and "le" in labelnames:
            raise ValueError("'le' is reserved for histogram buckets")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._child_kwargs = child_kwargs
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            self._default = self._make_child(())

    def _make_child(self, key: Tuple[str, ...]) -> Any:
        child = _KIND_CLASSES[self.kind](
            threading.Lock(), **self._child_kwargs
        )
        self._children[key] = child
        return child

    def labels(self, *labelvalues: Any, **labelkwargs: Any) -> Any:
        if labelkwargs:
            if labelvalues:
                raise ValueError("pass label values positionally OR by name")
            try:
                labelvalues = tuple(
                    labelkwargs[n] for n in self.labelnames
                )
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r}"
                ) from None
            if len(labelkwargs) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels {self.labelnames}, "
                    f"got {sorted(labelkwargs)}"
                )
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values, got {len(labelvalues)}"
            )
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child(key)
            return child

    # Unlabeled convenience proxies ------------------------------------
    def _default_child(self) -> Any:
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self._default

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def __getattr__(self, attr: str) -> Any:
        # value/count/sum/mean/min/max/quantile/... on unlabeled families.
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self._default_child(), attr)

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())

    # ------------------------------------------------------------ render
    def render(self) -> List[str]:
        sample_name = self.name
        if self.kind == "counter" and not sample_name.endswith("_total"):
            sample_name += "_total"
        lines = [
            f"# HELP {sample_name} {self.help or self.name}",
            f"# TYPE {sample_name} {self.kind}",
        ]
        for key, child in self.children():
            if self.kind == "histogram":
                cumulative = child.cumulative_counts()
                for bound, acc in zip(child.bounds, cumulative[:-1]):
                    le = _render_labels(
                        self.labelnames, key, extra=("le", _format_value(bound))
                    )
                    lines.append(f"{sample_name}_bucket{le} {acc}")
                le = _render_labels(self.labelnames, key, extra=("le", "+Inf"))
                lines.append(f"{sample_name}_bucket{le} {cumulative[-1]}")
                labels = _render_labels(self.labelnames, key)
                lines.append(
                    f"{sample_name}_sum{labels} {_format_value(child.sum)}"
                )
                lines.append(f"{sample_name}_count{labels} {cumulative[-1]}")
            else:
                labels = _render_labels(self.labelnames, key)
                lines.append(
                    f"{sample_name}{labels} {_format_value(child.value)}"
                )
        return lines

    def snapshot(self) -> dict:
        samples = []
        for key, child in self.children():
            labels = dict(zip(self.labelnames, key))
            if self.kind == "histogram":
                samples.append({
                    "labels": labels,
                    "count": child.count,
                    "sum": round(child.sum, 9),
                    "min": round(child.min, 9),
                    "max": round(child.max, 9),
                    "p50": round(child.quantile(0.5), 9),
                    "p95": round(child.quantile(0.95), 9),
                    "p99": round(child.quantile(0.99), 9),
                })
            else:
                samples.append({"labels": labels, "value": child.value})
        return {"kind": self.kind, "help": self.help, "samples": samples}


class MetricRegistry:
    """Named metric families with get-or-create semantics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(
        self, name: str, kind: str, help: str,
        labelnames: Sequence[str], **kwargs: Any,
    ) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, requested "
                        f"{kind}{tuple(labelnames)}"
                    )
                if kind == "histogram":
                    have = tuple(sorted(
                        float(b) for b in fam._child_kwargs["buckets"]
                    ))
                    want = tuple(sorted(
                        float(b) for b in kwargs["buckets"]
                    ))
                    if have != want:
                        # Silently returning the old geometry would hand
                        # the caller quantiles interpolated against
                        # buckets it never asked for.
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {have}, requested {want}"
                        )
                return fam
            fam = _Family(name, kind, help, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        # _total belongs to the exposition format, not the family name.
        if name.endswith("_total"):
            name = name[: -len("_total")]
        return self._get_or_create(name, "counter", help, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get_or_create(name, "gauge", help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> _Family:
        return self._get_or_create(
            name, "histogram", help, labelnames, buckets=buckets
        )

    def families(self) -> List[_Family]:
        with self._lock:
            return [f for _, f in sorted(self._families.items())]

    def render(self) -> str:
        """The whole registry in Prometheus exposition format."""
        lines: List[str] = []
        for fam in self.families():
            lines.extend(fam.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-able snapshot (the /-path status sidecar)."""
        return {fam.name: fam.snapshot() for fam in self.families()}
