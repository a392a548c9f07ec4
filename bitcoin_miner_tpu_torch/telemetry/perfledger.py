"""Perf ledger: the one place performance evidence goes.

Counterpart of ``bitcoin_miner_tpu/telemetry/perfledger.py``, the same
schema, loader, keys and gates, so a ledger of either package loads in
the other:

- **Schema** ``tpu-miner-perfledger/1``: one append-only JSONL file. A
  row is any evidence shape (sweeps, probes, the CPU proxy microbench,
  incident rows); the loader VALIDATES but never mutates, so a row loaded
  and written again is the same line. New rows carry ``schema``, a
  unique ``id``, an environment ``fingerprint`` (:func:`env_fingerprint`:
  here the torch build, its CUDA version and the card's name and power
  limit) and ``artifacts`` pointers to the files beside the number.
- **Like-for-like grouping**: :meth:`LedgerRow.key` digests the fields
  that make two rows the *same experiment*: metric, sub-benchmark,
  backend, unit, kernel geometry (normalized with the same defaults),
  scheduler. Gates only ever compare rows with equal keys.
- **Noise-banded gates**: :func:`gate_rows` compares best-of-N of the
  current run against best-of-N of the baseline series, with a relative
  band from the baseline's median absolute deviation (MAD): a noisy
  baseline widens its own band, a quiet one tightens it.
  ``higher_better`` comes from the row's unit (MH/s up, seconds down).

The file is plain JSONL: ``grep``-able, diff-able, append-only (a crashed
writer can at worst truncate its own last line, which the loader reports
by line number) and mergeable with ``cat``.
"""

from __future__ import annotations

import json
import os
import secrets
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import (
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    TextIO,
    Tuple,
    Union,
)

SCHEMA = "tpu-miner-perfledger/1"

#: Kernel-geometry knobs that make two rows different experiments. The
#: same vocabulary the reference's tune.py sweeps and bench.py labels;
#: ``kernel``/``bench`` cover llo_probe and proxy-microbench sub-cases.
GEOMETRY_KEYS = (
    "backend", "batch_bits", "inner_bits", "sublanes", "inner_tiles",
    "interleave", "vshare", "unroll", "spec", "kernel", "bench",
    "scheduler", "word7", "variant", "cgroup",
    # ``compiler`` separates the frontier autotuner's AOT-schedule rows
    # from stub-model rows (frontier.py labels every row): a model smoke
    # must never enter the same trajectory/gate series as a real
    # compile. Absent on every other metric → None both sides, no-op.
    "compiler",
    # ``sessions`` separates frontend_load rows by scale: a
    # 100-session row and a 10k-session row are different experiments —
    # the whole point of the sweep is locating the knee between them.
    # Absent on every other metric → None both sides, no-op.
    "sessions",
    # ``topology`` separates mesh-native rows by the device layout that
    # produced them: a 1x4 whole-slice mesh and a fanout-3
    # degradation ladder are different machines, not one series.
    # Absent on every other metric → None both sides, no-op.
    "topology",
)

#: Absent-knob defaults, as the reference's tune.py has them: a row
#: written before a knob existed must group with a new row that spells
#: the default out, or history silently stops matching. ``cgroup``'s
#: legacy default is VARIANT-DERIVED (see :meth:`LedgerRow.geometry`),
#: not a constant — the 0 here is the "derive it" sentinel.
_KEY_DEFAULTS = {"interleave": 1, "vshare": 1, "spec": True,
                 "variant": "baseline", "cgroup": 0}

#: Kernel variants whose variant-derived chain-pass size is 1 (the tile
#: kernel's default chain passes, ``ops/sha256_tile.py``): wsplit's split
#: passes plus the staged family.
PER_CHAIN_PASS_VARIANTS = frozenset(
    {"wsplit", "wstage", "vroll", "vroll-db"})

#: unit → is a larger value better? Units outside this map are not
#: gateable (diagnostic rows: fusion counts, cycle estimates, booleans).
_HIGHER_BETTER = {
    "MH/s": True, "GH/s": True, "H/s": True, "ops/s": True,
    "s": False, "seconds": False, "ms": False,
}


class LedgerError(ValueError):
    """A row (or file) failed ledger validation."""


# ------------------------------------------------------------------ rows
@dataclass(frozen=True)
class LedgerRow:
    """One evidence row: the raw dict, validated, plus typed accessors.

    The raw dict is kept verbatim — the ledger's promise is that loading
    and re-serializing a row is the identity, so historical evidence
    files ingest without rewriting."""

    raw: Dict = field(repr=False)

    @property
    def metric(self) -> str:
        return self.raw["metric"]

    @property
    def row_id(self) -> Optional[str]:
        return self.raw.get("id")

    @property
    def value(self) -> Optional[float]:
        v = self.raw.get("value")
        return float(v) if isinstance(v, (int, float)) else None

    @property
    def unit(self) -> Optional[str]:
        return self.raw.get("unit")

    @property
    def backend(self) -> Optional[str]:
        return self.raw.get("backend")

    @property
    def measured(self) -> Optional[str]:
        return self.raw.get("measured")

    @property
    def fingerprint(self) -> Dict:
        fp = self.raw.get("fingerprint")
        return fp if isinstance(fp, dict) else {}

    @property
    def artifacts(self) -> Dict:
        art = self.raw.get("artifacts")
        return art if isinstance(art, dict) else {}

    @property
    def higher_better(self) -> Optional[bool]:
        """True/False per the row's unit; None = not gateable."""
        return _HIGHER_BETTER.get(self.unit or "")

    def geometry(self) -> Dict:
        """The experiment-identity knobs, normalized. New rows may nest
        them under ``config``; historical rows carry them at top level —
        both are read, top level winning (it is what actually ran)."""
        config = self.raw.get("config")
        merged: Dict = dict(config) if isinstance(config, dict) else {}
        for k in GEOMETRY_KEYS:
            if k in self.raw:
                merged[k] = self.raw[k]
        norm = {k: merged.get(k) for k in GEOMETRY_KEYS}
        for k, default in _KEY_DEFAULTS.items():
            if norm[k] is None:
                norm[k] = default
        # cgroup's legacy default is the chain-pass size that PHYSICALLY
        # ran before the knob existed (ops.sha256_pallas._cgroup_size):
        # one chain per pass for wsplit and the staged family, all
        # vshare chains interleaved otherwise. Deriving it — rather
        # than pinning a constant — makes an explicit row that spells
        # that same size out group WITH its pre-cgroup history, not
        # beside it.
        if not norm["cgroup"]:
            norm["cgroup"] = (1 if norm["variant"] in
                              PER_CHAIN_PASS_VARIANTS
                              else norm["vshare"])
        return norm

    def key(self) -> str:
        """Like-for-like identity: rows with equal keys are repeats of
        one experiment and may be compared/gated against each other.
        Environment fields (host, library versions) are deliberately NOT
        part of the key — the gate reports them so a cross-environment
        comparison is visible, but a rebuilt environment must not orphan
        the entire history."""
        ident = {"metric": self.metric, "unit": self.unit}
        ident.update(self.geometry())
        return json.dumps(ident, sort_keys=True)


def validate_row(raw: object) -> LedgerRow:
    """Validate one raw row; raises :class:`LedgerError`."""
    if not isinstance(raw, dict):
        raise LedgerError(f"row must be a JSON object, got {type(raw).__name__}")
    metric = raw.get("metric")
    if not isinstance(metric, str) or not metric:
        raise LedgerError(f"row needs a non-empty 'metric' string: {raw!r:.200}")
    value = raw.get("value")
    if value is not None and not isinstance(value, (int, float)):
        raise LedgerError(f"'value' must be numeric, got {value!r}")
    if isinstance(value, bool):
        raise LedgerError("'value' must be numeric, got a bool")
    for key in ("unit", "backend", "measured", "schema", "id"):
        v = raw.get(key)
        if v is not None and not isinstance(v, str):
            raise LedgerError(f"{key!r} must be a string, got {v!r}")
    schema = raw.get("schema")
    if schema is not None and schema != SCHEMA:
        raise LedgerError(f"unsupported row schema {schema!r} (loader "
                          f"understands {SCHEMA})")
    for key in ("fingerprint", "artifacts", "config"):
        v = raw.get(key)
        if v is not None and not isinstance(v, dict):
            raise LedgerError(f"{key!r} must be an object, got {v!r}")
    return LedgerRow(raw)


def load_rows(
    source: "Union[str, os.PathLike, TextIO]",
) -> List[LedgerRow]:
    """Read one JSONL evidence source (a path, or an open text stream —
    ``perf record --from -`` passes stdin) through validation. Blank
    lines are skipped; anything else that fails to parse or validate
    raises :class:`LedgerError` with the source/line position — a
    corrupt ledger should fail loudly at ingest, not silently skew a
    baseline."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, encoding="utf-8") as fh:
            return load_rows(fh)
    name = getattr(source, "name", "<stream>")
    rows: List[LedgerRow] = []
    for lineno, line in enumerate(source, 1):
        line = line.strip()
        if not line:
            continue
        try:
            raw = json.loads(line)
        except json.JSONDecodeError as e:
            raise LedgerError(f"{name}:{lineno}: not JSON: {e}") from None
        try:
            rows.append(validate_row(raw))
        except LedgerError as e:
            raise LedgerError(f"{name}:{lineno}: {e}") from None
    return rows


# ----------------------------------------------------------- fingerprint
def _git_rev() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def _card() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them;
    None without ``nvidia-smi`` or a card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _torch_build() -> Tuple[Optional[str], Optional[str]]:
    """torch's version and the CUDA version it was built for, without
    importing torch: from the loaded module where this process has one,
    else from the installed ``torch/version.py``. Host tooling that
    stamps rows (``perf record``, the load probe) never loads torch."""
    torch = sys.modules.get("torch")
    if torch is not None:
        return str(torch.__version__), torch.version.cuda
    import ast
    import importlib.util

    spec = importlib.util.find_spec("torch")
    if spec is None or not spec.submodule_search_locations:
        return None, None
    facts: Dict = {}
    path = os.path.join(list(spec.submodule_search_locations)[0],
                        "version.py")
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return None, None
    for node in tree.body:
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  else node.target if isinstance(node, ast.AnnAssign)
                  else None)
        if isinstance(target, ast.Name) and isinstance(node.value,
                                                       ast.Constant):
            facts[target.id] = node.value.value
    return facts.get("__version__"), facts.get("cuda")


def env_fingerprint(platform: Optional[str] = None) -> Dict:
    """The environment a measurement ran under: enough to decide later
    whether two numbers are comparable and, when they aren't, why.

    It records this package's platform: the torch build and the CUDA
    version it was built for, and the card's name and power limit (a
    card set below its maximum power runs slower under load). It records
    no JAX or TPU library, so a TPU row of the reference never shares a
    fingerprint with a card row. ``platform`` is declared by the caller,
    who knows what it ran on; by default ``cuda`` where torch sees a
    card (a process without torch loaded: where the build has CUDA and
    ``nvidia-smi`` names a card), else ``cpu``. It never imports torch.
    The reference's relay probe has no counterpart: this package has no
    relay."""
    import platform as platform_mod
    import socket

    version, cuda = _torch_build()
    card = _card()
    if platform is None:
        torch = sys.modules.get("torch")
        on_card = (torch.cuda.is_available() if torch is not None
                   else cuda is not None and card is not None)
        platform = "cuda" if on_card else "cpu"
    fp: Dict = {
        "python": platform_mod.python_version(),
        "torch": version,
        "cuda": cuda,
        "card": card,
        "platform": platform,
        "host": socket.gethostname(),
        "git_rev": _git_rev(),
    }
    return {k: v for k, v in fp.items() if v is not None}


def new_row_id() -> str:
    """Unique, sortable row id: UTC second + random suffix."""
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    return f"pl-{stamp}-{secrets.token_hex(3)}"


#: fields the ledger stamps onto a row at append time — stripped when
#: comparing CONTENT for duplicate detection, so the same physical
#: measurement arriving twice (battery appends live, then the evidence
#: file is ingested wholesale) is recognized even though each copy got
#: its own id/fingerprint.
_STAMPED_FIELDS = frozenset({"schema", "id", "fingerprint", "artifacts",
                             "rc"})


def content_key(raw: Dict) -> str:
    """The measurement's identity independent of ledger stamping."""
    return json.dumps(
        {k: v for k, v in raw.items() if k not in _STAMPED_FIELDS},
        sort_keys=True,
    )


# ----------------------------------------------------------------- stats
def median(values: Sequence[float]) -> float:
    if not values:
        raise ValueError("median of empty series")
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def mad(values: Sequence[float], center: Optional[float] = None) -> float:
    """Median absolute deviation — the robust spread estimator the noise
    band is built from (one outlier repeat cannot blow the band open the
    way a standard deviation would let it)."""
    c = median(values) if center is None else center
    return median([abs(v - c) for v in values])


def noise_band(
    baseline: Sequence[float], rel_floor: float = 0.05, mad_k: float = 4.0,
) -> float:
    """Relative regression tolerance for a baseline series: at least
    ``rel_floor``, widened to ``mad_k`` MADs of the series when the
    baseline itself is noisy. With a single baseline row the MAD is 0 and
    the floor alone governs."""
    center = median(baseline)
    if center == 0:
        return rel_floor
    return max(rel_floor, mad_k * mad(baseline, center) / abs(center))


@dataclass
class GateCheck:
    """One like-for-like comparison's verdict."""

    key: str
    status: str  # "ok" | "fail" | "no_baseline"
    current_best: float
    baseline_best: Optional[float] = None
    regression: Optional[float] = None  # fractional; positive = worse
    band: Optional[float] = None
    n_current: int = 0
    n_baseline: int = 0
    reason: str = ""

    def as_dict(self) -> Dict:
        out = {"key": json.loads(self.key), "status": self.status,
               "current_best": self.current_best,
               "n_current": self.n_current, "n_baseline": self.n_baseline}
        if self.baseline_best is not None:
            out["baseline_best"] = self.baseline_best
        if self.regression is not None:
            out["regression"] = round(self.regression, 4)
        if self.band is not None:
            out["band"] = round(self.band, 4)
        if self.reason:
            out["reason"] = self.reason
        return out


def _row_value(row: LedgerRow) -> float:
    """The row's numeric value, typed non-optional — only valid on
    rows that came through :func:`group_by_key` (which filters the
    valueless)."""
    v = row.value
    if v is None:  # pragma: no cover — group_by_key filtered these
        raise LedgerError(f"row {row.row_id!r} has no value")
    return v


def group_by_key(rows: Iterable[LedgerRow]) -> Dict[str, List[LedgerRow]]:
    """Gateable rows (numeric value + oriented unit) by like-for-like
    key. Rows carrying an ``error`` field are evidence of a FAILED run
    (bench.py emits ``value: 0.0`` + error on pool-down/fallback) —
    they stay in the ledger as history but must not enter trajectories
    or gates: one dead-pool window would otherwise read as a 100%
    regression of the headline experiment."""
    groups: Dict[str, List[LedgerRow]] = {}
    for row in rows:
        if row.value is None or row.higher_better is None:
            continue
        if row.raw.get("error"):
            continue
        groups.setdefault(row.key(), []).append(row)
    return groups


def gate_rows(
    current: Iterable[LedgerRow],
    baseline: Iterable[LedgerRow],
    rel_floor: float = 0.05,
    mad_k: float = 4.0,
) -> List[GateCheck]:
    """Compare the current run's rows against the baseline series,
    like-for-like keys only. Per key: best-of-N both sides (max for
    higher-better units, min for lower-better), relative regression of
    current-best vs baseline-best, failed iff it exceeds the baseline's
    noise band. Keys with no baseline pass with ``no_baseline`` — a new
    experiment cannot regress, and the gate must not punish adding
    coverage."""
    cur_groups = group_by_key(current)
    base_groups = group_by_key(baseline)
    checks: List[GateCheck] = []
    for key in sorted(cur_groups):
        cur_rows = cur_groups[key]
        higher = cur_rows[0].higher_better
        cur_vals = [_row_value(r) for r in cur_rows]
        cur_best = max(cur_vals) if higher else min(cur_vals)
        base_rows = base_groups.get(key, [])
        # The same physical row may sit in both files (a run ledger
        # seeded from the baseline): identical ids are not independent
        # evidence, so they don't count as baseline for themselves.
        cur_ids = {r.row_id for r in cur_rows if r.row_id}
        base_rows = [r for r in base_rows
                     if not (r.row_id and r.row_id in cur_ids)]
        if not base_rows:
            checks.append(GateCheck(
                key=key, status="no_baseline", current_best=cur_best,
                n_current=len(cur_vals),
                reason="no like-for-like baseline rows",
            ))
            continue
        base_vals = [_row_value(r) for r in base_rows]
        base_best = max(base_vals) if higher else min(base_vals)
        if base_best == 0:
            regression = 0.0
        elif higher:
            regression = (base_best - cur_best) / abs(base_best)
        else:
            regression = (cur_best - base_best) / abs(base_best)
        band = noise_band(base_vals, rel_floor=rel_floor, mad_k=mad_k)
        failed = regression > band
        checks.append(GateCheck(
            key=key, status="fail" if failed else "ok",
            current_best=cur_best, baseline_best=base_best,
            regression=regression, band=band,
            n_current=len(cur_vals), n_baseline=len(base_vals),
            reason=(f"best-of-{len(cur_vals)} regressed "
                    f"{regression:.1%} vs best-of-{len(base_vals)} "
                    f"baseline (band {band:.1%})" if failed else ""),
        ))
    return checks


def gate_report(checks: Sequence[GateCheck]) -> Dict:
    """The machine-readable gate outcome (``tpu-miner perf gate --json``)."""
    worst = "ok"
    if any(c.status == "fail" for c in checks):
        worst = "fail"
    return {
        "schema": "tpu-miner-perfgate/1",
        "status": worst,
        "checked": len(checks),
        "failed": sum(1 for c in checks if c.status == "fail"),
        "no_baseline": sum(1 for c in checks if c.status == "no_baseline"),
        "checks": [c.as_dict() for c in checks],
    }


# ---------------------------------------------------------------- ledger
class PerfLedger:
    """Append-only JSONL ledger at ``path``.

    ``append`` stamps schema/id/measured/fingerprint onto rows that lack
    them and validates before writing — the ledger can only ever hold
    loadable rows. Appends are line-buffered single ``write`` calls
    under a lock, so concurrent writers within one process interleave at
    line granularity (POSIX O_APPEND covers cross-process appends, the
    when_up.sh battery's case)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()

    def load(self) -> List[LedgerRow]:
        if not os.path.exists(self.path):
            return []
        return load_rows(self.path)

    def append(
        self,
        raw: Dict,
        fingerprint: Optional[Dict] = None,
        artifacts: Optional[Dict] = None,
        row_id: Optional[str] = None,
    ) -> LedgerRow:
        row = dict(raw)
        row.setdefault("schema", SCHEMA)
        if row_id is not None:
            row["id"] = row_id
        row.setdefault("id", new_row_id())
        row.setdefault("measured", time.strftime(
            "%Y-%m-%dT%H:%MZ", time.gmtime()))
        if fingerprint:
            row.setdefault("fingerprint", fingerprint)
        if artifacts:
            row.setdefault("artifacts", artifacts)
        validated = validate_row(row)
        line = json.dumps(row) + "\n"
        with self._lock:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(line)
        return validated

    def append_many(
        self, raws: Iterable[Dict], fingerprint: Optional[Dict] = None,
    ) -> List[LedgerRow]:
        return [self.append(raw, fingerprint=fingerprint) for raw in raws]


def trajectory(rows: Iterable[LedgerRow]) -> List[Dict]:
    """Per-key series summary (``tpu-miner perf report``): the bench
    trajectory the feature loop never had — count, best, median, latest,
    and when each endpoint was measured."""
    out: List[Dict] = []
    for key, group in sorted(group_by_key(rows).items()):
        higher = group[0].higher_better
        vals = [_row_value(r) for r in group]
        best_row = (max if higher else min)(group, key=_row_value)
        latest = max(group, key=lambda r: r.measured or "")
        out.append({
            "key": json.loads(key),
            "n": len(vals),
            "best": best_row.value,
            "best_measured": best_row.measured,
            "median": median(vals),
            "latest": latest.value,
            "latest_measured": latest.measured,
        })
    return out


def format_report(
    summary: List[Dict], file: Optional[TextIO] = None,
) -> None:
    """Human-readable trajectory table."""
    file = file or sys.stdout
    print("| metric | config | n | best | median | latest |", file=file)
    print("|---|---|---|---|---|---|", file=file)
    for entry in summary:
        key = entry["key"]
        # A derived-default cgroup (see LedgerRow.geometry) is not an
        # experiment knob worth a label column — hide it unless swept.
        derived_g = (1 if key.get("variant") in PER_CHAIN_PASS_VARIANTS
                     else key.get("vshare"))
        knobs = {k: v for k, v in key.items()
                 if k not in ("metric", "unit", "backend")
                 and v not in (None, _KEY_DEFAULTS.get(k))
                 and not (k == "cgroup" and v == derived_g)}
        label = f"{key.get('backend') or '?'} {knobs}" if knobs \
            else (key.get("backend") or "?")
        unit = key.get("unit") or ""
        print(f"| {key['metric']} | {label} | {entry['n']} "
              f"| {entry['best']:g} {unit} ({entry['best_measured'] or '?'}) "
              f"| {entry['median']:g} | {entry['latest']:g} "
              f"({entry['latest_measured'] or '?'}) |", file=file)
