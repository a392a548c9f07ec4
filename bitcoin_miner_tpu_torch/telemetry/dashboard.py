"""The ``top`` subcommand: a live fleet dashboard.

Counterpart of ``bitcoin_miner_tpu/telemetry/dashboard.py``. One terminal
pane over the fleet, rendered from one ``/query`` range query against
the process's embedded time-series store (:mod:`.tsdb`): per-process
frontend sessions and shares/s, per-child fleet state and hashes,
per-slot SLO burn and accept rate, pool acks/s, each with a sparkline of
its recent history. :func:`render_top` is a pure function of the
validated ``tpu-miner-query/1`` payload, so tests render without a
terminal or an HTTP server.

One divergence from the reference: the fleet panel names a child's state
from :data:`~.pipeline.FLEET_CHILD_LEVELS`, the values the supervisor
sets (probing 2, quarantined 3); the reference's table has those two
swapped.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

from .pipeline import FLEET_CHILD_LEVELS
from .tsdb import QueryError, parse_query_payload

#: eight-level bar glyphs, lowest to highest.
SPARK_GLYPHS = "▁▂▃▄▅▆▇█"

#: series the dashboard panels read (the names RegistrySampler /
#: ScrapeFederator store them under — rendered exposition names — plus
#: the Observatory's default recording rules).
_SESSIONS = "tpu_miner_frontend_sessions"
_SHARES_RATE = "tpu_miner_frontend_shares_per_s"
_ACKS_RATE = "tpu_miner_pool_acks_per_s"
_FLEET_STATE = "tpu_miner_fleet_child_state"
_HASHES = "tpu_miner_hashes_total"
_SLOT_BURN = "tpu_miner_slo_slot_burn"
_SLOT_ACCEPT = "slo.slot_accept"

_FLEET_STATE_NAMES = {
    level: state for state, level in FLEET_CHILD_LEVELS.items()
}


def sparkline(values: Sequence[float], width: int = 24) -> str:
    """The last ``width`` values as an eight-level bar strip (empty
    input renders empty — never a crash over missing history)."""
    tail = list(values)[-width:]
    if not tail:
        return ""
    lo = min(tail)
    hi = max(tail)
    span = hi - lo
    if span <= 0:
        return SPARK_GLYPHS[0] * len(tail)
    out = []
    for v in tail:
        idx = int((v - lo) / span * (len(SPARK_GLYPHS) - 1))
        out.append(SPARK_GLYPHS[max(0, min(len(SPARK_GLYPHS) - 1, idx))])
    return "".join(out)


def _by_name(
    payload: Dict[str, Any], name: str
) -> List[Dict[str, Any]]:
    return [s for s in payload.get("series", []) if s["name"] == name]


def _values(series: Dict[str, Any]) -> List[float]:
    return [float(p[1]) for p in series.get("points", [])]


def _last(series: Optional[Dict[str, Any]]) -> Optional[float]:
    if series is None or not series.get("points"):
        return None
    return float(series["points"][-1][1])


def _find(
    rows: List[Dict[str, Any]], **labels: str
) -> Optional[Dict[str, Any]]:
    for row in rows:
        if all(row["labels"].get(k) == v for k, v in labels.items()):
            return row
    return None


def _fmt(value: Optional[float], suffix: str = "") -> str:
    if value is None:
        return "-"
    if abs(value) >= 100:
        return f"{value:.0f}{suffix}"
    return f"{value:.2f}{suffix}"


def render_top(
    payload: Dict[str, Any], *, width: int = 24
) -> str:
    """One dashboard frame from a validated ``tpu-miner-query/1``
    payload. Panels render only when their series exist — a single-
    process miner gets a one-panel frame, not a wall of dashes."""
    lines: List[str] = []
    n_series = len(payload.get("series", []))
    stale = sum(1 for s in payload.get("series", []) if s.get("stale"))
    header = (
        f"tpu-miner top — {n_series} series"
        + (f" ({stale} stale)" if stale else "")
    )
    dropped = payload.get("dropped_series", 0)
    if dropped:
        header += f" [{dropped} dropped at the store bound]"
    lines.append(header)

    # --- per-shard / per-process frontend panel
    sessions = _by_name(payload, _SESSIONS)
    share_rates = _by_name(payload, _SHARES_RATE)
    if sessions:
        lines.append("")
        lines.append("frontend (per process):")
        for row in sessions:
            process = row["labels"].get("process", "?")
            rate_row = _find(share_rates, process=process)
            rates = _values(rate_row) if rate_row else []
            mark = " STALE" if row.get("stale") else ""
            lines.append(
                f"  {process:<12} sessions {_fmt(_last(row)):>8}  "
                f"shares/s {_fmt(_last(rate_row)):>8}  "
                f"{sparkline(rates, width)}{mark}"
            )

    # --- fleet children panel
    fleet = _by_name(payload, _FLEET_STATE)
    hashes = _by_name(payload, _HASHES)
    if fleet:
        lines.append("")
        lines.append("fleet children:")
        for row in fleet:
            child = row["labels"].get("child", "?")
            level = _last(row)
            state = _FLEET_STATE_NAMES.get(
                level if level is not None else -1.0,
                _fmt(level),
            )
            hash_row = _find(hashes, process=child) or _find(
                hashes, worker=child
            )
            mark = " STALE" if row.get("stale") else ""
            lines.append(
                f"  {child:<20} {state:<12} "
                f"hashes {_fmt(_last(hash_row)):>12}  "
                f"{sparkline(_values(hash_row) if hash_row else [], width)}"
                f"{mark}"
            )

    # --- pool slots panel
    burns = _by_name(payload, _SLOT_BURN)
    accepts = _by_name(payload, _SLOT_ACCEPT)
    slots = sorted(
        {r["labels"].get("pool", "?") for r in burns}
        | {r["labels"].get("pool", "?") for r in accepts}
    )
    if slots:
        lines.append("")
        lines.append("pool slots:")
        for slot in slots:
            burn_row = _find(burns, pool=slot)
            accept_row = _find(accepts, pool=slot)
            lines.append(
                f"  {slot:<20} burn {_fmt(_last(burn_row), 'x'):>8}  "
                f"accept {_fmt(_last(accept_row)):>6}  "
                f"{sparkline(_values(accept_row) if accept_row else [], width)}"
            )

    # --- acks rate panel (any process)
    ack_rates = _by_name(payload, _ACKS_RATE)
    accepted = [
        r for r in ack_rates if r["labels"].get("result") == "accepted"
    ]
    if accepted:
        lines.append("")
        lines.append("pool acks/s (accepted):")
        for row in accepted:
            process = row["labels"].get("process", "?")
            lines.append(
                f"  {process:<12} {_fmt(_last(row)):>8}  "
                f"{sparkline(_values(row), width)}"
            )

    if len(lines) == 1:
        lines.append("  (no series yet — is the Observatory running?)")
    return "\n".join(lines) + "\n"


def fetch_query(
    status_url: str, window_s: float, timeout: float = 5.0
) -> Dict[str, Any]:
    """GET ``/query`` and validate the document (:class:`QueryError`
    on a malformed body — a broken server dies loudly, not as an
    empty dashboard)."""
    url = (
        status_url.rstrip("/")
        + f"/query?window_s={window_s:g}"
    )
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    return parse_query_payload(payload, source=url)


def top_main(argv: Optional[List[str]] = None) -> int:
    """The ``top`` subcommand: live fleet dashboard over ``/query``."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch top",
        description="live fleet dashboard over the embedded "
                    "time-series store's /query endpoint "
                    "(telemetry/tsdb.py)",
    )
    parser.add_argument(
        "--status-url", default="http://127.0.0.1:18181",
        help="a live --status-port base URL (default %(default)s)",
    )
    parser.add_argument(
        "--window", type=float, default=300.0, metavar="SECONDS",
        help="history window per panel (default %(default)s)",
    )
    parser.add_argument(
        "--interval", type=float, default=2.0, metavar="SECONDS",
        help="refresh interval (default %(default)s)",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="render one frame and exit (no screen clearing) — the "
             "scripting/test mode",
    )
    args = parser.parse_args(argv)
    while True:
        try:
            payload = fetch_query(args.status_url, args.window)
        except QueryError as e:
            print(f"bad /query payload: {e}", file=sys.stderr)
            return 2
        except Exception as e:  # noqa: BLE001 — CLI surface
            print(f"cannot fetch /query: {e}", file=sys.stderr)
            return 2
        frame = render_top(payload)
        if args.once:
            sys.stdout.write(frame)
            return 0
        # ANSI clear + home: a live pane, not a scrolling log.
        sys.stdout.write("\x1b[2J\x1b[H" + frame)
        sys.stdout.flush()
        time.sleep(args.interval)
