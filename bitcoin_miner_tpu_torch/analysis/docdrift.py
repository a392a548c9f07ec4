"""metric-doc-drift: ARCHITECTURE.md ↔ the telemetry vocabulary.

Counterpart of ``bitcoin_miner_tpu/analysis/docdrift.py``, reading the
port's vocabulary, whose families are the reference's name for name.
Stale metric alias docs were once removed BY HAND, which is exactly once
more than a machine should have allowed. This project rule re-reads
ARCHITECTURE.md's observability tables on every lint:

- every ``tpu_miner_*`` name a table row mentions must exist in the
  declared vocabulary (telemetry/vocabulary.py) — docs can't advertise
  a series the code doesn't export;
- every registry family in the vocabulary must appear in some table row
  — the code can't grow a series the docs (and the people who write
  health rules from them) never hear about.

The one placeholder row ``tpu_miner_<stat>_total`` (the legacy
MinerStats counters ``utils/status.py`` renders) is expanded from the
vocabulary's ``STATUS_SNAPSHOT_COUNTERS`` so nine near-identical rows
don't bloat the table.
"""

from __future__ import annotations

import os
import re
from typing import List, Set

from .engine import Finding, register_project

_METRIC_TOKEN_RE = re.compile(r"tpu_miner_[a-z0-9_]+")
_PLACEHOLDER = "tpu_miner_<stat>_total"


def _table_lines(text: str) -> List[tuple]:
    """(lineno, line) for markdown table rows only — prose mentions of a
    metric are narrative, not contract. Rows inside the "Static
    analysis" section are ALSO excluded: its rule table documents the
    lint rules (and names the `tpu_miner_<stat>_total` placeholder as a
    concept), and letting it count would permanently satisfy the very
    placeholder-presence check it describes."""
    out = []
    in_static_analysis = False
    section_level = 0
    in_fence = False
    for i, line in enumerate(text.splitlines(), start=1):
        if line.lstrip().startswith("```"):
            in_fence = not in_fence
            continue
        if in_fence:
            # Code blocks are examples: a `# comment` is not a heading
            # and a `| ...` line is not a documentation table row.
            continue
        if line.startswith("#"):
            level = len(line) - len(line.lstrip("#"))
            if in_static_analysis and level > section_level:
                continue  # a SUB-heading stays inside the excluded
                # section; only a peer/parent heading can end it
            in_static_analysis = "static analysis" in line.lower()
            if in_static_analysis:
                section_level = level
            continue
        if not in_static_analysis and line.lstrip().startswith("|"):
            out.append((i, line))
    return out


@register_project(
    "metric-doc-drift",
    "ARCHITECTURE.md observability tables out of sync with the "
    "telemetry vocabulary",
    origin="stale alias rows removed by hand",
)
def check_doc_drift(root: str) -> List[Finding]:
    doc_path = os.path.join(root, "ARCHITECTURE.md")
    if not os.path.exists(doc_path):
        return []  # not a repo checkout (installed package): nothing to
        # compare against
    try:
        from ..telemetry.vocabulary import (
            STATUS_SNAPSHOT_COUNTERS,
            all_metric_names,
            documented_names,
        )
    except Exception:  # pragma: no cover — vocabulary itself broken
        return [Finding(
            rule="metric-doc-drift", path="ARCHITECTURE.md", line=1,
            col=1, message="telemetry vocabulary is unimportable — fix "
                           "telemetry/vocabulary.py first",
        )]
    with open(doc_path, "r", encoding="utf-8") as fh:
        text = fh.read()
    known: Set[str] = set(all_metric_names())
    findings: List[Finding] = []
    documented: Set[str] = set()
    saw_placeholder = False
    for lineno, line in _table_lines(text):
        if _PLACEHOLDER in line:
            saw_placeholder = True
            documented.update(
                f"tpu_miner_{stat}_total"
                for stat in STATUS_SNAPSHOT_COUNTERS
            )
        for token in _METRIC_TOKEN_RE.findall(line):
            documented.add(token)
            if token not in known:
                findings.append(Finding(
                    rule="metric-doc-drift", path="ARCHITECTURE.md",
                    line=lineno, col=line.index(token) + 1,
                    message=f"documented metric `{token}` is not in the "
                            "telemetry vocabulary "
                            "(telemetry/vocabulary.py) — stale docs, a "
                            "typo, or an undeclared series",
                ))
    for name in sorted(documented_names() - documented):
        findings.append(Finding(
            rule="metric-doc-drift", path="ARCHITECTURE.md", line=1,
            col=1,
            message=f"vocabulary metric `{name}` appears in no "
                    "observability table row — document it in "
                    "ARCHITECTURE.md (metric → meaning → layer)",
        ))
    if not saw_placeholder and not any(
        f"tpu_miner_{stat}_total" in documented
        for stat in STATUS_SNAPSHOT_COUNTERS
    ):
        findings.append(Finding(
            rule="metric-doc-drift", path="ARCHITECTURE.md", line=1,
            col=1,
            message="the legacy MinerStats counter families "
                    "(`tpu_miner_<stat>_total`) are no longer "
                    "documented — restore the placeholder row or the "
                    "expanded rows",
        ))
    return findings
