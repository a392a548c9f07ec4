"""Sweep checkpoint and resume.

Mining keeps no state beyond the current job, so the one thing worth
saving is search progress: how far a job's sweep has come, so that a
restarted miner resumes instead of hashing a prefix of the space again.
The file is a small JSON map keyed by the job's work identity
(``Job.sweep_key``: bare Stratum job ids are per-connection counters),
written by atomic rename and read at best effort: a missing or corrupt
file means a fresh sweep. The format is the JAX package's, so either
package resumes from the other's file.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional


class SweepCheckpoint:
    """Persists {job_key: resume index} to ``path``, for the most recent
    ``max_entries`` job keys (insertion order), so a session that sees a
    new job every block cannot grow the file without bound."""

    #: The meaning of the stored indices: format 2 is one linear index over
    #: (ntime offset, version variant, extranonce2 stride). A file of
    #: another format is discarded: a fresh sweep mines again, never skips.
    FORMAT = 2

    def __init__(self, path: str, max_entries: int = 16) -> None:
        self.path = path
        self.max_entries = max_entries
        self._state: dict = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                state = json.load(f)
            if (isinstance(state, dict)
                    and state.get("format") == self.FORMAT
                    and isinstance(state.get("jobs"), dict)):
                self._state = state["jobs"]
        except (OSError, json.JSONDecodeError):
            self._state = {}

    def save(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"format": self.FORMAT, "jobs": self._state}, f)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get_resume_index(self, job_key: str) -> Optional[int]:
        v = self._state.get(job_key)
        return int(v) if isinstance(v, (int, float)) else None

    def set_progress(self, job_key: str, next_extranonce2_index: int) -> None:
        # Re-inserted so the key is the most recent; the oldest beyond the
        # cap are evicted.
        self._state.pop(job_key, None)
        self._state[job_key] = int(next_extranonce2_index)
        while len(self._state) > self.max_entries:
            self._state.pop(next(iter(self._state)))

    def clear(self, job_key: str) -> None:
        self._state.pop(job_key, None)

    def clear_all(self) -> None:
        """Drop every position: at a session boundary the job ids and
        extranonce1 they were recorded under no longer hold."""
        self._state.clear()
