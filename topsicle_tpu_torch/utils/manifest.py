"""Restartable-run manifest.

The reference's de-facto resume story: the CSV is appended in real time
under a lock (partial results survive a kill, README.md:155) and the
step-1 subset FASTQ is reused on rerun (main.py:65-66).  Both behaviors
are kept; on top of them the manifest records each completed
(input file, telophrase) unit so an interrupted multi-file / multi-k run
can restart at file granularity instead of recomputing everything
(SURVEY.md §5 "restartable at batch granularity").
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple


class RunManifest:
    FILENAME = ".topsicle_manifest.json"

    def __init__(self, output_dir: str):
        self.path = os.path.join(output_dir, self.FILENAME)
        # unit key -> {"n": row count, "trcs": [full-precision floats]}
        # (older manifests stored a bare int; still readable)
        self._done: Dict[str, dict] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as fh:
                    data = json.load(fh)
                raw = dict(data.get("completed", {}))
                self._done = {
                    k: (v if isinstance(v, dict) else {"n": int(v)})
                    for k, v in raw.items()
                }
            except (json.JSONDecodeError, OSError):
                self._done = {}

    @staticmethod
    def _key(path: str, phrase: int) -> str:
        return f"{os.path.abspath(path)}::{phrase}"

    def is_done(self, path: str, phrase: int) -> bool:
        return self._key(path, phrase) in self._done

    def rows_for(self, path: str, phrase: int) -> Optional[int]:
        entry = self._done.get(self._key(path, phrase))
        return None if entry is None else entry.get("n")

    def trcs_for(self, path: str, phrase: int) -> Optional[List[float]]:
        """Full-precision TRCs of a completed unit, in row order — the
        CSV only carries 3 decimals, but the quadratic fit consumes full
        precision, so resume must recover it to reproduce an
        uninterrupted run's aggregates exactly."""
        entry = self._done.get(self._key(path, phrase))
        if entry is None or "trcs" not in entry:
            return None
        return [float(x) for x in entry["trcs"]]

    def mark_done(self, path: str, phrase: int, n_rows: int,
                  trcs: Optional[List[float]] = None) -> None:
        entry: dict = {"n": int(n_rows)}
        if trcs is not None:
            entry["trcs"] = [repr(float(t)) for t in trcs]
        self._done[self._key(path, phrase)] = entry
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"completed": self._done}, fh, indent=0)
        os.replace(tmp, self.path)

    def reset(self) -> None:
        self._done = {}
        if os.path.exists(self.path):
            os.remove(self.path)
