"""Structured JSONL metrics (SURVEY.md §6 "Metrics / logging").

The reference's observability was stdout prints + CloudWatch agent; the
rebuild logs one JSON object per event from process 0 (step, loss,
examples/sec/device — the north-star metric is computed here), flushed line
by line so the launcher and the bench harness can tail it live.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, IO, List, Optional


class MetricsWriter:
    """Append-only JSONL writer. The port runs one process per engine, so
    every writer writes (the JAX package asks ``jax.process_index()`` to
    keep multi-host runs to one stream; ``all_processes`` is kept for the
    same call signature). The file handle is opened lazily on the first
    :meth:`write`.
    """

    def __init__(self, path: Optional[str], also_stdout: bool = True,
                 all_processes: bool = False):
        self._path = path
        self.also_stdout = also_stdout
        self._all_processes = all_processes
        self._enabled = True
        self._fh: Optional[IO[str]] = None
        self._opened = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _file(self) -> Optional[IO[str]]:
        if not self._opened:
            self._opened = True
            if self._path:
                os.makedirs(os.path.dirname(os.path.abspath(self._path)),
                            exist_ok=True)
                self._fh = open(self._path, "a", buffering=1)
        return self._fh

    def write(self, record: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        record = {"ts": time.time(), **record}
        line = json.dumps(record, default=float)
        fh = self._file()
        if fh is not None:
            fh.write(line + "\n")
        if self.also_stdout:
            print(line, file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
