"""Export sinks: where instruments and spans leave the process.

A copy of the JAX package's ``obs/sinks.py``, which imports
nothing of JAX (the port never imports that package).

Three, per the subsystem contract:

- :class:`JsonlSink` — appends span/metric records to the run's existing
  ``metrics.jsonl`` through :class:`~..metrics.jsonl.MetricsWriter`, so
  one stream still tells the whole story. Purely additive: old keys keep
  their bytes; span records are new lines with a ``"span"`` key that
  ``dlcfn-tpu metrics`` and the bench harness already ignore.
- :func:`write_prometheus` — renders a :class:`MetricsRegistry` snapshot
  in Prometheus text exposition format (version 0.0.4) to a file,
  atomically (tmp + rename), for scrape-by-file setups (node_exporter
  textfile collector — no server dependency, same as the rest of the
  repo's no-new-deps posture).
- :class:`MemorySink` — a list, for tests.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

from .metrics import Counter, Gauge, Histogram, MetricsRegistry


class MemorySink:
    """Collects records in memory; tests assert on ``.records``."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def write(self, record: Dict[str, Any]) -> None:
        self.records.append(dict(record))

    def by_span(self, name: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("span") == name]


class JsonlSink:
    """Adapts a MetricsWriter (or anything with ``write(dict)``) as a span
    sink. ``also_stdout`` should stay False for span streams — spans are
    high-rate and the stdout stream is the human one."""

    def __init__(self, writer):
        self._writer = writer

    def write(self, record: Dict[str, Any]) -> None:
        self._writer.write(record)

    def close(self) -> None:
        close = getattr(self._writer, "close", None)
        if close is not None:
            close()


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch in "_:") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _prom_labels(key) -> str:
    if not key:
        return ""
    inner = ",".join(
        '%s="%s"' % (_prom_name(k), str(v).replace("\\", "\\\\")
                     .replace('"', '\\"').replace("\n", "\\n"))
        for k, v in key
    )
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(registry: MetricsRegistry) -> str:
    """Registry → Prometheus text exposition format (one snapshot)."""
    lines: List[str] = []
    for inst in registry.instruments():
        name = _prom_name(inst.name)
        if inst.help:
            lines.append(f"# HELP {name} {inst.help}")
        lines.append(f"# TYPE {name} {inst.kind}")
        if isinstance(inst, (Counter, Gauge)):
            for key, v in sorted(inst.series().items()):
                lines.append(f"{name}{_prom_labels(key)} {_prom_num(v)}")
        elif isinstance(inst, Histogram):
            for key, s in sorted(inst.series().items()):
                cum = 0
                for b, c in zip(inst.buckets, s.bucket_counts):
                    cum += c
                    le = _prom_labels(key + (("le", _prom_num(b)),))
                    lines.append(f"{name}_bucket{le} {cum}")
                cum += s.bucket_counts[-1]
                le = _prom_labels(key + (("le", "+Inf"),))
                lines.append(f"{name}_bucket{le} {cum}")
                lines.append(f"{name}_sum{_prom_labels(key)} "
                             f"{_prom_num(s.total)}")
                lines.append(f"{name}_count{_prom_labels(key)} {s.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(registry: MetricsRegistry, path: str) -> str:
    """Atomic snapshot write (tmp + rename — a scraper never sees a torn
    file). Returns the rendered text."""
    text = render_prometheus(registry)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return text
