"""Typed metric instruments and the registry that owns them.

Three instrument kinds, deliberately the Prometheus trio:

- :class:`Counter` — monotonically non-decreasing (``inc`` rejects negative
  deltas). Lifecycle events: requests admitted, store retries, steps run.
- :class:`Gauge` — a value that goes both ways (``set``/``inc``): queue
  depth, slot occupancy, last retry-after hint.
- :class:`Histogram` — observations bucketed into *fixed exponential
  bounds* for export, **plus** the raw samples, because the repo's
  pre-existing p50/p95 numbers (serve queue wait, TTFT, decode latency)
  are exact :func:`percentile` values over raw series and must stay
  byte-identical after the migration. Buckets serve Prometheus; samples
  serve parity.

Every instrument supports per-instrument labels: call ``labels(k=v)`` to
get a child bound to one label-set; series are keyed by the sorted label
items, so ``labels(op="save")`` and ``labels(op="load")`` are independent
series under one registered name.

The registry is get-or-create (``registry.counter("x")`` twice returns the
same object; re-registering a name as a different kind raises) and
thread-safe, because serve's admission path and the trainer's checkpoint
hook thread both record into it.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank-with-interpolation percentile; None on empty input
    (matching the bench contract's null-over-zero convention)."""
    if not xs:
        return None
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    rank = (len(s) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def exponential_buckets(start: float = 1e-4, factor: float = 2.0,
                        count: int = 20) -> Tuple[float, ...]:
    """Fixed exponential bucket upper bounds: start, start*factor, ...
    The default spans 100µs → ~52s, wide enough for step times and
    checkpoint I/O alike."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out, b = [], start
    for _ in range(count):
        out.append(b)
        b *= factor
    return tuple(out)


DEFAULT_BUCKETS = exponential_buckets()


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared label plumbing. A bound child shares the parent's series
    table; only the bound label-set differs."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", *, lock: threading.Lock,
                 _parent: Optional["_Instrument"] = None,
                 _bound: LabelKey = ()):
        self.name = name
        self.help = help
        self._lock = lock
        self._parent = _parent
        self._bound = _bound

    def labels(self, **labels: str) -> "_Instrument":
        key = _label_key({**dict(self._bound), **labels})
        child = type(self).__new__(type(self))
        _Instrument.__init__(child, self.name, self.help, lock=self._lock,
                             _parent=self._root(), _bound=key)
        return child

    def _root(self) -> "_Instrument":
        return self._parent if self._parent is not None else self


class Counter(_Instrument):
    """Monotonic counter. ``inc(n)`` with n >= 0."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", *, lock: threading.Lock,
                 _parent=None, _bound=()):
        super().__init__(name, help, lock=lock, _parent=_parent,
                         _bound=_bound)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key({**dict(self._bound), **labels})
        root = self._root()
        with self._lock:
            root._values[key] = root._values.get(key, 0.0) + n

    def value(self, **labels: str) -> float:
        key = _label_key({**dict(self._bound), **labels})
        with self._lock:
            return self._root()._values.get(key, 0.0)

    def series(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._root()._values)


class Gauge(_Instrument):
    """Last-write-wins value; inc/dec allowed."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", *, lock: threading.Lock,
                 _parent=None, _bound=()):
        super().__init__(name, help, lock=lock, _parent=_parent,
                         _bound=_bound)
        self._values: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels: str) -> None:
        key = _label_key({**dict(self._bound), **labels})
        with self._lock:
            self._root()._values[key] = float(v)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = _label_key({**dict(self._bound), **labels})
        root = self._root()
        with self._lock:
            root._values[key] = root._values.get(key, 0.0) + n

    def value(self, **labels: str) -> Optional[float]:
        key = _label_key({**dict(self._bound), **labels})
        with self._lock:
            return self._root()._values.get(key)

    def series(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._root()._values)


# Raw-sample retention bound per histogram series: exact percentiles up
# to this many observations; beyond it, uniform reservoir sampling keeps
# memory flat (a multi-day serve run observes unboundedly many latencies).
DEFAULT_MAX_SAMPLES = 8192

# Fixed reservoir seed — sampling must be deterministic across runs, per
# the repo rule that nothing in the metrics path reads wall-clock
# randomness (reproducible runs, assertable tests).
_RESERVOIR_SEED = 0x5EED


class _HistSeries:
    __slots__ = ("bucket_counts", "count", "total", "samples", "rng",
                 "first_ts", "last_ts")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * (n_buckets + 1)  # +1 for +Inf
        self.count = 0
        self.total = 0.0
        self.samples: List[float] = []
        self.rng: Optional[random.Random] = None  # created at first evict
        # Observation window bounds — set only from caller-supplied
        # timestamps (observe(ts=...)); the metrics path itself never
        # reads a clock, per the determinism rule above.
        self.first_ts: Optional[float] = None
        self.last_ts: Optional[float] = None


class Histogram(_Instrument):
    """Observations into fixed exponential buckets + retained raw samples.

    ``keep_samples=False`` drops raw retention for genuinely hot series
    where only the bucketed export matters; percentiles then return None.

    Retention is bounded: the first ``max_samples`` observations are kept
    verbatim (percentiles exact — short runs see identical behavior to
    unbounded retention), after which uniform reservoir sampling
    (Algorithm R, deterministic seed) keeps a fixed-size representative
    subset, so percentiles degrade to an unbiased approximation instead
    of memory growing without bound. ``count``/``sum`` stay exact always.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 keep_samples: bool = True,
                 max_samples: int = DEFAULT_MAX_SAMPLES,
                 lock: threading.Lock,
                 _parent=None, _bound=()):
        super().__init__(name, help, lock=lock, _parent=_parent,
                         _bound=_bound)
        if _parent is None:
            bs = tuple(sorted(float(b) for b in buckets))
            if not bs:
                raise ValueError("histogram needs at least one bucket")
            if max_samples < 1:
                raise ValueError("max_samples must be >= 1")
            self.buckets = bs
            self.keep_samples = keep_samples
            self.max_samples = max_samples
            self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, v: float, ts: Optional[float] = None,
                **labels: str) -> None:
        """Record one observation. ``ts`` (optional, caller-supplied —
        never read from a clock here) stamps the series' observation
        window so windowed percentiles can report how much wall time
        backs them."""
        key = _label_key({**dict(self._bound), **labels})
        root = self._root()
        v = float(v)
        with self._lock:
            s = root._series.get(key)
            if s is None:
                s = root._series[key] = _HistSeries(len(root.buckets))
            if ts is not None:
                ts = float(ts)
                if s.first_ts is None or ts < s.first_ts:
                    s.first_ts = ts
                if s.last_ts is None or ts > s.last_ts:
                    s.last_ts = ts
            i = 0
            for i, b in enumerate(root.buckets):
                if v <= b:
                    break
            else:
                i = len(root.buckets)  # +Inf bucket
            s.bucket_counts[i] += 1
            s.count += 1
            s.total += v
            if root.keep_samples:
                if len(s.samples) < root.max_samples:
                    s.samples.append(v)
                else:
                    if s.rng is None:
                        s.rng = random.Random(_RESERVOIR_SEED)
                    j = s.rng.randrange(s.count)
                    if j < root.max_samples:
                        s.samples[j] = v

    def _get(self, labels: Dict[str, str]) -> Optional[_HistSeries]:
        key = _label_key({**dict(self._bound), **labels})
        return self._root()._series.get(key)

    def count(self, **labels: str) -> int:
        with self._lock:
            s = self._get(labels)
            return s.count if s else 0

    def sum(self, **labels: str) -> float:
        with self._lock:
            s = self._get(labels)
            return s.total if s else 0.0

    def samples(self, **labels: str) -> List[float]:
        """The raw series (copy); empty if keep_samples=False or no data."""
        with self._lock:
            s = self._get(labels)
            return list(s.samples) if s else []

    def percentile(self, q: float, **labels: str) -> Optional[float]:
        """Exact percentile over retained samples — the same math (and so
        the same value) as the pre-registry list-based code paths."""
        return percentile(self.samples(**labels), q)

    def mean(self, **labels: str) -> Optional[float]:
        with self._lock:
            s = self._get(labels)
            if not s or s.count == 0:
                return None
            return s.total / s.count

    def series(self) -> Dict[LabelKey, _HistSeries]:
        with self._lock:
            return dict(self._root()._series)


class MetricsRegistry:
    """Get-or-create home for instruments; one per process is typical
    (``obs.trace.get_tracer().registry``), but tests build their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {inst.kind}")
                return inst
            inst = cls(name, help, lock=threading.Lock(), **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  keep_samples: bool = True,
                  max_samples: int = DEFAULT_MAX_SAMPLES) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets,
                                   keep_samples=keep_samples,
                                   max_samples=max_samples)

    def instruments(self) -> Iterable[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> Dict[str, Dict]:
        """Flat, JSON-able view: {name: {kind, series: {label_str: ...}}}.
        Histogram series carry count/sum/p50/p95 (percentiles None when
        samples are not retained)."""
        out: Dict[str, Dict] = {}
        for inst in self.instruments():
            if isinstance(inst, (Counter, Gauge)):
                series = {_fmt_labels(k): v for k, v in inst.series().items()}
            else:
                series = {}
                for k, s in inst.series().items():
                    series[_fmt_labels(k)] = {
                        "count": s.count,
                        "sum": s.total,
                        "p50": percentile(s.samples, 50),
                        "p95": percentile(s.samples, 95),
                        # Honesty fields: how many raw samples actually
                        # back the percentiles (== count until the
                        # reservoir cap bites) and the observation
                        # window they were taken over (None when the
                        # caller supplied no timestamps).
                        "samples_retained": len(s.samples),
                        "window_start_ts": s.first_ts,
                        "window_end_ts": s.last_ts,
                    }
            out[inst.name] = {"kind": inst.kind, "series": series}
        return out


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    return ",".join(f"{k}={v}" for k, v in key)
