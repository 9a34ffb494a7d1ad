"""Trace specs: WHAT the load generator replays, parsed from the CLI.

``--trace burst`` (or ``burst:requests=12,burst_s=0.2``) names a preset
arrival process plus a request-class mix; :func:`parse_trace_spec` turns
the string into an immutable :class:`TraceSpec`. A spec is a complete,
seedable description of a workload:

- an **arrival process** (``poisson`` | ``burst`` | ``diurnal``, from
  :mod:`.arrivals`) with its rate parameters and a total duration;
- a tuple of **request classes** — each with a prompt length, a
  max-new-tokens decode budget, a sampling weight, an optional per-class
  request **budget** (hard cap on how many of that class are scheduled),
  and optional **prefix-sharing groups** (members of a group share their
  leading prompt tokens, the shape prefix caches feed on);
- a ``max_requests`` cap so bench cost stays bounded no matter the rate.

Presets keep their knobs relative to the bench's own dimensions
(``src_len`` / ``max_new_tokens`` / ``requests``) so ``--smoke`` shrinks
the trace the same way it shrinks everything else. The ``mix=`` key
selects the class mix: ``uniform`` (one class) or ``prefill-heavy`` (the
long-prompt/short-decode adversaries interleaved with short-prompt
latency streams — the same adversarial mix ``fleet/bench.py`` used to
hard-code in ``_prefill_heavy_trace``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .arrivals import bursty_arrivals, diurnal_arrivals, poisson_arrivals

PROCESSES = ("poisson", "burst", "diurnal")
MIXES = ("uniform", "prefill-heavy", "tenants", "prefix-heavy")


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One class of requests in the mix. ``budget`` caps how many of
    this class the schedule may contain (None = unbounded within
    ``max_requests``); ``prefix_groups > 0`` assigns the class's
    requests round-robin into that many groups, each sharing its first
    ``prefix_len`` prompt tokens. ``tenant`` / ``qos_class`` tag every
    request of the class for the fleet's multi-tenant QoS admission —
    None means untagged (the pre-QoS single-tenant default)."""

    name: str
    src_len: int
    max_new_tokens: int
    weight: float = 1.0
    budget: Optional[int] = None
    prefix_groups: int = 0
    prefix_len: int = 0
    tenant: Optional[str] = None
    qos_class: Optional[str] = None

    def __post_init__(self):
        if self.src_len < 1:
            raise ValueError(f"src_len must be >= 1, got {self.src_len}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.budget is not None and self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")
        if self.prefix_groups < 0:
            raise ValueError(
                f"prefix_groups must be >= 0, got {self.prefix_groups}")
        if self.prefix_groups and not (0 < self.prefix_len <= self.src_len):
            raise ValueError(
                f"prefix_len must be in (0, src_len] when prefix_groups "
                f"is set, got {self.prefix_len} (src_len {self.src_len})")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A named, fully-parameterized workload. ``params`` holds the
    arrival-process knobs as a sorted tuple of (key, value) pairs so the
    spec stays hashable and its repr is stable."""

    name: str
    process: str
    duration_s: float
    max_requests: int
    params: Tuple[Tuple[str, float], ...]
    classes: Tuple[RequestClass, ...]

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r} "
                             f"(one of {PROCESSES})")
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s must be > 0, got {self.duration_s}")
        if self.max_requests < 1:
            raise ValueError(
                f"max_requests must be >= 1, got {self.max_requests}")
        if not self.classes:
            raise ValueError("a trace spec needs at least one class")

    def param(self, key: str) -> float:
        return dict(self.params)[key]

    def arrival_times(self, seed=0) -> List[float]:
        """The seeded arrival schedule, capped at ``max_requests``."""
        p = dict(self.params)
        if self.process == "poisson":
            times = poisson_arrivals(p["rate"], self.duration_s, seed)
        elif self.process == "burst":
            times = bursty_arrivals(p["base"], p["rate"],
                                    p["burst_start_s"], p["burst_s"],
                                    self.duration_s, seed)
        else:
            times = diurnal_arrivals(p["trough"], p["peak"],
                                     p["period_s"], self.duration_s, seed)
        return times[:self.max_requests]

    def hot_window(self) -> Tuple[float, float]:
        """The high-rate interval — where burst-window latency
        (``p95_during_burst``) is measured. The whole trace for
        ``poisson``; the burst window for ``burst``; the middle third of
        the first period for ``diurnal``."""
        p = dict(self.params)
        if self.process == "burst":
            return (p["burst_start_s"],
                    p["burst_start_s"] + p["burst_s"])
        if self.process == "diurnal":
            period = min(p["period_s"], self.duration_s)
            return (period / 3.0, 2.0 * period / 3.0)
        return (0.0, self.duration_s)


def _classes_for_mix(mix: str, src_len: int,
                     max_new_tokens: int) -> Tuple[RequestClass, ...]:
    if mix == "prefill-heavy":
        short_len = max(2, src_len // 3)
        return (
            RequestClass("adversary", src_len=src_len,
                         max_new_tokens=min(2, max_new_tokens)),
            RequestClass("stream", src_len=short_len,
                         max_new_tokens=max_new_tokens),
        )
    if mix == "prefix-heavy":
        # The shared-system-prompt mix the radix token-prefix cache
        # feeds on: two tenants whose requests repeat a handful of
        # WHOLE prompts (prefix_len == src_len — members of a prefix
        # group share the entire source, the identical-source condition
        # decoder-KV sharing needs in an encoder-decoder model). The
        # group count is deliberately small so every group repeats many
        # times; `prefix_groups=` on the trace spec overrides it to
        # sweep the sharing level.
        return (
            RequestClass("sys-a", src_len=src_len,
                         max_new_tokens=max_new_tokens, weight=2.0,
                         tenant="tenant-a",
                         prefix_groups=2, prefix_len=src_len),
            RequestClass("sys-b", src_len=src_len,
                         max_new_tokens=max_new_tokens, weight=1.0,
                         tenant="tenant-b",
                         prefix_groups=2, prefix_len=src_len),
        )
    if mix == "tenants":
        # The noisy-neighbour mix: tenant-a's interactive streams
        # (latency class, short prompts, tight budgets) share the fleet
        # with tenant-b's bulk decode jobs (batch class, long budgets).
        # Bulk outweighs interactive 2:1 in arrivals — the QoS admission
        # and preemption layer is what keeps tenant-a's p95 flat.
        short_len = max(2, src_len // 3)
        return (
            RequestClass("interactive", src_len=short_len,
                         max_new_tokens=max(1, max_new_tokens // 2),
                         weight=1.0, tenant="tenant-a",
                         qos_class="latency"),
            RequestClass("bulk", src_len=src_len,
                         max_new_tokens=max_new_tokens,
                         weight=2.0, tenant="tenant-b",
                         qos_class="batch"),
        )
    return (RequestClass("base", src_len=src_len,
                         max_new_tokens=max_new_tokens),)


# Per-preset knob vocabulary: name → (default builder, allowed keys).
_COMMON_KEYS = ("requests", "duration", "mix", "prefix_groups",
                "prefix_len")
_PRESET_KEYS: Dict[str, Tuple[str, ...]] = {
    "poisson": _COMMON_KEYS + ("rate",),
    "burst": _COMMON_KEYS + ("rate", "base", "burst_s", "burst_start_s"),
    "diurnal": _COMMON_KEYS + ("peak", "trough", "period_s"),
}


def parse_trace_spec(text: str, src_len: int = 12,
                     max_new_tokens: int = 16,
                     requests: int = 16) -> TraceSpec:
    """Parse a ``--trace`` spec string: ``NAME`` or
    ``NAME:key=value,key=value``. ``src_len`` / ``max_new_tokens`` /
    ``requests`` are the bench's dimensions — preset defaults scale off
    them so the same spec string works in smoke and full runs.

    Arrival-rate defaults deliberately OVERSAMPLE (the candidate process
    runs at roughly twice the rate needed to produce ``requests``
    arrivals) and then cap at ``requests`` — a thinned Poisson draw
    below the expected count must not silently under-load the bench.
    """
    text = (text or "").strip()
    if not text:
        raise ValueError("empty trace spec")
    name, _, rest = text.partition(":")
    name = name.strip()
    if name not in _PRESET_KEYS:
        raise ValueError(f"unknown trace preset {name!r} "
                         f"(one of {sorted(_PRESET_KEYS)})")
    kv: Dict[str, str] = {}
    if rest.strip():
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if not eq or not key or not val:
                raise ValueError(
                    f"malformed trace param {item!r} (want key=value)")
            if key not in _PRESET_KEYS[name]:
                raise ValueError(
                    f"unknown param {key!r} for preset {name!r} "
                    f"(one of {sorted(_PRESET_KEYS[name])})")
            kv[key] = val

    def _num(key: str, default: float) -> float:
        if key not in kv:
            return float(default)
        try:
            return float(kv[key])
        except ValueError:
            raise ValueError(
                f"trace param {key!r} must be a number, got {kv[key]!r}")

    mix = kv.get("mix", "uniform")
    if mix not in MIXES:
        raise ValueError(f"unknown mix {mix!r} (one of {MIXES})")
    n = int(_num("requests", requests))
    if n < 1:
        raise ValueError(f"requests must be >= 1, got {n}")
    classes = _classes_for_mix(mix, src_len, max_new_tokens)
    groups = int(_num("prefix_groups", 0))
    if groups:
        # prefix-heavy keeps whole-prompt sharing under a prefix_groups
        # sweep: identical full sources are what decoder-KV (radix)
        # sharing needs, not just a common head.
        plen = int(_num("prefix_len", src_len if mix == "prefix-heavy"
                        else max(1, src_len // 2)))
        classes = tuple(
            dataclasses.replace(c, prefix_groups=groups,
                                prefix_len=min(plen, c.src_len))
            for c in classes)

    if name == "poisson":
        duration = _num("duration", 4.0)
        rate = _num("rate", 2.0 * n / duration)
        params = (("rate", rate),)
    elif name == "burst":
        burst_s = _num("burst_s", 0.1)
        burst_start = _num("burst_start_s", 0.0)
        duration = _num("duration",
                        max(4.0, burst_start + burst_s + 3.0))
        rate = _num("rate", 2.0 * n / burst_s)
        base = _num("base", 0.0)
        params = (("base", base), ("burst_s", burst_s),
                  ("burst_start_s", burst_start), ("rate", rate))
    else:
        period = _num("period_s", 4.0)
        duration = _num("duration", period)
        peak = _num("peak", 4.0 * n / period)
        trough = _num("trough", 0.0)
        params = (("peak", peak), ("period_s", period),
                  ("trough", trough))

    return TraceSpec(name=name, process=name, duration_s=duration,
                     max_requests=n, params=params, classes=classes)
