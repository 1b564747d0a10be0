"""Labeled counters/gauges/histograms with Prometheus text exposition.

Stdlib-only metric primitives for the serving stack (docs/observability.md).
Metrics are registered on a :class:`Registry` and scraped through
``Registry.expose()``, which renders the Prometheus text format 0.0.4
(``# HELP``/``# TYPE`` headers, escaped label values, cumulative histogram
buckets with the ``+Inf`` terminator, ``_sum``/``_count`` series).

Design constraints, in order:

  * **Hot-path cheap.**  ``Counter.inc`` / ``Histogram.observe`` sit on the
    engine tick path; each is a dict lookup + a few float ops under a
    per-metric lock (the lock is uncontended in practice: one writer
    thread per replica label set, readers only at scrape time).
  * **Thread-safe.**  Engines tick on worker threads while the asyncio
    frontend scrapes ``/metrics``; exposition takes each metric's lock
    just long enough to snapshot its label map.
  * **Fixed buckets.**  Histograms take an explicit bucket tuple (see
    :func:`exp_buckets`); there is no dynamic resizing, so bucket series
    are stable across scrapes and cumulativity is checkable by a test.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[str, ...]


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` exponentially spaced upper bounds from ``start``:
    start, start*factor, ... (the ``+Inf`` bucket is implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"need start > 0, factor > 1, count >= 1; "
            f"got {start}, {factor}, {count}")
    return tuple(start * factor ** i for i in range(count))


# Default latency buckets: 50us .. ~52s, x2 per step — wide enough to hold
# both a smoke-model CPU tick (~ms) and a queued-request wait (~s) without
# per-deployment tuning.
LATENCY_BUCKETS = exp_buckets(50e-6, 2.0, 20)


def escape_label_value(v: str) -> str:
    """Prometheus text-format label value escaping: backslash, quote, LF."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_VALID_REST = _VALID_FIRST | set("0123456789")


def _check_name(name: str) -> str:
    if not name or name[0] not in _VALID_FIRST \
            or any(c not in _VALID_REST for c in name[1:]):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Metric:
    """Base: one named family of samples keyed by a label-value tuple."""

    type_name = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            _check_name(ln)
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, object] = {}

    def _key(self, labels: Dict[str, str]) -> LabelKey:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _render_labels(self, key: LabelKey,
                       extra: Sequence[Tuple[str, str]] = ()) -> str:
        pairs = [(ln, lv) for ln, lv in zip(self.labelnames, key)]
        pairs.extend(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{ln}="{escape_label_value(lv)}"'
                         for ln, lv in pairs)
        return "{" + inner + "}"

    def labels(self, **labels) -> "_Bound":
        """Pre-bound handle for a fixed label set: validates the labels
        once and skips the per-call key construction — the tick hot path
        uses these."""
        return _Bound(self, self._key(labels))

    def samples(self) -> List[Tuple[str, str, float]]:
        """(series name, rendered labels, value) rows for exposition."""
        raise NotImplementedError

    def expose(self, openmetrics: bool = False) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type_name}"]
        for series, labels, value in self.samples():
            lines.append(f"{series}{labels} {_fmt(value)}")
        return "\n".join(lines)


class Counter(Metric):
    """Monotone non-decreasing counter (per label set).

    ``inc(..., exemplar={"trace_id": ...})`` attaches an OpenMetrics
    exemplar to the label set — the metrics<->trace join point
    (docs/observability.md): the exemplar surfaces only in the
    OpenMetrics exposition (``expose(openmetrics=True)``), so the
    default Prometheus 0.0.4 scrape and its parser stay byte-compatible.
    """

    type_name = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._exemplars: Dict[LabelKey, Tuple[dict, float, float]] = {}

    def inc(self, amount: float = 1.0,
            exemplar: Optional[dict] = None, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only increase "
                             f"(inc {amount})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount
            if exemplar:
                self._exemplars[key] = (dict(exemplar), amount,
                                        time.time())

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    def samples(self):
        with self._lock:
            items = sorted(self._values.items())
        return [(self.name, self._render_labels(k), v) for k, v in items]

    def expose(self, openmetrics: bool = False) -> str:
        if not openmetrics:
            return super().expose()
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type_name}"]
        with self._lock:
            items = sorted(self._values.items())
            exemplars = dict(self._exemplars)
        for key, value in items:
            line = f"{self.name}{self._render_labels(key)} {_fmt(value)}"
            ex = exemplars.get(key)
            if ex is not None:
                elabels, evalue, ets = ex
                inner = ",".join(
                    f'{ln}="{escape_label_value(str(lv))}"'
                    for ln, lv in sorted(elabels.items()))
                line += f" # {{{inner}}} {_fmt(evalue)} {ets:.3f}"
            lines.append(line)
        return "\n".join(lines)


class Gauge(Metric):
    """Set/inc/dec current-value gauge (per label set)."""

    type_name = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    def samples(self):
        with self._lock:
            items = sorted(self._values.items())
        return [(self.name, self._render_labels(k), v) for k, v in items]


class Histogram(Metric):
    """Fixed-bucket histogram; exposition renders cumulative ``_bucket``
    series (ending at ``le="+Inf"``) plus ``_sum`` and ``_count``."""

    type_name = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"{name}: buckets must be strictly increasing "
                             f"and non-empty, got {bs}")
        if bs and bs[-1] == math.inf:
            bs = bs[:-1]               # +Inf bucket is implicit
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)   # le: v <= bound
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = self._values[key] = \
                    [[0] * (len(self.buckets) + 1), 0.0]
            state[0][i] += 1
            state[1] += v

    def snapshot(self, **labels) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        key = self._key(labels)
        with self._lock:
            state = self._values.get(key)
            counts = list(state[0]) if state else \
                [0] * (len(self.buckets) + 1)
            total = state[1] if state else 0.0
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, total, acc

    def samples(self):
        with self._lock:
            items = [(k, (list(s[0]), s[1])) for k, s in
                     sorted(self._values.items())]
        rows: List[Tuple[str, str, float]] = []
        for key, (counts, total) in items:
            acc = 0
            for bound, c in zip(self.buckets + (math.inf,), counts):
                acc += c
                rows.append((f"{self.name}_bucket",
                             self._render_labels(
                                 key, extra=[("le", _fmt(bound))]),
                             float(acc)))
            rows.append((f"{self.name}_sum", self._render_labels(key),
                         total))
            rows.append((f"{self.name}_count", self._render_labels(key),
                         float(acc)))
        return rows


class _Bound:
    """A (metric, label-key) pair with the key resolved up front.  Exposes
    the union of the write APIs; the metric type determines which apply."""

    __slots__ = ("_m", "_k")

    def __init__(self, metric: Metric, key: LabelKey):
        self._m = metric
        self._k = key

    def inc(self, amount: float = 1.0) -> None:
        m = self._m
        if isinstance(m, Counter) and amount < 0:
            raise ValueError(f"{m.name}: counters only increase "
                             f"(inc {amount})")
        with m._lock:
            m._values[self._k] = m._values.get(self._k, 0.0) + amount

    def set(self, value: float) -> None:
        with self._m._lock:
            self._m._values[self._k] = float(value)

    def observe(self, value: float) -> None:
        m = self._m
        v = float(value)
        i = bisect.bisect_left(m.buckets, v)
        with m._lock:
            state = m._values.get(self._k)
            if state is None:
                state = m._values[self._k] = \
                    [[0] * (len(m.buckets) + 1), 0.0]
            state[0][i] += 1
            state[1] += v


class Registry:
    """Named collection of metrics with one text exposition surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is not None:
                if type(have) is not type(metric) \
                        or have.labelnames != metric.labelnames:
                    raise ValueError(
                        f"metric {metric.name!r} already registered with a "
                        f"different type or label set")
                return have            # idempotent re-registration
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help, labelnames, buckets))

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self, openmetrics: bool = False) -> str:
        """Text exposition.  ``openmetrics=True`` renders the same sample
        lines plus counter exemplars and the ``# EOF`` terminator — serve
        it when the scraper sends ``Accept: application/openmetrics-text``
        (exemplars are illegal in the 0.0.4 text format)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        body = "\n".join(m.expose(openmetrics) for m in metrics)
        if openmetrics:
            return body + ("\n# EOF\n" if body else "# EOF\n")
        return body + ("\n" if body else "")


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def parse_exposition(text: str) -> Dict[str, Dict[str, float]]:
    """Parse Prometheus text format into ``{series: {labelstr: value}}``
    (``labelstr`` is the raw ``{...}`` rendering, ``""`` when unlabeled).

    Strict enough to catch real breakage: raises ``ValueError`` on a line
    that is neither a comment nor a ``name{labels} value`` sample, on
    unbalanced quoting, and on non-float values.  Used by the scrape
    validation in loadgen/CI and by the golden-format tests.
    """
    out: Dict[str, Dict[str, float]] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        rest = line
        if "{" in line:
            name, rest = line.split("{", 1)
            if '"} ' not in rest and not rest.endswith('"}'):
                raise ValueError(f"line {ln}: malformed labels: {line!r}")
            labels, val = rest.rsplit("} ", 1)
            labelstr = "{" + labels + "}"
            # count quote delimiters, skipping backslash-escaped ones
            # (label values may legally contain \" per the text format)
            if len(re.findall(r'(?<!\\)(?:\\\\)*"', labelstr)) % 2:
                raise ValueError(f"line {ln}: unbalanced quotes: {line!r}")
        else:
            parts = rest.rsplit(" ", 1)
            if len(parts) != 2:
                raise ValueError(f"line {ln}: not a sample: {line!r}")
            name, val = parts
            labelstr = ""
        _check_name(name.strip())
        try:
            fval = float(val)
        except ValueError:
            raise ValueError(f"line {ln}: bad value {val!r}")
        out.setdefault(name.strip(), {})[labelstr] = fval
    return out


def validate_histogram(samples: Dict[str, Dict[str, float]],
                       name: str) -> None:
    """Assert bucket cumulativity and ``_sum``/``_count`` consistency for
    histogram ``name`` in a :func:`parse_exposition` result."""
    buckets = samples.get(f"{name}_bucket", {})
    counts = samples.get(f"{name}_count", {})
    if not buckets or not counts:
        raise ValueError(f"histogram {name}: missing bucket/count series")
    # group bucket series by their non-le labels
    by_key: Dict[str, List[Tuple[float, float]]] = {}
    for labelstr, v in buckets.items():
        inner = labelstr[1:-1]
        pairs = [p for p in _split_labels(inner) if not p.startswith('le=')]
        le = [p for p in _split_labels(inner) if p.startswith('le=')]
        if len(le) != 1:
            raise ValueError(f"{name}: bucket without le label {labelstr}")
        bound = le[0][4:-1]
        key = "{" + ",".join(pairs) + "}" if pairs else ""
        by_key.setdefault(key, []).append(
            (math.inf if bound == "+Inf" else float(bound), v))
    for key, rows in by_key.items():
        rows.sort()
        vals = [v for _, v in rows]
        if any(later < earlier
               for earlier, later in zip(vals, vals[1:])):
            raise ValueError(f"{name}{key}: buckets not cumulative: {vals}")
        if rows[-1][0] != math.inf:
            raise ValueError(f"{name}{key}: missing +Inf bucket")
        if key not in counts or counts[key] != vals[-1]:
            raise ValueError(
                f"{name}{key}: _count {counts.get(key)} != +Inf bucket "
                f"{vals[-1]}")


def _split_labels(inner: str) -> List[str]:
    """Split ``a="x",b="y"`` on commas outside quotes."""
    parts, cur, in_q, esc = [], [], False, False
    for ch in inner:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts
