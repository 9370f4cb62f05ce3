"""Prometheus text exposition (format 0.0.4), standard library only.

The port's one renderer of metric families: the extender's
:mod:`tpushare_torch.routes.metrics` registry and the grant watchdog's
gauges (:mod:`tpushare_torch.deviceplugin.watchdog`) both render here.
The output is what ``prometheus_client`` 0.25's ``generate_latest``
writes for the same families, line for line:

* a counter ``x_total`` renders as ``# TYPE x_total counter`` with the
  sample ``x_total``, then a gauge family ``x_created`` holding each
  child's creation time;
* a histogram renders ``_bucket{le="…"}`` (cumulative, ``+Inf`` last),
  ``_count`` and ``_sum``, then its ``_created`` family;
* a labelled family renders nothing but HELP and TYPE until a child is
  made; an unlabelled one renders its 0.0 from birth;
* labels render sorted by name (a bucket's ``le`` among them), values
  in Go's float formatting (:func:`go_float`), children in the order
  they were made.

Each family guards its children with its own lock, so ``inc``,
``observe`` and ``set`` may run on any thread.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Sequence


def go_float(value: float) -> str:
    """A sample value as the Prometheus text format writes it (Go's
    formatting: exponents from 1e7 up)."""
    d = float(value)
    if math.isinf(d):
        return "+Inf" if d > 0 else "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def escape(text: str, quote: bool) -> str:
    """HELP text (``quote`` False) or a label value (True), escaped."""
    text = text.replace("\\", r"\\").replace("\n", r"\n")
    return text.replace('"', r'\"') if quote else text


def _label_text(names: Sequence[str], values: Sequence[str],
                extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = sorted([*zip(names, values), *extra])
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{escape(v, True)}"' for k, v in pairs) + "}"


def _header(name: str, doc: str, kind: str) -> list[str]:
    return [f"# HELP {name} {escape(doc, False)}", f"# TYPE {name} {kind}"]


class GaugeFamily:
    """One gauge family keyed by label tuples in ``labelnames`` order: a
    value per label set, in the order the sets were first set. The
    watchdog's per-pod gauges, which it sets and removes by tuple."""

    def __init__(self, name: str, doc: str,
                 labelnames: Sequence[str] = ()):
        self.name, self.doc = name, doc
        self.labelnames = tuple(labelnames)
        self.samples: dict[tuple[str, ...], float] = {}

    def set(self, labels: tuple[str, ...], value: float) -> None:
        self.samples[labels] = float(value)

    def remove(self, labels: tuple[str, ...]) -> None:
        self.samples.pop(labels, None)

    def get(self, labels: tuple[str, ...]) -> float | None:
        return self.samples.get(labels)

    def render(self) -> str:
        lines = _header(self.name, self.doc, "gauge")
        for labels, value in self.samples.items():
            lines.append(f"{self.name}{_label_text(self.labelnames, labels)}"
                         f" {go_float(value)}")
        return "\n".join(lines) + "\n"


class Registry:
    """The families of one exposition, rendered in registration order."""

    def __init__(self) -> None:
        self._families: list[_Family] = []
        # vet: ignore[raw-lock] - the exposition's own leaf lock, as prometheus_client's; a traced lock would profile the scrape that renders the profile
        self._lock = threading.Lock()

    def register(self, family: "_Family") -> None:
        with self._lock:
            if any(f.name == family.name for f in self._families):
                raise ValueError(f"duplicate metric family {family.name}")
            self._families.append(family)

    def families(self) -> list["_Family"]:
        with self._lock:
            return list(self._families)

    def render(self) -> bytes:
        return "".join(f.render() for f in self.families()).encode()

    def reset(self) -> None:
        """Every family back to its state at birth (tests)."""
        for family in self.families():
            family.reset()


class _Child:
    __slots__ = ("value", "created", "buckets", "total")

    def __init__(self, n_buckets: int = 0) -> None:
        self.value = 0.0
        self.created = time.time()
        self.buckets = [0.0] * n_buckets
        self.total = 0.0


class _Family:
    """Shared machinery: the children by label values, the lock, and the
    unlabelled family's single child."""

    kind = ""

    def __init__(self, name: str, doc: str,
                 labelnames: Sequence[str] = (),
                 registry: Registry | None = None) -> None:
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        # vet: ignore[raw-lock] - a family's leaf lock, as prometheus_client's; a traced lock would profile the scrape that renders the profile
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self) -> _Child:
        return _Child()

    def labels(self, *values: str, **kw: str) -> "_Bound":
        if kw:
            if values or set(kw) != set(self.labelnames):
                raise ValueError(f"{self.name}: labels {sorted(kw)} are not "
                                 f"{list(self.labelnames)}")
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if not self.labelnames or len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: {len(values)} label values for "
                             f"{list(self.labelnames)}")
        with self._lock:
            if values not in self._children:
                self._children[values] = self._new_child()
        return _Bound(self, values)

    def _child(self, key: tuple[str, ...]) -> _Child:
        if self.labelnames and not key:
            raise ValueError(f"{self.name} is labelled: call labels() first")
        return self._children[key]

    def clear(self) -> None:
        """Drop every labelled child (the scrape's rebuild-from-scratch)."""
        with self._lock:
            if self.labelnames:
                self._children.clear()

    def reset(self) -> None:
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = self._new_child()

    def samples(self) -> list[tuple[tuple[str, ...], _Child]]:
        with self._lock:
            return [(k, c) for k, c in self._children.items()]

    def render(self) -> str:
        raise NotImplementedError


class _Bound:
    """A family at one label set: the object ``labels()`` returns."""

    __slots__ = ("_family", "_key")

    def __init__(self, family: _Family, key: tuple[str, ...]) -> None:
        self._family, self._key = family, key

    def inc(self, amount: float = 1.0) -> None:
        self._family._inc(self._key, amount)

    def set(self, value: float) -> None:
        self._family._set(self._key, value)

    def observe(self, value: float) -> None:
        self._family._observe(self._key, value)

    def get(self) -> float:
        return self._family._child(self._key).value


class Counter(_Family):
    """A monotonic count. ``name`` may carry ``_total`` or not; the
    sample is always ``<base>_total``."""

    kind = "counter"

    def __init__(self, name: str, doc: str, labelnames: Sequence[str] = (),
                 registry: Registry | None = None) -> None:
        self.base = name[:-len("_total")] if name.endswith("_total") else name
        super().__init__(self.base + "_total", doc, labelnames, registry)

    def _inc(self, key: tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by "
                             "non-negative amounts")
        with self._lock:
            self._child(key).value += amount

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    def get(self) -> float:
        return self._child(()).value

    def render(self) -> str:
        samples = self.samples()
        lines = _header(self.name, self.doc, "counter")
        for key, child in samples:
            lines.append(f"{self.name}{_label_text(self.labelnames, key)} "
                         f"{go_float(child.value)}")
        if samples:
            created = f"{self.base}_created"
            lines += _header(created, self.doc, "gauge")
            for key, child in samples:
                lines.append(f"{created}{_label_text(self.labelnames, key)} "
                             f"{go_float(child.created)}")
        return "\n".join(lines) + "\n"


class Gauge(_Family):
    """A value that goes up and down."""

    kind = "gauge"

    def _inc(self, key: tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._child(key).value += amount

    def _set(self, key: tuple[str, ...], value: float) -> None:
        with self._lock:
            self._child(key).value = float(value)

    def set(self, value: float) -> None:
        self._set((), value)

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    def get(self) -> float:
        return self._child(()).value

    def render(self) -> str:
        lines = _header(self.name, self.doc, "gauge")
        for key, child in self.samples():
            lines.append(f"{self.name}{_label_text(self.labelnames, key)} "
                         f"{go_float(child.value)}")
        return "\n".join(lines) + "\n"


class Histogram(_Family):
    """Observations counted into cumulative buckets, with their count
    and sum."""

    kind = "histogram"

    def __init__(self, name: str, doc: str, labelnames: Sequence[str] = (),
                 registry: Registry | None = None,
                 buckets: Sequence[float] = ()) -> None:
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.bounds = tuple(bounds)
        super().__init__(name, doc, labelnames, registry)

    def _new_child(self) -> _Child:
        return _Child(len(self.bounds))

    def _observe(self, key: tuple[str, ...], value: float) -> None:
        value = float(value)
        with self._lock:
            child = self._child(key)
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    child.buckets[i] += 1
                    break
            child.total += value

    def observe(self, value: float) -> None:
        self._observe((), value)

    @contextmanager
    def time(self) -> Iterator[None]:
        """Observe the seconds the block takes, whether it raises or not."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(max(time.perf_counter() - t0, 0.0))

    def render(self) -> str:
        samples = self.samples()
        lines = _header(self.name, self.doc, "histogram")
        for key, child in samples:
            acc = 0.0
            for bound, n in zip(self.bounds, list(child.buckets)):
                acc += n
                le = (("le", go_float(bound)),)
                lines.append(f"{self.name}_bucket"
                             f"{_label_text(self.labelnames, key, le)} "
                             f"{go_float(acc)}")
            labels = _label_text(self.labelnames, key)
            lines.append(f"{self.name}_count{labels} {go_float(acc)}")
            lines.append(f"{self.name}_sum{labels} {go_float(child.total)}")
        if samples:
            created = f"{self.name}_created"
            lines += _header(created, self.doc, "gauge")
            for key, child in samples:
                lines.append(f"{created}{_label_text(self.labelnames, key)} "
                             f"{go_float(child.created)}")
        return "\n".join(lines) + "\n"
