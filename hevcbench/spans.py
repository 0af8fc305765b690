"""Spans the benchmark puts around the calls into the program's layers.

A traced run wraps, from here and never in the program's files, the calls
by which the pipeline reaches each layer and records one span per call:
its thread, layer and host clock interval. The layers are not listed
here: each per-layer metric module (metrics/<name>.py) of the cell names
the calls of the layer it reads in `SPANS`, {layer: (module, class,
method names)}, and may define `install(spans)` to hook anything else it
reads, through `Spans.patch`. A metric of another layer adds its own file
and edits none. A call made inside a span of the same layer on the same
thread (encode_frame reaching dispatch_packed) records nothing of its
own, so no time counts twice. While a profiler runs, each span also opens
a `torch.profiler.record_function` range, so the device trace carries the
host span that was open at any moment. The untraced run installs none of
this.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import threading
import time


@dataclasses.dataclass
class Span:
    thread: int
    main: bool
    layer: str
    t0: float
    t1: float


class Spans:
    """In-memory spans of the traced run; `recording` gates what is kept,
    `profiling` adds record_function ranges, `on_layer` (if set) is told
    the layer each thread enters and leaves (the op counter's stage).
    `layers` maps each installed layer to its (module, class) -> methods;
    `records` holds what metric hooks keep, each under a key of its own."""

    def __init__(self):
        self.spans: list[Span] = []
        self.layers: dict[str, dict[tuple[str, str], set[str]]] = {}
        self.records: dict[str, list] = {}
        self.recording = False
        self.profiling = False
        self.on_layer = None
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._main = threading.main_thread().ident
        self._saved = []

    def current_layer(self):
        return getattr(self._tls, "layer", None)

    @contextlib.contextmanager
    def span(self, layer: str):
        outer = self.current_layer()
        if outer == layer:
            yield
            return
        self._tls.layer = layer
        if self.on_layer is not None:
            self.on_layer(layer)
        rf = contextlib.nullcontext()
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(f"hevcbench.{layer}")
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            t1 = time.perf_counter()
            self._tls.layer = outer
            if self.on_layer is not None:
                self.on_layer(outer)
            if self.recording:
                tid = threading.get_ident()
                with self._lock:
                    self.spans.append(Span(tid, tid == self._main, layer,
                                           t0, t1))

    def install(self, metric_modules) -> None:
        """Wrap the calls that the metric modules name in `SPANS` and run
        their `install` hooks; uninstall undoes both."""
        where: dict[tuple[str, str, str], str] = {}
        for mod in metric_modules:
            for layer, (modname, cls, names) in getattr(
                    mod, "SPANS", {}).items():
                for name in names:
                    key = (modname, cls, name)
                    if where.setdefault(key, layer) != layer:
                        raise ValueError(f"{key} is in two layers: "
                                         f"{where[key]} and {layer}")
                    self.layers.setdefault(layer, {}).setdefault(
                        (modname, cls), set()).add(name)
        for layer, owners in self.layers.items():
            for (modname, cls), names in owners.items():
                owner = getattr(importlib.import_module(modname), cls)
                for name in sorted(names):
                    self.patch(owner, name,
                               self._wrap(getattr(owner, name), layer))
        for mod in metric_modules:
            hook = getattr(mod, "install", None)
            if hook is not None:
                hook(self)

    def patch(self, owner, name: str, new) -> None:
        """Set `owner.name` to `new` until uninstall."""
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def uninstall(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    def _wrap(self, fn, layer):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with self.span(layer):
                return fn(*a, **k)
        return wrapped


def self_time(spans: list[Span], layer: str, children: set[str]) -> float:
    """Seconds of `layer`'s spans on the main thread less the time that
    the union of its child layers' spans on that thread covers inside
    them (a child nested in another child counts once)."""
    total = 0.0
    by_thread: dict[int, list[Span]] = {}
    for s in spans:
        by_thread.setdefault(s.thread, []).append(s)
    for ss in by_thread.values():
        if not ss[0].main:
            continue
        kids: list[list[float]] = []       # the union of child spans
        for a, b in sorted((s.t0, s.t1) for s in ss if s.layer in children):
            if kids and a <= kids[-1][1]:
                kids[-1][1] = max(kids[-1][1], b)
            else:
                kids.append([a, b])
        for s in ss:
            if s.layer != layer:
                continue
            inner = sum(max(0.0, min(b, s.t1) - max(a, s.t0))
                        for a, b in kids)
            total += (s.t1 - s.t0) - inner
    return total


def layer_seconds(spans: list[Span], layer: str) -> float:
    """Seconds of `layer`'s spans, on every thread."""
    return sum(s.t1 - s.t0 for s in spans if s.layer == layer)
