"""Unified telemetry: metric registry + flight recorder (observability).

The paper's pitch is that BALBOA is *inspectable* where commercial NICs
are black boxes.  This module is the repo-wide observability plane that
backs that claim for the reproduction:

``MetricRegistry``
    A hierarchical registry of typed metrics (counters / gauges /
    histograms) plus *providers* — existing stats surfaces
    (``PortStats``, ``NodeStats``, ``CreditManager``, ``StreamReport``,
    fabric/reducer/rate-controller telemetry) that expose a common
    ``snapshot() -> dict`` shape.  ``snapshot()`` walks everything into
    one nested dict; ``flat()`` flattens it to ``"a/b/c" -> value`` for
    JSON export (the fig benches embed it in their ``--json`` output,
    which is what ``benchmarks/regress.py`` diffs across commits);
    ``diff()`` subtracts two snapshots leaf-wise.

``FlightRecorder``
    A bounded ring of sim-tick-timestamped packet-lifecycle events
    (inject, per-hop enqueue/dequeue with queue depth, ECN mark, drop,
    SACK/NAK, retransmit, CNP, completion, spine failure, stream tile
    events, collective phases) recorded by ``netsim`` / ``rdma`` /
    ``ingest`` / ``collectives`` when a recorder is attached — and by
    nothing (one ``is None`` test per event site) when it is not.
    ``chrome_trace()`` exports Chrome-trace / Perfetto JSON where tracks
    are ports, spines, uplinks and QPs, so an 8:1 incast or a mid-run
    spine failure is visually debuggable in ``chrome://tracing``.

Determinism contract: every timestamp is the simulator's integer tick —
there is NO wall-clock anywhere in ``repro_torch.core``, so two runs of
the same seeded config produce byte-identical trace exports, on the card
and on the CPU alike (tests/test_torch_telemetry.py holds the port's
export byte for byte against the reference's).

This module is the port's own copy of ``repro.core.telemetry``: pure
Python, no torch.  The engine-carried per-QP counters it reads through
``RdmaNode.snapshot`` are torch columns on the node's device, harvested
in one device-to-host copy at snapshot time (the epoch boundary).
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Typed metrics
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float):
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bound histogram: counts per bucket plus count/sum/min/max.
    Bounds are upper edges; values beyond the last bound land in the
    overflow bucket."""

    __slots__ = ("bounds", "buckets", "count", "total", "vmin", "vmax")

    DEFAULT_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float):
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def snapshot(self) -> Dict[str, Union[int, float, list]]:
        return {"count": self.count, "sum": self.total,
                "min": 0 if self.vmin is None else self.vmin,
                "max": 0 if self.vmax is None else self.vmax,
                "buckets": list(self.buckets)}


Provider = Union[Counter, Gauge, Histogram, Callable[[], dict], object]


class MetricRegistry:
    """Hierarchical metric registry.  Paths are ``/``-separated; a
    registered *provider* is either an owned metric (``counter()`` /
    ``gauge()`` / ``histogram()``), any object with a ``snapshot()``
    method, or a zero-arg callable returning a dict — which is how
    every pre-existing ad-hoc stats surface plugs in without being
    rewritten."""

    def __init__(self):
        self._providers: Dict[str, Provider] = {}

    # ---- registration -------------------------------------------------
    def register(self, path: str, provider: Provider) -> Provider:
        if not path or path.startswith("/") or path.endswith("/"):
            raise ValueError(f"bad metric path {path!r}")
        if path in self._providers:
            raise ValueError(f"metric path {path!r} already registered")
        self._providers[path] = provider
        return provider

    def deregister(self, path: str):
        self._providers.pop(path, None)

    def counter(self, path: str) -> Counter:
        return self.register(path, Counter())

    def gauge(self, path: str, value: float = 0.0) -> Gauge:
        return self.register(path, Gauge(value))

    def histogram(self, path: str,
                  bounds: Tuple[float, ...] = Histogram.DEFAULT_BOUNDS
                  ) -> Histogram:
        return self.register(path, Histogram(bounds))

    def paths(self) -> List[str]:
        return sorted(self._providers)

    # ---- export --------------------------------------------------------
    @staticmethod
    def _resolve(provider: Provider):
        if callable(provider) and not hasattr(provider, "snapshot"):
            return provider()
        return provider.snapshot()

    def snapshot(self) -> dict:
        """Nested dict keyed by path components; provider dicts embed
        as-is (and may nest further)."""
        out: dict = {}
        for path in sorted(self._providers):
            node = out
            parts = path.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise ValueError(f"metric path {path!r} collides with "
                                     f"a leaf at {part!r}")
            node[parts[-1]] = self._resolve(self._providers[path])
        return out

    def flat(self, snap: Optional[dict] = None) -> Dict[str, Union[int, float]]:
        """Flatten a (possibly nested) snapshot into ``"a/b/c" -> value``
        with scalar leaves only (lists index as ``path/i``)."""
        return flatten(self.snapshot() if snap is None else snap)

    def diff(self, before: dict, after: dict) -> Dict[str, Union[int, float]]:
        """Leaf-wise ``after - before`` over the numeric leaves both
        snapshots share — what changed during an epoch."""
        fb, fa = flatten(before), flatten(after)
        return {k: fa[k] - fb[k] for k in fa
                if k in fb and isinstance(fa[k], (int, float))
                and isinstance(fb[k], (int, float))
                and not isinstance(fa[k], bool)}


def flatten(tree: dict, prefix: str = "") -> Dict[str, Union[int, float]]:
    out: Dict[str, Union[int, float]] = {}
    for k in sorted(tree, key=str):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif isinstance(v, (list, tuple)):
            out.update(flatten({i: x for i, x in enumerate(v)}, key + "/"))
        elif isinstance(v, (int, float)):
            out[key] = v
    return out


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

# event kinds -> Chrome-trace phase.  "qdepth" renders as a counter
# track (ph "C"); events carrying a ``dur`` attr render as complete
# spans (ph "X"); everything else is an instant (ph "i").
EVENT_KINDS = (
    "inject", "wire_drop", "enqueue", "dequeue", "tail_drop", "ecn",
    "flush", "spine_fail", "reroute", "nak", "sack", "retransmit",
    "cnp_tx", "cnp_rx", "completion", "qp_error", "qdepth",
    "stream_issue", "stream_tile", "stream_done", "stream_refetch",
    "coll_transfer",
)

Track = Tuple[str, Union[int, str]]      # (category, instance)


@dataclasses.dataclass(frozen=True)
class Event:
    tick: int
    kind: str
    track: Track
    attrs: Tuple[Tuple[str, Union[int, float, str]], ...] = ()


class FlightRecorder:
    """Bounded, sim-tick-timestamped event ring.

    ``record`` is the single entry point every instrumented subsystem
    calls; the ring is a ``deque(maxlen=capacity)`` so a long run never
    grows without bound (``dropped_events`` counts overwrites).  The
    per-kind totals in ``counts`` are monotonic and independent of the
    ring, so they reconcile exactly with the ``MetricRegistry`` snapshot
    even after wraparound; the *exported trace* only reconciles while
    the ring has not wrapped (``dropped_events == 0``)."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("FlightRecorder capacity must be >= 1")
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.counts: Dict[str, int] = {}
        self.total_events = 0
        self.dropped_events = 0

    # ---- recording -----------------------------------------------------
    def record(self, tick: int, kind: str, track: Track, **attrs):
        self.total_events += 1
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if len(self._ring) == self.capacity:
            self.dropped_events += 1
        self._ring.append(Event(int(tick), kind, track,
                                tuple(sorted(attrs.items()))))

    def events(self, kind: Optional[str] = None) -> List[Event]:
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e.kind == kind]

    def clear(self):
        self._ring.clear()
        self.counts = {}
        self.total_events = 0
        self.dropped_events = 0

    # ---- registry integration ------------------------------------------
    def snapshot(self) -> dict:
        """The recorder's own registry surface: monotonic per-kind event
        totals (+ ring health)."""
        return {"events_total": self.total_events,
                "events_dropped": self.dropped_events,
                "events_retained": len(self._ring),
                "by_kind": dict(sorted(self.counts.items()))}

    # ---- Chrome-trace / Perfetto export --------------------------------
    # track category -> (pid, sort index); unknown categories get pids
    # after the known ones, in first-seen order per export (the event
    # stream is deterministic, so the mapping is too)
    _PID_ORDER = ("port", "uplink", "spdown", "spine", "link", "node",
                  "qp", "stripe", "coll")

    def chrome_trace(self, *, tick_us: int = 1) -> dict:
        """Render the retained ring as a Chrome-trace JSON object
        (``chrome://tracing`` / Perfetto's legacy JSON importer).

        Mapping: track *category* -> process, track *instance* ->
        thread, so ports/spines/uplinks/QPs each get their own named
        track.  ``qdepth`` events render as counter tracks (queue-depth
        graphs), ``dur``-carrying events as complete spans, the rest as
        instants.  Timestamps are ``tick * tick_us`` microseconds."""
        cats: Dict[str, int] = {}
        tids: Dict[Track, int] = {}
        meta: List[dict] = []

        def pid_of(cat: str) -> int:
            if cat not in cats:
                cats[cat] = len(cats) + 1
                meta.append({"ph": "M", "name": "process_name",
                             "pid": cats[cat], "tid": 0,
                             "args": {"name": cat}})
                try:
                    sort = self._PID_ORDER.index(cat)
                except ValueError:
                    sort = len(self._PID_ORDER)
                meta.append({"ph": "M", "name": "process_sort_index",
                             "pid": cats[cat], "tid": 0,
                             "args": {"sort_index": sort}})
            return cats[cat]

        def tid_of(track: Track) -> Tuple[int, int]:
            pid = pid_of(track[0])
            if track not in tids:
                tids[track] = len([t for t in tids if t[0] == track[0]]) + 1
                meta.append({"ph": "M", "name": "thread_name",
                             "pid": pid, "tid": tids[track],
                             "args": {"name": f"{track[0]} {track[1]}"}})
            return pid, tids[track]

        events: List[dict] = []
        for e in self._ring:
            pid, tid = tid_of(e.track)
            ts = e.tick * tick_us
            attrs = dict(e.attrs)
            if e.kind == "qdepth":
                events.append({"ph": "C", "name": "qdepth", "pid": pid,
                               "tid": tid, "ts": ts,
                               "args": {"depth": attrs.get("depth", 0)}})
            elif "dur" in attrs:
                dur = attrs.pop("dur")
                events.append({"ph": "X", "name": e.kind, "pid": pid,
                               "tid": tid, "ts": ts,
                               "dur": dur * tick_us, "args": attrs})
            else:
                events.append({"ph": "i", "name": e.kind, "pid": pid,
                               "tid": tid, "ts": ts, "s": "t",
                               "args": attrs})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"clock": "sim_ticks",
                              "tick_us": tick_us,
                              "events_dropped": self.dropped_events}}

    def chrome_trace_json(self, *, tick_us: int = 1) -> str:
        """Deterministic serialization: sorted keys, no whitespace
        variance — two identically seeded runs export byte-identical
        traces (tested)."""
        return json.dumps(self.chrome_trace(tick_us=tick_us),
                          sort_keys=True, separators=(",", ":"))

    def export_chrome_trace(self, path: str, *, tick_us: int = 1) -> int:
        """Write the Perfetto JSON to ``path``; returns event count."""
        blob = self.chrome_trace_json(tick_us=tick_us)
        with open(path, "w") as f:
            f.write(blob)
        return len(self._ring)


# ---------------------------------------------------------------------------
# Wiring helpers: plug the existing subsystems into a registry/recorder
# ---------------------------------------------------------------------------


def register_fabric(reg: MetricRegistry, fabric, prefix: str = "fabric"):
    """Register any of the port's netsim topologies (``Network`` /
    ``SwitchedFabric`` / ``ClosFabric``) under ``prefix`` — they all
    expose ``snapshot()``."""
    reg.register(prefix, fabric.snapshot)
    return reg


def register_node(reg: MetricRegistry, node, prefix: Optional[str] = None):
    """Register one port ``RdmaNode``'s combined surface: host-side
    ``NodeStats``, the engine-carried per-QP counter totals (harvested
    at snapshot time — the epoch boundary, the only host sync they ever
    cost), flow control, RX credits and the retransmission buffer."""
    p = prefix if prefix is not None else f"node{node.node_id}"
    reg.register(p, node.snapshot)
    return reg


def register_recorder(reg: MetricRegistry, rec: FlightRecorder,
                      prefix: str = "flight"):
    reg.register(prefix, rec.snapshot)
    return reg


def instrument(fabric=None, nodes=(), recorder: Optional[FlightRecorder] = None,
               registry: Optional[MetricRegistry] = None
               ) -> Tuple[MetricRegistry, FlightRecorder]:
    """One-call observability: attach a flight recorder to the fabric
    and every node, register all their stats surfaces (plus the
    recorder itself) into a registry, and return ``(registry,
    recorder)``.  Takes the port's fabrics and ``RdmaNode``s (anything
    with ``attach_recorder`` and ``snapshot``).  The canonical setup:

        reg, rec = instrument(fabric=res.fabric,
                              nodes=[res.receiver] + res.senders)
    """
    rec = recorder if recorder is not None else FlightRecorder()
    reg = registry if registry is not None else MetricRegistry()
    if fabric is not None:
        fabric.attach_recorder(rec)
        register_fabric(reg, fabric)
    for node in nodes:
        node.attach_recorder(rec)
        register_node(reg, node)
    register_recorder(reg, rec)
    return reg, rec
