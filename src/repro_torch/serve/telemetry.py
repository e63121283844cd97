"""Zero-device-sync tracing + unified metrics for the serving stack (a
copy of ``repro/serve/telemetry.py``, numpy only).

Two cooperating pieces, both pure host-side (no jax imports, no device
syncs — everything is stamped with monotonic clocks at dispatch
boundaries that already exist):

* :class:`MetricsRegistry` — a single namespace of :class:`Counter` /
  :class:`Gauge` / :class:`Histogram` instruments.  ``ServeStats`` /
  ``DisaggStats`` / ``TransportStats`` are *views* built over registries
  (``repro_torch.serve.scheduler``, ``repro_torch.serve.disagg``,
  ``repro_torch.serve.transport``); byte-flow metering — LinkModel link
  bytes, weight-HBM bytes, PageCache tier traffic — lands in the same
  namespace.  ``snapshot()`` emits a versioned, JSON-serializable dict
  (the ``METRICS`` RPC payload of ``repro_torch.serve.net``), and
  :meth:`MetricsRegistry.merge` folds per-replica snapshots into fleet
  totals (counters sum, gauges aggregate per their hint, histogram
  values concatenate).

* :class:`Tracer` — per-request lifecycle spans::

      submit -> queue -> admit(bucket, shared/cold/warm/snapshot)
             -> replay -> [export -> wire -> import]
             -> decode windows -> finish(stop_reason)

  recorded as *complete* events ("ph": "X") with ``perf_counter_ns``
  timestamps, exportable as Chrome trace-event JSON (Perfetto-loadable)
  via :meth:`Tracer.to_chrome_trace`.  A disabled tracer (the default)
  turns every call into an early-out no-op, so the decode hot loop pays
  nothing when telemetry is off.

Span addressing: ``pid`` is an engine name (``serve``, ``prefill0``,
``decode1`` — mapped to integer pids with ``process_name`` metadata on
export); ``tid`` 0 is the engine lane (admission batches, replay and
decode windows, cache-tier traffic), and request spans live on
``tid = uid + 1`` with the uid repeated in ``args``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

SNAPSHOT_VERSION = 1

# tid of the per-engine lane (dispatch-scoped spans); request spans use
# uid + 1 so uid 0 never collides with the lane
ENGINE_LANE = 0


# ---------------------------------------------------------------------------
# shared stats helpers (the dedup target: ServeStats / DisaggStats /
# TransportStats each hand-rolled these)
# ---------------------------------------------------------------------------


def summarize_latencies(values: Sequence[float]) -> Dict[str, float]:
    """mean/p50/p95 of a latency sample, 0.0 on empty — the one
    percentile helper behind every stats dataclass in the serving
    stack."""
    lats = sorted(float(v) for v in values)
    if not lats:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0}
    return {"mean": float(np.mean(lats)),
            "p50": float(np.percentile(lats, 50)),
            "p95": float(np.percentile(lats, 95))}


def sum_counters(dicts: Iterable[Dict[str, Any]],
                 keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Fold per-replica counter dicts into totals (fleet aggregation)."""
    dicts = list(dicts)
    if keys is None:
        keys = sorted({k for d in dicts for k in d})
    out: Dict[str, Any] = {}
    for k in keys:
        out[k] = sum(d.get(k, 0) for d in dicts)
    return out


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic-ish numeric cell (int or float).  ``set`` exists so
    stats views can refresh absolute values from loop state."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v


class Gauge:
    """Point-in-time value with a fleet-merge hint: ``sum`` (e.g. live
    slots), ``max`` (e.g. peak pages — every replica reports its own
    peak), or ``last``."""

    __slots__ = ("name", "value", "agg")

    def __init__(self, name: str, agg: str = "sum"):
        if agg not in ("sum", "max", "last"):
            raise ValueError(f"unknown gauge agg {agg!r}")
        self.name = name
        self.value = 0
        self.agg = agg

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Raw-sample histogram (latency distributions are small here:
    one value per request / dispatch, not per token)."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def set_values(self, values: Sequence[float]) -> None:
        self.values = [float(v) for v in values]

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def summary(self) -> Dict[str, float]:
        return summarize_latencies(self.values)

    def percentile(self, q: float) -> float:
        return (float(np.percentile(sorted(self.values), q))
                if self.values else 0.0)


class MetricsRegistry:
    """Get-or-create namespace of instruments.  Names are dotted
    (``serve.*``, ``cache.*``, ``weights.*``, ``transport.*``,
    ``link.*``, ``latency.*``); a name is bound to one instrument kind
    for the registry's lifetime."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name, **kw)
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"requested {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, agg: str = "sum") -> Gauge:
        return self._get(name, Gauge, agg=agg)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def value(self, name: str, default=0):
        m = self._metrics.get(name)
        return default if m is None or isinstance(m, Histogram) else m.value

    def values_of(self, name: str) -> List[float]:
        m = self._metrics.get(name)
        return list(m.values) if isinstance(m, Histogram) else []

    def snapshot(self) -> Dict[str, Any]:
        """Versioned, JSON-serializable dump — the METRICS RPC payload."""
        counters: Dict[str, Any] = {}
        gauges: Dict[str, Any] = {}
        hists: Dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                gauges[name] = {"value": m.value, "agg": m.agg}
            else:
                hists[name] = {"values": list(m.values)}
        return {"version": SNAPSHOT_VERSION, "counters": counters,
                "gauges": gauges, "hists": hists}

    def load(self, snap: Dict[str, Any]) -> "MetricsRegistry":
        """Populate this registry from a snapshot dict (inverse of
        :meth:`snapshot`; used on merged fleet totals)."""
        if snap.get("version") != SNAPSHOT_VERSION:
            raise ValueError(f"metrics snapshot v{snap.get('version')}, "
                             f"this side v{SNAPSHOT_VERSION}")
        for name, v in snap.get("counters", {}).items():
            self.counter(name).set(v)
        for name, g in snap.get("gauges", {}).items():
            self.gauge(name, agg=g.get("agg", "sum")).set(g["value"])
        for name, h in snap.get("hists", {}).items():
            self.histogram(name).set_values(h["values"])
        return self

    @staticmethod
    def merge(snapshots: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Fold per-replica snapshots into fleet totals: counters sum,
        gauges follow their agg hint, histogram samples concatenate."""
        out = {"version": SNAPSHOT_VERSION, "counters": {},
               "gauges": {}, "hists": {}}
        for snap in snapshots:
            if snap.get("version") != SNAPSHOT_VERSION:
                raise ValueError(
                    f"cannot merge metrics snapshot v{snap.get('version')} "
                    f"with v{SNAPSHOT_VERSION}")
            for name, v in snap.get("counters", {}).items():
                out["counters"][name] = out["counters"].get(name, 0) + v
            for name, g in snap.get("gauges", {}).items():
                cur = out["gauges"].get(name)
                if cur is None:
                    out["gauges"][name] = dict(g)
                elif g.get("agg", "sum") == "max":
                    cur["value"] = max(cur["value"], g["value"])
                elif g.get("agg", "sum") == "last":
                    cur["value"] = g["value"]
                else:
                    cur["value"] = cur["value"] + g["value"]
            for name, h in snap.get("hists", {}).items():
                cur = out["hists"].setdefault(name, {"values": []})
                cur["values"].extend(h["values"])
        return out


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Request-lifecycle span recorder.  All methods are no-ops when
    ``enabled`` is False; when on, each call is a dict append plus a
    ``perf_counter_ns`` read — never a device sync.

    Two layers of API:

    * ``emit`` / ``span_begin`` / ``span_end`` — raw complete-span
      plumbing for dispatch-scoped (engine-lane) events.
    * ``request_begin`` / ``stage`` / ``stage_end`` / ``request_end`` —
      per-uid lifecycle: one root ``request`` span per uid, with at most
      one open stage at a time (``stage`` auto-closes the previous one,
      ``request_end`` closes any straggler, so a request that finishes
      at admission still yields a well-nested tree).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._t0 = time.perf_counter_ns()
        self.events: List[Dict[str, Any]] = []
        # uid -> (t_start_ns, pid, args) of the open root span
        self._open_req: Dict[int, Any] = {}
        # uid -> (name, t_start_ns, pid, args) of the open stage
        self._open_stage: Dict[int, Any] = {}

    # -- clock -------------------------------------------------------------

    def now(self) -> int:
        """ns since tracer start; 0 when disabled (callers may stamp
        t0/t1 unconditionally around a dispatch)."""
        if not self.enabled:
            return 0
        return time.perf_counter_ns() - self._t0

    # -- raw spans ---------------------------------------------------------

    def emit(self, name: str, *, cat: str, pid: str, tid: int,
             t0: int, t1: int,
             args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span over [t0, t1] (ns, from :meth:`now`)."""
        if not self.enabled:
            return
        self.events.append({"name": name, "cat": cat, "pid": pid,
                            "tid": tid, "ts": t0, "dur": max(0, t1 - t0),
                            "args": dict(args or {})})

    def instant(self, name: str, *, cat: str, pid: str, tid: int,
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.emit(name, cat=cat, pid=pid, tid=tid, t0=self.now(),
                  t1=self.now(), args=args)

    # -- request lifecycle -------------------------------------------------

    def request_begin(self, uid: int, *, pid: str,
                      args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled or uid in self._open_req:
            return
        self._open_req[uid] = (self.now(), pid, dict(args or {}))

    def stage(self, uid: int, name: str, *, pid: Optional[str] = None,
              args: Optional[Dict[str, Any]] = None) -> None:
        """Open stage ``name`` for ``uid``, closing any previous stage
        at the same instant (stages are sequential per request)."""
        if not self.enabled or uid not in self._open_req:
            return
        now = self.now()
        self._close_stage(uid, now)
        if pid is None:
            pid = self._open_req[uid][1]
        self._open_stage[uid] = (name, now, pid, dict(args or {}))

    def stage_end(self, uid: int,
                  args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self._close_stage(uid, self.now(), args)

    def _close_stage(self, uid: int, t1: int,
                     args: Optional[Dict[str, Any]] = None) -> None:
        open_stage = self._open_stage.pop(uid, None)
        if open_stage is None:
            return
        name, t0, pid, st_args = open_stage
        if args:
            st_args.update(args)
        st_args.setdefault("uid", uid)
        self.emit(name, cat="stage", pid=pid, tid=uid + 1,
                  t0=t0, t1=t1, args=st_args)

    def request_span(self, uid: int, name: str, *, t0: int, t1: int,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """Complete span on a request's lane (decode windows, wire
        transfers measured around a call)."""
        if not self.enabled or uid not in self._open_req:
            return
        pid = self._open_req[uid][1]
        a = dict(args or {})
        a.setdefault("uid", uid)
        self.emit(name, cat="stage", pid=pid, tid=uid + 1,
                  t0=t0, t1=t1, args=a)

    def request_end(self, uid: int,
                    args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        open_req = self._open_req.pop(uid, None)
        if open_req is None:
            return
        now = self.now()
        self._close_stage(uid, now)
        t0, pid, req_args = open_req
        if args:
            req_args.update(args)
        req_args["uid"] = uid
        self.emit("request", cat="request", pid=pid, tid=uid + 1,
                  t0=t0, t1=now, args=req_args)

    def open_requests(self) -> List[int]:
        return sorted(self._open_req)

    # -- export ------------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}``
        object form): complete events with µs timestamps, plus
        ``process_name`` / ``thread_name`` metadata so Perfetto shows
        engine names and request lanes."""
        pids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = []
        seen_tids = set()
        for ev in self.events:
            pid = pids.setdefault(ev["pid"], len(pids) + 1)
            seen_tids.add((pid, ev["pid"], ev["tid"]))
            out.append({"name": ev["name"], "cat": ev["cat"], "ph": "X",
                        "ts": ev["ts"] / 1e3, "dur": ev["dur"] / 1e3,
                        "pid": pid, "tid": ev["tid"],
                        "args": ev["args"]})
        meta: List[Dict[str, Any]] = []
        for name, pid in pids.items():
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": name}})
        for pid, _, tid in sorted(seen_tids):
            label = ("engine" if tid == ENGINE_LANE
                     else f"req {tid - 1}")
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": label}})
        return {"traceEvents": meta + out,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
