"""Request-level trace spans: host-side, bounded, Perfetto-loadable
(mirrors ``accelerate_tpu/telemetry/spans.py``, standard library only).

A :class:`SpanRecorder` is a fixed-capacity ring buffer of trace events
recorded at hook points the engine and scheduler already own: no added
device syncs.  Every timestamp is host-side (``time.perf_counter`` by
default, or an injected :class:`VirtualClock` so tests pin deterministic
traces).  Export is Chrome trace-event JSON (``chrome://tracing`` /
Perfetto) or JSONL; :func:`validate_chrome_trace` checks the schema.  The
recorder measures its own cost (``overhead_s``).

:class:`RequestTracer` layers the serving taxonomy on top: per-request
lifecycle spans (submit -> admit -> prefill chunks -> decode -> evict /
readmit -> adapter swap -> retire) driven off the scheduler's event log,
and per-tick phase spans (scheduler decision, device dispatch, host sync)
recorded by the engine tick (``ServingEngine.enable_tracing``).
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional

# Chrome trace-event phases this recorder emits: complete, instant, metadata
_VALID_PHASES = frozenset({"X", "i", "I", "B", "E", "M", "C"})


class VirtualClock:
    """Deterministic clock: each call advances by ``step`` (virtual
    microseconds by convention — the exported ``ts`` values are then exact
    integers, so same trace + same hooks => byte-identical export)."""

    def __init__(self, step: float = 1.0, start: float = 0.0):
        self.step = float(step)
        self.now = float(start)

    def __call__(self) -> float:
        self.now += self.step
        return self.now


class SpanRecorder:
    """Bounded ring buffer of trace events.

    Events are stored as plain tuples ``(ph, name, cat, track, ts, dur,
    args)`` with ``ts``/``dur`` in *seconds* on the recorder's clock; the
    exporters scale to Chrome's microseconds.  When the ring wraps, the
    oldest events drop and ``dropped`` counts them — a long serve never
    grows host memory with trace state (the always-on contract).
    """

    def __init__(self, capacity: int = 4096,
                 clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True, process_name: str = "accelerate_tpu"):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self.clock = clock if clock is not None else time.perf_counter
        self.enabled = enabled
        self.process_name = process_name
        self.dropped = 0
        self.recorded = 0
        self.overhead_s = 0.0

    # -- recording ----------------------------------------------------------

    def _push(self, event: tuple) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(event)
        self.recorded += 1

    def complete(self, name: str, track: str, start: float,
                 end: Optional[float] = None, cat: str = "", **args) -> None:
        """One Chrome ``"X"`` (complete) event: ``[start, end)`` on
        ``track``.  ``end`` defaults to now."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        if end is None:
            end = self.clock()
        self._push(("X", name, cat, track, start, max(0.0, end - start), args or None))
        self.overhead_s += time.perf_counter() - t0

    def instant(self, name: str, track: str, cat: str = "", **args) -> None:
        if not self.enabled:
            return
        t0 = time.perf_counter()
        self._push(("i", name, cat, track, self.clock(), 0.0, args or None))
        self.overhead_s += time.perf_counter() - t0

    @contextmanager
    def span(self, name: str, track: str, cat: str = "", **args):
        """Context-manager form of :meth:`complete`."""
        if not self.enabled:
            yield
            return
        start = self.clock()
        try:
            yield
        finally:
            self.complete(name, track, start, cat=cat, **args)

    def stamp(self) -> float:
        """A timestamp on the recorder's clock (0.0 when disabled — callers
        pair it with :meth:`complete`, which is also a no-op then)."""
        return self.clock() if self.enabled else 0.0

    # -- queries / export ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> list[tuple]:
        return list(self._events)

    def overhead_frac(self, wall_s: float) -> float:
        """Share of ``wall_s`` spent inside record calls — the measured
        ``telemetry_overhead_frac`` bench.py reports."""
        if wall_s <= 0:
            return 0.0
        return round(min(1.0, self.overhead_s / wall_s), 6)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0
        self.recorded = 0
        self.overhead_s = 0.0

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto/``chrome://tracing``
        loadable): one ``{"traceEvents": [...]}`` with ``X``/``i`` events,
        tracks mapped to thread names via ``M`` metadata events.  Timestamps
        scale seconds -> microseconds."""
        tracks: dict[str, int] = {}
        events: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "ts": 0, "args": {"name": self.process_name},
        }]
        rows: list[dict] = []
        for ph, name, cat, track, ts, dur, args in self._events:
            tid = tracks.setdefault(track, len(tracks) + 1)
            ev = {
                "ph": ph, "name": name, "pid": 0, "tid": tid,
                "ts": round(ts * 1e6, 3),
            }
            if cat:
                ev["cat"] = cat
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = args
            rows.append(ev)
        for track, tid in tracks.items():
            events.append({
                "ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                "ts": 0, "args": {"name": track},
            })
        events.extend(rows)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def write_jsonl(self, path) -> None:
        """One JSON object per event (the raw-events sink; the Chrome
        export is the human-facing one)."""
        with open(path, "w") as f:
            for ph, name, cat, track, ts, dur, args in self._events:
                f.write(json.dumps({
                    "ph": ph, "name": name, "cat": cat, "track": track,
                    "ts": ts, "dur": dur, "args": args or {},
                }) + "\n")


def validate_chrome_trace(trace: dict) -> list[str]:
    """Schema check against the Chrome trace-event format (the subset this
    recorder emits).  Returns a list of problems — empty means valid; the
    multichip dryrun ``_telemetry_leg`` gates on that."""
    problems: list[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a 'traceEvents' array"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PHASES:
            problems.append(f"event {i}: bad phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"event {i}: missing name")
        for field in ("pid", "tid", "ts"):
            if not isinstance(ev.get(field), (int, float)):
                problems.append(f"event {i}: missing numeric {field!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: 'X' event needs dur >= 0")
        ts = ev.get("ts")
        if isinstance(ts, (int, float)) and ts < 0:
            problems.append(f"event {i}: negative ts")
        args = ev.get("args")
        if args is not None:
            try:
                json.dumps(args)
            except (TypeError, ValueError):
                problems.append(f"event {i}: args not JSON-serializable")
    return problems


class RequestTracer:
    """The serving-span taxonomy over a :class:`SpanRecorder`.

    **Per-request track** (``req <uid>``): ``queued`` span (submit ->
    admit; re-emitted as the readmit wait after an eviction), ``admit``/
    ``evict``/``retire`` instants, one ``prefill_chunk`` span per chunk
    (bracketing the chunk's real dispatch+sync window), one ``decode`` span
    from prefill completion to retirement, ``adapter_swap`` instants when
    admission hot-swapped the tenant's adapter in, and the overload-control
    retirements: a ``shed`` instant (admission-control drop, with its
    reason — queue / kv_pressure / deadline / overload) or a ``cancel``
    instant (any-stage retirement, with the stage it struck at and the
    reason — an explicit cancel or a deadline miss).

    **Per-step track** (``engine``): ``schedule`` (admission + the
    scheduler decision), ``dispatch:<kind>`` (the device program call —
    async, so this is host dispatch time), ``host_sync`` (the token
    fetch), and ``ladder`` instants marking degradation-ladder stage
    transitions.  All host-side: the engine's device programs are
    untouched.
    """

    def __init__(self, capacity: int = 4096,
                 clock: Optional[Callable[[], float]] = None):
        self.recorder = SpanRecorder(capacity=capacity, clock=clock)
        self._events_seen = 0      # scheduler event-log cursor
        self._submit_ts: dict[int, float] = {}
        self._decode_start: dict[int, float] = {}

    # engine tick hooks --------------------------------------------------

    def stamp(self) -> float:
        return self.recorder.stamp()

    def phase(self, name: str, start: float, end: Optional[float] = None,
              **args) -> None:
        self.recorder.complete(name, "engine", start, end, cat="step", **args)

    def consume_scheduler_events(self, events: list, step: int,
                                 window: Optional[tuple] = None) -> None:
        """Translate the scheduler's deterministic event log (everything
        appended since the last call) into lifecycle spans.  ``window`` is
        the ``(start, end)`` of this tick's device work — prefill-chunk
        spans reuse it so chunk durations are the real dispatch+sync time."""
        rec = self.recorder
        if not rec.enabled:
            self._events_seen = len(events)
            return
        now = rec.clock()
        w0, w1 = window if window is not None else (now, now)
        for ev in list(events)[self._events_seen:]:
            kind = ev[0]
            if kind == "submit":
                uid = ev[1]
                self._submit_ts[uid] = now
                rec.instant("submit", f"req {uid}", cat="request", step=step)
            elif kind == "admit":
                uid, slot = ev[1], ev[2]
                start = self._submit_ts.pop(uid, now)
                rec.complete("queued", f"req {uid}", start, now,
                             cat="request", step=step, slot=slot)
                rec.instant("admit", f"req {uid}", cat="request",
                            step=step, slot=slot)
            elif kind == "swap":
                tid, slot = ev[1], ev[2]
                rec.instant("adapter_swap", "engine", cat="adapter",
                            adapter_id=tid, pool_slot=slot, step=step)
            elif kind == "bypass":
                rec.instant("bypass", "engine", cat="schedule",
                            admitted_uid=ev[1], blocked_head_uid=ev[2],
                            step=step)
            elif kind == "prefill":
                uid, slot, prefilled = ev[1], ev[2], ev[3]
                rec.complete("prefill_chunk", f"req {uid}", w0, w1,
                             cat="request", step=step, slot=slot,
                             prefilled=prefilled)
                self._decode_start.setdefault(uid, w1)
            elif kind == "verify":
                # speculative draft-and-verify pass: per-slot accepted draft
                # counts (the dispatch:verify phase span carries the timing;
                # this instant carries the acceptance outcome)
                rec.instant("verify", "engine", cat="schedule",
                            accepted=[list(p) for p in ev[1]], step=step)
            elif kind == "evict":
                uid = ev[1]
                rec.instant("evict", f"req {uid}", cat="request", step=step)
                # the readmit wait is the next queued span
                self._submit_ts[uid] = now
                self._decode_start.pop(uid, None)
            elif kind == "shed":
                uid, reason = ev[1], ev[2]
                rec.instant("shed", f"req {uid}", cat="request", step=step,
                            reason=reason)
                self._submit_ts.pop(uid, None)
            elif kind == "cancel":
                uid, stage, reason = ev[1], ev[2], ev[3]
                start = self._decode_start.pop(uid, None)
                if start is not None:
                    # close the open decode span at the cancellation point
                    rec.complete("decode", f"req {uid}", start, now,
                                 cat="request", step=step)
                rec.instant("cancel", f"req {uid}", cat="request", step=step,
                            stage=stage, reason=reason)
                self._submit_ts.pop(uid, None)
            elif kind == "ladder":
                rec.instant("ladder", "engine", cat="overload", stage=ev[1],
                            step=step)
            elif kind == "prefix_hit":
                # admission mapped a cached prefix: hit_tokens of prefill
                # skipped (the COW share boundary for this request)
                rec.instant("prefix_hit", f"req {ev[1]}", cat="prefix",
                            hit_tokens=ev[2], step=step)
            elif kind == "cow_fork":
                rec.instant("cow_fork", f"req {ev[1]}", cat="prefix",
                            step=step)
            elif kind == "prefix_evict":
                rec.instant("prefix_evict", "engine", cat="prefix",
                            page=ev[1], step=step)
            elif kind == "prefix_flush":
                rec.instant("prefix_flush", "engine", cat="prefix",
                            pages_freed=ev[1], step=step)
            elif kind == "page_transfer":
                # the disaggregation handoff: one request's KV pages
                # streamed prefill -> decode
                rec.instant("page_transfer", f"req {ev[1]}", cat="transfer",
                            pages=ev[2], bytes=ev[3], step=step)
            elif kind == "finish":
                uid = ev[1]
                start = self._decode_start.pop(uid, now)
                rec.complete("decode", f"req {uid}", start, now,
                             cat="request", step=step)
                rec.instant("retire", f"req {uid}", cat="request", step=step)
                self._submit_ts.pop(uid, None)
        self._events_seen = len(events)

    # export --------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        return self.recorder.to_chrome_trace()

    def write_chrome_trace(self, path) -> None:
        self.recorder.write_chrome_trace(path)

    def write_jsonl(self, path) -> None:
        self.recorder.write_jsonl(path)
