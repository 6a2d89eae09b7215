"""Latency-breakdown summary over an exported trace (port of
``easyparallellibrary_tpu/observability/report.py``).

``python -m easyparallellibrary_tpu_torch.observability.report <trace.json>``
prints, without leaving the terminal for Perfetto:

* a **span table** — per span name: count, total/mean/p50/p99 duration
  and share of the trace's wall clock (where did the run's time go);
* **request timelines** — per serving request: queue wait, prefill
  time/chunks, decode steps, speculation drafted/accepted, TTFT,
  total latency and finish reason (where did THIS request's latency
  go); merged multi-process traces with front-door instrumentation
  add the hop decomposition — client-observed TTFT, ingress and wire
  columns (docs/observability.md "Distributed tracing");
* with ``--metrics <metrics.jsonl>``, the **fleet rollup** — the last
  ``serving/fleet/*`` record a multi-replica Router published through
  the registry (tokens/s summed, merged TTFT/ITL percentiles,
  shed/failover counters, replica state counts; docs/serving.md
  "Multi-replica serving");
* with ``--follow <metrics.jsonl>``, **tail mode** — re-render the
  fleet rollup and SLO status as records append, so a live
  ``make chaos-router`` run is watched AS the kill and failover happen
  instead of post-mortem.  ``--slo <slo_events.jsonl>`` adds the SLO
  monitor's breach/recovery stream (auto-detected when a sibling
  ``slo_events.jsonl`` exists); Ctrl-C exits cleanly.

Reads the Chrome-trace JSON the tracer exports (observability/trace.py)
— and nothing else; the report is a pure function of the artifact, so
it works on traces mailed in from another machine.  Unmatched B/E
events (a ring buffer that wrapped mid-span) are skipped and counted
rather than fatal — post-mortems read partial traces, and tail mode
reads mid-write files (partial trailing lines are left for the next
poll).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from easyparallellibrary_tpu_torch.observability.registry import (
    FLEET_NAMESPACE)
from easyparallellibrary_tpu_torch.profiler.serving import percentile


def load_events(path: str) -> List[Dict[str, Any]]:
  with open(path) as f:
    doc = json.load(f)
  return doc["traceEvents"] if isinstance(doc, dict) else doc


def pair_spans(events: List[Dict[str, Any]]
               ) -> Tuple[List[Dict[str, Any]], int]:
  """Match B/E pairs per (pid, tid) into completed spans
  ``{name, cat, ts, dur, pid, tid, args}``; returns (spans, unmatched).
  Merged multi-process traces (docs/observability.md "Distributed
  tracing") interleave pids, so the pid rides along — timeline
  containment checks must key on (pid, tid), not tid alone."""
  spans: List[Dict[str, Any]] = []
  unmatched = 0
  stacks: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
  for ev in sorted((e for e in events if e.get("ph") in ("B", "E")),
                   key=lambda e: e.get("ts", 0.0)):
    key = (ev.get("pid"), ev.get("tid"))
    stack = stacks.setdefault(key, [])
    if ev["ph"] == "B":
      stack.append(ev)
      continue
    if not stack or stack[-1]["name"] != ev.get("name", stack[-1]["name"]):
      unmatched += 1
      continue
    b = stack.pop()
    args = dict(b.get("args") or {})
    args.update(ev.get("args") or {})
    spans.append({"name": b["name"], "cat": b.get("cat", ""),
                  "ts": b["ts"], "dur": ev["ts"] - b["ts"],
                  "pid": key[0], "tid": key[1], "args": args})
  unmatched += sum(len(s) for s in stacks.values())
  return spans, unmatched


def span_table(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
  """Aggregate spans by name into count/total/mean/p50/p99 rows,
  sorted by total time descending."""
  by_name: Dict[str, List[float]] = {}
  for sp in spans:
    by_name.setdefault(sp["name"], []).append(sp["dur"])
  rows = []
  for name, durs in by_name.items():
    rows.append({
        "name": name, "count": len(durs), "total_us": sum(durs),
        "mean_us": sum(durs) / len(durs),
        "p50_us": percentile(durs, 50), "p99_us": percentile(durs, 99)})
  rows.sort(key=lambda r: -r["total_us"])
  return rows


def request_timelines(events: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
  """Per-request lifecycle rollup from the serving instrumentation:
  request spans (cat ``serving.request``), the prefill/decode/speculate
  chunk spans nested in them, and the submit/first_token instants —
  plus the resilience events (docs/robustness.md "Serving resilience"):
  per-uid requeue counts, and rows for requests that never reached a
  slot (shed at submit, expired or cancelled in the queue), whose whole
  story is an instant.

  On a merged multi-process trace with front-door instrumentation the
  rows also carry the hop decomposition (docs/observability.md
  "Distributed tracing"): ``ingress_us`` (front-door receipt to router
  submit), ``client_ttft_us`` (front-door receipt to first SSE byte —
  the latency the CLIENT observed) and ``wire_us`` (engine first token
  to first SSE byte: harvest-rebased wire + stream-delivery gap; small
  negatives are clock-offset noise and reported as-is)."""
  spans, _ = pair_spans(events)
  submits: Dict[str, float] = {}
  first_tokens: Dict[str, float] = {}
  fd_requests: Dict[str, float] = {}
  fd_first_bytes: Dict[str, float] = {}
  requeues: Dict[str, int] = {}
  # Requests resolved without ever holding a slot: uid -> (ts, reason).
  unadmitted: Dict[str, Tuple[float, str]] = {}
  for ev in events:
    if ev.get("ph") != "i":
      continue
    uid = (ev.get("args") or {}).get("uid")
    if uid is None:
      continue
    uid = str(uid)
    name = ev.get("name")
    if name == "serving/submit":
      submits[uid] = ev["ts"]
    elif name == "serving/first_token":
      first_tokens[uid] = ev["ts"]
    elif name == "serving/requeue":
      requeues[uid] = requeues.get(uid, 0) + 1
    elif name == "frontdoor/request":
      fd_requests[uid] = ev["ts"]
    elif name == "frontdoor/first_byte":
      fd_first_bytes[uid] = ev["ts"]
    elif name == "serving/shed":
      unadmitted[uid] = (ev["ts"], "shed")
    elif name in ("serving/deadline", "serving/cancelled"):
      # Emitted only for queue-side retirement (args.where == "queue");
      # slot-side expiry/cancellation ends the request span instead.
      unadmitted[uid] = (ev["ts"], name.split("/", 1)[1])
  requests = []
  for req in (s for s in spans if s["cat"] == "serving.request"):
    uid = str(req["args"].get("uid", req["name"]))
    t0, t1 = req["ts"], req["ts"] + req["dur"]
    inner = [s for s in spans
             if s["pid"] == req["pid"] and s["tid"] == req["tid"]
             and s["name"] != req["name"]
             and t0 <= s["ts"] and s["ts"] + s["dur"] <= t1 + 1e-9]
    phase_us = {ph: sum(s["dur"] for s in inner if s["name"] == ph)
                for ph in ("prefill", "decode", "speculate")}
    drafted = sum(s["args"].get("drafted", 0) for s in inner
                  if s["name"] == "speculate")
    accepted = sum(s["args"].get("accepted", 0) for s in inner
                   if s["name"] == "speculate")
    # Paged engine: each per-step span carries the slot's block count
    # (engine._trace_slot_spans); the request's peak is its KV
    # footprint high-water mark in blocks.  0 on a contiguous engine.
    kv_blocks_peak = max(
        (s["args"].get("kv_blocks", 0) for s in inner), default=0)
    submit = submits.get(uid)
    ttft = first_tokens.get(uid)
    fd_req = fd_requests.get(uid)
    fd_byte = fd_first_bytes.get(uid)
    requests.append({
        "uid": uid,
        "queue_wait_us": (t0 - submit) if submit is not None else None,
        "ingress_us": (submit - fd_req)
                      if None not in (submit, fd_req) else None,
        "client_ttft_us": (fd_byte - fd_req)
                          if None not in (fd_byte, fd_req) else None,
        "wire_us": (fd_byte - first_tokens[uid])
                   if fd_byte is not None and uid in first_tokens
                   else None,
        "admitted_ts_us": t0,
        "total_us": req["dur"],
        "ttft_us": (ttft - (submit if submit is not None else t0))
                   if ttft is not None else None,
        "prefill_us": phase_us["prefill"],
        "prefill_chunks": sum(1 for s in inner if s["name"] == "prefill"),
        "decode_steps": sum(1 for s in inner
                            if s["name"] in ("decode", "speculate")),
        "decode_us": phase_us["decode"] + phase_us["speculate"],
        "drafted": drafted, "accepted": accepted,
        "kv_blocks_peak": kv_blocks_peak,
        # Blocks mapped by reference from the prefix cache at admission
        # (scheduler._admit stamps the request span).  0 without the
        # cache — the column stays hidden below.
        "blk_reused": req["args"].get("prefix_blocks_reused", 0),
        "new_tokens": req["args"].get("new_tokens"),
        "finish_reason": req["args"].get("finish_reason"),
        "requeues": requeues.get(uid, 0),
    })
  # A requeued request's queue-side resolution (expiry/cancel) — or a
  # shed — is an instant, not a span end; requests that DID end in a
  # slot already carry their final reason above.
  resolved_in_slot = {r["uid"] for r in requests
                      if r["finish_reason"] not in (None, "requeued")}
  for uid, (ts, reason) in unadmitted.items():
    if uid in resolved_in_slot:
      continue
    submit = submits.get(uid)
    fd_req = fd_requests.get(uid)
    requests.append({
        "uid": uid,
        "queue_wait_us": (ts - submit) if submit is not None else None,
        "ingress_us": (submit - fd_req)
                      if None not in (submit, fd_req) else None,
        "client_ttft_us": None, "wire_us": None,
        "admitted_ts_us": ts,
        "total_us": None, "ttft_us": None,
        "prefill_us": 0.0, "prefill_chunks": 0,
        "decode_steps": 0, "decode_us": 0.0,
        "drafted": 0, "accepted": 0, "kv_blocks_peak": 0,
        "blk_reused": 0,
        "new_tokens": None, "finish_reason": reason,
        "requeues": requeues.get(uid, 0),
    })
  requests.sort(key=lambda r: r["admitted_ts_us"])
  return requests


def _fmt_us(us: Optional[float]) -> str:
  if us is None:
    return "-"
  return f"{us / 1e3:.2f}ms" if us >= 1e3 else f"{us:.0f}us"


def fleet_rollup(metrics_path: str) -> Optional[Dict[str, Any]]:
  """The LAST ``serving/fleet/*`` record in a registry-written metrics
  JSONL (one ``{"step", "time", **namespaced_keys}`` object per line),
  with the namespace prefix stripped — or None when the file holds no
  fleet record.  Lenient to trailing partial lines (a live server's
  sink may be mid-write) — post-mortems read partial logs."""
  prefix = FLEET_NAMESPACE + "/"
  last: Optional[Dict[str, Any]] = None
  try:
    with open(metrics_path) as f:
      for line in f:
        try:
          rec = json.loads(line)
        except ValueError:
          continue
        if not isinstance(rec, dict):
          continue  # a truncated line can still parse (e.g. a number)
        fleet = {k[len(prefix):]: v for k, v in rec.items()
                 if k.startswith(prefix)}
        if fleet:
          fleet["step"] = rec.get("step")
          last = fleet
  except OSError:
    return None
  return last


def format_fleet(fleet: Dict[str, Any]) -> str:
  """Render one fleet rollup as a compact block (keys grouped:
  throughput / latency / resolution / control plane)."""
  def g(key, default=0.0):
    return fleet.get(key, default)

  lines = [
      f"fleet rollup (step {fleet.get('step', '-')}): "
      f"{g('replicas'):.0f} replica(s) — "
      f"{g('replicas_healthy'):.0f} healthy, "
      f"{g('replicas_suspect'):.0f} suspect, "
      f"{g('replicas_down'):.0f} down, "
      f"{g('replicas_draining'):.0f} draining",
      f"  throughput: {g('tokens_per_s'):.1f} tok/s summed, "
      f"{g('finished_requests'):.0f} finished, "
      f"{g('generated_tokens'):.0f} tokens, "
      f"occupancy {g('slot_occupancy_mean'):.2f}",
      f"  latency:    ttft p50 {g('ttft_p50_s') * 1e3:.1f}ms "
      f"p99 {g('ttft_p99_s') * 1e3:.1f}ms, "
      f"itl p50 {g('itl_p50_s') * 1e3:.2f}ms "
      f"p99 {g('itl_p99_s') * 1e3:.2f}ms (merged raw samples)",
      f"  resolution: shed {g('shed'):.0f} (+{g('router_shed'):.0f} at "
      f"router), deadline {g('deadline_expired'):.0f}, "
      f"cancelled {g('cancelled'):.0f}, failed {g('failed'):.0f}",
      f"  control:    failovers {g('failovers'):.0f}, "
      f"migrated {g('migrated_requests'):.0f}, "
      f"probes {g('probes'):.0f}, parked {g('parked'):.0f}, "
      f"scale-ups {g('scale_ups'):.0f} "
      f"(-{g('scale_downs'):.0f} down), "
      f"requeues {g('requeues'):.0f}, "
      f"preemptions {g('preemptions'):.0f} "
      f"(+{g('proactive_preemptions'):.0f} proactive), "
      f"recompiles {g('recompiles'):.0f}",
  ]
  return "\n".join(lines)


class FollowState:
  """Incremental tail over a registry metrics JSONL (and optionally the
  SLO monitor's ``slo_events.jsonl``): each :meth:`poll` consumes only
  the bytes appended since the last one — COMPLETE lines only, a
  partial trailing line (the sink may be mid-write) waits for the next
  poll — and returns a rendered status block when anything changed,
  else None.  Pure state machine, no sleeping: :func:`follow` owns the
  loop so tests can drive polls directly."""

  def __init__(self, metrics_path: str, slo_path: Optional[str] = None):
    self.metrics_path = metrics_path
    self.slo_path = slo_path
    self._offsets: Dict[str, int] = {}
    self.records = 0
    self.last_step: Optional[int] = None
    self.last_fleet: Optional[Dict[str, Any]] = None
    self.slo_breaches = 0
    # rule@metric -> last breach/recover event (current stream state;
    # bounded — a follow session is meant to run for days, so it keeps
    # state per RULE STREAM, never per event).
    self.slo_state: Dict[str, Dict[str, Any]] = {}
    # Self-healing actuations (serving/autotune.py / autoscale.py write
    # "actuation" events into the same stream): total count plus the
    # last few, so operators watch the control loop CLOSE — breach,
    # knob moved old->new, recovery — in one panel.  Bounded like
    # slo_state: a days-long follow keeps a tail, never every event.
    self.actuation_count = 0
    self.actuations: Deque[Dict[str, Any]] = deque(maxlen=4)
    self._polls = 0

  def _read_new_lines(self, path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
      with open(path, "rb") as f:
        offset = self._offsets.get(path, 0)
        size = os.fstat(f.fileno()).st_size
        if size < offset:
          # The file shrank: truncated or rotated under us.  Restart
          # from the top rather than seeking past EOF and going
          # permanently silent.
          offset = self._offsets[path] = 0
        f.seek(offset)
        chunk = f.read()
    except OSError:
      return out
    consumed = chunk.rfind(b"\n") + 1  # whole lines only
    if consumed <= 0:
      return out
    self._offsets[path] = self._offsets.get(path, 0) + consumed
    for line in chunk[:consumed].splitlines():
      try:
        rec = json.loads(line)
      except ValueError:
        continue
      if isinstance(rec, dict):
        out.append(rec)
    return out

  def poll(self) -> Optional[str]:
    changed = False
    prefix = FLEET_NAMESPACE + "/"
    for rec in self._read_new_lines(self.metrics_path):
      self.records += 1
      changed = True
      self.last_step = rec.get("step", self.last_step)
      fleet = {k[len(prefix):]: v for k, v in rec.items()
               if k.startswith(prefix)}
      if fleet:
        fleet["step"] = rec.get("step")
        self.last_fleet = fleet
    if self.slo_path:
      for ev in self._read_new_lines(self.slo_path):
        changed = True
        if ev.get("event") == "actuation":
          self.actuation_count += 1
          self.actuations.append(ev)
          continue
        self.slo_breaches += ev.get("event") == "breach"
        key = f"{ev.get('rule', '?')}@{ev.get('metric', '-')}"
        self.slo_state[key] = ev
    self._polls += 1
    if not changed and self._polls > 1:
      return None
    return self.render()

  def render(self) -> str:
    last = self.last_step if self.last_step is not None else "-"
    lines = [f"--- {time.strftime('%H:%M:%S')}  {self.records} "
             f"record(s), last step {last}"]
    if self.last_fleet is not None:
      lines.append(format_fleet(self.last_fleet))
    else:
      lines.append("(no serving/fleet/* record yet)")
    if self.slo_path:
      if not self.slo_state:
        lines.append("SLO: no events")
      else:
        parts = []
        for key, ev in sorted(self.slo_state.items()):
          state = "BREACH" if ev.get("event") == "breach" else "ok"
          detail = ""
          if "value" in ev:
            detail = f" (value {ev['value']:.4g} vs {ev.get('target')})"
          elif "fast_burn" in ev:
            detail = f" (burn {ev['fast_burn']:.2g}x)"
          parts.append(f"{key}: {state}{detail}")
        lines.append(f"SLO [{self.slo_breaches} breach event(s)]: "
                     + "; ".join(parts))
      if self.actuation_count:
        lines.append(
            f"actuations [{self.actuation_count} total]: "
            + "; ".join(self._fmt_actuation(ev)
                        for ev in self.actuations))
    return "\n".join(lines)

  @staticmethod
  def _fmt_actuation(ev: Dict[str, Any]) -> str:
    """One actuation as ``actor: knob old->new (rule)`` — the knob
    moved, its old and new value, and the breach that triggered it."""
    actor = ev.get("actuator", ev.get("rule", "?"))
    rule = ev.get("rule", "?")
    knobs = ev.get("knobs") or {}
    moves = [f"{k} {v[0]}->{v[1]}" for k, v in sorted(knobs.items())
             if isinstance(v, (list, tuple)) and len(v) == 2]
    if not moves and "from_level" in ev:
      moves = [f"level {ev['from_level']}->{ev['to_level']}"]
    if not moves and "action" in ev:
      moves = [f"{ev['action']} replica {ev.get('replica', '?')}"]
    if not moves and "transition" in ev:
      # Blue/green rollout transitions (serving/rollout.py).
      moves = [f"{ev['transition']} v{ev.get('blue_version', '?')}"
               f"->v{ev.get('green_version', '?')}"]
    return f"{actor}: {', '.join(moves) or ev.get('action', '?')} " \
           f"(rule {rule})"


def follow(metrics_path: str, slo_path: Optional[str] = None,
           interval_s: float = 2.0, max_polls: int = 0,
           out=None) -> FollowState:
  """Tail loop over :class:`FollowState` (``report.py --follow``):
  re-print the fleet rollup + SLO status whenever records append.
  ``max_polls`` bounds the loop (0 = until Ctrl-C); returns the final
  state for callers that inspect it."""
  out = out if out is not None else print
  state = FollowState(metrics_path, slo_path)
  polls = 0
  try:
    while True:
      block = state.poll()
      if block is not None:
        out(block)
      polls += 1
      if max_polls and polls >= max_polls:
        break
      time.sleep(interval_s)
  except KeyboardInterrupt:
    pass
  return state


def format_report(events: List[Dict[str, Any]]) -> str:
  spans, unmatched = pair_spans(events)
  lines: List[str] = []
  wall = 0.0
  if spans:
    wall = max(s["ts"] + s["dur"] for s in spans) - \
        min(s["ts"] for s in spans)
  lines.append(f"{len(events)} events, {len(spans)} spans over "
               f"{_fmt_us(wall)} wall clock"
               + (f" ({unmatched} unmatched B/E skipped)"
                  if unmatched else ""))
  lines.append("")
  lines.append(f"{'span':<28}{'count':>7}{'total':>11}{'mean':>10}"
               f"{'p50':>10}{'p99':>10}{'share':>8}")
  for row in span_table(spans):
    share = row["total_us"] / wall if wall else 0.0
    lines.append(
        f"{row['name']:<28}{row['count']:>7}"
        f"{_fmt_us(row['total_us']):>11}{_fmt_us(row['mean_us']):>10}"
        f"{_fmt_us(row['p50_us']):>10}{_fmt_us(row['p99_us']):>10}"
        f"{share:>7.1%}")
  requests = request_timelines(events)
  if requests:
    lines.append("")
    # The blk column (peak KV blocks held) only appears when any request
    # actually ran paged — a contiguous-engine trace keeps its old shape.
    paged = any(r["kv_blocks_peak"] for r in requests)
    # Same shape-preservation rule for blk-reused: it only appears when
    # the prefix cache actually mapped shared blocks into some request.
    reuse = any(r["blk_reused"] for r in requests)
    # Hop columns (fd-ttft = client-observed TTFT, wire = engine first
    # token -> first SSE byte) only appear when the trace actually
    # carries front-door instants — an engine-only trace keeps its
    # old shape.
    hops = any(r["client_ttft_us"] is not None
               or r["ingress_us"] is not None for r in requests)
    lines.append(f"{'request':<12}{'wait':>9}{'ttft':>10}"
                 + (f"{'fd-ttft':>9}{'ingress':>9}{'wire':>9}"
                    if hops else "")
                 + f"{'prefill':>10}"
                 f"{'chunks':>7}{'decode':>10}{'steps':>6}{'drafted':>8}"
                 f"{'accepted':>9}{'rq':>4}"
                 + (f"{'blk':>5}" if paged else "")
                 + (f"{'blk-reused':>11}" if reuse else "")
                 + f"{'total':>10}  finish")
    for r in requests:
      lines.append(
          f"{r['uid']:<12}{_fmt_us(r['queue_wait_us']):>9}"
          f"{_fmt_us(r['ttft_us']):>10}"
          + (f"{_fmt_us(r['client_ttft_us']):>9}"
             f"{_fmt_us(r['ingress_us']):>9}"
             f"{_fmt_us(r['wire_us']):>9}" if hops else "")
          + f"{_fmt_us(r['prefill_us']):>10}"
          f"{r['prefill_chunks']:>7}{_fmt_us(r['decode_us']):>10}"
          f"{r['decode_steps']:>6}{r['drafted']:>8}{r['accepted']:>9}"
          f"{r['requeues']:>4}"
          + (f"{r['kv_blocks_peak']:>5}" if paged else "")
          + (f"{r['blk_reused']:>11}" if reuse else "")
          + f"{_fmt_us(r['total_us']):>10}"
          f"  {r['finish_reason'] or '-'}")
  counters = sorted({e["name"] for e in events if e.get("ph") == "C"})
  if counters:
    lines.append("")
    lines.append("counter tracks: " + ", ".join(counters))
  return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.observability.report",
      description="Latency-breakdown summary of an exported trace "
                  "(observability/trace.py JSON).")
  parser.add_argument("trace", nargs="?", default=None,
                      help="path to the exported trace JSON (optional "
                           "with --follow)")
  parser.add_argument(
      "--metrics", default=None,
      help="registry metrics JSONL; prints the last serving/fleet/* "
           "rollup a multi-replica Router published")
  parser.add_argument(
      "--follow", default=None, metavar="METRICS_JSONL",
      help="tail a live registry metrics JSONL: re-render the fleet "
           "rollup and SLO status as records append (Ctrl-C to stop)")
  parser.add_argument(
      "--slo", default=None, metavar="SLO_EVENTS_JSONL",
      help="SLO monitor events JSONL for --follow (default: a sibling "
           "slo_events.jsonl of the followed file, when present)")
  parser.add_argument("--interval", type=float, default=2.0,
                      help="--follow poll interval in seconds")
  parser.add_argument("--max-polls", type=int, default=0,
                      help="stop --follow after N polls (0 = forever)")
  args = parser.parse_args(argv)
  if args.follow is not None:
    slo_path = args.slo
    if slo_path is None:
      sibling = os.path.join(os.path.dirname(os.path.abspath(
          args.follow)), "slo_events.jsonl")
      slo_path = sibling if os.path.exists(sibling) else None
    follow(args.follow, slo_path=slo_path, interval_s=args.interval,
           max_polls=args.max_polls)
    return 0
  if args.trace is None:
    parser.error("a trace path is required unless --follow is given")
  print(format_report(load_events(args.trace)))
  if args.metrics is not None:
    fleet = fleet_rollup(args.metrics)
    print()
    if fleet is None:
      print(f"no serving/fleet/* record in {args.metrics}")
    else:
      print(format_fleet(fleet))
  return 0


if __name__ == "__main__":
  sys.exit(main())
