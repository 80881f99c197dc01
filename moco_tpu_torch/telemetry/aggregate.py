"""obsd's core: the fleet-wide metrics aggregator and the SLO burn-rate
engine (port of `moco_tpu/telemetry/aggregate.py`).

Every process of the port writes its own telemetry (`events.jsonl` step,
serve, fleet, supervisor and input-server records, `heartbeat.json`), but
nothing watches a deployment as it runs: `tools/telemetry_report.py` is an
after-the-fact fold, and the fleet's autoscaler needs a rolling signal.
This module is that always-on layer. It keeps the supervisor's import
contract: the standard library alone, transitively, no torch and no numpy
(`tests/test_torch_isolation.py`), so the aggregator outlives the runtimes
it observes.

Pieces, bottom-up:

  - `PercentileWindow`: a ring-buffered percentile sketch over the newest N
    observations (`registry.Histogram` in its bounded-window mode; the
    fleet router's latency window behind `router_stats`).
  - `StreamTailer`: incremental, partial-line-safe reads of one
    `events.jsonl` (only newline-terminated lines parse, the torn tail
    waits, truncation resets, a missing file means "not yet"). obsd is a
    pure reader of producer streams: no producer ever blocks on it.
  - `RunWindow`: one run_id's rolling state: step-time, MFU and
    phase-share sketches, event times by name, router_stats and serve
    snapshot history for window deltas. `metric(name, window_s)` resolves
    the objective names SLO rules key on (table in `metric.__doc__`).
  - `SLORule` / `SLOEngine`: declarative rules (a JSON file). An
    objective is violated only when BOTH the fast and the slow window pass
    the threshold (multi-window burn rate: the fast window says "now", the
    slow one "not a blip"), sustained for `for_s` before alerting and
    clear for `clear_s` before recovering (hysteresis).
  - `Aggregator`: tails every stream under N telemetry roots (a fleet root
    contributes its own `events.jsonl` and every `replica*/` and
    `staging_server*/` one, discovered live), folds records into per-run
    windows, evaluates the rules each tick, appends `kind:"slo"`
    alert/recovery records to the producing run's own stream (one
    O_APPEND line), and snapshots for the HTTP endpoints.
  - `ObsServer`: a ThreadingHTTPServer: `/metrics` (Prometheus text
    exposition 0.0.4), `/slo` and `/runs` (JSON), `/healthz`.

`python -m moco_tpu_torch.obsd` is the CLI; `tools/telemetry_report.py`
renders the `slo:` section from the records this module appends. The
exposition's metric names and every record and payload field are the JAX
package's, so either package's obsd reads either package's streams.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from moco_tpu_torch.telemetry.registry import Histogram

SCHEMA_VERSION = 1

EVENTS_FILENAME = "events.jsonl"
HEARTBEAT_FILENAME = "heartbeat.json"

# telemetry subdirectory families a root can contain: `replica*` (the
# serve-fleet layout) and `staging_server*` (the input-service layout).
# THE definition — telemetry_report discovers the
# same dirs obsd tails, so the next family lands in both at once
TELEMETRY_SUBDIR_PREFIXES = ("replica", "staging_server")

SLO_KIND = "slo"

# event names that count as "rollback/NaN trouble" for the default rule
ROLLBACK_EVENTS = ("rollback", "sentinel")
# fleet events that count as reload failures (quarantine included: a
# corrupt export IS a deploy failure even though the fleet survived it;
# a bank-pair quarantine is the dual-swap flavor of the same outcome)
RELOAD_FAILURE_EVENTS = ("reload_failed", "reload_quarantine",
                         "reload_watch_error", "reload_bad_layout",
                         "bank_quarantine")


# ---------------------------------------------------------------------------
# percentile sketch (ring-buffered; shared with FleetRouter's latency window)
# ---------------------------------------------------------------------------


class PercentileWindow(Histogram):
    """`registry.Histogram` pinned to its bounded-`window` mode — the
    ring shape the router latency window and the run windows need, with
    ONE copy of the nearest-rank math. `observe` is a `deque.append`
    (GIL-atomic — concurrent HTTP handler threads may observe without a
    lock); `percentile` sorts a snapshot copy, so a concurrent append
    during the sort costs at most one sample of skew."""

    def __init__(self, size: int = 512):
        super().__init__("window", window=int(size))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of a plain iterable (one-shot form of
    `Histogram.percentile`, same rank math by construction)."""
    h = Histogram("tmp")
    for v in values:
        h.observe(float(v))
    return h.percentile(q)


# ---------------------------------------------------------------------------
# stream tailing (the --follow read discipline, as a reusable object)
# ---------------------------------------------------------------------------


class StreamTailer:
    """Incrementally read complete JSONL records from one events file.

    Each `poll()` returns the records whose terminating newline landed
    since the last poll. Partial-line-safe: bytes after the last newline
    stay buffered until their newline arrives (the producer's buffered
    multi-line appends can be caught mid-write). A missing file means
    "producer not up yet"; shrinkage means truncation/rotation — reset
    and re-read. Unparseable lines are counted, never fatal.

    Content that already exists when the tailer is CREATED is flagged as
    catch-up (`polled_catchup` True for polls still inside it): the
    aggregator folds it into counters/meta but not into the rolling
    windows — a restarted obsd must not replay yesterday's incident as
    if it were happening now (and then append a duplicate alert)."""

    def __init__(self, path: str, from_start: bool = True):
        self.path = path
        self._offset = 0
        self._buffer = b""
        self.skipped = 0
        self.records_read = 0
        try:
            self.preexisting = os.path.getsize(path)
        except OSError:
            self.preexisting = 0
        self.polled_catchup = False  # last poll began inside preexisting
        if not from_start:
            self._offset = self.preexisting

    def poll(self) -> list[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []  # not created yet
        if size < self._offset:  # truncated/rotated: start over — the
            self._offset, self._buffer = 0, b""
            self.preexisting = 0  # rewritten content is NEW, not history
        self.polled_catchup = self._offset < self.preexisting
        if size <= self._offset:
            return []
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return []  # vanished between stat and open: next poll decides
        self._offset += len(chunk)
        self._buffer += chunk
        *complete, self._buffer = self._buffer.split(b"\n")
        records = []
        for raw in complete:
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw.decode("utf-8", errors="replace"))
            except json.JSONDecodeError:
                self.skipped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
                self.records_read += 1
            else:
                self.skipped += 1
        return records


def discover_streams(roots) -> dict:
    """`{label: events_path}` for the given telemetry roots. A FILE
    argument is one stream; a DIRECTORY contributes its own events.jsonl
    plus every `replica*/events.jsonl` (the fleet layout) and
    `staging_server*/events.jsonl` (the input-service layout)
    under it — called every poll, so replica/server dirs that appear
    later join live."""
    streams: dict[str, str] = {}
    for root in roots:
        if os.path.isfile(root) or root.endswith(".jsonl"):
            streams[root] = root
            continue
        own = os.path.join(root, EVENTS_FILENAME)
        streams[root] = own
        try:
            names = sorted(os.listdir(root))
        except OSError:
            continue
        for name in names:
            sub = os.path.join(root, name, EVENTS_FILENAME)
            if (name.startswith(TELEMETRY_SUBDIR_PREFIXES)
                    and os.path.exists(sub)):
                streams[os.path.join(root, name)] = sub
    return streams


# ---------------------------------------------------------------------------
# per-run rolling windows
# ---------------------------------------------------------------------------


class RunWindow:
    """One run_id's rolling telemetry state.

    Entries are (mono_seen, ...) tuples on ring-buffered deques —
    bounded memory no matter how long the run — and every window metric
    filters by OBSERVATION time on the aggregator's own monotonic
    clock, so a producer's wall-clock step can never fake freshness or
    staleness (the same lesson as the heartbeat's seq/mono_s pair)."""

    def __init__(self, run_id: str, ring: int = 2048):
        self.run_id = run_id
        self.srcs: set[str] = set()
        self.kinds: dict[str, int] = {}
        self.meta: dict = {}
        self.ended = False
        self.last_wall_t: float | None = None
        self.first_seen = float("inf")   # mono of the first ingest (any)
        self.last_seen = float("-inf")   # mono of the newest LIVE record
        self.home_path: str | None = None  # stream slo records append to
        self.steps_total = 0
        self.incidents: dict[str, int] = {}
        self.slo_events = 0
        # rings: (mono, payload...)
        self._steps: deque = deque(maxlen=ring)       # (mono, step_s,
                                                      #  data_s, mfu)
        self._events: deque = deque(maxlen=ring)      # (mono, name)
        self._router: deque = deque(maxlen=256)       # (mono, record)
        self._serve: deque = deque(maxlen=256)        # (mono, record)
        self._health: deque = deque(maxlen=256)       # (mono, block, step)
        self._input: deque = deque(maxlen=256)        # (mono, input snap)
        self.last_step: dict | None = None
        self.last_router: dict | None = None
        self.last_serve: dict | None = None
        self.last_health: dict | None = None
        self.last_bank: dict | None = None

    # -- ingest --------------------------------------------------------------
    def ingest(self, rec: dict, src: str, path: str, now: float,
               historical: bool = False) -> None:
        """Fold one record. `historical=True` marks catch-up content
        that predates this aggregator (a restarted obsd re-reading the
        file): it feeds counters, meta and incident totals — the /runs
        story — but NEVER the time-windowed rings, because stamping old
        records at observation-time `now` would replay yesterday's
        incident as live and fire a duplicate alert into the stream."""
        self.first_seen = min(self.first_seen, now)
        kind = str(rec.get("kind", "?"))
        if kind == SLO_KIND:
            # our own (or a previous obsd incarnation's) output: count it,
            # never feed it back into the windows it was computed from
            self.slo_events += 1
            return
        self.srcs.add(src)
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        if not historical:
            # historical records must not make a long-dead run look
            # live: stale_s stays anchored to genuinely observed appends
            self.last_seen = now
        if isinstance(rec.get("t"), (int, float)):
            self.last_wall_t = rec["t"]
        if self.home_path is None:
            self.home_path = path
        if kind == "step":
            self.steps_total += 1
            self.last_step = rec
            try:
                step_no = int(rec.get("step", self.steps_total))
            except (TypeError, ValueError):
                step_no = self.steps_total
            health = rec.get("health")
            if isinstance(health, dict):
                self.last_health = health
            if not historical:
                self._steps.append((
                    now,
                    float(rec.get("step_s") or 0.0),
                    float(rec.get("data_s") or 0.0),
                    rec.get("mfu"),
                    step_no,
                ))
                if isinstance(health, dict):
                    self._health.append((now, health, step_no))
                # cumulative input-pipeline snapshot: the
                # credit_stall_s/wall_s pair feeds the windowed
                # input_credit_stall_rate delta
                if isinstance(rec.get("input"), dict):
                    self._input.append((now, rec["input"]))
        elif kind == "event":
            name = str(rec.get("event", "unknown"))
            self.incidents[name] = self.incidents.get(name, 0) + 1
            if not historical:
                self._events.append((now, name))
        elif kind == "input_server":
            # staging-server stream: periodic `stats` records
            # are routine cumulative snapshots, lifecycle transitions
            # (launch/eject/kill/worker_exit/give_up) are incidents like
            # their fleet twins
            name = str(rec.get("event", "unknown"))
            if name != "stats":
                self.incidents[name] = self.incidents.get(name, 0) + 1
                if not historical:
                    self._events.append((now, name))
        elif kind in ("supervisor", "fleet"):
            name = str(rec.get("event", "unknown"))
            if name == "router_stats":
                self.last_router = rec
                if not historical:
                    self._router.append((now, rec))
            else:
                self.incidents[name] = self.incidents.get(name, 0) + 1
                if not historical:
                    self._events.append((now, name))
        elif kind == "bank":
            # bank lifecycle stream: builder progress
            # (build_start/shard_done/build_done), the service's dual
            # `swap`, and the fleet's `bank_waiting`/`quarantine`/
            # `bank_quarantine`/`rollback`. Event names normalize to a
            # `bank_` prefix so `event:bank_rollback` reads the same
            # whether the producer already prefixed or not; shard_done
            # is routine build progress, not an incident
            name = str(rec.get("event", "unknown"))
            if not name.startswith("bank"):
                name = "bank_" + name
            if name in ("bank_swap", "bank_waiting"):
                # the records that carry freshness: swap pins age to
                # step - bank_step, bank_waiting carries age_steps
                self.last_bank = rec
            if name != "bank_shard_done":
                self.incidents[name] = self.incidents.get(name, 0) + 1
                if not historical:
                    self._events.append((now, name))
        elif kind == "serve":
            self.last_serve = rec
            if not historical:
                self._serve.append((now, rec))
        elif kind == "run_start":
            self.meta = {
                k: rec[k] for k in ("name", "variant", "arch",
                                    "batch_size", "n_chips")
                if k in rec
            }
            self.ended = False
        elif kind == "run_end":
            self.ended = True

    # -- window folds --------------------------------------------------------
    def _step_window(self, window_s: float, now: float,
                     min_step: int = 0) -> list:
        cut = now - window_s
        return [s for s in self._steps
                if s[0] >= cut and s[4] > min_step]

    def event_count(self, names, window_s: float, now: float) -> int:
        cut = now - window_s
        names = set(names)
        return sum(1 for (mono, n) in self._events
                   if mono >= cut and n in names)

    def _counter_delta(self, ring: deque, window_s: float, now: float,
                       fold) -> tuple[float, float] | None:
        """(delta_numer, delta_denom) between the oldest and newest
        cumulative-counter snapshot inside the window; None without two
        snapshots. `fold(rec) -> (numer, denom)`."""
        cut = now - window_s
        inside = [rec for (mono, rec) in ring if mono >= cut]
        if len(inside) < 2:
            return None
        n0, d0 = fold(inside[0])
        n1, d1 = fold(inside[-1])
        return max(n1 - n0, 0.0), max(d1 - d0, 0.0)

    def metric(self, name: str, window_s: float, now: float,
               min_step: int = 0):
        """Resolve one SLO objective over `window_s` trailing seconds.
        `min_step` drops step records with step index <= it from the
        step-derived objectives (the rule-level `min_step` knob: cold
        compile/warmup steps are seconds-scale BY DESIGN — the
        SlowSampleDetector `skip` lesson — and must not page anyone).

        Objectives (None = no data in the window; a rule never fires on
        silence — staleness is its own objective):

          step_time_ms_p50|p95|p99|max  windowed step-time percentiles
          data_share                    sum(data_s)/sum(step_s)
          mfu_mean                      windowed mean MFU
          shed_rate                     router window delta: sheds/requests
          serve_shed_rate               serve-snapshot delta: sheds/requests
          outstanding                   last router_stats outstanding depth
          router_latency_ms_p95         last router_stats window p95
          serve_latency_ms_p95          last serve snapshot p95
          input_credit_stall_rate       input-snapshot delta:
                                        credit_stall_s/wall_s — the
                                        fraction of wall time the train
                                        host spent blocked on an empty
                                        ready queue; a sustained high
                                        rate IS a starving train host
          reload_failures               reload_* failure events in window
                                        (bank_quarantine included: a
                                        refused pair IS a failed deploy)
          rollback_events               rollback/sentinel events in window
          bank_age_steps                promoted-checkpoint step minus
                                        serving-bank step, from the last
                                        bank swap/bank_waiting record
                                        — a growing age means
                                        checkpoints are landing without
                                        paired banks and the fleet is
                                        pinned on an aging pair
          resize_relaunches             resize_relaunch records in window
          ann_recall_probe              last serve snapshot's seeded
                                        ANN-vs-exact recall@1 probe
                                        — the quantizer's
                                        standing quality gauge; absent
                                        on exact-only services
          knn_partial_rate              router window delta:
                                        partial fan-out answers /
                                        fan-outs — sustained partials
                                        mean a shard can't make the
                                        deadline
          autoscale_events              autoscale_up + autoscale_down
                                        actions in window (flapping
                                        capacity is its own incident)
          stale_s                       seconds since the newest record
          event:<name>                  count of that event name in window
          health:<key>                  windowed MEAN of that key in the
                                        step records' learning-health
                                        block (keys as written
                                        by the driver: logit_margin,
                                        emb_std_q, emb_std_k, emb_pr_q,
                                        qnorm_min, pdrift, ...)
          health_min:<key> /            windowed MIN / MAX of the same —
          health_max:<key>              collapse is a floor violation, and
                                        a window MEAN would let healthy
                                        history mask a fresh collapse
          collapse_events               sentinel `health` incidents in
                                        window (alias of event:health)
        """
        if name.startswith("event:"):
            return float(self.event_count((name[6:],), window_s, now))
        if name == "collapse_events":
            return float(self.event_count(("health",), window_s, now))
        for prefix, fold in (("health:", None), ("health_min:", min),
                             ("health_max:", max)):
            if name.startswith(prefix):
                key = name[len(prefix):]
                cut = now - window_s
                vals = [h[key] for (mono, h, step_no) in self._health
                        if mono >= cut and step_no > min_step
                        and isinstance(h.get(key), (int, float))]
                if not vals:
                    return None
                if fold is None:
                    return sum(vals) / len(vals)
                return float(fold(vals))
        if name in ("step_time_ms_p50", "step_time_ms_p95",
                    "step_time_ms_p99", "step_time_ms_max"):
            steps = self._step_window(window_s, now, min_step)
            if not steps:
                return None
            times = [s[1] for s in steps]
            if name.endswith("max"):
                return max(times) * 1e3
            return percentile(times, float(name.rsplit("p", 1)[1])) * 1e3
        if name == "data_share":
            steps = self._step_window(window_s, now, min_step)
            total = sum(s[1] for s in steps)
            if total <= 0.0:
                return None
            return sum(s[2] for s in steps) / total
        if name == "mfu_mean":
            mfus = [s[3] for s in self._step_window(window_s, now, min_step)
                    if isinstance(s[3], (int, float))]
            if not mfus:
                return None
            return sum(mfus) / len(mfus)
        if name == "shed_rate":
            delta = self._counter_delta(
                self._router, window_s, now,
                lambda r: (float(r.get("shed_no_backend", 0)
                                 + r.get("upstream_timeout", 0)
                                 + r.get("upstream_error", 0)
                                 + r.get("shed_deadline_router", 0)),
                           float(r.get("requests", 0))))
            if delta is None:
                return None
            sheds, requests = delta
            return sheds / requests if requests else 0.0
        if name == "serve_shed_rate":
            delta = self._counter_delta(
                self._serve, window_s, now,
                lambda r: (float(r.get("shed_overload", 0)
                                 + r.get("shed_deadline", 0)),
                           float(r.get("requests", 0))))
            if delta is None:
                return None
            sheds, requests = delta
            return sheds / requests if requests else 0.0
        if name == "input_credit_stall_rate":
            delta = self._counter_delta(
                self._input, window_s, now,
                lambda r: (float(r.get("credit_stall_s", 0.0)),
                           float(r.get("wall_s", 0.0))))
            if delta is None:
                return None
            stalled, wall = delta
            return stalled / wall if wall else 0.0
        if name == "outstanding":
            if self.last_router is None:
                return None
            return float(self.last_router.get("outstanding", 0))
        if name == "router_latency_ms_p95":
            lat = (self.last_router or {}).get("latency_ms")
            return float(lat["p95"]) if isinstance(lat, dict) \
                and "p95" in lat else None
        if name == "serve_latency_ms_p95":
            lat = (self.last_serve or {}).get("latency_ms")
            return float(lat["p95"]) if isinstance(lat, dict) \
                and "p95" in lat else None
        if name == "reload_failures":
            return float(self.event_count(RELOAD_FAILURE_EVENTS,
                                          window_s, now))
        if name == "rollback_events":
            return float(self.event_count(ROLLBACK_EVENTS, window_s, now))
        if name == "bank_age_steps":
            if self.last_bank is None:
                return None
            age = self.last_bank.get("age_steps")
            if isinstance(age, (int, float)):
                return float(age)
            step = self.last_bank.get("step")
            bank_step = self.last_bank.get("bank_step")
            if (isinstance(step, (int, float))
                    and isinstance(bank_step, (int, float))):
                return float(step) - float(bank_step)
            return None
        if name == "resize_relaunches":
            return float(self.event_count(("resize_relaunch",),
                                          window_s, now))
        if name == "ann_recall_probe":
            ann = (self.last_serve or {}).get("ann")
            if isinstance(ann, dict) and isinstance(
                    ann.get("recall_probe"), (int, float)):
                return float(ann["recall_probe"])
            return None
        if name == "knn_partial_rate":
            delta = self._counter_delta(
                self._router, window_s, now,
                lambda r: (float(r.get("knn_partial", 0)),
                           float(r.get("knn_fanout", 0))))
            if delta is None:
                return None
            partial, fanout = delta
            return partial / fanout if fanout else 0.0
        if name == "autoscale_events":
            return float(self.event_count(
                ("autoscale_up", "autoscale_down"), window_s, now))
        if name == "stale_s":
            if self.last_seen == float("-inf"):
                return None
            return max(now - self.last_seen, 0.0)
        raise ValueError(f"unknown SLO objective {name!r}")

    def snapshot(self, now: float) -> dict:
        """The /runs payload for this run."""
        snap: dict = {
            "run_id": self.run_id,
            "srcs": sorted(self.srcs),
            "kinds": dict(sorted(self.kinds.items())),
            "steps": self.steps_total,
            "ended": self.ended,
            "slo_events": self.slo_events,
        }
        if self.meta:
            snap["run"] = self.meta
        if self.last_wall_t is not None:
            snap["last_t"] = self.last_wall_t
        if self.last_seen != float("-inf"):
            snap["stale_s"] = round(max(now - self.last_seen, 0.0), 3)
        if self.last_step is not None:
            snap["last_step"] = {
                k: self.last_step[k]
                for k in ("step", "step_s", "data_share", "mfu",
                          "imgs_per_sec")
                if k in self.last_step
            }
        if self.incidents:
            snap["events"] = dict(sorted(self.incidents.items()))
        if self.last_health is not None:
            snap["health"] = self.last_health
        if self.last_bank is not None:
            snap["bank"] = {
                k: self.last_bank[k]
                for k in ("event", "step", "bank_step", "age_steps",
                          "rows", "generation", "agreement")
                if k in self.last_bank
            }
        return snap


# ---------------------------------------------------------------------------
# SLO rules + burn-rate engine
# ---------------------------------------------------------------------------

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

# The default rule set (README "obsd" documents each): thresholds are
# deliberately conservative — an operator tunes them per deployment via
# the rule file; the count-objective rules (reload/rollback/resize) are
# meaningful everywhere as shipped.
DEFAULT_RULES = (
    {"name": "step_time_p95", "objective": "step_time_ms_p95",
     "op": ">", "threshold": 2000.0,
     "fast_window_s": 60.0, "slow_window_s": 300.0},
    {"name": "data_stall_share", "objective": "data_share",
     "op": ">", "threshold": 0.6,
     "fast_window_s": 60.0, "slow_window_s": 300.0},
    {"name": "shed_rate", "objective": "shed_rate",
     "op": ">", "threshold": 0.05,
     "fast_window_s": 60.0, "slow_window_s": 300.0},
    {"name": "input_credit_stall", "objective": "input_credit_stall_rate",
     "op": ">", "threshold": 0.25,
     "fast_window_s": 60.0, "slow_window_s": 300.0},
    {"name": "reload_failure", "objective": "reload_failures",
     "op": ">=", "threshold": 1.0,
     "fast_window_s": 300.0, "slow_window_s": 900.0},
    {"name": "nonfinite_loss", "objective": "rollback_events",
     "op": ">=", "threshold": 1.0,
     "fast_window_s": 300.0, "slow_window_s": 900.0},
    {"name": "resize_loop", "objective": "resize_relaunches",
     "op": ">=", "threshold": 3.0,
     "fast_window_s": 600.0, "slow_window_s": 1800.0},
)


class SLORule:
    """One declarative objective. JSON fields (rule-file reference):

      name           unique id (required)
      objective      a RunWindow.metric name (required)
      op             ">" | ">=" | "<" | "<=" (default ">")
      threshold      violation bound (required)
      fast_window_s  burn-rate fast window (default 60)
      slow_window_s  burn-rate slow window (default 5 × fast)
      fast_threshold / slow_threshold
                     per-window overrides of `threshold` (classic
                     multi-burn-rate: a steeper bar on the fast window)
      for_s          violation must be sustained this long before the
                     alert fires (default 0: first confirmed tick)
      clear_s        fast window must be clean this long before the
                     recovery fires (default 2 s — hysteresis: a metric
                     hovering at its threshold flaps once, not once per
                     tick)
      min_step       ignore step records with step <= this for the
                     step-derived objectives (default 3: cold-compile
                     steps are seconds-scale by design)
      severity       "page" | "ticket" | ... (annotation only)
    """

    def __init__(self, spec: dict):
        try:
            self.name = str(spec["name"])
            self.objective = str(spec["objective"])
            self.threshold = float(spec["threshold"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad SLO rule {spec!r}: {e}") from None
        self.op = str(spec.get("op", ">"))
        if self.op not in _OPS:
            raise ValueError(
                f"rule {self.name!r}: unknown op {self.op!r} "
                f"(choose from {sorted(_OPS)})"
            )
        self.fast_window_s = float(spec.get("fast_window_s", 60.0))
        self.slow_window_s = float(
            spec.get("slow_window_s", 5.0 * self.fast_window_s))
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                f"rule {self.name!r}: need 0 < fast_window_s <= "
                f"slow_window_s"
            )
        self.fast_threshold = float(spec.get("fast_threshold",
                                             self.threshold))
        self.slow_threshold = float(spec.get("slow_threshold",
                                             self.threshold))
        self.for_s = float(spec.get("for_s", 0.0))
        self.clear_s = float(spec.get("clear_s", 2.0))
        self.min_step = int(spec.get("min_step", 3))
        self.severity = str(spec.get("severity", "ticket"))

    def violated(self, window: RunWindow, now: float) -> tuple | None:
        """(fast_value, slow_value, violating) — None when the objective
        has no data in EITHER window (silence never burns budget)."""
        fast = window.metric(self.objective, self.fast_window_s, now,
                             self.min_step)
        slow = window.metric(self.objective, self.slow_window_s, now,
                             self.min_step)
        if fast is None or slow is None:
            return None
        op = _OPS[self.op]
        return (fast, slow,
                op(fast, self.fast_threshold)
                and op(slow, self.slow_threshold))


def load_rules(path: str | None) -> list[SLORule]:
    """Rule file -> rules; None/"" -> the default set. Accepts either a
    bare JSON list or {"rules": [...]}."""
    if not path:
        return [SLORule(dict(s)) for s in DEFAULT_RULES]
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("rules")
    if not isinstance(data, list) or not data:
        raise ValueError(f"{path}: expected a JSON list of rules "
                         '(or {"rules": [...]})')
    rules = [SLORule(s) for s in data]
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate rule names in {names}")
    return rules


class _RuleState:
    """Alert state machine for one (rule, run) pair."""

    __slots__ = ("alerting", "violating_since", "clean_since",
                 "alerts", "recoveries", "last_fast", "last_slow",
                 "since_wall")

    def __init__(self):
        self.alerting = False
        self.violating_since: float | None = None
        self.clean_since: float | None = None
        self.alerts = 0
        self.recoveries = 0
        self.last_fast: float | None = None
        self.last_slow: float | None = None
        self.since_wall: float | None = None


class SLOEngine:
    """Evaluate every rule against every run window each tick; return
    alert/recovery TRANSITIONS (the aggregator lands them as records).

    Burn-rate + hysteresis semantics, per (rule, run):
      ok -> alert   when fast AND slow windows violate, sustained for
                    `for_s` (a one-tick blip inside `for_s` re-arms)
      alert -> ok   when the fast window stops violating (or goes
                    data-less) for `clear_s` — the slow window is
                    deliberately NOT required to clear: it can stay
                    poisoned for its whole width after a real incident,
                    and recovery means "not happening NOW"
    """

    def __init__(self, rules: list[SLORule]):
        self.rules = list(rules)
        self._state: dict[tuple[str, str], _RuleState] = {}

    def state_for(self, rule_name: str, run_id: str) -> _RuleState:
        return self._state.setdefault((rule_name, run_id), _RuleState())

    def evaluate(self, windows: dict, now: float) -> list[dict]:
        transitions = []
        for rule in self.rules:
            for run_id, window in windows.items():
                res = rule.violated(window, now)
                if res is None and (rule.name, run_id) not in self._state:
                    # an objective this run has NEVER produced data for
                    # (a step-time rule over a serve fleet): no state, no
                    # /slo row — silence is absence, not "ok"
                    continue
                st = self.state_for(rule.name, run_id)
                if res is not None:
                    st.last_fast, st.last_slow = res[0], res[1]
                violating = bool(res and res[2])
                if violating:
                    st.clean_since = None
                    if st.violating_since is None:
                        st.violating_since = now
                    if (not st.alerting
                            and now - st.violating_since >= rule.for_s):
                        st.alerting = True
                        st.alerts += 1
                        st.since_wall = time.time()
                        transitions.append(self._transition(
                            "alert", rule, run_id, st))
                else:
                    st.violating_since = None
                    if st.alerting:
                        if st.clean_since is None:
                            st.clean_since = now
                        if now - st.clean_since >= rule.clear_s:
                            st.alerting = False
                            st.recoveries += 1
                            transitions.append(self._transition(
                                "recover", rule, run_id, st))
                            st.since_wall = None
        return transitions

    def _transition(self, action: str, rule: SLORule, run_id: str,
                    st: _RuleState) -> dict:
        rec = {
            "action": action,
            "rule": rule.name,
            "objective": rule.objective,
            "op": rule.op,
            "threshold": rule.threshold,
            "severity": rule.severity,
            "run_id": run_id,
            "fast_window_s": rule.fast_window_s,
            "slow_window_s": rule.slow_window_s,
        }
        if st.last_fast is not None:
            rec["value_fast"] = round(st.last_fast, 6)
        if st.last_slow is not None:
            rec["value_slow"] = round(st.last_slow, 6)
        return rec

    def snapshot(self, windows: dict) -> dict:
        """The /slo payload: per-rule spec + per-run state."""
        out: dict = {"rules": []}
        for rule in self.rules:
            entry: dict = {
                "name": rule.name,
                "objective": rule.objective,
                "op": rule.op,
                "threshold": rule.threshold,
                "fast_window_s": rule.fast_window_s,
                "slow_window_s": rule.slow_window_s,
                "for_s": rule.for_s,
                "clear_s": rule.clear_s,
                "severity": rule.severity,
                "runs": {},
            }
            for run_id in windows:
                st = self._state.get((rule.name, run_id))
                if st is None:
                    continue
                run_state: dict = {
                    "state": "alert" if st.alerting else "ok",
                    "alerts": st.alerts,
                    "recoveries": st.recoveries,
                }
                if st.last_fast is not None:
                    run_state["value_fast"] = round(st.last_fast, 6)
                if st.last_slow is not None:
                    run_state["value_slow"] = round(st.last_slow, 6)
                if st.since_wall is not None:
                    run_state["since"] = round(st.since_wall, 3)
                entry["runs"][run_id] = run_state
            out["rules"].append(entry)
        return out


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------


class Aggregator:
    """Tail N telemetry roots into per-run windows + the SLO engine.

    `poll_once()` is the whole unit of work (tests drive it directly;
    `run()` loops it on `tick_secs`): tail every stream, ingest, evaluate
    rules, append transitions as `kind:"slo"` records to each producing
    run's home stream. Thread-safety: `poll_once` runs on ONE thread
    (the collector); HTTP handlers read snapshots under `_lock`."""

    def __init__(self, roots, *, rules: list[SLORule] | None = None,
                 ring: int = 2048, emit_slo: bool = True,
                 retire_after_s: float = 6 * 3600.0):
        self.roots = [str(r) for r in roots]
        self.engine = SLOEngine(rules if rules is not None
                                else load_rules(None))
        self.emit_slo = emit_slo
        self.ring = int(ring)
        self.retire_after_s = float(retire_after_s)
        self.retired = 0
        self.windows: dict[str, RunWindow] = {}
        self._tailers: dict[str, StreamTailer] = {}
        self._lock = threading.Lock()
        self.polls = 0
        self.records_total = 0
        self.slo_written = 0
        self.started_wall = time.time()

    # -- ingest + evaluate ---------------------------------------------------
    def poll_once(self, now: float | None = None) -> list[dict]:
        """One tick; returns the SLO transitions it produced."""
        now = time.monotonic() if now is None else now
        streams = discover_streams(self.roots)
        batches = []
        for label, path in streams.items():
            tailer = self._tailers.get(label)
            if tailer is None:
                tailer = self._tailers[label] = StreamTailer(path)
            recs = tailer.poll()
            for rec in recs:
                batches.append((label, path, rec, tailer.polled_catchup))
        with self._lock:
            for label, path, rec, historical in batches:
                self.records_total += 1
                run_id = str(rec.get("run_id") or rec.get("run") or "-")
                window = self.windows.get(run_id)
                if window is None:
                    window = self.windows[run_id] = RunWindow(
                        run_id, ring=self.ring)
                window.ingest(rec, label, path, now,
                              historical=historical)
            transitions = self.engine.evaluate(self.windows, now)
            self._retire_windows(now)
            self.polls += 1
        for tr in transitions:
            self._write_slo(tr)
        return transitions

    def _retire_windows(self, now: float) -> None:
        """Bounded state for an always-on daemon (caller holds _lock):
        a run that ENDED (run_end seen) or went silent past
        `retire_after_s` is dropped — window, engine state, everything —
        once no rule is still alerting for it (retiring mid-alert would
        orphan the alert without its recovery record). run_ids churn
        with every supervisor relaunch; without this, windows and rule
        states grow forever and every tick re-evaluates dead runs."""
        if self.retire_after_s <= 0:
            return
        for run_id in list(self.windows):
            window = self.windows[run_id]
            # a history-only window never updates last_seen: fall back
            # to its ingest time so it can still age out
            anchor = max(window.last_seen, window.first_seen)
            silent_for = now - anchor if anchor != float("inf") else 0.0
            if not (window.ended or silent_for >= self.retire_after_s):
                continue
            states = {k: st for k, st in self.engine._state.items()
                      if k[1] == run_id}
            if any(st.alerting for st in states.values()):
                continue  # recovery (or its record) first
            # a freshly-ended run lingers a grace period so /slo and
            # /runs still answer for it right after run_end
            if window.ended and silent_for < 60.0:
                continue
            del self.windows[run_id]
            for key in states:
                del self.engine._state[key]
            self.retired += 1

    def _write_slo(self, transition: dict) -> None:
        """Append one `kind:"slo"` record to the producing run's own
        stream (its home events.jsonl): ONE newline-terminated line via
        an O_APPEND handle, the same interleave-safe discipline as the
        span layer's multi-process spans file. This is the aggregator's
        ONLY write into producer directories."""
        window = self.windows.get(transition["run_id"])
        path = window.home_path if window is not None else None
        record = {"v": SCHEMA_VERSION, "t": round(time.time(), 3),
                  "kind": SLO_KIND}
        record.update(transition)
        if not self.emit_slo or path is None:
            # endpoint-only mode still counts the event on the window
            # (the tail-read normally does this when the line comes back)
            if window is not None:
                window.slo_events += 1
            return
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
                f.flush()
        except OSError:
            return  # an unwritable producer dir must not kill the watcher
        self.slo_written += 1

    # -- snapshots (HTTP side; also handy for tests) -------------------------
    def runs_snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "v": SCHEMA_VERSION,
                "roots": self.roots,
                "streams": len(self._tailers),
                "records": self.records_total,
                "skipped_lines": sum(t.skipped
                                     for t in self._tailers.values()),
                "polls": self.polls,
                "slo_written": self.slo_written,
                "retired_runs": self.retired,
                "runs": [w.snapshot(now)
                         for w in self.windows.values()],
            }

    def slo_snapshot(self) -> dict:
        with self._lock:
            snap = self.engine.snapshot(self.windows)
        snap["v"] = SCHEMA_VERSION
        return snap

    def prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of every run window's
        gauges/counters + the aggregator's own meta-metrics."""
        now = time.monotonic()
        lines: list[str] = []

        def emit(name, mtype, help_text, samples):
            # samples: [(labels_dict, value)] — emitted only when any
            # sample exists, so the exposition never carries NaN filler
            if not samples:
                return
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for labels, value in samples:
                label_s = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items())
                )
                label_s = f"{{{label_s}}}" if label_s else ""
                lines.append(f"{name}{label_s} {_format_value(value)}")

        with self._lock:
            per_run = [(w.run_id, w) for w in self.windows.values()]
            step_pcts, data_share, mfu, steps_tot, stale = [], [], [], [], []
            incidents, router_g, router_lat, serve_lat = [], [], [], []
            health_g: list = []
            input_stall: list = []
            bank_age: list = []
            router_counters: dict[str, list] = {}
            for run_id, w in per_run:
                lab = {"run_id": run_id}
                steps_tot.append((lab, w.steps_total))
                if w.last_seen != float("-inf"):
                    stale.append((lab, max(now - w.last_seen, 0.0)))
                for q in ("50", "95", "99"):
                    v = w.metric(f"step_time_ms_p{q}", 300.0, now)
                    if v is not None:
                        step_pcts.append((dict(lab, quantile=f"p{q}"), v))
                v = w.metric("data_share", 300.0, now)
                if v is not None:
                    data_share.append((lab, v))
                v = w.metric("mfu_mean", 300.0, now)
                if v is not None:
                    mfu.append((lab, v))
                v = w.metric("input_credit_stall_rate", 300.0, now)
                if v is not None:
                    input_stall.append((lab, v))
                v = w.metric("bank_age_steps", 300.0, now)
                if v is not None:
                    bank_age.append((lab, v))
                if w.last_health:
                    for key in sorted(w.last_health):
                        v = w.metric(f"health:{key}", 300.0, now)
                        if v is not None:
                            health_g.append((dict(lab, key=key), v))
                for name, count in w.incidents.items():
                    incidents.append((dict(lab, event=name), count))
                if w.last_router is not None:
                    r = w.last_router
                    router_g.append((lab, r.get("outstanding", 0)))
                    for key in ("requests", "ok", "retries",
                                "shed_no_backend", "upstream_timeout",
                                "upstream_error", "shed_deadline_router",
                                "passthrough_non_200"):
                        if key in r:
                            router_counters.setdefault(key, []).append(
                                (lab, r[key]))
                    lat = r.get("latency_ms")
                    if isinstance(lat, dict):
                        for q, v in lat.items():
                            router_lat.append(
                                (dict(lab, quantile=q), v))
                if w.last_serve is not None:
                    lat = w.last_serve.get("latency_ms")
                    if isinstance(lat, dict):
                        for q, v in lat.items():
                            serve_lat.append((dict(lab, quantile=q), v))
            slo_state, slo_alerts = [], []
            for (rule_name, run_id), st in self.engine._state.items():
                lab = {"rule": rule_name, "run_id": run_id}
                slo_state.append((lab, 1 if st.alerting else 0))
                slo_alerts.append((lab, st.alerts))
            meta = [({}, self.records_total)]
            skipped = [({}, sum(t.skipped
                                for t in self._tailers.values()))]
            streams = [({}, len(self._tailers))]

        emit("moco_tpu_steps_total", "counter",
             "training step records ingested per run", steps_tot)
        emit("moco_tpu_step_time_ms", "gauge",
             "windowed (300s) step-time percentiles", step_pcts)
        emit("moco_tpu_data_share", "gauge",
             "windowed (300s) input-stall share of step time", data_share)
        emit("moco_tpu_mfu", "gauge",
             "windowed (300s) mean model FLOPs utilization", mfu)
        emit("moco_tpu_health", "gauge",
             "windowed (300s) mean learning-health diagnostics by key",
             health_g)
        emit("moco_tpu_input_credit_stall_rate", "gauge",
             "windowed (300s) fraction of wall time the train host spent "
             "blocked on an empty input ready queue", input_stall)
        emit("moco_tpu_bank_age_steps", "gauge",
             "promoted-checkpoint step minus serving kNN-bank step "
             "(last bank swap/bank_waiting record)", bank_age)
        emit("moco_tpu_run_stale_seconds", "gauge",
             "seconds since the run's newest record was observed", stale)
        emit("moco_tpu_events_total", "counter",
             "event records ingested by name", incidents)
        emit("moco_tpu_router_outstanding", "gauge",
             "router in-flight depth (last router_stats)", router_g)
        for key, samples in router_counters.items():
            emit(f"moco_tpu_router_{key}_total", "counter",
                 f"router cumulative {key} (last router_stats)", samples)
        emit("moco_tpu_router_latency_ms", "gauge",
             "router latency window percentiles (last router_stats)",
             router_lat)
        emit("moco_tpu_serve_latency_ms", "gauge",
             "serve latency percentiles (last serve snapshot)", serve_lat)
        emit("moco_tpu_slo_alert", "gauge",
             "1 while the rule is alerting for the run", slo_state)
        emit("moco_tpu_slo_alerts_total", "counter",
             "alerts fired per rule per run", slo_alerts)
        emit("moco_tpu_obsd_records_total", "counter",
             "records ingested by this obsd", meta)
        emit("moco_tpu_obsd_skipped_lines_total", "counter",
             "unparseable lines skipped by this obsd", skipped)
        emit("moco_tpu_obsd_streams", "gauge",
             "streams currently tailed", streams)
        return "\n".join(lines) + "\n"

    # -- loop ----------------------------------------------------------------
    def run(self, tick_secs: float = 1.0,
            stop: threading.Event | None = None) -> None:
        stop = stop or threading.Event()
        while not stop.is_set():
            self.poll_once()
            stop.wait(tick_secs)


def _escape_label(value) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _format_value(value) -> str:
    f = float(value)
    return str(int(f)) if f == int(f) else repr(f)


# ---------------------------------------------------------------------------
# the HTTP endpoints
# ---------------------------------------------------------------------------


class _ObsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 32  # scrape traffic, not user traffic


def _make_handler(agg: Aggregator):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102
            pass  # scrapes at 1/s would drown stderr

        def _send(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, agg.prometheus().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/slo":
                self._send(200,
                           json.dumps(agg.slo_snapshot()).encode("utf-8"),
                           "application/json")
            elif self.path == "/runs":
                self._send(200,
                           json.dumps(agg.runs_snapshot()).encode("utf-8"),
                           "application/json")
            elif self.path == "/healthz":
                self._send(200, b'{"status": "ok"}', "application/json")
            else:
                self._send(404, json.dumps(
                    {"error": "not_found", "path": self.path}
                ).encode("utf-8"), "application/json")

    return Handler


class ObsServer:
    """Owns the ThreadingHTTPServer; `port=0` binds an ephemeral port
    exposed as `.port` (tests, parallel obsds)."""

    def __init__(self, agg: Aggregator, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = _ObsHTTPServer((host, port), _make_handler(agg))
        self.host, self.port = self.server.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True, name="obsd-http"
        )
        self._thread.start()

    def shutdown(self) -> None:
        if self._thread is not None:
            self.server.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self.server.server_close()
