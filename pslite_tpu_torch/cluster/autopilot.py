# The port's copy of pslite_tpu/cluster/autopilot.py (it imports nothing of JAX).
"""Scheduler-side autopilot: the sense→decide→act loop
(docs/autopilot.md).

PRs 9–16 gave the scheduler both halves of a control loop — the senses
(ClusterHistory windowed rates/quantiles, the SLO watchdog,
critical-path attribution, the flight recorder) and the actuators
(routing epochs with live range migration, elastic join/decommission,
coordinated snapshots, apply-shard retune) — but an operator still
pulled every lever.  :class:`Autopilot` closes the loop: it rides the
ClusterHistory sampler (``observe`` runs after every watchdog
evaluation) and grades a small set of declarative rules against the
freshest window:

- ``hot_skew``     sustained per-server request-rate skew → split/move
                   the hot rank's most loaded range to the coldest rank
                   (a new routing epoch; the existing migration
                   machinery performs the handoff).
- ``shed_scale``   sustained shed-rate CRIT → scale OUT through the
                   pluggable ``spawn_server`` actuator (the tracker, or
                   an in-process launcher in tests/benches).
- ``scale_in``     sustained idleness (opt-in watermark) → retire the
                   least-loaded rank through ``retire_server``.
- ``snapshot_age`` durable-tier staleness → schedule a snapshot, with
                   exponential backoff while the cut keeps getting
                   vetoed (quiesce-fence pressure, migrations in
                   flight).
- ``apply_wait``   critical-path dominance of the apply-shard wait
                   stage → halve the apply task quantum cluster-wide.
- ``apply_widen``  the symmetric recovery: apply-wait share collapsed
                   with the quantum narrowed → double it back toward
                   the configured baseline, same guardrails.

Safety is the point, not the afterthought:

- **Hysteresis**: a rule must trip on ``sustain`` CONSECUTIVE samples
  before it may act; one noisy window never moves data.
- **Per-rule cooldown**: after an action (or a veto) the rule re-arms
  only after ``cooldown_s`` AND a fresh sustained streak.
- **Global budget**: at most ``PS_AUTOPILOT_MAX_ACTIONS`` actions per
  ``PS_AUTOPILOT_WINDOW_S`` across ALL rules — a sick signal cannot
  melt the cluster with remediation.
- **Dry run**: ``PS_AUTOPILOT=plan`` decides (and consumes budget)
  exactly like ``=1`` but never acts — the narration shows what WOULD
  have happened.
- **Kill switch**: with ``PS_AUTOPILOT`` unset nothing is constructed,
  registered, or sent — bit-identical to a cluster without this file.

Every decision AND every veto lands as a structured flight-recorder
event (``autopilot``) and a health INFO event, so ``psmon --watch``
and postmortems can narrate the loop.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils import logging as log

# Mirrors telemetry.health severities without importing at module load.
_INFO, _WARN = "info", "warn"

# Outcomes a decision can land on.
ACTED = "acted"        # actuator invoked and returned
PLANNED = "planned"    # dry-run: would have acted
VETOED = "vetoed"      # a guardrail or precondition said no
FAILED = "failed"      # actuator raised


def parse_mode(raw: Optional[str]) -> Optional[str]:
    """``PS_AUTOPILOT`` → ``None`` (off) / ``"plan"`` / ``"act"``.

    Unrecognized spellings are FATAL, not coerced: silently reading a
    typo'd ``paln`` as act mode would turn an intended dry run into
    live actuation — the one direction a safety knob must never
    default."""
    if raw is None:
        return None
    raw = raw.strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return None
    if raw in ("plan", "dry", "dryrun", "dry-run"):
        return "plan"
    if raw in ("1", "act", "on", "true", "yes"):
        return "act"
    log.check(False, f"PS_AUTOPILOT={raw!r} is not a recognized mode "
                     f"(1/act/on, plan/dry-run, or 0/off/unset)")


class Veto(Exception):
    """An actuator's precondition failed — a POLICY decline (recorded
    as a veto), not an execution error."""


class Decision:
    """One autopilot verdict — what a rule proposed and what happened
    to the proposal."""

    __slots__ = ("wall", "rule", "action", "outcome", "reason", "detail")

    def __init__(self, wall: float, rule: str, action: str, outcome: str,
                 reason: str, detail: Optional[dict] = None):
        self.wall = wall
        self.rule = rule
        self.action = action
        self.outcome = outcome
        self.reason = reason
        self.detail = detail or {}

    def as_dict(self) -> dict:
        return {
            "wall": self.wall, "rule": self.rule, "action": self.action,
            "outcome": self.outcome, "reason": self.reason,
            "detail": dict(self.detail),
        }

    def __repr__(self) -> str:
        return (f"<Decision {self.rule}:{self.action} {self.outcome} "
                f"({self.reason})>")


class PolicyRule:
    """Base rule: subclasses implement ``sense`` (proposal or None)
    and ``act`` (raise :class:`Veto` for precondition declines)."""

    name = "rule"

    def __init__(self, sustain: int, cooldown_s: float):
        self.sustain = max(1, int(sustain))
        self.cooldown_s = float(cooldown_s)
        self.streak = 0           # consecutive breaching samples
        self.last_fired = -1e18   # wall of the last decision (any outcome)

    def effective_cooldown(self) -> float:
        return self.cooldown_s

    def sense(self, ap: "Autopilot", history, wall: float) -> Optional[dict]:
        raise NotImplementedError

    def act(self, ap: "Autopilot", proposal: dict) -> None:
        raise NotImplementedError

    # Backoff hooks — only snapshot_age overrides them today.
    def on_result(self, ok: bool) -> None:
        pass


def _server_rates(history, counters=("kv.server_push_requests",
                                     "kv.server_pull_requests")):
    """``{node_id: windowed request rate}`` for every server the
    history has ≥2 samples of (None-rate nodes are skipped — a node
    with one sample must not read as idle)."""
    rates: Dict[int, float] = {}
    for nid in history.node_ids():
        if history.role_of(nid) != "server":
            continue
        total, seen = 0.0, False
        for c in counters:
            r = history.rate(nid, c)
            if r is not None:
                total += r
                seen = True
        if seen:
            rates[nid] = total
    return rates


def _hot_hint(history) -> Dict[int, int]:
    """Union of ``kv.hot_keys`` top-k estimates across the freshest
    server snapshots (the same shape as ``Postoffice.hot_key_hint``,
    but sourced from the history so synthetic feeds work)."""
    hint: Dict[int, int] = {}
    for nid in history.node_ids():
        m = history.latest(nid) or {}
        for item in (m.get("topk", {}) or {}).get("kv.hot_keys") or []:
            try:
                k, n = int(item[0]), int(item[1])
            except (TypeError, ValueError, IndexError):
                continue
            hint[k] = hint.get(k, 0) + n
    return hint


class HotSkewRule(PolicyRule):
    """Sustained per-server request-rate skew → move/split the hot
    rank's most loaded range to the coldest rank."""

    name = "hot_skew"

    def __init__(self, env):
        super().__init__(
            sustain=env.find_int("PS_AUTOPILOT_SUSTAIN", 3),
            cooldown_s=env.find_float("PS_AUTOPILOT_SKEW_COOLDOWN_S", 20.0),
        )
        self.ratio = env.find_float("PS_AUTOPILOT_SKEW_RATIO", 2.0)
        # Below this aggregate rate the cluster is idle — rebalancing
        # noise-level traffic just churns epochs.
        self.min_rate = env.find_float("PS_AUTOPILOT_MIN_RATE", 1.0)

    def sense(self, ap, history, wall):
        rates = _server_rates(history)
        if len(rates) < 2 or sum(rates.values()) < self.min_rate:
            return None
        mean = sum(rates.values()) / len(rates)
        hot_nid = max(rates, key=rates.get)
        cold_nid = min(rates, key=rates.get)
        if mean <= 0 or rates[hot_nid] < self.ratio * mean:
            return None
        from ..base import id_to_rank
        return {
            "action": "rebalance",
            "reason": (f"server {hot_nid} at {rates[hot_nid]:.1f} req/s "
                       f"≥ {self.ratio:g}x mean {mean:.1f}"),
            "src": id_to_rank(hot_nid) // ap.po.group_size,
            "dst": id_to_rank(cold_nid) // ap.po.group_size,
            "skew": round(rates[hot_nid] / max(mean, 1e-9), 2),
        }

    def act(self, ap, proposal):
        po = ap.po
        table = po.routing_table()
        if table is None:
            raise Veto("static routing (PS_ELASTIC=0) — no epoch to derive")
        # The live ledger, not the table's prev markers: markers persist
        # on the CURRENT epoch long after the handoff landed (the next
        # epoch derives from the settled base), but the ledger clears on
        # MIGRATE_DONE and expires after PS_MIGRATION_SETTLE_S.
        pending = po.migrations_in_flight()
        if pending:
            raise Veto(f"{len(pending)} range migration(s) still in "
                       f"flight (epoch {table.epoch})")
        hot = _hot_hint(ap.history_ref) if ap.history_ref is not None else {}
        if not hot:
            hot = po.hot_key_hint()
        new = table.with_rebalance(proposal["src"], proposal["dst"],
                                   hot=hot)
        po.van.broadcast_routing(new)
        proposal["epoch"] = new.epoch


class ShedScaleRule(PolicyRule):
    """Sustained shed-rate CRIT (tenant QoS sheds) → scale out through
    the pluggable spawn actuator."""

    name = "shed_scale"

    def __init__(self, env, crit: float):
        super().__init__(
            sustain=env.find_int("PS_AUTOPILOT_SUSTAIN", 3),
            cooldown_s=env.find_float("PS_AUTOPILOT_SCALE_COOLDOWN_S", 60.0),
        )
        self.crit = crit  # the watchdog's shed_rate CRIT threshold

    def sense(self, ap, history, wall):
        worst_nid, worst = None, 0.0
        for nid in history.node_ids():
            if history.role_of(nid) != "server":
                continue
            r = history.rate(nid, "qos.shed_requests")
            if r is not None and r > worst:
                worst_nid, worst = nid, r
        if worst_nid is None or worst < self.crit:
            return None
        return {
            "action": "scale_out",
            "reason": (f"server {worst_nid} shedding {worst:.1f} req/s "
                       f"≥ CRIT {self.crit:g}"),
            "shed_rate": round(worst, 2),
        }

    def act(self, ap, proposal):
        if ap.spawn_server is None:
            raise Veto("no spawn actuator attached (tracker not wired)")
        ap.spawn_server()


class ScaleInRule(PolicyRule):
    """Opt-in scale-in: with every server under the configured
    watermark (``PS_AUTOPILOT_SCALE_IN_RATE`` > 0) and nothing
    shedding, retire the least-loaded rank.  Disabled by default —
    shrinking a healthy cluster is never urgent."""

    name = "scale_in"

    def __init__(self, env):
        super().__init__(
            sustain=env.find_int("PS_AUTOPILOT_SCALE_IN_SUSTAIN", 10),
            cooldown_s=env.find_float("PS_AUTOPILOT_SCALE_COOLDOWN_S", 60.0),
        )
        self.watermark = env.find_float("PS_AUTOPILOT_SCALE_IN_RATE", 0.0)
        self.min_servers = env.find_int("PS_AUTOPILOT_MIN_SERVERS", 1)

    def sense(self, ap, history, wall):
        if self.watermark <= 0:
            return None
        rates = _server_rates(history)
        if len(rates) <= self.min_servers:
            return None
        if any(r >= self.watermark for r in rates.values()):
            return None
        for nid in rates:
            shed = history.rate(nid, "qos.shed_requests")
            if shed is not None and shed > 0:
                return None
        from ..base import id_to_rank
        idle_nid = min(rates, key=rates.get)
        return {
            "action": "scale_in",
            "reason": (f"all {len(rates)} servers under "
                       f"{self.watermark:g} req/s"),
            "rank": id_to_rank(idle_nid) // ap.po.group_size,
        }

    def act(self, ap, proposal):
        if ap.retire_server is None:
            raise Veto("no retire actuator attached (tracker not wired)")
        table = ap.po.routing_table()
        if table is not None and len(table.active) <= max(
                1, self.min_servers):
            raise Veto(f"already at min_servers={self.min_servers}")
        ap.retire_server(proposal["rank"])


class SnapshotAgeRule(PolicyRule):
    """Durable-tier staleness → schedule a snapshot; exponential
    backoff while the cut keeps getting vetoed (apply-pool quiesce
    pressure, migrations in flight)."""

    name = "snapshot_age"

    def __init__(self, env, warn: float):
        super().__init__(
            sustain=env.find_int("PS_AUTOPILOT_SNAPSHOT_SUSTAIN", 2),
            cooldown_s=env.find_float(
                "PS_AUTOPILOT_SNAPSHOT_COOLDOWN_S", 30.0),
        )
        self.age_s = warn  # the watchdog's snapshot_age WARN threshold
        self.backoff = 1
        self.backoff_max = env.find_int("PS_AUTOPILOT_BACKOFF_MAX", 16)

    def effective_cooldown(self) -> float:
        return self.cooldown_s * self.backoff

    def on_result(self, ok: bool) -> None:
        # Quiesce-fence pressure is the backoff signal: a vetoed cut
        # (busy apply pool, migration mid-handoff) doubles the retry
        # horizon; a committed cut resets it.
        self.backoff = 1 if ok else min(self.backoff * 2,
                                        self.backoff_max)

    def sense(self, ap, history, wall):
        worst = None
        for nid in history.node_ids():
            m = history.latest(nid) or {}
            age = m.get("gauges", {}).get("snapshot.age_s")
            if age is None:
                continue
            age = float(age)
            # Negative = configured but never committed: infinitely
            # stale for scheduling purposes.
            age = float("inf") if age < 0 else age
            if worst is None or age > worst:
                worst = age
        if worst is None or worst < self.age_s:
            return None
        pretty = "never" if worst == float("inf") else f"{worst:.0f}s"
        return {
            "action": "snapshot",
            "reason": f"snapshot age {pretty} ≥ {self.age_s:g}s",
            "backoff": self.backoff,
        }

    def act(self, ap, proposal):
        po = ap.po
        if not po.snapshot_dir:
            raise Veto("no snapshot directory (PS_SNAPSHOT_DIR unset)")
        # po.snapshot blocks on a cluster-wide gather — never on the
        # sampler thread.  The outcome lands as a follow-up flight
        # event and feeds the backoff.
        def _cut():
            try:
                po.snapshot()
            except Exception as exc:  # noqa: BLE001 - veto/timeout
                self.on_result(False)
                ap._record_followup(self, "snapshot", FAILED,
                                    repr(exc)[:160],
                                    backoff=self.backoff)
            else:
                self.on_result(True)
                ap._record_followup(self, "snapshot", ACTED,
                                    "cut committed")
        threading.Thread(target=_cut, name="autopilot-snapshot",
                         daemon=True).start()


class ApplyWaitRule(PolicyRule):
    """Critical-path dominance of the apply-shard wait stage → halve
    the apply task quantum cluster-wide (smaller tasks preempt
    sooner; docs/apply_shards.md)."""

    name = "apply_wait"

    _FLOOR = 64 << 10  # quantum floor: below this, task overhead wins

    def __init__(self, env):
        super().__init__(
            sustain=env.find_int("PS_AUTOPILOT_SUSTAIN", 3),
            cooldown_s=env.find_float(
                "PS_AUTOPILOT_RETUNE_COOLDOWN_S", 60.0),
        )
        self.share = env.find_float("PS_AUTOPILOT_APPLY_WAIT_SHARE", 0.5)
        self.min_traces = env.find_int("PS_AUTOPILOT_MIN_TRACES", 8)

    def sense(self, ap, history, wall):
        agg = ap.trace_aggregate()
        if not agg or agg.get("count", 0) < self.min_traces:
            return None
        info = (agg.get("slow") or {}).get("apply_wait") or {}
        share = float(info.get("share", 0.0))
        if share < self.share:
            return None
        return {
            "action": "retune_apply",
            "reason": (f"apply_wait is {share * 100:.0f}% of the "
                       f"slow-quartile wall (≥ {self.share * 100:.0f}%)"),
            "share": round(share, 3),
        }

    def act(self, ap, proposal):
        cur = ap.apply_task_bytes
        if cur <= self._FLOOR:
            raise Veto(f"apply quantum already at floor ({cur} B)")
        new = max(self._FLOOR, cur // 2)
        ap.po.retune_apply(new)
        ap.apply_task_bytes = new
        proposal["task_bytes"] = new


class ApplyWidenRule(PolicyRule):
    """Symmetric recovery for :class:`ApplyWaitRule`: when the
    apply-wait share of the slow-quartile wall has COLLAPSED and the
    quantum sits below its configured baseline, double it back toward
    the baseline (bigger tasks amortize dispatch overhead;
    docs/apply_shards.md).  Same sustain/cooldown guardrails as the
    narrowing rule, so a transient lull can't thrash the quantum."""

    name = "apply_widen"

    def __init__(self, env):
        super().__init__(
            sustain=env.find_int("PS_AUTOPILOT_SUSTAIN", 3),
            cooldown_s=env.find_float(
                "PS_AUTOPILOT_RETUNE_COOLDOWN_S", 60.0),
        )
        self.share = env.find_float("PS_AUTOPILOT_APPLY_WIDEN_SHARE",
                                    0.15)
        self.min_traces = env.find_int("PS_AUTOPILOT_MIN_TRACES", 8)
        # The quantum the operator configured — the ceiling widening
        # converges back to, never beyond.
        self.baseline = env.find_int("PS_APPLY_TASK_BYTES", 2 << 20)

    def sense(self, ap, history, wall):
        if ap.apply_task_bytes >= self.baseline:
            return None  # nothing was narrowed; nothing to undo
        agg = ap.trace_aggregate()
        if not agg or agg.get("count", 0) < self.min_traces:
            return None  # no evidence the pressure is gone — hold
        info = (agg.get("slow") or {}).get("apply_wait") or {}
        share = float(info.get("share", 0.0))
        if share > self.share:
            return None
        return {
            "action": "retune_apply",
            "reason": (f"apply_wait fell to {share * 100:.0f}% of the "
                       f"slow-quartile wall (≤ {self.share * 100:.0f}%) "
                       f"with the quantum narrowed"),
            "share": round(share, 3),
        }

    def act(self, ap, proposal):
        cur = ap.apply_task_bytes
        if cur >= self.baseline:
            raise Veto(f"apply quantum already at baseline ({cur} B)")
        new = min(self.baseline, cur * 2)
        ap.po.retune_apply(new)
        ap.apply_task_bytes = new
        proposal["task_bytes"] = new


class Autopilot:
    """The policy engine.  Constructed by ``Postoffice.start_history``
    when ``PS_AUTOPILOT`` is set; ``observe`` rides every
    ``ClusterHistory.ingest`` (after the watchdog)."""

    def __init__(self, po, env=None, mode: str = "act"):
        env = env if env is not None else po.env
        self.po = po
        self.mode = mode
        self.history_ref = None  # set when attached to a ClusterHistory
        # Pluggable scale actuators (the tracker, or in-process fakes
        # in tests/benches).  Decisions veto loudly when absent.
        self.spawn_server: Optional[Callable[[], None]] = None
        self.retire_server: Optional[Callable[[int], None]] = None
        # Global action budget: across ALL rules.
        self.max_actions = env.find_int("PS_AUTOPILOT_MAX_ACTIONS", 4)
        self.window_s = env.find_float("PS_AUTOPILOT_WINDOW_S", 60.0)
        self._action_walls: collections.deque = collections.deque(
            maxlen=max(16, self.max_actions * 4))
        self.decision_log: collections.deque = collections.deque(
            maxlen=env.find_int("PS_AUTOPILOT_LOG", 128))
        # The apply quantum the fleet currently runs (scheduler's view;
        # retunes keep it in step).
        self.apply_task_bytes = env.find_int("PS_APPLY_TASK_BYTES",
                                             2 << 20)
        # Trace aggregation source for apply_wait (injectable in
        # tests): default pulls the scheduler's trace collector at most
        # every trace_every-th observe round.
        self.trace_every = env.find_int("PS_AUTOPILOT_TRACE_EVERY", 4)
        self.trace_source: Optional[Callable[[], dict]] = None
        self._trace_agg: dict = {}
        self._observes = 0
        self._mu = threading.Lock()

        from ..telemetry.health import DEFAULT_THRESHOLDS
        wd_rules = getattr(po, "history", None)
        wd_rules = (wd_rules.watchdog.rules
                    if wd_rules is not None else None)

        def _thresh(rule, idx):
            if wd_rules is not None and rule in wd_rules:
                r = wd_rules[rule]
                return r.crit if idx else r.warn
            return DEFAULT_THRESHOLDS[rule][idx]

        self.rules: List[PolicyRule] = [
            HotSkewRule(env),
            ShedScaleRule(env, crit=_thresh("shed_rate", 1)),
            ScaleInRule(env),
            SnapshotAgeRule(env, warn=_thresh("snapshot_age", 0)),
            ApplyWaitRule(env),
            ApplyWidenRule(env),
        ]
        disabled = {
            r.strip() for r in
            (env.find("PS_AUTOPILOT_DISABLE") or "").split(",")
            if r.strip()
        }
        known = {r.name for r in self.rules}
        bad = disabled - known
        log.check(not bad, f"unknown PS_AUTOPILOT_DISABLE rule(s) "
                           f"{sorted(bad)} (known: {sorted(known)})")
        self.rules = [r for r in self.rules if r.name not in disabled]

    # -- sensing hooks -------------------------------------------------------

    def trace_aggregate(self) -> dict:
        """Freshest critical-path aggregate.  The default source pulls
        the scheduler's live trace collector (TRACE_PULL) every
        ``trace_every``-th observe round — trace assembly is too heavy
        for every sample.  Tests inject ``trace_source``."""
        if self.trace_source is not None:
            try:
                self._trace_agg = self.trace_source() or {}
            except Exception as exc:  # noqa: BLE001 - a bad source
                log.vlog(1, f"autopilot trace source failed: {exc!r}")
            return self._trace_agg
        if self.trace_every <= 0:
            return {}
        if self._observes % self.trace_every == 0:
            try:
                coll = self.po.collect_cluster_traces(timeout_s=2.0)
                self._trace_agg = coll.aggregate()
            except Exception as exc:  # noqa: BLE001 - mid-teardown van
                log.vlog(1, f"autopilot trace pull failed: {exc!r}")
        return self._trace_agg

    # -- the loop ------------------------------------------------------------

    def observe(self, history, wall: Optional[float] = None) -> List[Decision]:
        """Grade every rule against the history's freshest window.
        Called by ``ClusterHistory.ingest`` (sampler thread or a
        synthetic test feed); returns the decisions made this round."""
        wall = time.time() if wall is None else float(wall)
        if not self._mu.acquire(blocking=False):
            return []  # a slow actuator round must not stack observers
        try:
            self.history_ref = history
            out: List[Decision] = []
            for rule in self.rules:
                try:
                    proposal = rule.sense(self, history, wall)
                except Exception as exc:  # noqa: BLE001 - one broken
                    # sensor must not blind the others.
                    log.warning(f"autopilot {rule.name}.sense failed: "
                                f"{exc!r}")
                    continue
                if proposal is None:
                    rule.streak = 0
                    continue
                rule.streak += 1
                if rule.streak < rule.sustain:
                    log.vlog(1, f"autopilot {rule.name} arming "
                                f"{rule.streak}/{rule.sustain}: "
                                f"{proposal['reason']}")
                    continue
                d = self._decide(rule, proposal, wall)
                out.append(d)
            self._observes += 1
            return out
        finally:
            self._mu.release()

    def _decide(self, rule: PolicyRule, proposal: dict,
                wall: float) -> Decision:
        action = proposal.pop("action")
        reason = proposal.pop("reason")
        # A decision point always resets the streak: the rule must
        # re-sustain before its next consideration (this also rate-
        # limits repeated veto narration to once per sustained streak).
        rule.streak = 0
        if wall - rule.last_fired < rule.effective_cooldown():
            remain = rule.effective_cooldown() - (wall - rule.last_fired)
            return self._record(wall, rule, action, VETOED, reason,
                                veto=f"cooldown ({remain:.0f}s left)",
                                **proposal)
        recent = [w for w in self._action_walls
                  if wall - w < self.window_s]
        if len(recent) >= self.max_actions:
            return self._record(
                wall, rule, action, VETOED, reason,
                veto=(f"budget ({self.max_actions} actions/"
                      f"{self.window_s:.0f}s exhausted)"),
                **proposal)
        rule.last_fired = wall
        # Plan mode consumes budget too: the dry-run narration must
        # match what act mode would actually have done.
        self._action_walls.append(wall)
        if self.mode == "plan":
            return self._record(wall, rule, action, PLANNED, reason,
                                **proposal)
        try:
            rule.act(self, proposal)
        except Veto as v:
            self._action_walls.pop()  # a vetoed action spent nothing
            return self._record(wall, rule, action, VETOED, reason,
                                veto=str(v), **proposal)
        except Exception as exc:  # noqa: BLE001 - actuator failure
            log.warning(f"autopilot {rule.name}.act failed: {exc!r}")
            return self._record(wall, rule, action, FAILED, reason,
                                error=repr(exc)[:160], **proposal)
        return self._record(wall, rule, action, ACTED, reason, **proposal)

    # -- narration -----------------------------------------------------------

    def _record(self, wall: float, rule: PolicyRule, action: str,
                outcome: str, reason: str, **detail) -> Decision:
        d = Decision(wall, rule.name, action, outcome, reason, detail)
        self.decision_log.append(d)
        sev = _INFO if outcome in (ACTED, PLANNED) else _WARN
        self.po.flight.record("autopilot", severity=sev, rule=rule.name,
                              action=action, outcome=outcome,
                              reason=reason, **detail)
        hist = self.history_ref
        if hist is not None:
            hist.watchdog._emit(
                wall, _INFO, f"autopilot.{rule.name}", node_id=-1,
                role="scheduler", metric=action, value=0.0,
                threshold=0.0, window_s=hist.default_window_s,
                message=f"{outcome}: {reason}"
                        + (f" — {detail['veto']}" if "veto" in detail
                           else ""),
            )
        log.vlog(0 if outcome in (ACTED, FAILED) else 1,
                 f"autopilot {rule.name}:{action} {outcome} — {reason}"
                 + (f" ({detail.get('veto') or detail.get('error')})"
                    if outcome in (VETOED, FAILED) else ""))
        return d

    def _record_followup(self, rule: PolicyRule, action: str,
                         outcome: str, reason: str, **detail) -> None:
        """Async actuator completion (the snapshot thread) — narrated
        like a decision so the flight log shows the whole arc."""
        self._record(time.time(), rule, action, outcome, reason,
                     followup=True, **detail)

    def decisions(self, n: int = 8) -> List[Decision]:
        """The last ``n`` decisions, oldest first (psmon's footer)."""
        return list(self.decision_log)[-max(0, n):]

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for d in self.decision_log:
            c[d.outcome] = c.get(d.outcome, 0) + 1
        return c
