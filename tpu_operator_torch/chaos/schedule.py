"""Seeded, replayable chaos schedules.

EVERY decision — event times, kinds, victim names, join names, slice
shapes — is made at GENERATION time from one ``random.Random(seed)``
over a *projected* fleet the generator tracks itself (joins add names,
preemptions remove them). The executed schedule is therefore a pure
function of ``(seed, knobs)``: the same seed replays the identical
event sequence byte for byte, and a recorded trace re-executes without
the RNG at all. That is the debugging contract the soak exists to
provide — a failing 40-minute run collapses to "replay seed N".

Event kinds (args are plain JSON):

========== ==========================================================
kind        effect at execution
========== ==========================================================
join        ``sim.add_nodes`` with pinned names (optionally forming a
            new multi-host slice via TFD slice labels)
preempt     ``sim.delete_node`` for each named victim (spot wave)
kill_chips  ``sim.kill_node_chips`` (+ plugin-side health flip)
restore     ``sim.restore_node_chips`` for a previously killed host
flap        ``sim.flap_node_chips`` (one edge)
fault       ``sim.inject_fault`` (verb/code/count)
partition   ``sim.partition`` (short full-apiserver window)
repartition flip ``spec.sliceManager.config.default`` to a profile —
            the live re-partition roll (third budget consumer)
bad_version register a driver version as bad
            (``kube.testing.inject_bad_version``: degraded validator
            TFLOPS/membw, optional CrashLoopBackOff)
driver_roll flip ``spec.driver.version`` — with ``spec.rollout``
            enabled, a health-gated canary roll the injected bad
            version must fail, driving automatic rollback
========== ==========================================================

``bad_version``/``driver_roll`` are scheduled explicitly (like the one
repartition) from the ``rollout`` knob and consume NO RNG draws, so
schedules generated without the knob stay byte-identical to old seeds.

The port's copy of ``tpu_operator/chaos/schedule.py``. The generator
draws from its RNG exactly as the reference's does, in the same order, so
one seed gives the reference's trace under
``convert.chaos_trace_from_reference``: the event kinds, ``ChaosEvent``,
``ChaosSchedule`` and ``TRACE_VERSION`` are the reference's, the driver
roll is ``driver_roll`` where the reference rolls ``libtpu_roll``, and a
profile or version is an opaque string the caller names (the soak's
profile ``all-1x2`` where the reference's is ``balanced-2x2``, its bad
version a driver version).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

TRACE_VERSION = 1

# (kind, weight): the steady chaos mix; repartition is scheduled
# explicitly (once, mid-run) rather than drawn
_WEIGHTS = (
    ("join", 2.0),
    ("preempt", 2.0),
    ("kill_chips", 3.0),
    ("restore", 2.0),
    ("flap", 1.0),
    ("fault", 2.0),
    ("partition", 0.5),
)


@dataclass
class ChaosEvent:
    at_s: float
    kind: str
    args: Dict[str, object] = field(default_factory=dict)

    def to_doc(self) -> dict:
        return {"at_s": round(self.at_s, 4), "kind": self.kind, "args": self.args}

    @classmethod
    def from_doc(cls, doc: dict) -> "ChaosEvent":
        return cls(
            at_s=float(doc["at_s"]),
            kind=str(doc["kind"]),
            args=dict(doc.get("args") or {}),
        )


class ChaosSchedule:
    """Generate (or reload) one deterministic event schedule."""

    def __init__(
        self,
        seed: int,
        duration_s: float,
        initial_nodes: List[str],
        *,
        mean_gap_s: float = 0.6,
        join_max: int = 4,
        preempt_fraction: float = 0.08,
        min_fleet: int = 4,
        slice_hosts: int = 2,
        repartition_profiles: Optional[List[str]] = None,
        rollout: Optional[Dict[str, object]] = None,
        events: Optional[List[ChaosEvent]] = None,
    ):
        self.seed = seed
        self.duration_s = duration_s
        self.initial_nodes = sorted(initial_nodes)
        self.mean_gap_s = mean_gap_s
        self.join_max = join_max
        self.preempt_fraction = preempt_fraction
        self.min_fleet = min_fleet
        self.slice_hosts = slice_hosts
        self.repartition_profiles = repartition_profiles or []
        # {"version": str, "tflops_factor": float, "crashloop": bool}:
        # schedule one seeded bad-version driver roll mid-run (the
        # rollout orchestrator's rollback acceptance scenario)
        self.rollout = dict(rollout) if rollout else {}
        self.events: List[ChaosEvent] = (
            events if events is not None else self._generate()
        )

    # ------------------------------------------------------------------
    def _generate(self) -> List[ChaosEvent]:
        rng = random.Random(self.seed)
        live = list(self.initial_nodes)  # projected fleet, insertion order
        killed: List[str] = []  # projected dead-chip hosts
        join_seq = 0
        slice_seq = 0
        events: List[ChaosEvent] = []
        kinds = [k for k, _ in _WEIGHTS]
        weights = [w for _, w in _WEIGHTS]
        t = 0.0
        while True:
            t += rng.uniform(0.2, 2.0) * self.mean_gap_s
            if t >= self.duration_s:
                break
            kind = rng.choices(kinds, weights=weights, k=1)[0]
            if kind == "join":
                count = rng.randint(1, self.join_max)
                names = []
                args: Dict[str, object] = {}
                if count >= self.slice_hosts and rng.random() < 0.5:
                    # this wave forms a NEW multi-host slice
                    slice_seq += 1
                    count = self.slice_hosts
                    args["slice_id"] = f"storm-slice-{slice_seq}"
                    args["slice_hosts"] = self.slice_hosts
                for _ in range(count):
                    join_seq += 1
                    names.append(f"storm-{self.seed}-{join_seq}")
                live.extend(names)
                args["names"] = names
                events.append(ChaosEvent(t, "join", args))
            elif kind == "preempt":
                if len(live) <= self.min_fleet:
                    continue
                count = min(
                    len(live) - self.min_fleet,
                    max(1, int(len(live) * self.preempt_fraction)),
                )
                victims = rng.sample(sorted(live), count)
                for v in victims:
                    live.remove(v)
                    if v in killed:
                        killed.remove(v)
                events.append(ChaosEvent(t, "preempt", {"names": victims}))
            elif kind == "kill_chips":
                candidates = sorted(set(live) - set(killed))
                if not candidates:
                    continue
                victim = rng.choice(candidates)
                killed.append(victim)
                events.append(ChaosEvent(t, "kill_chips", {"node": victim}))
            elif kind == "restore":
                if not killed:
                    continue
                victim = rng.choice(sorted(killed))
                killed.remove(victim)
                events.append(ChaosEvent(t, "restore", {"node": victim}))
            elif kind == "flap":
                if not live:
                    continue
                victim = rng.choice(sorted(live))
                # a flap toggles: keep the projected killed set honest
                if victim in killed:
                    killed.remove(victim)
                else:
                    killed.append(victim)
                events.append(ChaosEvent(t, "flap", {"node": victim}))
            elif kind == "fault":
                verb = rng.choice(["PUT", "PATCH", "POST", "LIST", "GET"])
                code = rng.choice([429, 500, 503])
                events.append(
                    ChaosEvent(
                        t,
                        "fault",
                        {
                            "verb": verb,
                            "code": code,
                            "count": rng.randint(1, 4),
                            "retry_after": 0.05 if code == 429 else None,
                        },
                    )
                )
            elif kind == "partition":
                events.append(
                    ChaosEvent(
                        t,
                        "partition",
                        {"duration_s": round(rng.uniform(0.2, 0.6), 3)},
                    )
                )
        if self.rollout:
            # seeded mid-roll bad version: the injection lands BEFORE
            # the version flip so the canary cohort reports degraded
            # perf the moment it rolls. Fixed fractions, zero RNG draws
            # — pre-existing seeds replay byte-identically
            events.append(
                ChaosEvent(
                    self.duration_s * 0.2,
                    "bad_version",
                    {
                        "version": str(self.rollout["version"]),
                        "tflops_factor": float(
                            self.rollout.get("tflops_factor", 0.4)
                        ),
                        "crashloop": bool(
                            self.rollout.get("crashloop", False)
                        ),
                    },
                )
            )
            events.append(
                ChaosEvent(
                    self.duration_s * 0.25,
                    "driver_roll",
                    {"version": str(self.rollout["version"])},
                )
            )
        if self.repartition_profiles:
            # exactly one live re-partition roll, mid-run: the layout
            # flip lands while joins/preemptions/faults are in flight
            profile = self.repartition_profiles[
                rng.randrange(len(self.repartition_profiles))
            ]
            events.append(
                ChaosEvent(
                    self.duration_s * 0.4, "repartition", {"profile": profile}
                )
            )
        events.sort(key=lambda e: (e.at_s, e.kind))
        return events

    # ------------------------------------------------------------------
    def trace(self) -> dict:
        """The replayable record: feed it back through ``from_trace`` to
        re-execute the identical schedule with no RNG involved."""
        return {
            "version": TRACE_VERSION,
            "seed": self.seed,
            "duration_s": self.duration_s,
            "initial_nodes": self.initial_nodes,
            "events": [e.to_doc() for e in self.events],
        }

    @classmethod
    def from_trace(cls, doc: dict) -> "ChaosSchedule":
        if doc.get("version") != TRACE_VERSION:
            raise ValueError(
                f"trace version {doc.get('version')!r} != {TRACE_VERSION}"
            )
        return cls(
            seed=int(doc["seed"]),
            duration_s=float(doc["duration_s"]),
            initial_nodes=list(doc["initial_nodes"]),
            events=[ChaosEvent.from_doc(d) for d in doc["events"]],
        )
