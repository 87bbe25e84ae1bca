"""Serving federation: city-sharded engine replicas behind one router.

A copy of ``stmgcn_tpu/serving/federation.py`` (host code over numpy and
the registry) with the port's registry, admission errors and config; the
replicas are the port's engines (on one card, each fleet engine's graph
pool lock serializes only its own replays, and :meth:`FederationRouter.close`
releases every engine's programs).

One engine process closed the single-host story (admission control,
atomic hot-swap, guarded promotion, the continual loop); "millions of
users" is a *tier* of them. :class:`FederationRouter` shards cities
across M engine replicas via consistent city→replica hashing — one
level above the fleet engine's city→class routing, the Morphling
multi-graph batching pattern lifted to processes — and owns the pieces
a replica tier is only real with:

- **scatter/gather** — a multi-city request fans out per owning
  replica and gathers under a bounded join; every city comes back as a
  :class:`CityOutcome` carrying either its prediction or its *own*
  typed error (shed, dispatch failure, dead replica, gather timeout).
  A caller is never hung and never handed a half-answer it cannot
  attribute.
- **tier generation consistency** — the per-engine atomic
  ``(generation, params)`` contract lifted to M engines: a gathered
  multi-city response is re-dispatched (bounded, like the engine's own
  ``_SWAP_RETRIES``) until every city answers from one generation, so
  a tier-wide cutover never leaks a mixed-generation response.
- **global admission** — every replica's
  :class:`~stmgcn_tpu_torch.serving.admission.AdmissionController` draws one
  shared :class:`~stmgcn_tpu_torch.serving.admission.GlobalBudget` down, so
  tier-wide pending work is bounded even when each local bound alone
  would admit.
- **lifecycle** — drain (stop admitting, flush in-flight bounded by
  ``drain_timeout_s``, detach — a wedged checkpoint watcher is
  *reported*, not waited on), re-shard (consistent-hash ring move:
  only the removed/added replica's cities move, handover bounded by
  ``handover_timeout_s``), and warm-spare promotion (a spare already
  built and checkpoint-watching joins the ring in one assignment
  swap).
- **fleet drift rollup** — per-replica drift snapshots published as
  replica-labeled gauges (``federation.drift_*{replica=...}``) plus a
  fleet-wide worst-case, the signal one
  :class:`~stmgcn_tpu_torch.train.continual.ContinualDaemon` per shard
  retrains on.

Fault drills, not mocks: a
:class:`~stmgcn_tpu_torch.resilience.FederationFaultPlan` gets its shot at
scatter entry (replica-kill by scatter ordinal), drain entry
(hang-on-drain), and the open-loop schedule (herd-spike); the empty
plan short-circuits every hook — production routes exactly the drilled
code.

Lock discipline (the concurrency lint rules hold here too): the
router's ring/assignment state lives behind ``self._lock``; engine
calls NEVER run under it (group snapshots are copied out first);
per-replica state lives behind each :class:`ReplicaHandle`'s own lock;
and the only cross-object order is router-lock → handle-lock →
budget-lock, acyclic by construction.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.serving.admission import ShedError

__all__ = [
    "CityOutcome",
    "FederationRouter",
    "HashRing",
    "ReplicaHandle",
    "ReplicaUnavailable",
    "ring_hash",
]

#: absolute never-hang backstop for one scatter/gather (normal requests
#: are bounded far tighter by each replica's admission deadline)
GATHER_TIMEOUT_S = 30.0

#: bounded re-dispatch budget for single-generation gather assembly —
#: mirrors the engine's ``_SWAP_RETRIES`` (a swap can land mid-gather
#: at most once per generation; 20 covers pathological stacking)
_TIER_RETRIES = 20

#: pause between generation-consistency retry rounds: long enough for a
#: cutover poll on a sibling replica to land, short enough to stay
#: inside any sane deadline
_RETRY_PAUSE_S = 0.002


def ring_hash(key: str) -> int:
    """Deterministic 64-bit ring position (process-salt-free, unlike
    builtin ``hash`` — ring layouts must agree across runs and hosts)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class ReplicaUnavailable(ShedError):
    """The owning replica is dead, draining, or detached — a typed
    routing rejection (retryable: the ring heals on the next scatter)."""


@dataclasses.dataclass
class CityOutcome:
    """One city's slice of a gathered multi-city response: exactly one
    of ``prediction`` (with its ``generation``) or ``error`` is set."""

    city: int
    prediction: Optional[np.ndarray] = None
    generation: Optional[int] = None
    error: Optional[BaseException] = None
    replica: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class HashRing:
    """Consistent city→replica hash ring with virtual nodes.

    Each replica contributes ``vnodes`` points; a city is owned by the
    first point clockwise of its own hash. Removing a replica moves
    only *its* cities (the minimal-movement property re-sharding relies
    on); adding one steals only the cities its new points cover.
    Immutable once built — the router swaps whole rings atomically.
    """

    def __init__(self, replica_ids, vnodes: int = 64):
        self.replica_ids = tuple(sorted(replica_ids))
        if not self.replica_ids:
            raise ValueError("HashRing needs at least one replica")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, int]] = sorted(
            (ring_hash(f"replica:{rid}#{v}"), rid)
            for rid in self.replica_ids
            for v in range(self.vnodes)
        )
        self._keys = [p[0] for p in self._points]

    def owner(self, city: int) -> int:
        """The replica owning ``city`` (deterministic across runs)."""
        h = ring_hash(f"city:{city}")
        i = bisect.bisect_right(self._keys, h)
        if i == len(self._points):
            i = 0  # wrap: the ring is a circle
        return self._points[i][1]

    def assignment(self, cities) -> Dict[int, int]:
        """city → owning replica for every city."""
        return {c: self.owner(c) for c in cities}

    def imbalance(self, cities) -> float:
        """Max relative per-replica overload vs the uniform share
        (0.0 = perfectly even). The ``federation-config`` rule bounds
        what a config may *demand*; this measures what a ring *does*."""
        cities = list(cities)
        if not cities:
            return 0.0
        counts = {rid: 0 for rid in self.replica_ids}
        for c in cities:
            counts[self.owner(c)] += 1
        uniform = len(cities) / len(self.replica_ids)
        return max(n / uniform - 1.0 for n in counts.values())


class ReplicaHandle:
    """One replica's identity + lifecycle state + in-flight account.

    States: ``active`` (in the ring), ``spare`` (built and watching,
    outside the ring), ``draining`` (no new admissions, flushing),
    ``detached`` (out of the ring, engine alive), ``dead`` (killed).
    All state is guarded by the handle's own lock; the engine reference
    itself is immutable.
    """

    def __init__(self, replica_id: int, engine, state: str = "active"):
        self.replica_id = replica_id
        self.engine = engine
        self._lock = threading.Lock()
        self._state = state
        self._in_flight = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def mark(self, state: str) -> None:
        with self._lock:
            self._state = state

    def routable(self) -> bool:
        """Whether the router may send new work here."""
        with self._lock:
            return self._state == "active"

    def begin(self) -> bool:
        """Account one in-flight request; False = not admitting."""
        with self._lock:
            if self._state != "active":
                return False
            self._in_flight += 1
            return True

    def end(self) -> None:
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)

    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight


class FederationRouter:
    """City-sharded scatter/gather over M engine replicas.

    ``engines`` are fully built fleet/serving engines able to serve any
    city (the ring decides *ownership*, so a re-shard is an assignment
    move, not a rebuild); ``spare_engines`` join as warm spares.
    ``global_budget`` is the :class:`GlobalBudget` the engines'
    admission controllers were built with (the router only reports it).
    """

    def __init__(self, engines, cities, *, config=None, spare_engines=(),
                 global_budget=None, fault_plan=None, log=None):
        if config is None:
            from stmgcn_tpu_torch.config import FederationConfig

            config = FederationConfig(enabled=True, replicas=len(engines))
        bad = config.violations(n_cities=len(tuple(cities)))
        if bad:
            raise ValueError("invalid federation config: " + "; ".join(bad))
        self.config = config
        self.cities = tuple(int(c) for c in cities)
        self.budget = global_budget
        self._log = log if log is not None else (lambda msg: None)
        self._fault_plan = (
            fault_plan if fault_plan is not None and fault_plan.active else None
        )
        self._handles: Dict[int, ReplicaHandle] = {}
        for rid, eng in enumerate(engines):
            self._handles[rid] = ReplicaHandle(rid, eng, "active")
        for off, eng in enumerate(spare_engines):
            rid = len(engines) + off
            self._handles[rid] = ReplicaHandle(rid, eng, "spare")
        if not any(h.routable() for h in self._handles.values()):
            raise ValueError("FederationRouter needs at least one active replica")
        #: per-shard continual daemons (attach_continual)
        self.daemons: Dict[int, object] = {}
        # ring + assignment swap atomically under one lock; scatter and
        # drill counters share it (single-writer hot path, cheap)
        self._lock = threading.Lock()
        self._ring = HashRing(
            [rid for rid, h in self._handles.items() if h.routable()],
            vnodes=config.vnodes,
        )
        self._assignment = self._ring.assignment(self.cities)
        # the city *set* is immutable after construction (re-shards move
        # ownership, never membership) — validation reads this, not the
        # mutable assignment
        self._city_set = frozenset(self.cities)
        self._scatter_seq = 0
        self.generation_retries = 0
        self.cities_moved = 0
        self.kills = 0

    # -- routing ---------------------------------------------------------

    def replica_for(self, city: int) -> int:
        """Current owner of ``city`` (ring + any re-shard moves)."""
        self._check_city(city)
        with self._lock:
            return self._assignment[city]

    def _check_city(self, city: int) -> None:
        if city not in self._city_set:
            raise ValueError(
                f"city must be one of {sorted(self._city_set)}, got {city}"
            )

    def assignment(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._assignment)

    def predict(self, history, *, city: int, with_generation: bool = False):
        """Single-city predict through the owning replica.

        Typed errors propagate exactly like the engine API (sheds,
        dispatch failures); a dead/draining owner raises
        :class:`ReplicaUnavailable` after one transparent re-shard
        attempt finds no live owner.
        """
        self._check_city(city)
        for _ in range(2):  # original owner, then post-heal owner
            with self._lock:
                rid = self._assignment[city]
            handle = self._handles[rid]
            if handle.begin():
                try:
                    return handle.engine.predict(
                        history, city=city, with_generation=with_generation
                    )
                finally:
                    handle.end()
            self._heal(rid)
        raise ReplicaUnavailable(
            f"no live replica owns city {city} — replica {rid} is "
            f"{handle.state} and the ring could not re-shard around it"
        )

    # -- scatter/gather --------------------------------------------------

    def predict_many(self, requests: Mapping[int, np.ndarray], *,
                     timeout_s: Optional[float] = None
                     ) -> Dict[int, CityOutcome]:
        """Scatter a multi-city batch request, gather per-city outcomes.

        Never hangs (bounded join per round, ``timeout_s`` overall,
        default :data:`GATHER_TIMEOUT_S`) and never mixes generations:
        successful cities are re-dispatched until they agree on the
        newest generation seen, so a tier-wide cutover mid-gather costs
        retries, not consistency. Cities that cannot be served come
        back with their own typed error.
        """
        deadline = time.perf_counter() + (
            GATHER_TIMEOUT_S if timeout_s is None else timeout_s
        )
        with self._lock:
            ordinal = self._scatter_seq
            self._scatter_seq += 1
        REGISTRY.counter("federation.scatters").inc()
        plan = self._fault_plan
        if plan is not None:
            victim = plan.kill_at_scatter(ordinal)
            if victim is not None:
                self.kill(victim)
        outcomes: Dict[int, CityOutcome] = {}
        todo = [int(c) for c in requests]
        for round_no in range(_TIER_RETRIES):
            if not todo:
                break
            self._gather_round(requests, todo, outcomes, deadline)
            # generation consistency: retry successes behind the newest
            # generation any city answered from (errors keep their type)
            gens = {o.generation for o in outcomes.values() if o.ok}
            if len(gens) <= 1:
                break
            target = max(gens)
            todo = [c for c, o in outcomes.items()
                    if o.ok and o.generation < target]
            self.generation_retries += len(todo)
            REGISTRY.counter("federation.generation_retries").inc(len(todo))
            if time.perf_counter() >= deadline:
                break
            time.sleep(_RETRY_PAUSE_S)
        # retries exhausted with generations still split: demote the
        # stale minority to a typed error — a mixed success response
        # must never leave the router
        gens = {o.generation for o in outcomes.values() if o.ok}
        if len(gens) > 1:
            target = max(gens)
            for c, o in outcomes.items():
                if o.ok and o.generation < target:
                    outcomes[c] = CityOutcome(
                        city=c, replica=o.replica,
                        error=ReplicaUnavailable(
                            f"city {c} could not be re-served on the tier "
                            f"generation {target} within {_TIER_RETRIES} "
                            "retries"
                        ),
                    )
        return outcomes

    def _gather_round(self, requests, todo, outcomes, deadline) -> None:
        """One scatter round over ``todo`` cities (mutates ``outcomes``)."""
        groups: Dict[int, List[int]] = {}
        unroutable: List[int] = []
        with self._lock:
            owners = {c: self._assignment[c] for c in todo}
        for c, rid in owners.items():
            if self._handles[rid].routable():
                groups.setdefault(rid, []).append(c)
            else:
                unroutable.append((c, rid))
        healed = set()
        for c, rid in unroutable:
            # dead/draining owner: heal the ring once per replica, then
            # re-resolve — the city either finds a live owner now or
            # reports a typed error this round
            if rid not in healed:
                healed.add(rid)
                self._heal(rid)
            with self._lock:
                new_rid = self._assignment[c]
            if new_rid != rid and self._handles[new_rid].routable():
                groups.setdefault(new_rid, []).append(c)
            else:
                outcomes[c] = CityOutcome(
                    city=c, replica=rid,
                    error=ReplicaUnavailable(
                        f"replica {rid} owning city {c} is "
                        f"{self._handles[rid].state} and no live replica "
                        "could take it over"
                    ),
                )
        if not groups:
            return
        if len(groups) == 1:
            # single-replica scatter: dispatch inline, no thread overhead
            ((rid, cities),) = groups.items()
            self._dispatch_group(rid, cities, requests, outcomes)
            return
        threads = []
        for rid, cities in groups.items():
            t = threading.Thread(
                target=self._dispatch_group,
                args=(rid, cities, requests, outcomes),
                name=f"stmgcn-scatter-{rid}", daemon=True,
            )
            t.start()
            threads.append((t, rid, cities))
        for t, rid, cities in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
            if t.is_alive():
                # bounded-join miss: the caller gets typed timeouts NOW;
                # the daemon thread writes into a dict nobody re-reads
                # for these cities (outcomes are overwritten here)
                REGISTRY.counter("federation.hung_gathers").inc()
                for c in cities:
                    outcomes[c] = CityOutcome(
                        city=c, replica=rid,
                        error=ReplicaUnavailable(
                            f"gather from replica {rid} timed out for "
                            f"city {c} — caller released, replica marked "
                            "for drain"
                        ),
                    )

    def _dispatch_group(self, rid: int, cities, requests, outcomes) -> None:
        """Serve one replica's cities; every exception becomes that
        city's typed outcome (the worker must never die loudly)."""
        handle = self._handles[rid]
        for c in cities:
            if not handle.begin():
                outcomes[c] = CityOutcome(
                    city=c, replica=rid,
                    error=ReplicaUnavailable(
                        f"replica {rid} stopped admitting mid-gather "
                        f"({handle.state})"
                    ),
                )
                continue
            try:
                pred, gen = handle.engine.predict(
                    np.asarray(requests[c], dtype=np.float32),
                    city=c, with_generation=True,
                )
                outcomes[c] = CityOutcome(
                    city=c, prediction=pred, generation=gen, replica=rid
                )
            except Exception as e:  # typed per-city error, never a hang
                outcomes[c] = CityOutcome(city=c, replica=rid, error=e)
            finally:
                handle.end()

    # -- lifecycle -------------------------------------------------------

    def _heal(self, rid: int) -> int:
        """Re-shard around a non-routable replica; returns cities moved.
        Idempotent: a replica already outside the ring moves nothing."""
        handle = self._handles.get(rid)
        if handle is None or handle.routable():
            return 0
        return self._rebuild_ring()

    def _rebuild_ring(self) -> int:
        """Swap in a ring over the currently-routable replicas; returns
        how many cities changed owner (the minimal-movement property
        keeps this at ~1/M of cities per single-replica change)."""
        live = [r for r, h in self._handles.items() if h.routable()]
        if not live:
            return 0
        ring = HashRing(live, vnodes=self.config.vnodes)
        assignment = ring.assignment(self.cities)
        with self._lock:
            moved = sum(
                1 for c in self.cities if assignment[c] != self._assignment[c]
            )
            self._ring = ring
            self._assignment = assignment
            self.cities_moved += moved
        if moved:
            REGISTRY.counter("federation.resharded_cities").inc(moved)
        return moved

    def kill(self, rid: int) -> None:
        """Hard-kill a replica (the replica-kill drill's production
        path): mark dead, heal the ring, close the engine off-path —
        the scatter path never blocks behind a dying engine's drain."""
        handle = self._handles[rid]
        handle.mark("dead")
        self.kills += 1
        REGISTRY.counter("federation.replica_killed").inc()
        self._log(f"_event=replica_killed replica={rid}")
        self._heal(rid)
        closer = threading.Thread(
            target=self._close_engine, args=(rid,),
            name=f"stmgcn-reaper-{rid}", daemon=True,
        )
        closer.start()

    def _close_engine(self, rid: int) -> None:
        try:
            self._handles[rid].engine.close()
        except Exception as e:  # a dying engine must not kill the reaper
            self._log(f"_event=replica_close_error replica={rid} err={e!r}")

    def drain(self, rid: int, timeout_s: Optional[float] = None) -> dict:
        """Graceful replica removal: stop admitting, re-shard its
        cities away, flush in-flight within ``drain_timeout_s``, then
        detach. Always returns within the timeout (+ watcher join
        bound): a hang-on-drain fault or wedged watcher is *reported*
        in the result, never waited out.
        """
        timeout_s = (
            float(self.config.drain_timeout_s) if timeout_s is None
            else float(timeout_s)
        )
        t0 = time.perf_counter()
        handle = self._handles[rid]
        handle.mark("draining")
        moved = self._heal(rid)
        plan = self._fault_plan
        if plan is not None:
            plan.on_drain(rid)  # a hang here burns the drain budget
        deadline = t0 + timeout_s
        while handle.in_flight() > 0 and time.perf_counter() < deadline:
            time.sleep(0.005)
        flushed = handle.in_flight() == 0
        watcher = getattr(handle.engine, "_watcher", None)
        watcher_wedged = False
        if watcher is not None:
            # a False stop() already counted serving.watcher_wedged and
            # emitted the structured event naming this watch dir
            watcher_wedged = not watcher.stop()
        handle.mark("detached")
        report = {
            "replica": rid,
            "flushed": flushed,
            "moved_cities": moved,
            "watcher_wedged": watcher_wedged,
            "drain_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        self._log(f"_event=replica_drained {report}")
        return report

    def reshard(self, *, remove=(), add=()) -> dict:
        """Explicit ring membership change with a bounded handover.

        ``remove`` replicas stop admitting first; ``add`` replicas
        (spares or previously detached) become active; then one
        assignment swap moves only the affected cities. The handover
        window waits — bounded by ``handover_timeout_s`` — for the
        removed replicas' in-flight work, and reports whether it
        flushed.
        """
        for rid in remove:
            self._handles[rid].mark("draining")
        for rid in add:
            self._handles[rid].mark("active")
        moved = self._rebuild_ring()
        t0 = time.perf_counter()
        deadline = t0 + float(self.config.handover_timeout_s)
        flushed = True
        for rid in remove:
            handle = self._handles[rid]
            while handle.in_flight() > 0 and time.perf_counter() < deadline:
                time.sleep(0.005)
            flushed = flushed and handle.in_flight() == 0
            handle.mark("detached")
        return {
            "moved_cities": moved,
            "handover_flushed": flushed,
            "handover_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "active": sorted(
                r for r, h in self._handles.items() if h.routable()
            ),
        }

    def detach(self, rid: int) -> int:
        """Administrative detach: take a replica out of the ring without
        closing its engine (the tier promotion gate uses this for a
        replica whose cutover poll failed — it must leave the ring
        rather than serve a stale generation). Returns cities moved."""
        self._handles[rid].mark("detached")
        REGISTRY.counter("federation.replica_detached").inc()
        self._log(f"_event=replica_detached replica={rid}")
        return self._heal(rid)

    def promote_spare(self, spare_rid: int, *, replacing: Optional[int] = None
                      ) -> dict:
        """Warm-spare promotion: a built, checkpoint-watching spare
        joins the ring (optionally draining the replica it replaces).
        The spare's watcher/swap machinery already tracked the live
        generation, so the cutover is one assignment swap."""
        handle = self._handles[spare_rid]
        if handle.state != "spare":
            raise ValueError(
                f"replica {spare_rid} is {handle.state}, not a spare"
            )
        report = self.reshard(
            remove=(() if replacing is None else (replacing,)),
            add=(spare_rid,),
        )
        report["promoted"] = spare_rid
        report["replacing"] = replacing
        REGISTRY.counter("federation.spare_promoted").inc()
        return report

    # -- tier health / continual ----------------------------------------

    def engines(self) -> Dict[int, object]:
        """Engines that must track the live generation: active replicas
        AND warm spares (a spare promoted later must not time-travel)."""
        return {
            rid: h.engine for rid, h in sorted(self._handles.items())
            if h.state in ("active", "spare")
        }

    def health(self) -> dict:
        """Per-replica state + the tier invariant surface."""
        replicas = {}
        for rid, h in sorted(self._handles.items()):
            replicas[str(rid)] = {
                "state": h.state,
                "in_flight": h.in_flight(),
                "generation": h.engine.generation,
            }
        with self._lock:
            out = {
                "replicas": replicas,
                "scatters": self._scatter_seq,
                "generation_retries": self.generation_retries,
                "cities_moved": self.cities_moved,
                "kills": self.kills,
            }
        if self.budget is not None:
            out["budget"] = self.budget.snapshot()
        return out

    def drift_rollup(self) -> dict:
        """Fleet-wide drift view: replica-labeled gauges + the worst
        city/phase anywhere in the tier (what shard daemons and the
        fleet retrain trigger read)."""
        per: Dict[str, dict] = {}
        fleet = {"z_max": 0.0, "psi": 0.0}
        for rid, handle in sorted(self._handles.items()):
            if handle.state not in ("active", "draining"):
                continue
            snap = handle.engine.drift_snapshot()
            if snap is None:
                continue
            worst = {"z_max": 0.0, "psi": 0.0}
            for phases in snap.get("cities", {}).values():
                for gauges in phases.values():
                    worst["z_max"] = max(
                        worst["z_max"], float(gauges.get("z_max", 0.0))
                    )
                    worst["psi"] = max(
                        worst["psi"], float(gauges.get("psi", 0.0))
                    )
            labels = {"replica": str(rid)}
            REGISTRY.gauge("federation.drift_z_max", labels).set(worst["z_max"])
            REGISTRY.gauge("federation.drift_psi", labels).set(worst["psi"])
            per[str(rid)] = worst
            fleet["z_max"] = max(fleet["z_max"], worst["z_max"])
            fleet["psi"] = max(fleet["psi"], worst["psi"])
        REGISTRY.gauge("federation.drift_z_max", {"replica": "fleet"}).set(
            fleet["z_max"]
        )
        REGISTRY.gauge("federation.drift_psi", {"replica": "fleet"}).set(
            fleet["psi"]
        )
        return {"replicas": per, "fleet": fleet}

    def attach_continual(self, make_daemon) -> Dict[int, object]:
        """One continual daemon per shard: ``make_daemon(rid, engine)``
        builds each (see :class:`~stmgcn_tpu_torch.train.continual
        .ContinualDaemon` — pass ``replica=str(rid)`` so its gauges are
        replica-labeled). The router only holds them for lifecycle."""
        for rid, handle in sorted(self._handles.items()):
            if handle.state != "active" or rid in self.daemons:
                continue
            self.daemons[rid] = make_daemon(rid, handle.engine)
        return dict(self.daemons)

    def close(self) -> None:
        """Tier shutdown: stop daemons, stop watchers (wedged ones are
        counted + logged by ``stop()`` itself), close engines. Bounded:
        engine closes run on daemon reaper threads with a joined grace
        window, so one wedged replica cannot hold the tier open."""
        for daemon in self.daemons.values():
            stop = getattr(daemon, "stop", None)
            if stop is not None:
                stop()
        closers = []
        for rid, handle in sorted(self._handles.items()):
            if handle.state == "dead":
                continue  # the kill path already dispatched its reaper
            handle.mark("detached")
            watcher = getattr(handle.engine, "_watcher", None)
            if watcher is not None:
                watcher.stop()
            t = threading.Thread(
                target=self._close_engine, args=(rid,),
                name=f"stmgcn-close-{rid}", daemon=True,
            )
            t.start()
            closers.append(t)
        for t in closers:
            t.join(5.0)

    def __enter__(self) -> "FederationRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
