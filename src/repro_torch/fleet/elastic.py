"""Elastic pair scale-up/down driven by queue depth.

:class:`ElasticPairPool` serves a request stream through a growing and
shrinking fleet of **process-backed** draft–target pairs: the same
``spawn_pair`` → :class:`~repro_torch.distributed.host.PairHostHandle`
machinery ``build_deployment`` uses for ``process: true`` pairs, but with
the pair COUNT a runtime control variable instead of a spec constant.

Control law (evaluated every scheduling tick, on the ARRIVED backlog —
future arrivals never trigger scaling):

- scale UP when the backlog per active pair exceeds
  ``scale_up_depth × capacity`` and the pool is under ``max_pairs``
  (one spawn per tick — process startup is seconds, flapping is worse
  than a short queue);
- scale DOWN (reap) when the backlog per active pair falls below
  ``scale_down_depth × capacity`` and the pool is over ``min_pairs``:
  the youngest pair is put in DRAINING state — it receives no new waves,
  finishes its in-flight wave, then its worker processes are shut down.

The spawn path is injectable (``spawn_fn``) so the control law is testable
without paying multi-second process startups; the default clones the
template :class:`~repro_torch.topology.PairSpec` under a fresh id (ephemeral
ports) and calls :func:`repro_torch.distributed.host.spawn_pair` on the
augmented spec — exactly the deployment factory's machinery.

Unlike the reference, the pool takes the hosts' ``device`` explicitly (the
card by default, ``device="cpu"`` for the plain path), as every device-
bearing entry point of the port does, and forwards it to ``spawn_pair``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


class ElasticPairPool:
    """Queue-depth-driven elastic pool of process-backed serving pairs."""

    def __init__(self, spec, template_pair_id: Optional[str] = None, *,
                 min_pairs: int = 1, max_pairs: int = 4,
                 scale_up_depth: float = 2.0, scale_down_depth: float = 0.25,
                 model_configs: Optional[dict] = None,
                 spawn_fn: Optional[Callable] = None,
                 tick_s: float = 0.02, device: str = "cuda"):
        assert 1 <= min_pairs <= max_pairs, (min_pairs, max_pairs)
        self.spec = spec
        pairs = [p for p in spec.pairs if p.process] or list(spec.pairs)
        if template_pair_id is not None:
            self.template = next(p for p in spec.pairs
                                 if p.id == template_pair_id)
        else:
            self.template = pairs[0]
        self.min_pairs = int(min_pairs)
        self.max_pairs = int(max_pairs)
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_depth = float(scale_down_depth)
        self.model_configs = model_configs
        self.device = str(device)
        self._spawn_fn = spawn_fn or self._default_spawn
        self.tick_s = float(tick_s)
        self._n_spawned = 0
        # pair_id -> handle / state ("idle" | "busy" | "draining")
        self.handles: dict[str, object] = {}
        self._state: dict[str, str] = {}
        self.events: list[tuple[float, str, str]] = []   # (t, kind, pair_id)
        self.results: list = []
        self._served: dict[str, int] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    # -- spawning / reaping --------------------------------------------------

    def _default_spawn(self, pair_spec):
        from ..distributed.host import spawn_pair
        spec = dataclasses.replace(self.spec, pairs=[pair_spec])
        return spawn_pair(spec, pair_spec, model_configs=self.model_configs,
                          device=self.device)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def scale_up(self) -> str:
        """Spawn one pair cloned from the template; returns its id."""
        self._n_spawned += 1
        pid = f"{self.template.id}-e{self._n_spawned}"
        pair_spec = dataclasses.replace(self.template, id=pid)
        handle = self._spawn_fn(pair_spec)
        with self._lock:
            self.handles[pid] = handle
            self._state[pid] = "idle"
            self._served[pid] = 0
            self.events.append((self._now(), "spawn", pid))
        return pid

    def _reap_candidate(self) -> Optional[str]:
        """Youngest non-draining pair (LIFO keeps the original pairs warm)."""
        alive = [pid for pid, st in self._state.items() if st != "draining"]
        return alive[-1] if len(alive) > self.min_pairs else None

    def drain(self, pair_id: str) -> None:
        """Mark a pair DRAINING: it receives no new waves; its processes
        shut down once its in-flight wave (if any) completes."""
        with self._lock:
            if self._state.get(pair_id) in ("idle", "busy"):
                self._state[pair_id] = "draining"
                self.events.append((self._now(), "reap", pair_id))

    def _finalize_drained(self) -> None:
        for pid, st in list(self._state.items()):
            if st == "draining":
                self.handles[pid].shutdown()
                del self._state[pid]

    # -- control law ---------------------------------------------------------

    def _capacity(self) -> int:
        cap = getattr(next(iter(self.handles.values()), None), "capacity", 0)
        return max(1, int(cap or self.spec.serving.max_batch))

    def evaluate_scaling(self, backlog: int) -> Optional[str]:
        """One control-law step on the current ARRIVED backlog. Returns
        "up"/"down"/None (what it did)."""
        active = [pid for pid, st in self._state.items() if st != "draining"]
        n = max(1, len(active))
        per_pair = backlog / n
        cap = self._capacity()
        if (per_pair > self.scale_up_depth * cap
                and len(active) < self.max_pairs):
            self.scale_up()
            return "up"
        if (per_pair < self.scale_down_depth * cap
                and len(active) > self.min_pairs):
            pid = self._reap_candidate()
            if pid is not None and self._state.get(pid) == "idle":
                self.drain(pid)
                return "down"
        return None

    # -- serve loop ----------------------------------------------------------

    def run(self, requests: list) -> list:
        """Drain a :class:`~repro_torch.serving.ServeRequest` stream through the
        elastic pool; returns the merged per-request results (sorted by
        request id). Arrival times are honored against a wall clock, like
        the continuous server's loop."""
        pending = sorted(requests, key=lambda r: r.arrival_s)
        self._t0 = time.perf_counter()
        while len([s for s in self._state.values() if s != "draining"]) \
                < self.min_pairs:
            self.scale_up()
        threads: dict[str, threading.Thread] = {}
        errors: list[BaseException] = []

        def drive(pid: str, wave: list) -> None:
            try:
                rows = self.handles[pid].serve(wave)
                with self._lock:
                    self.results.extend(rows)
                    self._served[pid] += len(wave)
            except BaseException as e:
                errors.append(e)
            finally:
                with self._lock:
                    if self._state.get(pid) == "busy":
                        self._state[pid] = "idle"

        while True:
            if errors:
                raise errors[0]
            now = self._now()
            arrived = [r for r in pending if r.arrival_s <= now]
            busy = [pid for pid, st in self._state.items() if st == "busy"]
            if not pending and not busy:
                break
            self.evaluate_scaling(len(arrived))
            cap = self._capacity()
            for pid, st in list(self._state.items()):
                if st != "idle" or not arrived:
                    continue
                wave = arrived[:cap]
                for r in wave:
                    pending.remove(r)
                    arrived.remove(r)
                self._state[pid] = "busy"
                t = threading.Thread(target=drive, args=(pid, wave),
                                     daemon=True)
                threads[pid] = t
                t.start()
            # reap any drained pair that has gone idle
            for pid, st in list(self._state.items()):
                if st == "draining" and (pid not in threads
                                         or not threads[pid].is_alive()):
                    self.handles[pid].shutdown()
                    del self._state[pid]
            time.sleep(self.tick_s)
        for t in threads.values():
            t.join()
        if errors:
            raise errors[0]
        self.results.sort(key=lambda r: r.request_id)
        return self.results

    def shutdown(self) -> None:
        for pid, h in self.handles.items():
            try:
                h.shutdown()
            except Exception:
                pass
        self._state.clear()

    def summary(self) -> dict:
        return {
            "pairs_spawned": self._n_spawned,
            "events": [(round(t, 3), kind, pid)
                       for t, kind, pid in self.events],
            "served": dict(self._served),
            "max_concurrent_pairs": max(
                (sum(1 for t2, k, _ in self.events[:i + 1] if k == "spawn")
                 - sum(1 for t2, k, _ in self.events[:i + 1] if k == "reap"))
                for i in range(len(self.events))) if self.events else 0,
        }
