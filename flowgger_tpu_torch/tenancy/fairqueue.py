"""Weighted-fair multi-queue: per-tenant FIFO lanes, DRR dequeue,
noisiest-tenant-first load shedding (a trimmed copy of the JAX package's
``tenancy/fairqueue.py``).

Drop-in for ``utils.bounded_queue.PolicyQueue`` (the ``queue.Queue``
surface the sinks use: put/get/get_nowait/empty/qsize/task_done/join,
``unfinished_tasks``), built by the pipeline only when a
``TenantRegistry`` is configured.

Structure:

- one FIFO lane per tenant, created on first put;
- a separate control lane for the SHUTDOWN sentinel (``None``): never
  counted against capacity, never shed, and delivered only once every
  data lane is empty — so graceful drain keeps its "flush, then
  sentinel, then join" contract even though dequeue is no longer
  globally FIFO;
- deficit-round-robin dequeue: each lane accumulates quantum
  proportional to its weight and serves whole items against it, so a
  tenant's long-run share of dequeued *bytes* tracks its weight while
  each lane stays strictly FIFO;
- global-pressure shedding: when the queue is full (or the
  ``queue_pressure`` fault site fires), the *noisiest* sheddable lane —
  largest queued cost per unit weight, ``queue_policy != "block"`` —
  loses its oldest item first.  Only when no lane is sheddable does the
  producer's own policy apply (block = reference backpressure).

Item → lane attribution: per-message items take the producing thread's
tenant tag (set by the admission wrapper for connection threads; the
batch handler's Record-path emits re-tag per row from their ingest runs
— see tpu/batch.py ``_emit`` — so a mixed-tenant batch never lands
wholesale on the flusher's lane).  ``EncodedBlock`` items — the block
route's output — always ride the ``default`` lane: the batch aggregates
every tenant upstream of the queue, so block-route isolation is enforced
at admission instead.

Shed counts: ``dropped`` (items, the reference's ``queue_dropped``) and
each tenant's ``TenantState.shed`` (lines); the port's metrics, gauges
and events are a later slice.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, Optional

from ..utils import faultinject
from . import DEFAULT_TENANT, current_name
from .registry import TenantRegistry

# deficit added per DRR visit, scaled by the lane's weight.  Smaller
# than a typical block (MBs) — lanes with huge items accumulate over
# visits, which is exactly DRR's longest-item fairness behavior.
BASE_QUANTUM = 16384


class _Lane:
    __slots__ = ("name", "q", "cost", "deficit", "weight", "policy", "state")

    def __init__(self, name: str, weight: int, policy: str, state):
        self.name = name
        self.q: deque = deque()  # (item, cost, lines)
        self.cost = 0            # queued bytes (DRR + noisiest metric)
        self.deficit = 0.0
        self.weight = max(1, weight)
        self.policy = policy
        self.state = state       # admission.TenantState (shed counts)


def _item_cost(item):
    """(cost bytes, line count) of one queued item."""
    data = getattr(item, "data", None)
    if data is not None:  # EncodedBlock: data bytes, __len__ = messages
        return len(data), len(item)
    try:
        return len(item), 1
    except TypeError:
        return 1, 1


class WeightedFairQueue:
    def __init__(self, maxsize: int = 0,
                 registry: Optional[TenantRegistry] = None):
        self.maxsize = maxsize
        self.registry = registry
        self.mutex = threading.Lock()
        self.not_empty = threading.Condition(self.mutex)
        self.not_full = threading.Condition(self.mutex)
        self.all_tasks_done = threading.Condition(self.mutex)
        self.unfinished_tasks = 0
        self._lanes: Dict[str, _Lane] = {}
        self._order: list = []     # lane names, DRR rotation order
        self._cursor = 0           # rotation position of the last serve
        self._control: deque = deque()
        self._total = 0            # queued data items (maxsize domain)
        self.draining = False
        self.dropped = 0

    # -- introspection (PolicyQueue/queue.Queue parity) --------------------
    def qsize(self) -> int:
        with self.mutex:
            return self._total + len(self._control)

    def empty(self) -> bool:
        return self.qsize() == 0

    def lane_depths(self) -> Dict[str, int]:
        with self.mutex:
            return {name: len(lane.q) for name, lane in self._lanes.items()}

    def mark_draining(self) -> None:
        """Pipeline drain entered."""
        with self.mutex:
            self.draining = True

    # -- producers ---------------------------------------------------------
    def _lane_for(self, name: str) -> _Lane:
        lane = self._lanes.get(name)
        if lane is None:
            if self.registry is not None:
                spec = self.registry.spec(name)
                state = self.registry.state(name)
                lane = _Lane(name, spec.weight, spec.queue_policy, state)
            else:
                lane = _Lane(name, 1, "block", None)
            self._lanes[name] = lane
            self._order.append(name)
        return lane

    def _shed_head_locked(self, lane: _Lane) -> None:
        _item, cost, lines = lane.q.popleft()
        lane.cost -= cost
        self._total -= 1
        self._count_shed_locked(lane, lines)
        # the shed item's put was counted as an unfinished task
        self._task_done_locked()

    def _count_shed_locked(self, lane: Optional[_Lane], lines: int) -> None:  # flowcheck: disable=FC08 -- the port journals no events yet (the observability slice); the counts stay on the queue and the tenant
        # ``dropped`` counts ITEMS (PolicyQueue parity); the tenant's
        # ``shed`` counts LINES, the unit admission drops are counted in
        self.dropped += 1
        if lane is not None and lane.state is not None:
            lane.state.count_shed(lines)

    def _noisiest_sheddable_locked(self) -> Optional[_Lane]:
        best, best_score = None, -1.0
        for lane in self._lanes.values():
            if not lane.q or lane.policy == "block":
                continue
            score = lane.cost / lane.weight
            if score > best_score:
                best, best_score = lane, score
        return best

    def put(self, item, block: bool = True, timeout=None) -> None:
        if item is None:
            # SHUTDOWN sentinel: unsheddable, capacity-exempt, delivered
            # by get() only after the data lanes drain
            with self.not_empty:
                self._control.append(item)
                self.unfinished_tasks += 1
                self.not_empty.notify()
            return
        name = current_name()
        cost, lines = _item_cost(item)
        if getattr(item, "data", None) is not None or name is None:
            name = DEFAULT_TENANT  # block-route items: see module doc
        deadline = (time.monotonic() + timeout) if (block and timeout
                                                    is not None) else None
        with self.mutex:
            lane = self._lane_for(name)
            pressured = faultinject.enabled() and faultinject.fire(
                "queue_pressure")
            while True:
                full = 0 < self.maxsize <= self._total
                if not (full or pressured):
                    break
                synthetic = pressured and not full
                pressured = False
                victim = self._noisiest_sheddable_locked()
                if victim is lane and lane.policy == "drop_newest":
                    # own lane is the noisiest: honor its flavor — shed
                    # the incoming item (never queued, no task to balance)
                    self._count_shed_locked(lane, lines)
                    return
                if victim is not None:
                    self._shed_head_locked(victim)
                    continue
                # nothing sheddable queued anywhere
                if lane.policy == "block":
                    if synthetic:
                        # PolicyQueue parity: under block policy the
                        # pressure site only counts — never deadlock a
                        # producer on a queue that has room
                        break
                    if not block:
                        raise _queue.Full
                    if deadline is None:
                        self.not_full.wait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise _queue.Full
                        self.not_full.wait(remaining)
                    continue
                # the incoming item is discarded either way
                self._count_shed_locked(lane, lines)
                return
            lane.q.append((item, cost, lines))
            lane.cost += cost
            self._total += 1
            self.unfinished_tasks += 1
            self.not_empty.notify()

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    # -- consumers ---------------------------------------------------------
    def _dequeue_locked(self):
        # data lanes first; the control lane (SHUTDOWN) only when empty
        active = [n for n in self._order if self._lanes[n].q]
        if not active:
            return self._control.popleft()
        if len(active) == 1:
            lane = self._lanes[active[0]]
            item, cost, _lines = lane.q.popleft()
            lane.cost -= cost
            if not lane.q:
                lane.deficit = 0.0
            self._total -= 1
            return item
        # DRR: resume the rotation after the last-served lane; refill
        # every active lane's deficit until one can afford its head
        start = self._cursor
        while True:
            for off in range(len(active)):
                idx = (start + off) % len(active)
                lane = self._lanes[active[idx]]
                head_cost = lane.q[0][1]
                if lane.deficit >= head_cost:
                    item, cost, _lines = lane.q.popleft()
                    lane.cost -= cost
                    lane.deficit -= cost
                    if not lane.q:
                        lane.deficit = 0.0
                    self._total -= 1
                    self._cursor = idx
                    return item
            for n in active:
                lane = self._lanes[n]
                lane.deficit += BASE_QUANTUM * lane.weight

    def get(self, block: bool = True, timeout=None):
        with self.not_empty:
            if not block:
                if not (self._total or self._control):
                    raise _queue.Empty
            elif timeout is None:
                while not (self._total or self._control):
                    self.not_empty.wait()
            else:
                deadline = time.monotonic() + timeout
                while not (self._total or self._control):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise _queue.Empty
                    self.not_empty.wait(remaining)
            item = self._dequeue_locked()
            self.not_full.notify()
            return item

    def get_nowait(self):
        return self.get(block=False)

    # -- task accounting (queue.Queue parity) ------------------------------
    def _task_done_locked(self) -> None:
        unfinished = self.unfinished_tasks - 1
        if unfinished < 0:
            raise ValueError("task_done() called too many times")
        self.unfinished_tasks = unfinished
        if unfinished == 0:
            self.all_tasks_done.notify_all()

    def task_done(self) -> None:
        with self.all_tasks_done:
            self._task_done_locked()

    def join(self) -> None:
        with self.all_tasks_done:
            while self.unfinished_tasks:
                self.all_tasks_done.wait()
