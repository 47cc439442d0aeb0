"""Bounded pipeline queue with an overflow policy (a trimmed copy of the
JAX package's ``utils/bounded_queue.py``).

The reference's ``sync_channel`` blocks producers when the queue is full
(backpressure all the way to the socket).  That stays the default, but a
collector in front of a slow sink sometimes prefers shedding load to
stalling ingest, so the queue has a policy:

    [input]
    queue_policy = "block"        # reference parity (default)
                 | "drop_newest"  # full queue: discard the incoming item
                 | "drop_oldest"  # full queue: discard the oldest item

``dropped`` counts the items shed (the reference's ``queue_dropped``
counter; the port's metrics are a later slice).  Once the pipeline
enters its drain phase (``mark_draining``, called before the final
flush) ``draining`` is set.

The SHUTDOWN sentinel (``None``) is exempt: it always uses a blocking
put and is never dropped, so graceful drain survives any policy.

The ``queue_pressure`` fault-injection site makes a put behave as if the
queue were full (deterministically, see ``utils.faultinject``), so the
drop paths are testable without wedging a sink.

Multi-tenant pipelines (a configured ``[tenants]`` table) swap this
class for ``tenancy.fairqueue.WeightedFairQueue``.
"""

from __future__ import annotations

import queue

from . import faultinject

POLICIES = ("block", "drop_newest", "drop_oldest")

# the reference samples one queue_wait_seconds histogram point per this
# many dequeued items; the port keeps the constant (the fair queue
# imports it) for the observability slice
QUEUE_WAIT_SAMPLE = 16


class PolicyQueue(queue.Queue):
    def __init__(self, maxsize: int = 0, policy: str = "block"):
        if policy not in POLICIES:
            raise ValueError(f"unknown queue policy: {policy}")
        super().__init__(maxsize)
        self.policy = policy
        self.draining = False
        self.dropped = 0

    def mark_draining(self) -> None:
        """Pipeline drain entered."""
        self.draining = True

    def fill_fraction(self) -> float:
        """Queue occupancy in [0, 1]; an unbounded queue reports 0.0."""
        return self.qsize() / self.maxsize if self.maxsize > 0 else 0.0

    def _count_drop(self) -> None:  # flowcheck: disable=FC08 -- the port journals no events yet (the observability slice); the count stays on the queue
        self.dropped += 1

    def put(self, item, block: bool = True, timeout=None):
        if item is None or self.policy == "block":
            # sentinel delivery and reference-parity backpressure
            if item is not None and faultinject.enabled():
                # under block policy the pressure site only counts
                faultinject.fire("queue_pressure")
            return super().put(item, block, timeout)
        pressured = faultinject.enabled() and faultinject.fire("queue_pressure")
        while True:
            try:
                if pressured:
                    raise queue.Full
                return super().put(item, block=False)
            except queue.Full:
                if self.policy == "drop_newest":
                    self._count_drop()
                    return
                # drop_oldest: make room, then retry the put
                try:
                    old = super().get(block=False)
                # flowcheck: disable=FC04 -- not an error: a consumer raced us, so room exists and the put retries
                except queue.Empty:
                    pressured = False
                    continue
                if old is None:
                    # never shed the shutdown sentinel: put it back and
                    # drop the incoming item instead (task_done balances
                    # the re-put so unfinished-task accounting holds)
                    super().put(old)
                    self.task_done()
                    self._count_drop()
                    return
                self.task_done()
                self._count_drop()
                pressured = False
