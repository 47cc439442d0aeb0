"""Overlapped batch execution: the in-flight submit/fetch window, the
FIFO lane set and the device-vs-host route economics, on CUDA streams.

A trimmed copy of the JAX package's ``tpu/overlap.py`` with the same
names and contract:

``InflightWindow``
    A bounded window of submitted batches (``input.tpu_inflight``,
    default 2).  The ingest thread frames and *submits* batch N+1 while
    a fetcher thread *fetches, encodes and emits* batch N.  One fetcher
    pops a FIFO, so blocks reach the merger in submit order however long
    any fetch takes; a full window blocks ``submit`` (backpressure to the
    splitter).  ``depth = 0`` pops inline: strictly serial.  An exception
    out of the pop function (the port has no breaker, so a kernel or
    fetch failure is one) is stashed and raised again on the ingest
    thread at the next ``submit`` or ``fence``; the batches before it
    have been emitted in order by then.

``LaneSet``
    N lanes, each an ``InflightWindow`` with its own fetcher thread, fed
    round-robin by the ingest thread.  Their pop functions run at once
    and return *emit closures*, which one ticket turnstile
    (``_Sequencer``) runs in global submit order.  ``fence()`` fences
    every lane: each synchronous-emit path (the Record path, the drain at
    shutdown) keeps its place in the stream.  ``lanes = 1`` is the single
    window.

``RouteEconomics``
    EWMAs of measured seconds a row for the fused route, the split
    device encode tier and the host block encoder; ``allow_fused()`` and
    ``allow_device()`` route each batch to the cheaper path and re-probe
    the loser every ``input.tpu_encode_probe_every`` batches.  A device
    tier at or under ``DEVICE_OK_SPR`` never pays for a host sample.  A
    change of winner prints the reference's "route economics" notice on
    stderr.

``Lane``
    A lane's device context, in place of the reference's per-lane
    ``jax.Device``: its device, its own CUDA stream and its pinned
    staging buffers (``PinnedStaging``).  The ingest thread frames and
    submits a batch under ``lane.scope()``, and the lane's fetcher thread
    pops it under the same scope: PyTorch's current stream is per thread,
    and every kernel wrapper launches on the current stream
    (``kernels._stream``), so a thread that did not enter the lane's
    stream would launch on the default stream, unordered against the
    lane's work.  Two lanes on one card are two streams.

What the port leaves out: the gauges, counters and degradation events
(the port emits no metrics yet) and the supervisor (fetchers are plain
daemon threads).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

DEFAULT_INFLIGHT = 2
DEFAULT_PROBE_EVERY = 256
# the loser path must be this much slower (seconds/row) before traffic
# moves; hysteresis against flapping on noisy single-batch samples
ECON_MARGIN = 1.5
# EWMA weight of the newest sample (small history, fast adaptation)
ECON_ALPHA = 0.4
# a device tier at or under this measured seconds/row performs at
# accelerator levels: no host path can beat it, so the comparison sample
# (one host-routed batch) is never paid
DEVICE_OK_SPR = 1e-5


class InflightWindow:
    """Bounded FIFO of submitted batches with a fetch-behind worker.

    ``pop_fn(entry)`` runs on the fetcher thread and does the fetch,
    encode and emit of one entry; entries complete in submit order.
    ``depth=0`` has no worker: ``submit`` pops inline."""

    def __init__(self, depth: int, pop_fn: Callable, name: str = "tpu"):
        self.depth = max(0, int(depth))
        self._pop_fn = pop_fn
        self._name = name
        self._lock = threading.Lock()
        self._nonfull = threading.Condition(self._lock)
        self._nonempty = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._popping = False      # the fetcher is inside pop_fn
        self._pending_exc: Optional[BaseException] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- ingest side -------------------------------------------------------
    def submit(self, entry) -> None:
        """Queue one submitted batch; blocks while the window is full,
        raising any stashed fetcher exception."""
        if self.depth == 0:
            self._pop_fn(entry)
            return
        self._ensure_thread()
        with self._lock:
            self._raise_pending_locked()
            while len(self._queue) + (1 if self._popping else 0) >= self.depth:
                self._nonfull.wait(timeout=0.5)
                self._raise_pending_locked()
            self._queue.append(entry)
            self._nonempty.notify()

    def fence(self) -> None:
        """Block until every submitted batch has been fetched and
        emitted, then raise any exception the fetcher stashed: the
        ordering barrier of every synchronous-emit path."""
        if self.depth == 0:
            return
        with self._lock:
            while self._queue or self._popping:
                self._idle.wait(timeout=0.5)
            self._raise_pending_locked()

    def pending(self) -> int:
        with self._lock:
            return len(self._queue) + (1 if self._popping else 0)

    def close(self) -> None:
        """Stop the fetcher after the queue drains."""
        if self.depth == 0 or self._thread is None:
            return
        self.fence()
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
        self._thread.join(timeout=5)

    # -- fetcher side ------------------------------------------------------
    def _raise_pending_locked(self) -> None:
        if self._pending_exc is not None:
            exc, self._pending_exc = self._pending_exc, None
            raise exc

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._closed = False
            self._thread = threading.Thread(
                target=self._run, name=f"{self._name}-fetch", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._nonempty.wait(timeout=0.5)
                if self._closed and not self._queue:
                    self._idle.notify_all()
                    return
                entry = self._queue.popleft()
                self._popping = True
                self._nonfull.notify()
            try:
                self._pop_fn(entry)
            except BaseException as e:  # noqa: BLE001 - ferried to ingest
                exc = e
            else:
                exc = None
            with self._lock:
                if exc is not None and self._pending_exc is None:
                    self._pending_exc = exc
                self._popping = False
                self._nonfull.notify()
                if not self._queue:
                    self._idle.notify_all()


class _Sequencer:
    """FIFO ticket turnstile: emits happen in ticket order.  ``done``
    releases a ticket whether or not it emitted (a failed batch must not
    wedge the lanes behind it); it is idempotent and order-independent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._issued = 0
        self._next = 0
        self._finished = set()

    def ticket(self) -> int:
        with self._lock:
            t = self._issued
            self._issued += 1
            return t

    def wait_turn(self, ticket: int) -> None:
        with self._lock:
            while self._next != ticket:
                self._cond.wait(timeout=0.5)

    def done(self, ticket: int) -> None:
        with self._lock:
            if ticket < self._next:
                return
            self._finished.add(ticket)
            while self._next in self._finished:
                self._finished.discard(self._next)
                self._next += 1
            self._cond.notify_all()


class LaneSet:
    """N dispatch lanes behind one FIFO sequencer.

    ``pop_fn(payload, lane)`` runs concurrently on the lane fetcher
    threads and returns ``None`` or a zero-argument emit closure, which
    the lane set runs under the sequencer in submit order.  An exception
    out of ``pop_fn`` (or out of its closure) is ferried to the ingest
    thread as the window ferries it, and its ticket is released so later
    batches still drain in order."""

    def __init__(self, depth: int, pop_fn: Callable, lanes: int = 1,
                 name: str = "tpu"):
        self.lanes = max(1, int(lanes))
        self.depth = max(0, int(depth))
        self._pop_fn = pop_fn
        self._seq = _Sequencer()
        self._rr = 0
        self._submit_lock = threading.Lock()
        multi = self.lanes > 1
        self._windows = [
            InflightWindow(depth, self._lane_pop,
                           name=f"{name}-lane{i}" if multi else name)
            for i in range(self.lanes)]

    # -- ingest side -------------------------------------------------------
    def next_lane(self) -> int:
        """Reserve the next round-robin lane (callers that frame on the
        lane's device and stream before they submit)."""
        with self._submit_lock:
            lane = self._rr
            self._rr = (self._rr + 1) % self.lanes
            return lane

    def submit(self, lane: int, payload) -> None:
        """Ticket and enqueue one batch on ``lane``; blocks while that
        lane's window is full.  Tickets are issued in call order under
        one lock, so emission order is submission order."""
        with self._submit_lock:
            ticket = self._seq.ticket()
            try:
                self._windows[lane % self.lanes].submit(
                    (ticket, lane, payload))
            except BaseException:
                # the window refused the entry (a ferried exception, or a
                # depth-0 pop that failed): release the ticket, or every
                # later batch waits for a turn that never comes
                self._seq.done(ticket)
                raise

    def fence(self) -> None:
        """Fence every lane, even when one raises a ferried exception:
        the first exception propagates after the others have drained."""
        pending_exc = None
        for w in self._windows:
            try:
                w.fence()
            except BaseException as e:  # noqa: BLE001 - ferried, raised below
                if pending_exc is None:
                    pending_exc = e
        if pending_exc is not None:
            raise pending_exc

    def pending(self) -> int:
        return sum(w.pending() for w in self._windows)

    def close(self) -> None:
        for w in self._windows:
            w.close()

    # -- lane fetcher side -------------------------------------------------
    def _lane_pop(self, entry) -> None:
        """Compute (concurrent across lanes), then emit under the
        sequencer (strict submit order)."""
        ticket, lane, payload = entry
        try:
            emit = self._pop_fn(payload, lane)
            self._seq.wait_turn(ticket)
            if emit is not None:
                emit()
        finally:
            self._seq.done(ticket)


class PinnedStaging:
    """A lane's pinned host buffers for raw-region uploads.

    ``upload`` copies a region into the next of ``SLOTS`` page-locked
    buffers (zero-padded to the device size) and starts an asynchronous
    copy to the device on the current stream, recording an event after
    it.  A buffer is written again only once the event of its last copy
    has completed, so a region still in flight is never overwritten."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: List[Optional[torch.Tensor]] = [None] * self.SLOTS
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._next = 0

    def upload(self, region: bytes, size: int) -> torch.Tensor:
        """``region`` zero-padded to ``size`` bytes on the device."""
        i = self._next
        self._next = (i + 1) % self.SLOTS
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < size:
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self._bufs[i] = buf
        host = buf[:size]
        view = host.numpy()
        n = len(region)
        view[:n] = np.frombuffer(region, dtype=np.uint8)
        view[n:] = 0
        dev = torch.empty(size, dtype=torch.uint8, device=self.device)
        dev.copy_(host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[i] = ev
        return dev


class Lane:
    """One lane's device context: its device, and on a CUDA device its
    own stream and pinned staging buffers (None on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = None
        self.staging = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device=device)
            self.staging = PinnedStaging(device)

    def scope(self):
        """Make the lane's stream the calling thread's current stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def resolve_lanes(config, device: torch.device
                  ) -> Tuple[int, List[torch.device]]:
    """Resolve ``input.tpu_lanes`` to (lane count, per-lane devices).

    Unset ("auto"): one lane a card when more than one CUDA device is
    visible, else 1, so the CPU and a single card keep the single window.
    An explicit N engages anywhere; more lanes than cards cycle over
    them (two lanes on one card are two streams).  ``tpu_lanes > 1`` with
    ``input.tpu_mesh = "on"`` is the reference's config error (the port
    reads ``tpu_mesh`` for this check only)."""
    from ..config import ConfigError

    req = config.lookup_int(
        "input.tpu_lanes",
        "input.tpu_lanes must be an integer (device lanes)", None)
    mesh_mode = config.lookup_str(
        "input.tpu_mesh", "input.tpu_mesh must be a string", "auto")
    if req is not None and req < 1:
        raise ConfigError("input.tpu_lanes must be >= 1")
    if req is not None and req > 1 and mesh_mode == "on":
        raise ConfigError(
            'input.tpu_lanes > 1 and input.tpu_mesh = "on" are mutually '
            "exclusive (lanes give each chip its own batches; the mesh "
            "shards one batch across chips)")
    if req == 1 or device.type != "cuda":
        return (req or 1), [device] * (req or 1)
    count = torch.cuda.device_count()
    if req is None:
        if mesh_mode == "on" or count <= 1:
            return 1, [device]
        return count, [torch.device("cuda", i) for i in range(count)]
    return req, [torch.device("cuda", i % count) for i in range(req)]


class RouteEconomics:
    """Measured seconds a row for the fused route, the device encode
    tier and the host block encoder; ``allow_fused()`` and
    ``allow_device()`` route each batch to the cheaper one with periodic
    re-probes of the loser.

    The device tier (and the fused route) go first; while one measures
    at accelerator levels (``DEVICE_OK_SPR``) the other path is never
    paid.  Only a tier measuring slow buys a batch of the other path for
    the comparison, after which the loser re-probes every
    ``probe_every`` batches.  ``enabled=False`` pins the always-device
    behavior."""

    def __init__(self, enabled: bool = True,
                 probe_every: int = DEFAULT_PROBE_EVERY,
                 margin: float = ECON_MARGIN,
                 ok_spr: float = DEVICE_OK_SPR,
                 label: Optional[str] = None):
        self.enabled = enabled
        self.probe_every = max(2, int(probe_every))
        self.margin = margin
        self.ok_spr = ok_spr
        self.label = label
        self._lock = threading.Lock()
        self._spr = {"fused": None, "device": None, "host": None}
        self._batches = 0
        self._fused_batches = 0
        # the steady-state winner of each comparison arm: the device and
        # fused tiers are the probe-first defaults, so the first measured
        # re-route away from them (and every flip back) prints a notice
        self._winner = {"split": "device", "fused": "fused"}

    def allow_fused(self) -> bool:
        """The fused-vs-split arm, decided at submit time."""
        if not self.enabled:
            return True
        with self._lock:
            self._fused_batches += 1
            fused = self._spr["fused"]
            split = [v for v in (self._spr["device"], self._spr["host"])
                     if v is not None]
            best_split = min(split) if split else None
            if fused is None:
                return True
            if best_split is None:
                return fused <= self.ok_spr
            probe = self._fused_batches % self.probe_every == 0
            if fused > best_split * self.margin:
                return probe
            if best_split > fused * self.margin:
                return not probe
            return True

    def allow_device(self) -> bool:
        """The device-vs-host arm of the split path."""
        if not self.enabled:
            return True
        with self._lock:
            self._batches += 1
            dev, host = self._spr["device"], self._spr["host"]
            if dev is None:
                return True
            if host is None:
                return dev <= self.ok_spr
            probe = self._batches % self.probe_every == 0
            if dev > host * self.margin:
                return probe
            if host > dev * self.margin:
                return not probe
            return True

    def observe(self, path: str, rows: int, seconds: float) -> None:
        if not self.enabled or rows <= 0 or path not in self._spr:
            return
        spr = seconds / rows
        with self._lock:
            prev = self._spr[path]
            self._spr[path] = (spr if prev is None
                               else prev + ECON_ALPHA * (spr - prev))
            switches = self._winner_flips_locked()
        # the notices print outside the lock
        for arm, old, new, new_spr, old_spr in switches:
            print(f"route economics [{self.label or 'lane0'}/{arm}]: "
                  f"{old} -> {new} (measured {new_spr:.3g} s/row vs "
                  f"{old_spr:.3g})", file=sys.stderr)

    def _winner_flips_locked(self):
        """Steady-state winner changes (margin-hysteretic, as the routing
        decides): [(arm, old, new, new_spr, old_spr), ...]."""
        flips = []
        dev, host = self._spr["device"], self._spr["host"]
        if dev is not None and host is not None:
            old = self._winner["split"]
            new = old
            if dev > host * self.margin:
                new = "host"
            elif host > dev * self.margin:
                new = "device"
            if new != old:
                self._winner["split"] = new
                flips.append(("split", old, new,
                              dev if new == "device" else host,
                              host if new == "device" else dev))
        fused = self._spr["fused"]
        split = [v for v in (dev, host) if v is not None]
        best_split = min(split) if split else None
        if fused is not None and best_split is not None:
            old = self._winner["fused"]
            new = old
            if fused > best_split * self.margin:
                new = "split"
            elif best_split > fused * self.margin:
                new = "fused"
            if new != old:
                self._winner["fused"] = new
                flips.append(("fused", old, new,
                              fused if new == "fused" else best_split,
                              best_split if new == "fused" else fused))
        return flips

    def snapshot(self) -> dict:
        with self._lock:
            return {"fused_s_per_row": self._spr["fused"],
                    "device_s_per_row": self._spr["device"],
                    "host_s_per_row": self._spr["host"],
                    "batches": self._batches}

    @classmethod
    def from_config(cls, config, label: Optional[str] = None
                    ) -> "RouteEconomics":
        enabled = config.lookup_bool(
            "input.tpu_encode_economics",
            "input.tpu_encode_economics must be a boolean", True)
        probe_every = config.lookup_int(
            "input.tpu_encode_probe_every",
            "input.tpu_encode_probe_every must be an integer (batches)",
            DEFAULT_PROBE_EVERY)
        return cls(enabled=enabled, probe_every=probe_every, label=label)


def inflight_depth_from_config(config) -> int:
    from ..config import ConfigError

    depth = config.lookup_int(
        "input.tpu_inflight",
        "input.tpu_inflight must be an integer (batches)", DEFAULT_INFLIGHT)
    if depth < 0:
        raise ConfigError("input.tpu_inflight must be >= 0")
    return depth
