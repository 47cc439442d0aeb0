"""Per-tenant token-bucket admission, applied at input-accept (a trimmed
copy of the JAX package's ``tenancy/admission.py``).

``AdmissionHandler`` wraps the pipeline's per-connection handler: every
delivery unit is charged against the connection's tenant buckets
(lines/sec and bytes/sec, with burst) *before* it reaches the batch
arena or the queue.  A tenant over its rate is shed right here, so
well-behaved tenants keep their exact bytes and ordering: admission only
ever removes a misbehaving tenant's own input.

Admission granularity is the splitter's delivery unit: per line on the
scalar path, per framed region on the port's raw (device-framed)
sessions (:class:`RawCharge`), per span set on the UDP recvmmsg path —
all-or-nothing per call, so a denial never splits a region.

The ``tenant_flood`` fault site makes admission checks of *rate-limited*
tenants deny deterministically (unlimited tenants never check it).

A denial prints the reference's rate-limited notice, "tenant [x] over
admission rate; shedding ...", at most once in 5 s a tenant.
``TenantState.drops`` counts the lines denied and ``shed`` the lines the
fair queue shed (the reference's ``tenant_{name}_drops`` /
``tenant_{name}_shed`` counters; the port's metrics, gauges and events
are a later slice, as is the control plane's rate factor).
"""

from __future__ import annotations

import sys
import threading
import time

from ..splitters import Handler
from ..utils import faultinject as _faults
from . import set_current
from .registry import TenantSpec


class TokenBucket:
    """Monotonic-clock token bucket; ``rate <= 0`` = unlimited."""

    def __init__(self, rate: float, burst: float, clock=None):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else float(rate)
        self._clock = clock or time.monotonic
        self._tokens = self.burst
        self._last = self._clock()
        self._lock = threading.Lock()

    def try_take(self, n: float) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = self._clock()
            if now > self._last:
                self._tokens = min(self.burst,
                                   self._tokens + (now - self._last) * self.rate)
                self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class TenantState:
    """One tenant's shared admission and QoS state: every connection of
    the tenant charges the same bucket pair; the fair queue reads the
    spec's weight and policy through here too."""

    def __init__(self, spec: TenantSpec, clock=None):
        self.spec = spec
        self.name = spec.name
        self.lines_bucket = TokenBucket(spec.rate, spec.burst, clock)
        self.bytes_bucket = TokenBucket(spec.byte_rate, spec.byte_burst, clock)
        self._last_notice = 0.0
        self.drops = 0
        self.shed = 0

    def admit(self, lines: int, nbytes: int) -> bool:
        """Charge one delivery unit; False = shed it."""
        denied = (self.spec.limited and _faults.enabled()
                  and _faults.fire("tenant_flood"))
        if not denied:
            # lines first: a lines-denied unit must not drain the byte
            # bucket
            if not self.lines_bucket.try_take(lines):
                denied = True
            elif not self.bytes_bucket.try_take(nbytes):
                denied = True
        if not denied:
            return True
        self.drops += lines
        now = time.monotonic()
        if now - self._last_notice >= 5.0:
            # rate-limited: a sustained flood must not turn stderr into a
            # second flood
            self._last_notice = now
            print(f"tenant [{self.name}] over admission rate; shedding "
                  f"(tenant_{self.name}_drops counts lines)", file=sys.stderr)
        return False

    def count_shed(self, lines: int = 1) -> None:
        """A queued item of this tenant was shed under global pressure
        (the fair queue calls this)."""
        self.shed += lines


class RawCharge:
    """Record-aligned admission hook a raw (device-framed) session
    carries: the batch handler calls ``admit_region`` once a *framed*
    region — after the boundary scan, before dispatch — with the exact
    (records, bytes) the host splitter would have charged for the same
    stream.  All-or-nothing a region, so a denial sheds whole records.
    The carry tail (a record split across chunks) is charged when it
    frames, or as one record at the end of the stream."""

    __slots__ = ("state",)

    def __init__(self, state: TenantState):
        self.state = state

    def admit_region(self, lines: int, nbytes: int) -> bool:
        return self.state.admit(lines, nbytes)


class AdmissionHandler(Handler):
    """Per-connection wrapper: tags the connection thread with its
    tenant, charges admission, forwards admitted input to the shared
    inner handler.  Exposes ``ingest_spans`` only when the inner handler
    does, so the UDP input's ``hasattr`` dispatch is unchanged.

    Raw (device-framed) sessions forward too (``wants_raw`` /
    ``open_raw``): the session carries a :class:`RawCharge` that the
    batch handler invokes on each framed region, so admission stays
    record-aligned while admitted connections keep device framing."""

    def __init__(self, inner: Handler, tenant: TenantState):
        self._inner = inner
        self._tenant = tenant
        if hasattr(inner, "ingest_spans"):
            self.ingest_spans = self._ingest_spans

    # splitters and inputs set these ON the handler they receive; forward
    # them to the shared inner handler where its error paths read them
    @property
    def quiet_empty(self):
        return self._inner.quiet_empty

    @quiet_empty.setter
    def quiet_empty(self, v):
        self._inner.quiet_empty = v

    @property
    def bare_errors(self):
        return self._inner.bare_errors

    @bare_errors.setter
    def bare_errors(self, v):
        self._inner.bare_errors = v

    def wants_raw(self, framing: str) -> bool:
        return self._inner.wants_raw(framing)

    def open_raw(self, framing: str):
        # charged at frame time (RawCharge), not here: raw chunks enter
        # the session unconditionally and pay once boundaries are known
        set_current(self._tenant.name)
        sess = self._inner.open_raw(framing)
        sess.charge = RawCharge(self._tenant)
        return sess

    def handle_bytes(self, raw: bytes) -> None:
        if self._tenant.admit(1, len(raw)):
            set_current(self._tenant.name)
            self._inner.handle_bytes(raw)

    def _ingest_spans(self, chunk: bytes, starts, lens) -> None:
        if self._tenant.admit(len(starts), int(lens.sum())):
            set_current(self._tenant.name)
            self._inner.ingest_spans(chunk, starts, lens)

    def handle_record(self, record) -> None:
        if self._tenant.admit(1, 0):
            set_current(self._tenant.name)
            self._inner.handle_record(record)

    def flush(self) -> None:
        self._inner.flush()
