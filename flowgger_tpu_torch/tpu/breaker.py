"""Decode circuit breaker: take the scalar oracle for whole batches when
nearly every row goes there anyway (a trimmed copy of the JAX package's
``tpu/breaker.py``).

The batched path has a validated scalar oracle: the decoders produce
byte-identical output at lower throughput.  When the last ``window``
batches each pushed more than ``fallback_ratio`` of their rows through
the oracle, the card's round trip is pure overhead, and the breaker
trips:

- ``CLOSED``    — the card takes every batch (normal);
- ``OPEN``      — tripped: every batch takes the scalar oracle; after
  ``cooldown_ms`` the next batch probes the card;
- ``HALF_OPEN`` — one probe batch on the card.  Its emit closes the
  breaker, unless its own oracle share is still above the threshold:
  then the breaker opens again for another cooldown, without counting
  a new trip.

The reference also trips on ``failures`` consecutive device errors and
re-decodes each failed batch on the host.  The port does not: a device
or kernel failure ends its run, so ``input.tpu_breaker_failures`` is
read and checked with the reference's words, and kept, but nothing
counts failures.

Every transition is logged to stderr with the reference's words (its
journal events print the same lines); ``trips`` counts the trips (the
reference's ``breaker_trips`` counter).  The state gauge is a later
slice of the port.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

DEFAULT_FAILURES = 3
DEFAULT_COOLDOWN_MS = 5_000
DEFAULT_WINDOW = 8
DEFAULT_FALLBACK_RATIO = 0.95


class DecodeBreaker:
    def __init__(self, failures: int = DEFAULT_FAILURES,
                 cooldown_ms: int = DEFAULT_COOLDOWN_MS,
                 window: int = DEFAULT_WINDOW,
                 fallback_ratio: Optional[float] = DEFAULT_FALLBACK_RATIO,
                 clock=time.monotonic):
        self.failures = max(1, failures)
        self.cooldown_ms = cooldown_ms
        self.window = max(1, window)
        self.fallback_ratio = fallback_ratio
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._ratios: "deque[float]" = deque(maxlen=self.window)
        self._probe_ratio: Optional[float] = None
        self.transitions: list = []  # (clock, from, to) history
        self.trips = 0
        self.probes = 0

    @classmethod
    def from_config(cls, config) -> Optional["DecodeBreaker"]:
        """``input.tpu_breaker_*`` keys; None (no breaker) when
        ``input.tpu_breaker = false``."""
        enabled = config.lookup_bool(
            "input.tpu_breaker", "input.tpu_breaker must be a boolean", True)
        if not enabled:
            return None
        failures = config.lookup_int(
            "input.tpu_breaker_failures",
            "input.tpu_breaker_failures must be an integer",
            DEFAULT_FAILURES)
        cooldown = config.lookup_int(
            "input.tpu_breaker_cooldown_ms",
            "input.tpu_breaker_cooldown_ms must be an integer (ms)",
            DEFAULT_COOLDOWN_MS)
        window = config.lookup_int(
            "input.tpu_breaker_window",
            "input.tpu_breaker_window must be an integer (batches)",
            DEFAULT_WINDOW)
        ratio = config.lookup_float(
            "input.tpu_breaker_fallback_ratio",
            "input.tpu_breaker_fallback_ratio must be a number in (0, 1]",
            DEFAULT_FALLBACK_RATIO)
        if ratio is not None and not 0.0 < ratio <= 1.0:
            from ..config import ConfigError

            raise ConfigError(
                "input.tpu_breaker_fallback_ratio must be a number in (0, 1]")
        return cls(failures=failures, cooldown_ms=cooldown, window=window,
                   fallback_ratio=ratio)

    # -- state machine -----------------------------------------------------
    def _transition(self, new: str, count_trip: bool = True) -> None:
        """Runs under ``self._lock``."""
        old, self._state = self._state, new
        self.transitions.append((self._clock(), old, new))
        if new == OPEN and count_trip:
            # re-opens after an uncured probe are the same logical trip
            self.trips += 1
        print(f"device-decode breaker: {old} -> {new}", file=sys.stderr)
        if new == OPEN:
            self._opened_at = self._clock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May this batch take the card?  In OPEN state, the first call
        after the cooldown becomes the half-open probe; everything else
        stays on the oracle."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                elapsed_ms = (self._clock() - self._opened_at) * 1000.0
                if elapsed_ms >= self.cooldown_ms:
                    self._transition(HALF_OPEN)
                    self.probes += 1
                    return True  # this batch is the probe
                return False
            return False  # HALF_OPEN: probe already in flight

    def record_success(self) -> None:
        """A batch that took the card was emitted: a half-open probe
        closes the breaker, unless its own oracle share still exceeds
        the threshold (one probe a cooldown, not an open/close flap)."""
        with self._lock:
            if self._state != HALF_OPEN:
                return
            if (self.fallback_ratio is not None
                    and self._probe_ratio is not None
                    and self._probe_ratio > self.fallback_ratio):
                self._probe_ratio = None
                self._transition(OPEN, count_trip=False)
                return
            self._ratios.clear()
            self._probe_ratio = None
            self._transition(CLOSED)

    def observe_batch(self, n_rows: int, fallback_rows: int) -> None:
        """Feed one emitted batch's oracle share; a full window above the
        threshold trips the breaker."""
        if self.fallback_ratio is None or n_rows <= 0:
            return
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe batch's own ratio: record_success reads it
                self._probe_ratio = fallback_rows / n_rows
                return
            if self._state != CLOSED:
                return
            self._ratios.append(fallback_rows / n_rows)
            if (len(self._ratios) == self.window
                    and min(self._ratios) > self.fallback_ratio):
                print(
                    f"device-decode breaker tripping: fallback ratio > "
                    f"{self.fallback_ratio} over the last {self.window} "
                    f"batches", file=sys.stderr)
                self._ratios.clear()
                self._transition(OPEN)
