"""One retry/backoff policy for the port's reconnect loops: the redis
input's, the TLS sink's and the Kafka sink's.

Parity model: the JAX package's ``utils/retry.py`` (the reference's
three hand-rolled recovery loops expressed as one policy):

- mode ``"additive"`` — the reference's TLS recovery: the delay grows by
  ``uniform(0, delay)`` per failure up to ``max_ms`` and resets to
  ``init_ms`` once a connection has been stable for ``probe_ms``
  (tls_output.rs:163-172);
- mode ``"exponential"`` — exponential backoff with full jitter
  (``sleep(uniform(0, min(cap, init * mult**attempt)))``);
- an optional ``deadline_ms`` / ``max_attempts`` bound after which
  ``backoff()`` reports exhaustion, so a caller falls back to the
  reference's die contract.

The JAX package's policy also bumps a metrics counter a backoff; the
port emits no metrics (README deviation), so ``metric`` is taken and
only names what the counter would be.  The policy is stateful (one a
loop or thread) and deterministic under injected ``rng`` and ``sleep``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple

DEFAULT_INIT_MS = 100
DEFAULT_MAX_MS = 10_000
DEFAULT_MULTIPLIER = 2.0


class RetryExhausted(Exception):
    """Raised by ``run()`` when the policy's attempt/deadline budget is
    spent; carries the last underlying error as ``__cause__``."""


class RetryPolicy:
    def __init__(
        self,
        init_ms: float = DEFAULT_INIT_MS,
        max_ms: float = DEFAULT_MAX_MS,
        mode: str = "exponential",
        multiplier: float = DEFAULT_MULTIPLIER,
        probe_ms: Optional[float] = None,
        deadline_ms: Optional[float] = None,
        max_attempts: Optional[int] = None,
        metric: Optional[str] = None,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[float, float], float] = random.uniform,
        clock: Callable[[], float] = time.monotonic,
    ):
        if mode not in ("exponential", "additive"):
            raise ValueError(f"unknown retry mode: {mode}")
        if max_ms < init_ms:
            raise ValueError("max_ms cannot be less than init_ms")
        self.init_ms = float(init_ms)
        self.max_ms = float(max_ms)
        self.mode = mode
        self.multiplier = multiplier
        self.probe_ms = probe_ms
        self.deadline_ms = deadline_ms
        self.max_attempts = max_attempts
        # the counter the JAX package bumps a backoff; documentation only
        self.metric = metric
        self._sleep = sleep
        self._rng = rng
        self._clock = clock
        self.reset()

    # -- state -------------------------------------------------------------
    def reset(self) -> None:
        """Back to a fresh policy: next backoff starts at ``init_ms``."""
        self.attempts = 0
        self._delay_ms = self.init_ms
        self._started = self._clock()
        self._attempt_started = self._started

    def mark(self) -> None:
        """Note the start of a connection attempt (the additive mode's
        stability probe measures from here)."""
        self._attempt_started = self._clock()

    def note_success(self) -> None:
        """An attempt fully succeeded: reset the growth state and the
        attempt count, the deadline anchored anew."""
        self._delay_ms = self.init_ms
        self._started = self._clock()
        self.attempts = 0

    def note_run(self, started: float) -> None:
        """A connection that stayed up longer than the max backoff window
        counts as recovered: it earns a fresh retry budget."""
        if (self._clock() - started) * 1000.0 > self.max_ms:
            self.note_success()

    def exhausted(self) -> bool:
        if self.max_attempts is not None and self.attempts >= self.max_attempts:
            return True
        if self.deadline_ms is not None:
            return (self._clock() - self._started) * 1000.0 >= self.deadline_ms
        return False

    # -- delays ------------------------------------------------------------
    def next_delay_ms(self) -> float:
        """Advance the failure state and return the next delay in ms
        (without sleeping)."""
        if self.mode == "additive":
            # tls_output.rs:163-172: reset after a stable probe window,
            # otherwise additive randomized growth capped at max
            elapsed_ms = (self._clock() - self._attempt_started) * 1000.0
            if self.probe_ms is not None and elapsed_ms > self.probe_ms:
                self._delay_ms = self.init_ms
            elif self._delay_ms < self.max_ms:
                self._delay_ms += self._rng(0.0, self._delay_ms)
            self.attempts += 1
            return float(round(self._delay_ms))
        base = min(self.max_ms, self.init_ms * (self.multiplier ** self.attempts))
        self.attempts += 1
        return self._rng(0.0, base)  # full jitter

    def backoff(self) -> Optional[float]:
        """Sleep for the next delay and return it (ms); ``None`` when the
        policy is exhausted (the caller gives up)."""
        if self.exhausted():
            return None
        delay_ms = self.next_delay_ms()
        self._sleep(delay_ms / 1000.0)
        return delay_ms

    # -- convenience wrapper -----------------------------------------------
    def run(self, fn: Callable, retry_on: Tuple[type, ...] = (Exception,),
            on_error: Optional[Callable[[BaseException], None]] = None):
        """Call ``fn()`` until it returns, backing off between failures;
        raises ``RetryExhausted`` (chaining the last error) when the
        attempt/deadline budget runs out."""
        while True:
            try:
                return fn()
            except retry_on as e:  # noqa: PERF203 - retry loop by design
                if on_error is not None:
                    on_error(e)
                if self.backoff() is None:
                    raise RetryExhausted(str(e)) from e


def retry_config_kwargs(config, prefix: str, init_ms: float = DEFAULT_INIT_MS,
                        max_ms: float = DEFAULT_MAX_MS,
                        max_attempts: Optional[int] = None) -> dict:
    """RetryPolicy constructor kwargs from ``{prefix}_retry_*`` config
    keys (``init`` / ``max`` / ``attempts``, e.g.
    ``output.kafka_retry_init = 250``)."""
    kw = dict(
        init_ms=config.lookup_int(
            f"{prefix}_retry_init",
            f"{prefix}_retry_init must be an integer (ms)", int(init_ms)),
        max_ms=config.lookup_int(
            f"{prefix}_retry_max",
            f"{prefix}_retry_max must be an integer (ms)", int(max_ms)),
        max_attempts=config.lookup_int(
            f"{prefix}_retry_attempts",
            f"{prefix}_retry_attempts must be an integer", max_attempts))
    if kw["max_ms"] < kw["init_ms"]:
        from ..config import ConfigError

        # rejected at start-up, not as a ValueError in a worker thread
        raise ConfigError(
            f"{prefix}_retry_max cannot be less than {prefix}_retry_init")
    return kw


def policy_from_config(config, prefix: str, **defaults) -> RetryPolicy:
    """One RetryPolicy straight from ``{prefix}_retry_*`` config keys;
    extra ``defaults`` (mode, probe_ms, ...) pass through."""
    kw = retry_config_kwargs(
        config, prefix,
        init_ms=defaults.pop("init_ms", DEFAULT_INIT_MS),
        max_ms=defaults.pop("max_ms", DEFAULT_MAX_MS),
        max_attempts=defaults.pop("max_attempts", None))
    kw.update(defaults)
    return RetryPolicy(**kw)
