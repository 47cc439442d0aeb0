"""Redis input: a reliable-queue consumer.

Parity model: flowgger src/flowgger/input/redis_input.rs:12-163 and the
JAX package's ``inputs/redis_input.py``.  Each of ``input.redis_threads``
workers:

1. drains its leftover ``{key}.tmp.{tid}`` list back onto the main key
   (messages a previous run popped and did not finish are queued again:
   at-least-once delivery);
2. loops BRPOPLPUSH main → tmp, hands the message to its handler
   (``handle_bytes``), then LREMs it from tmp.

Every worker of a ``*_tpu`` pipeline gets the pipeline's one shared
batch handler, so N workers fill one batch.  A lost connection
reconnects in process under the retry policy (``input.redis_retry_*``,
jittered exponential backoff); the tmp drain on reconnect queues the
in-flight message again.  An exhausted budget (``redis_retry_attempts``
set; unlimited by default) exits the process with 1, the reference's
contract, unless ``exit_on_failure`` is off (tests).

BRPOPLPUSH with timeout 0 blocks for ever, so :meth:`RedisInput.stop`
(the pipeline's shutdown, SIGTERM, SIGINT, a failure) shuts every
worker's socket down: its blocked read ends, and the worker returns
without counting a lost connection.  A message popped and not yet
LREM'd stays in the tmp list for the next start.

Only a failure of the connection itself (:class:`_ConnectionLost`)
reconnects.  What the handler raises (a kernel that failed on the card,
a failed fetch) ends the worker and goes to the pipeline, which ends
the run non-zero: reconnecting past it would lose the rows already
LREM'd.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from . import Input
from ..config import Config
from ..utils.resp import RespClient, RespError
from ..utils.retry import RetryPolicy, retry_config_kwargs

DEFAULT_CONNECT = "127.0.0.1"
DEFAULT_QUEUE_KEY = "logs"
DEFAULT_THREADS = 1
DEFAULT_RETRY_INIT = 200
DEFAULT_RETRY_MAX = 10_000


class _Stopped(Exception):
    """The input was stopped while the worker talked to the server."""


class _ConnectionLost(Exception):
    """The connection to the server failed: the worker reconnects."""


class RedisWorker:
    def __init__(self, tid: int, connect: str, queue_key: str, handler,
                 stopped=lambda: False):
        self.tid = tid
        self.connect = connect
        self.queue_key = queue_key
        self.handler = handler
        self.stopped = stopped
        try:
            self.cnx = RespClient.from_connect_string(connect)
        except OSError as e:
            raise _ConnectionLost(
                f"Unable to connect to the Redis server: [{connect}], error: {e}")

    def _fail(self, what: str, e: BaseException):
        if self.stopped():
            raise _Stopped()
        raise _ConnectionLost(f"Redis protocol error in {what}: [{e}]")

    def run(self):
        queue_key = self.queue_key
        tmp_key = f"{queue_key}.tmp.{self.tid}"
        print(f"Connected to Redis [{self.connect}], pulling messages from "
              f"key [{queue_key}]")
        # crash recovery: push any leftover in-flight messages back
        while True:
            try:
                if self.cnx.rpoplpush(tmp_key, queue_key) is None:
                    break
            except RespError:  # flowcheck: disable=FC04 -- recovery drain only; the main BRPOPLPUSH loop raises on real errors
                break
            except OSError as e:
                if self.stopped():
                    raise _Stopped()
                raise _ConnectionLost(str(e))
        while True:
            try:
                line = self.cnx.brpoplpush(queue_key, tmp_key, 0)
            except (RespError, OSError) as e:
                self._fail("BRPOPLPUSH", e)
            if line is None:
                continue
            self.handler.handle_bytes(line)
            try:
                self.cnx.lrem(tmp_key, 1, line)
            except (RespError, OSError) as e:
                self._fail("LREM", e)


class RedisInput(Input):
    def __init__(self, config: Config):
        self.connect = config.lookup_str(
            "input.redis_connect", "input.redis_connect must be an ip:port string",
            DEFAULT_CONNECT)
        self.queue_key = config.lookup_str(
            "input.redis_queue_key", "input.redis_queue_key must be a string",
            DEFAULT_QUEUE_KEY)
        self.threads = config.lookup_int(
            "input.redis_threads", "input.redis_threads must be a 32-bit integer",
            DEFAULT_THREADS)
        self._retry_kw = retry_config_kwargs(
            config, "input.redis",
            init_ms=DEFAULT_RETRY_INIT, max_ms=DEFAULT_RETRY_MAX)
        self.exit_on_failure = True  # tests turn it off
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._clients = set()

    # -- stop ----------------------------------------------------------------
    def stop(self) -> None:
        """Stop every worker: a blocked BRPOPLPUSH wakes (its socket goes
        down), a backoff sleep ends, and the workers return."""
        self._stop.set()
        with self._lock:
            clients = list(self._clients)
        for cnx in clients:
            cnx.shutdown()

    def _register(self, cnx) -> bool:
        """Track a worker's client for :meth:`stop`; False once stopped."""
        with self._lock:
            if self._stop.is_set():
                return False
            self._clients.add(cnx)
            return True

    def _release(self, cnx) -> None:
        with self._lock:
            self._clients.discard(cnx)
        cnx.close()

    # -- workers -------------------------------------------------------------
    def _worker(self, tid: int, handler_factory):
        handler = handler_factory()
        policy = RetryPolicy(metric="input_reconnects", sleep=self._stop.wait,
                             **self._retry_kw)
        stopped = self._stop.is_set
        while not stopped():
            policy.mark()
            started = time.monotonic()
            worker = None
            try:
                worker = RedisWorker(tid, self.connect, self.queue_key,
                                     handler, stopped)
                if not self._register(worker.cnx):
                    return
                worker.run()
            except _Stopped:  # flowcheck: disable=FC04 -- the input's stop, not a lost connection: no line, no reconnect
                return
            except _ConnectionLost as e:
                if stopped():
                    return
                print(f"Redis connection lost - {e}", file=sys.stderr)
                policy.note_run(started)  # stable runs earn a fresh budget
                if policy.backoff() is None:
                    print("Redis connection lost, aborting", file=sys.stderr)
                    break
                if stopped():
                    return
                print(f"Reconnecting to Redis [{self.connect}] "
                      f"(attempt #{policy.attempts})", file=sys.stderr)
            finally:
                if worker is not None:
                    self._release(worker.cnx)
        else:
            return
        if self.exit_on_failure:
            os._exit(1)

    def accept(self, handler_factory) -> None:
        for tid in range(self.threads):
            self._spawn_handler(self._worker, (tid, handler_factory))
        while self.join_handlers(timeout=60.0):
            pass
