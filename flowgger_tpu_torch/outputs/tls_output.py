"""TLS output: forward framed messages to a downstream syslog/TLS
cluster with failover and randomized backoff.

Parity model: flowgger src/flowgger/output/tls_output.rs:21-361 and the
JAX package's ``outputs/tls_output.py`` (without its fault injection,
metrics and durability acks, which the port does not have).

- ``output.connect`` is a list of ``host:port`` endpoints, shuffled at
  startup; workers advance round-robin through the shared list and
  reshuffle each time a cycle completes (tls_output.rs:131-140);
- per-message flush unless ``output.tls_async`` (tls_output.rs:119-122);
- reconnect uses randomized additive backoff: delay grows by
  ``uniform(0, delay)`` up to ``tls_recovery_delay_max`` ms, resetting
  to ``tls_recovery_delay_init`` after ``tls_recovery_probe_time`` ms of
  connection stability (tls_output.rs:163-172);
- a message whose write failed waits in the worker's retry slot and goes
  first on the next connection;
- client-side TLS config mirrors the input side, plus optional client
  cert/key.
"""

from __future__ import annotations

import random
import socket
import ssl
import sys
import threading

from . import Output, SHUTDOWN, stream_bytes
from ..config import Config, ConfigError
from ..utils.retry import RetryPolicy

DEFAULT_RECOVERY_DELAY_INIT = 1
DEFAULT_RECOVERY_DELAY_MAX = 10_000
DEFAULT_RECOVERY_PROBE_TIME = 30_000
DEFAULT_ASYNC = False
DEFAULT_TIMEOUT = 3600
DEFAULT_THREADS = 1

# carry-slot stand-in for a consumed SHUTDOWN sentinel (which is None,
# the slot's empty value): a failed final flush must not lose shutdown
_CARRY_SHUTDOWN = object()


class _Cluster:
    def __init__(self, connect):
        self.connect = list(connect)
        random.shuffle(self.connect)
        self.idx = 0
        self.lock = threading.Lock()

    def next_endpoint(self) -> str:
        with self.lock:
            self.idx += 1
            if self.idx >= len(self.connect):
                random.shuffle(self.connect)
                self.idx = 0
            return self.connect[self.idx]


class TlsOutput(Output):
    def __init__(self, config: Config):
        self.threads = config.lookup_int(
            "output.tls_threads", "output.tls_threads must be a 32-bit integer",
            DEFAULT_THREADS)
        connect = config.lookup("output.connect")
        if connect is None:
            raise ConfigError("output.connect is required")
        if not isinstance(connect, list) or not all(isinstance(x, str) for x in connect):
            raise ConfigError("output.connect must be a list of strings")
        self.cluster = _Cluster(connect)
        cert = config.lookup_str(
            "output.tls_cert", "output.tls_cert must be a path to a .pem file")
        key = config.lookup_str(
            "output.tls_key", "output.tls_key must be a path to a .pem file")
        ciphers = config.lookup_str(
            "output.tls_ciphers", "output.tls_ciphers must be a string with a cipher suite")
        verify_peer = config.lookup_bool(
            "output.tls_verify_peer", "output.tls_verify_peer must be a boolean", False)
        ca_file = config.lookup_str(
            "output.tls_ca_file", "output.tls_ca_file must be a path to a file")
        self.timeout = config.lookup_int(
            "output.timeout", "output.timeout must be an integer", DEFAULT_TIMEOUT)
        self.async_ = config.lookup_bool(
            "output.tls_async", "output.tls_async must be a boolean", DEFAULT_ASYNC)
        self.recovery_delay_init = config.lookup_int(
            "output.tls_recovery_delay_init",
            "output.tls_recovery_delay_init must be an integer",
            DEFAULT_RECOVERY_DELAY_INIT)
        self.recovery_delay_max = config.lookup_int(
            "output.tls_recovery_delay_max",
            "output.tls_recovery_delay_max must be an integer",
            DEFAULT_RECOVERY_DELAY_MAX)
        self.recovery_probe_time = config.lookup_int(
            "output.tls_recovery_probe_time",
            "output.tls_recovery_probe_time must be an integer",
            DEFAULT_RECOVERY_PROBE_TIME)
        if self.recovery_delay_max < self.recovery_delay_init:
            raise ConfigError(
                "output.tls_recovery_delay_max cannot be less than "
                "output.tls_recovery_delay_init")

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if verify_peer:
            # reference SslConnector::connect(hostname, ...) verifies the
            # peer against system CAs and the hostname (tls_output.rs:323)
            ctx.check_hostname = True
            ctx.verify_mode = ssl.CERT_REQUIRED
            if ca_file is not None:
                try:
                    ctx.load_verify_locations(cafile=ca_file)
                except (OSError, ssl.SSLError):
                    raise ConfigError("Unable to read the trusted CA file")
            else:
                ctx.load_default_certs()
        else:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if cert is not None:
            try:
                ctx.load_cert_chain(certfile=cert, keyfile=key if key else cert)
            except (OSError, ssl.SSLError):
                raise ConfigError("Unable to read the TLS certificate")
        if ciphers is not None:
            try:
                ctx.set_ciphers(ciphers)
            except ssl.SSLError:
                raise ConfigError("Unsupported cipher suite")
        self.ctx = ctx

    # -- worker ------------------------------------------------------------
    def _handle_connection(self, arx, merger, endpoint: str, carry: list):
        """``carry`` is this worker's one-item retention slot: a message
        whose write failed rides there (never back through the queue —
        no drop, no reorder, no blocking put from the sole consumer) and
        is delivered first on the next connection."""
        host, _, port = endpoint.rpartition(":")
        if not host or not port.isdigit():
            # malformed endpoint: treated as a failed connection so the
            # worker rotates to the next cluster member instead of dying
            raise ConnectionRefusedError(f"Invalid connection string: {endpoint}")
        sock = socket.create_connection((host, int(port)), timeout=self.timeout)
        print(f"Connected to {endpoint}", file=sys.stderr)
        try:
            tls = self.ctx.wrap_socket(sock, server_hostname=host)
        except (ssl.SSLError, OSError):
            sock.close()
            raise ConnectionAbortedError("SSL handshake aborted by the server")
        print(f"Completed SSL handshake with {endpoint}", file=sys.stderr)
        # tls_async buffers like the reference's BufWriter (8KB) instead
        # of flushing per message (tls_output.rs:98,119-122)
        buf = bytearray()
        try:
            while True:
                if carry[0] is not None:
                    item = (SHUTDOWN if carry[0] is _CARRY_SHUTDOWN
                            else carry[0])
                    from_queue = False
                else:
                    item, from_queue = arx.get(), True
                if item is SHUTDOWN:
                    if buf:
                        try:
                            tls.sendall(bytes(buf))
                        except OSError:
                            # shutdown must survive the reconnect: carry
                            # it (the async-buffered bytes are lost with
                            # the connection, as in the reference)
                            carry[0] = _CARRY_SHUTDOWN
                            if from_queue:
                                arx.task_done()
                            raise
                    carry[0] = None
                    if from_queue:
                        arx.task_done()
                    return True
                data = stream_bytes(item, merger)
                try:
                    if self.async_:
                        buf.extend(data)
                        if len(buf) >= 8192:
                            tls.sendall(bytes(buf))
                            buf.clear()
                    else:
                        tls.sendall(data)
                except OSError:
                    # connection died with the message in hand: retain it
                    # for redelivery on the next connection
                    carry[0] = item
                    if from_queue:
                        arx.task_done()
                    raise
                carry[0] = None
                if from_queue:
                    arx.task_done()
        finally:
            try:
                tls.close()
            except OSError:  # flowcheck: disable=FC04 -- fd already dead; close is best-effort
                pass

    def _worker(self, arx, merger):
        # the reference's randomized additive backoff with a stability
        # probe (tls_output.rs:163-172), expressed as the shared policy
        policy = RetryPolicy(
            init_ms=self.recovery_delay_init, max_ms=self.recovery_delay_max,
            mode="additive", probe_ms=self.recovery_probe_time,
            metric="sink_reconnects")
        carry = [None]  # one-item retention slot (see _handle_connection)
        while True:
            policy.mark()
            endpoint = self.cluster.next_endpoint()
            try:
                if self._handle_connection(arx, merger, endpoint, carry):
                    return  # graceful shutdown
            except ConnectionRefusedError:
                print(f"Connection to {endpoint} refused", file=sys.stderr)
            except (ConnectionAbortedError, ConnectionResetError):
                print(f"Connection to {endpoint} aborted by the server",
                      file=sys.stderr)
            except OSError as e:
                print(f"Error while communicating with {endpoint} - {e}",
                      file=sys.stderr)
            policy.backoff()  # unlimited policy: never exhausts
            print("Attempting to reconnect", file=sys.stderr)

    def start(self, arx, merger):
        return [self.spawn(lambda: self._worker(arx, merger), "tls-output")
                for _ in range(self.threads)]
