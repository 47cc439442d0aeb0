"""TCP input: thread-per-connection (plus a coroutine variant).

Parity model: flowgger src/flowgger/input/tcp/{mod,tcp_input}.rs
(defaults: listen 0.0.0.0:514, read timeout 3600s, line framing;
``input.framed = true`` selects syslen unless ``input.framing`` is set)
and tcpco_input.rs for the coroutine tier (one asyncio event loop with
cooperative connection handling, each connection's split loop on the
loop's executor).  A ``*_tpu`` pipeline hands every connection the same
batch handler; each connection frames its own stream through its own
session of it.
"""

from __future__ import annotations

import socket
import sys

from . import Input
from ..config import Config, ConfigError
from ..splitters import get_splitter

DEFAULT_FRAMING = "line"
DEFAULT_LISTEN = "0.0.0.0:514"
DEFAULT_THREADS = 1
DEFAULT_TIMEOUT = 3600


def parse_listen(listen: str):
    host, _, port = listen.rpartition(":")
    if not host or not port.isdigit():
        raise ConfigError("unable to parse ip:port string from input.listen")
    return host, int(port)


def tcp_config_parse(config: Config, threads_key: str = "input.tcp_threads"):
    listen = config.lookup_str(
        "input.listen", "input.listen must be an ip:port string", DEFAULT_LISTEN)
    threads = config.lookup_int(
        threads_key, f"{threads_key} must be an unsigned integer", DEFAULT_THREADS)
    timeout = config.lookup_int(
        "input.timeout", "input.timeout must be an unsigned integer", DEFAULT_TIMEOUT)
    framed = config.lookup_bool(
        "input.framed", "input.framed must be a boolean", False)
    framing = "syslen" if framed else DEFAULT_FRAMING
    framing = config.lookup_str(
        "input.framing",
        'input.framing must be a string set to "line", "nul" or "syslen"',
        framing)
    return framing, threads, listen, timeout


class SocketStream:
    """read(n) view over a socket; timeouts surface as TimeoutError
    (the splitters treat that as the reference's WouldBlock idle-close)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def read(self, n: int) -> bytes:
        return self.sock.recv(n)


class TcpInput(Input):
    label = "TCP"

    def __init__(self, config: Config):
        self.framing, self.listen, self.timeout = self._configure(config)
        # an unknown framing raises the reference's ConfigError here
        # (its inputs raise it on each connection's thread)
        get_splitter(self.framing)
        self.bound_port = None
        self._listener = None

    def _configure(self, config: Config):
        """(framing, listen, idle timeout) of the transport's keys."""
        framing, _, listen, timeout = tcp_config_parse(config)
        return framing, listen, timeout

    def accept(self, handler_factory) -> None:
        self._handler_factory = handler_factory
        host, port = parse_listen(self.listen)
        self._listener = socket.create_server((host, port))
        self.bound_port = self._listener.getsockname()[1]
        try:
            while not self._stopping:
                try:
                    client, peer = self._listener.accept()
                except OSError as e:
                    # a listener the pipeline closed ends the loop quietly;
                    # any other error (EMFILE and friends) must not look
                    # like a clean end
                    if not self._stopping:
                        print(f"{self.label} accept loop exiting: {e}",
                              file=sys.stderr)
                    return
                client.settimeout(self.timeout)
                print(f"Connection over {self.label} from "
                      f"[{peer[0]}:{peer[1]}]")
                self._spawn_handler(self._handle_client, (client, peer[0]))
        finally:
            self._listener.close()

    def stop(self) -> None:
        """Close the listener: a blocked ``accept`` wakes (the shutdown
        does that on Linux, a close alone does not) and the loop ends."""
        self._stopping = True
        listener = self._listener
        if listener is not None:
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:  # flowcheck: disable=FC04 -- not listening any more; the close below ends it
                pass
            listener.close()

    def _handle_client(self, client: socket.socket, peer_ip=None):
        splitter = get_splitter(self.framing)
        try:
            splitter.run(SocketStream(client),
                         self._handler_factory(peer=peer_ip))
        finally:
            try:
                client.close()
            except OSError:  # flowcheck: disable=FC04 -- fd already dead; close is best-effort
                pass


class TcpCoInput(TcpInput):
    """Coroutine tier: cooperative handling on an asyncio loop
    (tcpco_input.rs:25-47)."""

    ssl_context = None

    def __init__(self, config: Config):
        super().__init__(config)
        self._loop = None
        self._serve_task = None

    def accept(self, handler_factory) -> None:
        import asyncio

        host, port = parse_listen(self.listen)
        framing = self.framing
        timeout = self.timeout
        label = self.label

        async def handle(reader: "asyncio.StreamReader", writer):
            peer = writer.get_extra_info("peername")
            if peer:
                print(f"Connection over {label} from [{peer[0]}:{peer[1]}]")
            handler = handler_factory(peer=peer[0] if peer else None)
            splitter = get_splitter(framing)
            stream = _AsyncBridgeStream(reader, timeout)
            # splitters are synchronous: each connection's split loop runs
            # on the executor, so the loop stays free for accepts while
            # reads await in the bridge
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._guarded, splitter.run,
                                       stream, handler)
            writer.close()

        async def serve():
            self._loop = asyncio.get_running_loop()
            self._serve_task = asyncio.current_task()
            server = await asyncio.start_server(handle, host, port,
                                                ssl=self.ssl_context)
            self.bound_port = server.sockets[0].getsockname()[1]
            try:
                if not self._stopping:
                    await server.serve_forever()
            finally:
                # no wait_closed: it would wait for every open connection;
                # asyncio.run cancels their reads, and their split loops
                # end as at EOF
                server.close()

        try:
            asyncio.run(serve())
        except asyncio.CancelledError:
            if not self._stopping:
                raise

    def stop(self) -> None:
        """Cancel the serving task from any thread: the server closes and
        ``asyncio.run`` returns once the executor's split loops end."""
        self._stopping = True
        loop, task = self._loop, self._serve_task
        if loop is not None and task is not None:
            try:
                loop.call_soon_threadsafe(task.cancel)
            except RuntimeError:  # flowcheck: disable=FC04 -- the loop already closed: accept has returned
                pass


class _AsyncBridgeStream:
    """Synchronous read() facade over an asyncio StreamReader."""

    def __init__(self, reader, timeout):
        import asyncio

        self.reader = reader
        self.timeout = timeout
        self.loop = asyncio.get_running_loop()

    def read(self, n: int) -> bytes:
        import asyncio
        import concurrent.futures

        fut = asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(self.reader.read(n), self.timeout), self.loop)
        try:
            return fut.result()
        except (asyncio.TimeoutError, concurrent.futures.TimeoutError):
            raise TimeoutError
        except concurrent.futures.CancelledError:  # flowcheck: disable=FC04 -- the pipeline stopped the input: the stream ends as at EOF
            return b""
