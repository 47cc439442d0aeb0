"""Minimal RESP (Redis serialization protocol) client over a socket.

Parity model: the JAX package's ``utils/resp.py``, a dependency-free
replacement for the redis crate subset the reference uses
(redis_input.rs: RPOPLPUSH, BRPOPLPUSH, LREM; plus LPUSH / LRANGE / DEL
for tests).  RESP2 only — ample for these list commands.  The port adds
:meth:`RespClient.shutdown`, which wakes a read blocked in BRPOPLPUSH
from another thread (the redis input's stop).
"""

from __future__ import annotations

import socket
from typing import List, Optional, Union


class RespError(Exception):
    pass


class RespClient:
    def __init__(self, host: str, port: int = 6379, timeout: Optional[float] = None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    @classmethod
    def from_connect_string(cls, connect: str, timeout: Optional[float] = None):
        if ":" in connect:
            host, _, port = connect.rpartition(":")
            return cls(host, int(port), timeout)
        return cls(connect, 6379, timeout)

    def shutdown(self):
        """Wake a blocked read from another thread: the socket's both
        sides go down, so the read sees the end of the stream."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:  # flowcheck: disable=FC04 -- already disconnected; the read has ended
            pass

    def close(self):
        try:
            self.sock.close()
        except OSError:  # flowcheck: disable=FC04 -- fd already dead; close is best-effort
            pass

    # -- wire --------------------------------------------------------------
    def _send(self, *parts: Union[str, bytes, int]):
        out = [f"*{len(parts)}\r\n".encode()]
        for p in parts:
            if isinstance(p, int):
                p = str(p)
            if isinstance(p, str):
                p = p.encode("utf-8")
            out.append(f"${len(p)}\r\n".encode() + p + b"\r\n")
        self.sock.sendall(b"".join(out))

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise RespError("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise RespError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_reply(self):
        line = self._read_line()
        t, body = line[:1], line[1:]
        if t == b"+":
            return body.decode()
        if t == b"-":
            raise RespError(body.decode())
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing CRLF
            return data
        if t == b"*":
            n = int(body)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"unexpected reply type: {line!r}")

    def command(self, *parts):
        self._send(*parts)
        return self._read_reply()

    # -- the commands the pipeline needs ----------------------------------
    def rpoplpush(self, src: str, dst: str) -> Optional[bytes]:
        return self.command("RPOPLPUSH", src, dst)

    def brpoplpush(self, src: str, dst: str, timeout: int = 0) -> Optional[bytes]:
        return self.command("BRPOPLPUSH", src, dst, timeout)

    def lrem(self, key: str, count: int, value: bytes) -> int:
        return self.command("LREM", key, count, value)

    def lpush(self, key: str, value: bytes) -> int:
        return self.command("LPUSH", key, value)

    def lrange(self, key: str, start: int, stop: int) -> List[bytes]:
        return self.command("LRANGE", key, start, stop)

    def delete(self, key: str) -> int:
        return self.command("DEL", key)
