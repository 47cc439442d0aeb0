"""Minimal Kafka wire-protocol producer (dependency-free).

Implements what the Kafka output needs, against both broker
generations — the same capability set the reference gets from the
`kafka` crate (kafka_output.rs: required-acks -1/0/1, ack timeout,
gzip/snappy compression):

- **ApiVersions negotiation** on connect picks the protocol per broker:
  modern brokers (Kafka >= 0.11, including 4.x where KIP-896 removed
  the legacy versions) get Metadata v4 + Produce v3 with **record
  batches v2** (varint records, CRC32C, per-batch compression); legacy
  brokers that reject or don't answer ApiVersions get Metadata v0 +
  Produce v0 with the classic message-set format (magic 0, CRC32).
- gzip on both generations; snappy (raw block format,
  utils/snappy.py) on record batches v2.

Messages are round-robined across the topic's led partitions.

Parity model: the JAX package's ``utils/kafka_wire.py``, unchanged but
for its CRC32C and snappy, which here always run the native host tier
(``native.crc32c``, ``utils/snappy.py``).

Protocol notes: every request is ``[i32 size][i16 api_key][i16 api_ver]
[i32 correlation][str client_id]body``; strings are i16-length-prefixed,
bytes i32-length-prefixed (-1 = null).
"""

from __future__ import annotations

import gzip as _gzip
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

_API_PRODUCE = 0
_API_METADATA = 3
_API_VERSIONS = 18
_CLIENT_ID = b"flowgger-tpu"


class KafkaError(Exception):
    pass


def _str(s: bytes) -> bytes:
    return struct.pack(">h", len(s)) + s


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _covers(rng: Optional[Tuple[int, int]], ver: int) -> bool:
    return rng is not None and rng[0] <= ver <= rng[1]


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def i8(self) -> int:
        v = struct.unpack_from(">b", self.data, self.off)[0]
        self.off += 1
        return v

    def i16(self) -> int:
        v = struct.unpack_from(">h", self.data, self.off)[0]
        self.off += 2
        return v

    def i32(self) -> int:
        v = struct.unpack_from(">i", self.data, self.off)[0]
        self.off += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from(">q", self.data, self.off)[0]
        self.off += 8
        return v

    def string(self) -> Optional[str]:
        n = self.i16()
        if n == -1:
            return None
        s = self.data[self.off:self.off + n]
        self.off += n
        return s.decode("utf-8")


def _message(value: bytes, compression: int = 0) -> bytes:
    # magic 0: crc over [magic][attrs][key][value]
    body = struct.pack(">bb", 0, compression) + _bytes(None) + _bytes(value)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return struct.pack(">I", crc) + body


def _message_set(values: List[bytes], compression: str) -> bytes:
    msgs = b"".join(
        struct.pack(">q", 0) + struct.pack(">i", len(m)) + m
        for m in (_message(v) for v in values)
    )
    if compression == "gzip":
        wrapped = _message(_gzip.compress(msgs), compression=1)
        return struct.pack(">q", 0) + struct.pack(">i", len(wrapped)) + wrapped
    return msgs


# -- record batch v2 (message format v2, magic 2) ---------------------------

def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _varint(v: int) -> bytes:
    v = _zigzag(v) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


_COMPRESSION_ATTR = {"none": 0, "gzip": 1, "snappy": 2}


def _record(value: bytes, offset_delta: int) -> bytes:
    body = (b"\x00"                       # record attributes
            + _varint(0)                  # timestamp delta
            + _varint(offset_delta)
            + _varint(-1)                 # null key
            + _varint(len(value)) + value
            + _varint(0))                 # no headers
    return _varint(len(body)) + body


def _record_batch(values: List[bytes], compression: str,
                  now_ms: Optional[int] = None) -> bytes:
    """One record batch v2: varint records, CRC32C over the post-crc
    region, whole-payload compression per ``attributes``."""
    from .. import native

    if now_ms is None:
        now_ms = int(time.time() * 1000)
    records = b"".join(_record(v, i) for i, v in enumerate(values))
    attrs = _COMPRESSION_ATTR[compression]
    if compression == "gzip":
        records = _gzip.compress(records)
    elif compression == "snappy":
        from . import snappy as _snappy

        records = _snappy.compress(records)
    post_crc = (
        struct.pack(">hiqqqhii", attrs, len(values) - 1, now_ms, now_ms,
                    -1, -1, -1, len(values))
        + records
    )
    crc = native.crc32c(post_crc)
    head = struct.pack(">qi", 0, 4 + 1 + 4 + len(post_crc))  # offset, length
    return head + struct.pack(">ib", -1, 2) + struct.pack(">I", crc) + post_crc


class KafkaProducer:
    """Synchronous producer: one connection per partition leader."""

    def __init__(self, brokers: List[str], required_acks: int, timeout_ms: int,
                 compression: str = "none", socket_timeout: float = 30.0):
        if compression not in ("none", "gzip", "snappy"):
            raise KafkaError(f"Unsupported compression method: {compression}")
        self.brokers = brokers
        self.required_acks = required_acks
        self.timeout_ms = timeout_ms
        self.compression = compression
        self.socket_timeout = socket_timeout
        self._corr = 0
        self._lock = threading.Lock()
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        self._leaders: Dict[str, List[Tuple[int, Tuple[str, int]]]] = {}
        # per-broker negotiated (produce_version, metadata_version)
        self._versions: Dict[Tuple[str, int], Tuple[int, int]] = {}
        self._rr = 0

    # -- plumbing ----------------------------------------------------------
    def _connect(self, addr: Tuple[str, int]) -> socket.socket:
        sock = self._conns.get(addr)
        if sock is not None:
            return sock
        sock = socket.create_connection(addr, timeout=self.socket_timeout)
        self._conns[addr] = sock
        if addr not in self._versions:
            versions, cacheable = self._negotiate(addr, sock)
            if cacheable:
                # an explicit broker answer (modern ranges, or an error
                # code from a pre-ApiVersions broker) is authoritative;
                # a transport failure is NOT cached so the next
                # connection re-negotiates instead of pinning a modern
                # broker to legacy v0 after one network blip
                self._versions[addr] = versions
            if addr not in self._conns:
                # negotiation closed the socket (a pre-ApiVersions
                # broker dropping the unknown request, or a blip):
                # reconnect so the caller gets a usable connection for
                # its legacy-versioned attempt
                sock = socket.create_connection(
                    addr, timeout=self.socket_timeout)
                self._conns[addr] = sock
        return sock

    def _negotiate(self, addr, sock) -> Tuple[Tuple[int, int], bool]:
        """ApiVersions v0 → ((produce_version, metadata_version),
        cacheable).  A broker that answers with an error, or ignores /
        closes on the request, is treated as legacy v0; only transport
        failures are marked non-cacheable."""
        self._corr += 1
        header = (struct.pack(">hhi", _API_VERSIONS, 0, self._corr)
                  + _str(_CLIENT_ID))
        old_timeout = sock.gettimeout()
        try:
            sock.settimeout(5.0)
            sock.sendall(struct.pack(">i", len(header)) + header)
            raw = b""
            while len(raw) < 4:
                chunk = sock.recv(4 - len(raw))
                if not chunk:
                    raise OSError("closed")
                raw += chunk
            size = struct.unpack(">i", raw)[0]
            data = b""
            while len(data) < size:
                chunk = sock.recv(size - len(data))
                if not chunk:
                    raise OSError("closed")
                data += chunk
        except (OSError, TimeoutError):
            # could be a pre-ApiVersions broker ignoring the request OR
            # a transient network failure on a modern one: use legacy
            # for this attempt but renegotiate on the next connection
            self._conns.pop(addr, None)
            try:
                sock.close()
            except OSError:  # flowcheck: disable=FC04 -- fd already dead; close is best-effort
                pass
            return (0, 0), False
        finally:
            try:
                sock.settimeout(old_timeout)
            except OSError:  # flowcheck: disable=FC04 -- socket died during negotiation; the caller reconnects
                pass
        rd = _Reader(data)
        rd.i32()  # correlation
        if rd.i16() != 0:
            return (0, 0), True
        ranges = {}
        for _ in range(rd.i32()):
            api = rd.i16()
            lo, hi = rd.i16(), rd.i16()
            ranges[api] = (lo, hi)
        produce = 3 if _covers(ranges.get(_API_PRODUCE), 3) else 0
        metadata = 4 if _covers(ranges.get(_API_METADATA), 4) else 0
        return (produce, metadata), True

    def _roundtrip(self, addr, api_key: int, body: bytes,
                   expect_response: bool = True,
                   api_ver: int = 0) -> Optional[_Reader]:
        sock = self._connect(addr)
        self._corr += 1
        header = (struct.pack(">hhi", api_key, api_ver, self._corr)
                  + _str(_CLIENT_ID))
        payload = header + body
        try:
            sock.sendall(struct.pack(">i", len(payload)) + payload)
            if not expect_response:
                return None
            raw = b""
            while len(raw) < 4:
                chunk = sock.recv(4 - len(raw))
                if not chunk:
                    raise KafkaError("connection closed")
                raw += chunk
            size = struct.unpack(">i", raw)[0]
            data = b""
            while len(data) < size:
                chunk = sock.recv(size - len(data))
                if not chunk:
                    raise KafkaError("connection closed")
                data += chunk
        except OSError as e:
            self._conns.pop(addr, None)
            try:
                sock.close()
            except OSError:  # flowcheck: disable=FC04 -- fd already dead; close is best-effort
                pass
            raise KafkaError(str(e))
        rd = _Reader(data)
        rd.i32()  # correlation id
        return rd

    @staticmethod
    def _parse_broker_addr(broker: str) -> Tuple[str, int]:
        host, sep, port = broker.rpartition(":")
        if not sep:
            return broker, 9092
        if not port.isdigit():
            raise KafkaError(f"invalid broker address: {broker!r}")
        return host, int(port)

    # -- metadata ----------------------------------------------------------
    def refresh_metadata(self, topic: str):
        last_err = None
        for broker in self.brokers:
            addr = self._parse_broker_addr(broker)
            try:
                self._connect(addr)  # negotiate before picking the body
                mver = self._versions.get(addr, (0, 0))[1]
                body = struct.pack(">i", 1) + _str(topic.encode())
                if mver >= 4:
                    body += struct.pack(">b", 1)  # allow_auto_topic_creation
                rd = self._roundtrip(addr, _API_METADATA, body, api_ver=mver)
            except (KafkaError, OSError) as e:
                last_err = KafkaError(str(e))
                continue
            if mver >= 4:
                rd.i32()  # throttle_time_ms
            nodes = {}
            for _ in range(rd.i32()):
                node_id = rd.i32()
                host = rd.string()
                port = rd.i32()
                if mver >= 4:
                    rd.string()  # rack
                nodes[node_id] = (host, port)
            if mver >= 4:
                rd.string()  # cluster_id
                rd.i32()     # controller_id
            parts = []
            for _ in range(rd.i32()):
                rd.i16()  # topic error code
                tname = rd.string()
                if mver >= 4:
                    rd.i8()  # is_internal
                for _ in range(rd.i32()):
                    perr = rd.i16()
                    pid = rd.i32()
                    leader = rd.i32()
                    for _ in range(rd.i32()):
                        rd.i32()  # replicas
                    for _ in range(rd.i32()):
                        rd.i32()  # isr
                    if tname == topic and perr in (0, 9) and leader in nodes:
                        parts.append((pid, nodes[leader]))
            if parts:
                self._leaders[topic] = sorted(parts)
                return
            last_err = KafkaError(f"no leaders found for topic {topic}")
        raise KafkaError(f"metadata refresh failed: {last_err}")

    # -- produce -----------------------------------------------------------
    def send_all(self, topic: str, values: List[bytes]):
        if not values:
            return
        with self._lock:
            if topic not in self._leaders:
                self.refresh_metadata(topic)
            parts = self._leaders[topic]
            self._rr = (self._rr + 1) % len(parts)
            pid, addr = parts[self._rr]
            try:
                self._connect(addr)
            except OSError as e:
                self._leaders.pop(topic, None)
                raise KafkaError(str(e))
            pver = self._versions.get(addr, (0, 0))[0]
            if pver >= 3:
                mset = _record_batch(values, self.compression)
                body = (
                    struct.pack(">h", -1)  # null transactional_id
                    + struct.pack(">hi", self.required_acks, self.timeout_ms)
                    + struct.pack(">i", 1) + _str(topic.encode())
                    + struct.pack(">i", 1) + struct.pack(">i", pid)
                    + struct.pack(">i", len(mset)) + mset
                )
            else:
                if self.compression == "snappy":
                    raise KafkaError(
                        "snappy compression requires a broker supporting "
                        "record batches v2 (Kafka >= 0.11)")
                mset = _message_set(values, self.compression)
                body = (
                    struct.pack(">hi", self.required_acks, self.timeout_ms)
                    + struct.pack(">i", 1) + _str(topic.encode())
                    + struct.pack(">i", 1) + struct.pack(">i", pid)
                    + struct.pack(">i", len(mset)) + mset
                )
            try:
                rd = self._roundtrip(addr, _API_PRODUCE, body,
                                     expect_response=self.required_acks != 0,
                                     api_ver=pver)
            except KafkaError:
                self._leaders.pop(topic, None)
                raise
            if rd is not None:
                for _ in range(rd.i32()):
                    rd.string()
                    for _ in range(rd.i32()):
                        rd.i32()  # partition
                        err = rd.i16()
                        rd.i64()  # offset
                        if pver >= 3:
                            rd.i64()  # log_append_time
                        if err != 0:
                            self._leaders.pop(topic, None)
                            raise KafkaError(f"produce error code {err}")

    def send(self, topic: str, value: bytes):
        self.send_all(topic, [value])

    def close(self):
        for sock in self._conns.values():
            try:
                sock.close()
            except OSError:  # flowcheck: disable=FC04 -- fd already dead; close is best-effort
                pass
        self._conns.clear()
