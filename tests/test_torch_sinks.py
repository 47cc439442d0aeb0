"""The port's redis input and its Kafka, TLS and rotating-file sinks on
the CPU against the JAX package's, in process, one case each: redis →
``rfc5424_tpu`` → Kafka (capnp, snappy) in order, three redis workers as
a multiset, a redis reconnect that drains the tmp list again, the
legacy Kafka broker (Metadata v0 / Produce v0, gzip), a broker that
stays down ("Kafka not responsive" on stdout), two Kafka workers
draining on shutdown, the TLS sink (delivering, failing over from a
refused endpoint, ``tls_async``) and a rotating, buffered file from the
block route.

Both packages run against their own ``chip_smoke.RespFake`` and
``chip_smoke.KafkaFake`` (the broker fake checks every batch's checksum
and decompresses it).  The port runs through ``Pipeline.run`` /
``Pipeline.shutdown`` on ``cpu``; the reference runs its input and sinks
on threads (it has no in-process shutdown), its host tier
(``FLOWGGER_DEVICE_ENCODE=0``, ``tpu_fuse = "off"``), flushing by size
and at the end only, and its redis workers give up at once when the
fake closes (``exit_on_failure`` off).
Ports differ between the two sides' fakes, so they are masked in the
lines compared.  Every wait is bounded (``WAIT``)."""

import queue
import random
import re
import socket
import ssl
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config as TConfig
from flowgger_tpu_torch.corpus import (capnp_messages, make_corpus,
                                       mask_capnp_stamps)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reference_host_tier(monkeypatch):
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")


WAIT = 60.0
T0 = time.time() - 1.0
LINES = make_corpus(700, 31)[0]
_PORT = re.compile(r"127\.0\.0\.1:\d+")
_ERROR = re.compile(r"\[.*\]$")


def _poll(cond, what: str, wait: float = WAIT):
    deadline = time.monotonic() + wait
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _mask(lines: list) -> list:
    return [_PORT.sub("127.0.0.1:<port>", ln) for ln in lines]


def _config(ref: bool, in_keys: str, out_keys: str,
            ref_attempts: int = 0) -> str:
    """A redis → rfc5424_tpu config; the reference's workers give up
    after ``ref_attempts`` reconnects (0: at once, when its fake
    closes).  The reference flushes by size and at the end only: its
    batch timer takes a batch's lines under one lock and decodes them
    under another, so on a loaded host a timer flush can land behind a
    later size flush, or behind the final flush and its SHUTDOWN (the
    port's batches keep their order: its timer is the port's own)."""
    flush_ms = 600000 if ref else 30
    return ('[input]\ntype = "redis"\nformat = "rfc5424_tpu"\n'
            f'tpu_batch_size = 256\ntpu_flush_ms = {flush_ms}\n'
            'tpu_encode_economics = false\nredis_retry_init = 5\n'
            'redis_retry_max = 20\n'
            + (f'tpu_fuse = "off"\nredis_retry_attempts = {ref_attempts}\n'
               if ref else 'redis_retry_attempts = 3\n')
            + in_keys + "[output]\n" + out_keys)


def _drained(resp: "chip_smoke.RespFake", n: int, threads: int):
    return lambda: (resp.popped >= n and not resp.llen("logs")
                    and not any(resp.llen(f"logs.tmp.{t}")
                                for t in range(threads)))


def run_port(text: str, resp, n: int, threads: int = 1):
    pipe = pipeline.Pipeline(TConfig.from_string(text), device="cpu")
    exc = []

    def run():
        try:
            pipe.run()
        except BaseException as e:  # noqa: BLE001 - raised below
            exc.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        _poll(_drained(resp, n, threads), "the port to drain the list")
    finally:
        pipe.shutdown(timeout=WAIT)
        t.join(WAIT)
    assert not t.is_alive(), "the port's run did not end"
    if exc:
        raise exc[0]
    return pipe


def run_ref(text: str, resp, n: int, threads: int = 1):
    """The reference over ``resp``'s list: its input and sinks on
    threads, then its handlers flushed and its sinks given a SHUTDOWN
    each; the fake is closed by the caller after the capture."""
    from flowgger_tpu.config import Config as JConfig
    from flowgger_tpu.outputs import SHUTDOWN
    from flowgger_tpu.pipeline import Pipeline as JPipeline

    rp = JPipeline(JConfig.from_string(text))
    rp.input.exit_on_failure = False
    sinks = rp.start_output()
    sinks = sinks if isinstance(sinks, list) else [sinks]
    accept = threading.Thread(target=rp.input.accept,
                              args=(rp.handler_factory,), daemon=True)
    accept.start()
    _poll(_drained(resp, n, threads), "the reference to drain the list")
    for h in rp._handlers:
        h.flush()
        h.close()
    for _ in sinks:
        rp.tx.put(SHUTDOWN)
    for s in sinks:
        s.join(WAIT)
    assert not any(s.is_alive() for s in sinks)
    return accept


def _kafka_keys(kafka, threads: int = 1) -> str:
    return ('type = "kafka"\nformat = "capnp"\n'
            f'kafka_brokers = ["{kafka.broker}"]\nkafka_topic = "logs"\n'
            'kafka_compression = "snappy"\nkafka_coalesce = 100\n'
            f'kafka_acks = 1\nkafka_threads = {threads}\n')


def _records(kafka) -> list:
    values, rep = kafka.records()
    assert rep["checksums_valid"]
    return [mask_capnp_stamps(v, T0) for v in values]


def redis_to_kafka(capsys, lines=LINES, threads=1, kafka_threads=1,
                   drop_at_lrem=0) -> dict:
    """{side: (records, stdout lines, stderr lines)} of redis →
    rfc5424_tpu → Kafka over ``lines`` on both packages."""
    out = {}
    in_keys = f"redis_threads = {threads}\n"
    for side in ("port", "ref"):
        with chip_smoke.RespFake(drop_at_lrem=drop_at_lrem) as resp, \
                chip_smoke.KafkaFake() as kafka:
            resp.lpush("logs", lines)
            n = len(lines) + (1 if drop_at_lrem else 0)
            text = _config(side == "ref", in_keys.replace(
                "redis_threads", f'redis_connect = "{resp.connect}"\n'
                "redis_threads"), _kafka_keys(kafka, kafka_threads),
                3 if drop_at_lrem else 0)
            accept = None
            if side == "port":
                run_port(text, resp, n, threads)
            else:
                accept = run_ref(text, resp, n, threads)
            said = capsys.readouterr()
            recs = _records(kafka)
        if accept is not None:
            accept.join(WAIT)
            capsys.readouterr()
        out[side] = (recs, _mask(said.out.splitlines()),
                     _mask(said.err.splitlines()))
    return out


_ROTATED = re.compile(r"File \S+ reached size limit \d+, rotating")


def _rotations_apart(lines: list):
    """(rotation lines, the other stderr lines sorted).  The sink thread
    prints the rotation line and the decoding thread its error lines, and
    a print writes its text and its newline apart, so in both packages
    one can land inside the other's line; each is taken out whole."""
    text = "\n".join(lines)
    rest = [ln for ln in _ROTATED.sub("\n", text).split("\n") if ln]
    return _ROTATED.findall(text), sorted(rest)


def _want(lines) -> list:
    from flowgger_tpu_torch.corpus import scalar_expectation

    exp = scalar_expectation(b"\0".join(lines), "nul", merger=None,
                             output="capnp")[0]
    return [mask_capnp_stamps(exp[a:b], T0) for a, b in capnp_messages(exp)]


def test_redis_kafka_capnp_snappy_matches_the_reference(capsys):
    got = redis_to_kafka(capsys)
    assert got["port"] == got["ref"]
    recs, stdout, _ = got["port"]
    assert recs == _want(LINES)
    assert stdout == ["Connected to Redis [127.0.0.1:<port>], pulling "
                      "messages from key [logs]"]


def test_three_redis_workers_feed_one_handler_as_a_multiset(capsys):
    got = redis_to_kafka(capsys, threads=3)
    (precs, pout, perr), (rrecs, rout, rerr) = got["port"], got["ref"]
    assert sorted(precs) == sorted(rrecs) == sorted(_want(LINES))
    assert sorted(pout) == sorted(rout) and len(pout) == 3
    assert sorted(perr) == sorted(rerr)


def test_redis_reconnect_drains_the_tmp_list_again(capsys):
    """The fake drops the connection at the LREM after the 50th message:
    the worker reconnects, queues the unremoved message again (the tmp
    list's drain) and delivers it a second time, at the list's end."""
    lines = LINES[:300]
    got = redis_to_kafka(capsys, lines=lines, drop_at_lrem=50)
    (precs, pout, perr), (rrecs, rout, rerr) = got["port"], got["ref"]
    assert precs == rrecs == _want(lines) + _want(lines[49:50])
    assert pout == rout and len(pout) == 2
    assert sorted(perr) == sorted(rerr)
    assert "Redis connection lost - Redis protocol error in LREM: " \
        "[connection closed]" in perr
    assert "Reconnecting to Redis [127.0.0.1:<port>] (attempt #1)" in perr


def test_a_kernel_failure_on_a_redis_worker_ends_the_run(monkeypatch,
                                                         capsys):
    """K1's split decode raises on its second launch, on the redis
    worker's thread (its size flush submits the batch): the run ends —
    ``run()`` raises — instead of the worker reconnecting, and the batch
    submitted before it is what reached the broker."""
    from flowgger_tpu_torch.tpu import batch as B

    calls = [0]
    submit, fetch, encode = B._ROUTES["rfc5424"]

    def failing(*a, **k):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("CUDA kernel failed to launch (cudaError 719)")
        return submit(*a, **k)

    monkeypatch.setitem(B._ROUTES, "rfc5424", (failing, fetch, encode))
    with chip_smoke.RespFake() as resp, chip_smoke.KafkaFake() as kafka:
        resp.lpush("logs", LINES)
        text = _config(False, f'redis_connect = "{resp.connect}"\n'
                       'tpu_fuse = "off"\n', _kafka_keys(kafka)).replace(
            "tpu_flush_ms = 30", "tpu_flush_ms = 600000")
        pipe = pipeline.Pipeline(TConfig.from_string(text), device="cpu")
        with pytest.raises(RuntimeError, match="cudaError 719"):
            pipe.run()
        err = capsys.readouterr().err
        recs = _records(kafka)
    assert calls[0] == 2
    assert "Redis connection lost" not in err and "Reconnecting" not in err
    assert recs == _want(LINES[:256])


def test_two_kafka_workers_drain_on_shutdown(capsys):
    """kafka_threads = 2: the drain puts one SHUTDOWN a worker, so both
    flush their coalesced records and end (no straggler line)."""
    got = redis_to_kafka(capsys, kafka_threads=2)
    (precs, _, perr), (rrecs, _, rerr) = got["port"], got["ref"]
    assert sorted(precs) == sorted(rrecs) == sorted(_want(LINES))
    assert not [ln for ln in perr if ln.startswith("drain:")]
    assert sorted(perr) == sorted(rerr)


# -- the Kafka sink alone -----------------------------------------------------

def _sink(pkg: str, kind: str, text: str, items, merger=True, setup=None):
    """``pkg``'s ``kind`` sink fed ``items`` (bytes, or ``("block",
    bounds)`` for an EncodedBlock of the joined items) then a SHUTDOWN a
    worker; returns after every worker ended."""
    import importlib

    mod, cls = {"kafka": ("outputs.kafka_output", "KafkaOutput"),
                "tls": ("outputs.tls_output", "TlsOutput")}[kind]
    config = importlib.import_module(f"{pkg}.config").Config
    out = getattr(importlib.import_module(f"{pkg}.{mod}"), cls)(
        config.from_string(text))
    if kind == "kafka":
        out.exit_on_failure = False
    blk = importlib.import_module(f"{pkg}.block").EncodedBlock
    mergers = importlib.import_module(f"{pkg}.mergers")
    shutdown = importlib.import_module(f"{pkg}.outputs").SHUTDOWN
    tx = queue.Queue()
    threads = out.start(tx, mergers.LineMerger() if merger else None)
    threads = threads if isinstance(threads, list) else [threads]
    for item in items:
        if isinstance(item, tuple):
            data = b"".join(v + b"\n" for v in item[1])
            bounds = np.cumsum([0] + [len(v) + 1 for v in item[1]])
            item = blk(data, bounds, None, 1)
        tx.put(item)
    for _ in threads:
        tx.put(shutdown)
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)


_KAFKA_ITEMS = [b"first", ("block", LINES[:40]), b"last"]
_KAFKA_VALUES = [b"first", *LINES[:40], b"last"]


def test_kafka_legacy_broker_gets_v0_and_gzip(capsys):
    """A broker that drops the ApiVersions request: the producer falls
    back to Metadata v0 and Produce v0 with a gzip message set; the
    records (one a block row, framing ignored with the warning) match."""
    seen = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        with chip_smoke.KafkaFake(legacy=True) as kafka:
            _sink(pkg, "kafka", '[output]\nkafka_topic = "logs"\n'
                  f'kafka_brokers = ["{kafka.broker}"]\n'
                  'kafka_compression = "gzip"\nkafka_coalesce = 10\n'
                  'kafka_acks = -1\n', _KAFKA_ITEMS)
            values, rep = kafka.records()
            seen[pkg] = (values, rep["compression"], kafka.requests,
                         capsys.readouterr())
    assert seen["flowgger_tpu_torch"] == seen["flowgger_tpu"]
    values, codecs, requests, said = seen["flowgger_tpu_torch"]
    assert values == _KAFKA_VALUES and codecs == [0, 1]
    assert requests[18] >= 1 and requests[0] == 2
    assert said.err == "Output framing is ignored with the Kafka output\n"


@pytest.mark.parametrize("down", ["produce", "connect"])
def test_kafka_broker_that_stays_down(capsys, down):
    """Every Produce dropped (or no broker at all): the retry ladder runs
    out and "Kafka not responsive" (or "Unable to connect to Kafka")
    goes to stdout, with the retries' lines on stderr, as in the
    reference; ``exit_on_failure`` is off, so the worker returns."""
    seen = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        with chip_smoke.KafkaFake(fail_produce=True) as kafka:
            broker = kafka.broker
            if down == "connect":
                kafka.close()
            _sink(pkg, "kafka", '[output]\nkafka_topic = "logs"\n'
                  f'kafka_brokers = ["{broker}"]\nkafka_retry_init = 1\n'
                  'kafka_retry_max = 2\nkafka_retry_attempts = 2\n'
                  'kafka_acks = 1\n',
                  [b"x"], merger=False)
            said = capsys.readouterr()
        # the error inside the brackets follows the socket's timing (a
        # closed connection, or a broken pipe on the next send)
        seen[pkg] = tuple([_ERROR.sub("[<error>]", ln)
                           for ln in _mask(text.splitlines())]
                          for text in (said.out, said.err))
    assert seen["flowgger_tpu_torch"] == seen["flowgger_tpu"]
    stdout, stderr = seen["flowgger_tpu_torch"]
    if down == "produce":
        assert stdout == ["Kafka not responsive: [<error>]"]
        assert stderr == ["Kafka send failed, retrying: [<error>]"] * 3
    else:
        assert stdout == ["Unable to connect to Kafka: [<error>]"]
        assert stderr == ["Unable to connect to Kafka, retrying: "
                          "[<error>]"] * 3


# -- the TLS sink ----------------------------------------------------------------

class _TlsServer:
    """A TLS listener on a loopback port that keeps each connection's
    bytes until its peer closes."""

    def __init__(self, pem: str):
        self.ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self.ctx.load_cert_chain(pem)
        # no TLS 1.3 session tickets: the sink never reads, and unread
        # bytes at its close would turn the FIN into a reset that drops
        # the tail of what this side has not read yet
        self.ctx.num_tickets = 0
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.received = []
        self.live = 0   # bytes read so far, over every connection
        self.threads = []
        self.accept = threading.Thread(target=self._serve, daemon=True)
        self.accept.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._read, args=(conn,),
                                 daemon=True)
            self.threads.append(t)
            t.start()

    def _read(self, conn):
        data = bytearray()
        try:
            with self.ctx.wrap_socket(conn, server_side=True) as tls:
                while True:
                    chunk = tls.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                    self.live += len(chunk)
        except (OSError, ssl.SSLError):
            pass
        self.received.append(bytes(data))

    def close(self):
        # a shutdown wakes the blocked accept (a close alone does not)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self.accept.join(WAIT)
        for t in self.threads:
            t.join(WAIT)


def _refused_endpoint() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _failover_seed(endpoints) -> int:
    """A seed under which the cluster's first pick is the refused
    endpoint (the list is shuffled, and the first pick is index 1)."""
    for seed in range(1000):
        random.seed(seed)
        order = list(endpoints)
        random.shuffle(order)
        if order[1] == endpoints[0]:
            return seed
    raise AssertionError("no seed puts the refused endpoint first")


@pytest.mark.parametrize("mode", ["sync", "failover", "async"])
def test_tls_sink_matches_the_reference(session_pem, capsys, mode):
    items = [*LINES[:60], ("block", LINES[60:200]), *LINES[200:260]]
    want = b"".join(v + b"\n" for v in LINES[:260])
    seen = {}
    server = _TlsServer(session_pem)
    try:
        good = f"127.0.0.1:{server.port}"
        endpoints = [_refused_endpoint(), good] if mode == "failover" \
            else [good]
        seed = _failover_seed(endpoints) if mode == "failover" else 0
        text = ('[output]\nconnect = [' + ", ".join(
            f'"{e}"' for e in endpoints) + ']\ntimeout = 10\n'
            + ("tls_async = true\n" if mode == "async" else ""))
        for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
            random.seed(seed)
            before = len(server.received)
            _sink(pkg, "tls", text, items)
            _poll(lambda: len(server.received) > before,
                  "the connection's close")
            seen[pkg] = (server.received[-1],
                         capsys.readouterr().err.splitlines())
    finally:
        server.close()
    assert seen["flowgger_tpu_torch"] == seen["flowgger_tpu"]
    data, err = seen["flowgger_tpu_torch"]
    assert data == want
    assert err[-2:] == [f"Connected to {good}",
                        f"Completed SSL handshake with {good}"]
    if mode == "failover":
        assert err[:2] == [f"Connection to {endpoints[0]} refused",
                           "Attempting to reconnect"]


# -- the rotating, buffered file ----------------------------------------------------

def test_rotating_buffered_file_from_the_block_route(tmp_path, capsys):
    """redis → rfc5424_tpu → GELF into a file rotating at 24 KiB behind a
    4 KiB buffer: the same files, names and bytes, and the same rotation
    lines, as the reference's."""
    seen = {}
    for side in ("port", "ref"):
        d = tmp_path / side
        d.mkdir()
        with chip_smoke.RespFake() as resp:
            resp.lpush("logs", LINES)
            text = _config(side == "ref",
                           f'redis_connect = "{resp.connect}"\n',
                           'type = "file"\nformat = "gelf"\n'
                           f'file_path = "{d / "out.log"}"\n'
                           'file_rotation_size = 24576\n'
                           'file_rotation_maxfiles = 40\n'
                           'file_buffer_size = 4096\n')
            accept = None
            if side == "port":
                run_port(text, resp, len(LINES))
            else:
                accept = run_ref(text, resp, len(LINES))
            said = capsys.readouterr().err.replace(str(d), "<dir>")
        if accept is not None:
            accept.join(WAIT)
            capsys.readouterr()
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        seen[side] = (files, _rotations_apart(said.splitlines()))
    assert seen["port"] == seen["ref"]
    files, (rotations, _) = seen["port"]
    assert len(files) >= 4
    assert sum(ln.startswith("File <dir>/out.log reached size limit")
               for ln in rotations) == len(files) - 1


@pytest.mark.parametrize("fmt", ["rfc5424", "rfc5424_tpu"])
def test_a_file_write_error_ends_the_run(tmp_path, monkeypatch, fmt):
    """The port has no supervisor to restart the file sink: a write error
    (``/dev/full``: ENOSPC), met while the drain waits for the sink, is
    kept by the pipeline, which raises it, so the CLI exits non-zero
    (README deviation); the host path and the batch handler alike."""
    import io
    import sys

    cfg = tmp_path / "cfg.toml"
    cfg.write_text(f'[input]\ntype = "stdin"\nformat = "{fmt}"\n'
                   'tpu_encode_economics = false\n'
                   '[output]\ntype = "file"\nformat = "gelf"\n'
                   'file_path = "/dev/full"\n')
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(
        b"\n".join(LINES[:50]))))
    with pytest.raises(OSError) as exc:
        pipeline.start(str(cfg), device="cpu")
    assert exc.value.errno == 28
