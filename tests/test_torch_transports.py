"""The port's transports on the CPU against the JAX package's, in process:
tcp, tcp_co, tls, tls_co, udp (per datagram, and through recvmmsg into
the batch handler's span ingest) and file (inotify and poll discovery,
truncation, logrotate's rename-create).  Each case runs one ``*_tpu``
format (``device="cpu"``: the kernels' plain versions) and one scalar
format over the same bytes and the same transport through both
packages, and compares the output bytes, stderr and stdout (without the
"Connection over" lines, whose ports differ).  Then: one batch handler
shared by every connection of a ``*_tpu`` pipeline (a ``ScalarHandler``
a connection for a scalar one), no loss under concurrent connections,
and a failure on a connection thread — or one the flush timer meets —
that ends the run after the batches submitted before it.

The reference runs its host tier (``FLOWGGER_DEVICE_ENCODE=0``,
``tpu_fuse = "off"``); each side runs after the other, the port first
(its ``Pipeline.shutdown`` drains it), so their stderr stays apart.
Every socket wait is bounded (``WAIT``)."""

import gzip
import queue
import socket
import ssl
import sys
import threading
import time
import zlib

import pytest
import torch

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_dns_corpus,
                                       make_gelf_corpus, make_jsonl_corpus,
                                       make_ltsv_corpus, make_rfc3164_corpus,
                                       make_tier_corpus, mask_wall_stamps,
                                       scalar_expectation, syslen_stream)
from flowgger_tpu_torch.mergers import NulMerger
from flowgger_tpu_torch.tpu import batch as B
from flowgger_tpu_torch.tpu import framing as F
from flowgger_tpu_torch.tpu import fused_routes as FR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WAIT = 15.0  # bound on every socket / output wait
# bound on the reference's output: its first batch of a new shape
# compiles its decode (JAX) first, which a loaded box can stretch
REF_WAIT = 60.0
T0 = time.time() - 1.0  # gelf rows without a stamp get the wall clock
CORPORA = {"rfc5424": make_corpus, "rfc3164": make_rfc3164_corpus,
           "ltsv": make_ltsv_corpus, "gelf": make_gelf_corpus,
           "jsonl": make_jsonl_corpus, "dns": make_dns_corpus}


def _poll(cond, what: str, wait: float = WAIT):
    deadline = time.monotonic() + wait
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


_DEFAULT_KEYS = {"tpu_encode_economics": "false", "tpu_batch_size": "256",
                 "tpu_flush_ms": "30", "timeout": "5"}


def _config_text(out, fmt: str, in_keys: str, ref: bool) -> str:
    """The [input] keys (``in_keys`` override the defaults here), the
    format, and a GELF file output."""
    given = {ln.split("=")[0].strip() for ln in in_keys.splitlines()}
    defaults = "".join(f"{k} = {v}\n" for k, v in _DEFAULT_KEYS.items()
                       if k not in given)
    return ('[input]\n' + defaults + f'format = "{fmt}"\n'
            + ('tpu_fuse = "off"\n' if ref else "") + in_keys
            + f'[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\n')


class PortSide:
    """The port's pipeline, run on a thread; :meth:`finish` shuts it down
    (the drain) and returns its output bytes."""

    def __init__(self, tmp_path, fmt: str, in_keys: str, name="port"):
        self.name = name
        self.out = tmp_path / f"{name}.out"
        self.pipe = pipeline.Pipeline(
            Config.from_string(_config_text(self.out, fmt, in_keys, False)),
            device="cpu")
        self.exc = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            self.pipe.run()
        except BaseException as e:  # noqa: BLE001 - the test raises it
            self.exc.append(e)

    @property
    def input(self):
        return self.pipe.input

    def records(self) -> int:
        return self.out.read_bytes().count(b"\0") if self.out.exists() else 0

    def finish(self) -> bytes:
        self.pipe.shutdown(timeout=WAIT)
        self.thread.join(WAIT)
        assert not self.thread.is_alive(), "the port's run did not end"
        if self.exc:
            raise self.exc[0]
        return self.out.read_bytes() if self.out.exists() else b""


class RefSide:
    """The JAX package's pipeline: its output and its accept loop run on
    daemon threads (it has no in-process shutdown)."""

    def __init__(self, tmp_path, fmt: str, in_keys: str, name="ref"):
        from flowgger_tpu.config import Config as RConfig
        from flowgger_tpu.pipeline import Pipeline as RPipeline

        self.name = name
        self.out = tmp_path / f"{name}.out"
        self.pipe = RPipeline(RConfig.from_string(
            _config_text(self.out, fmt, in_keys, True)))
        self.pipe.start_output()
        self.thread = threading.Thread(
            target=self.pipe.input.accept, args=(self.pipe.handler_factory,),
            daemon=True)
        self.thread.start()

    @property
    def input(self):
        return self.pipe.input

    def records(self) -> int:
        return self.out.read_bytes().count(b"\0") if self.out.exists() else 0

    def close(self) -> None:
        """Stop what can be stopped: the batch handler's fetcher threads
        and the sink (the accept loop stays blocked on its socket)."""
        from flowgger_tpu.outputs import SHUTDOWN

        for h in self.pipe._handlers:
            h.flush()
            h.close()
        self.pipe.tx.put(SHUTDOWN)


def _settle(side, quiet: float = 0.5) -> None:
    """Wait until the side's output has not grown for ``quiet`` seconds
    (a transport whose end the test cannot see: datagrams, a co-routine
    connection's last reads)."""
    last = [-1, time.monotonic()]

    def still():
        n = side.records()
        now = time.monotonic()
        if n != last[0]:
            last[:] = [n, now]
        return n > 0 and now - last[1] >= quiet

    _poll(still, "a settled output")


def _bound(side) -> int:
    _poll(lambda: side.input.bound_port is not None, "the listener")
    return side.input.bound_port


def _streams(capsys, acc: list):
    got = capsys.readouterr()
    acc[0] += got.out
    acc[1] += got.err
    return acc


def _stdout_lines(text: str):
    """stdout without the connection lines (their ports differ)."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("Connection over ")]


def _pair(tmp_path, monkeypatch, capsys, fmt, in_keys, drive,
          same=lambda a, b: a == b, same_err=None, want=None):
    """``drive(side)`` against each package in turn (``in_keys``: the
    [input] keys, or a callable of the side's name returning them);
    returns ``(port output, port stderr lines)`` after asserting the
    reference's output, stderr and stdout equal the port's (``same``
    compares each; ``same_err``, when given, the stderr lines).  With
    ``want`` (the records the stream holds) the port's run is shut down
    once its output has them, else once its output has settled."""
    same_err = same_err or same
    keys = in_keys if callable(in_keys) else (lambda name: in_keys)
    capsys.readouterr()
    port = PortSide(tmp_path, fmt, keys("port"))
    drive(port)
    if want is None:
        _settle(port)
    else:
        _poll(lambda: port.records() >= want, "the port's records")
    got = port.finish()
    acc = _streams(capsys, ["", ""])
    n = got.count(b"\0")
    # the reference's host tier only (its device encode compiles on the
    # CPU are not what these tests hold)
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    ref = RefSide(tmp_path, fmt, keys("ref"))
    drive(ref)
    racc = ["", ""]
    _poll(lambda: ref.records() >= n
          and len(_streams(capsys, racc)[1].splitlines())
          >= len(acc[1].splitlines()), "the reference's output", REF_WAIT)
    time.sleep(0.1)
    ref.close()
    _streams(capsys, racc)
    assert same(got, ref.out.read_bytes())
    errs, rerrs = acc[1].splitlines(), racc[1].splitlines()
    assert same_err(errs, rerrs), (errs[:5], rerrs[:5])
    assert same(_stdout_lines(acc[0]), _stdout_lines(racc[0]))
    return got, errs


def _as_multiset(a, b) -> bool:
    if isinstance(a, bytes):
        a, b = a.split(b"\0"), b.split(b"\0")
    return sorted(a) == sorted(b)


def _masked(a, b) -> bool:
    return mask_wall_stamps(a, T0) == mask_wall_stamps(b, T0) \
        if isinstance(a, bytes) else a == b


def _data(fmt: str, n: int, seed: int, framing: str) -> bytes:
    lines, _ = CORPORA[fmt](n, seed)
    if framing == "syslen":
        return syslen_stream(lines)
    sep = b"\0" if framing == "nul" else b"\n"
    # the last record has no separator: the end-of-stream partial frame
    return sep.join(lines)


def _send_tcp(data: bytes, tls: bool = False):
    def drive(side):
        port = _bound(side)
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=WAIT) as raw:
            if tls:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
                with ctx.wrap_socket(raw) as s:
                    s.sendall(data)
                    # half-close, then read to the server's close: a TLS
                    # 1.3 server's session tickets left unread would turn
                    # the close into a reset, which drops the bytes the
                    # server has not read yet
                    s.shutdown(socket.SHUT_WR)
                    try:
                        while s.recv(65536):
                            pass
                    except OSError:
                        pass
            else:
                raw.sendall(data)
        # the connection is closed: the port's drain waits for its thread
    return drive


# (input.type, input.format, input.framing, the corpus's format, lines)
TCP_CASES = {
    "tcp_tpu": ("tcp", "rfc5424_tpu", "line", "rfc5424", 700),
    "tcp_ltsv": ("tcp", "ltsv", "line", "ltsv", 300),
    "tcp_co_tpu": ("tcp_co", "rfc5424_tpu", "nul", "rfc5424", 500),
    "tcp_co_rfc3164": ("tcp_co", "rfc3164", "nul", "rfc3164", 300),
    "tls_tpu": ("tls", "rfc5424_tpu", "syslen", "rfc5424", 500),
    "tls_gelf": ("tls", "gelf", "line", "gelf", 300),
    "tls_co_tpu": ("tls_co", "jsonl_tpu", "line", "jsonl", 400),
    "tls_co_jsonl": ("tls_co", "jsonl", "syslen", "jsonl", 300),
}


@pytest.mark.parametrize("case", list(TCP_CASES))
def test_stream_transport_matches_reference(tmp_path, monkeypatch, capsys,
                                            case, request):
    itype, fmt, framing, corpus, n = TCP_CASES[case]
    tls = itype.startswith("tls")
    # no timer flush: batches cut at the batch size and at the end, so
    # the reference compiles few shapes
    keys = (f'type = "{itype}"\nlisten = "127.0.0.1:0"\n'
            f'framing = "{framing}"\ntpu_flush_ms = 600000\n')
    if tls:
        pem = request.getfixturevalue("session_pem")
        keys += f'tls_cert = "{pem}"\ntls_key = "{pem}"\n'
    data = _data(corpus, n, 11 + n, framing)
    exp, exp_errs = scalar_expectation(data, framing, fmt=corpus)
    # the reference's batch handler prints a syslen stream's end message
    # before its batches' error lines (the port, as its scalar path, after
    # them): its lines are compared as a multiset
    same_err = _as_multiset if framing == "syslen" and fmt.endswith("_tpu") \
        else None
    got, errs = _pair(tmp_path, monkeypatch, capsys, fmt, keys,
                      _send_tcp(data, tls),
                      same=_masked if corpus == "gelf" else
                      (lambda a, b: a == b), same_err=same_err,
                      want=exp.count(b"\0"))
    # and the scalar path's bytes over the same stream
    assert _masked(got, exp) and errs == exp_errs and got.count(b"\0") > n / 2


def _datagrams(n: int, seed: int):
    """``n`` rfc5424 lines as datagrams, every 16th zlib-compressed, with
    a gzip one, an empty one, a corrupt zlib one, a corrupt gzip one and a
    compression bomb."""
    lines, _ = make_corpus(n, seed)
    dgrams = [zlib.compress(ln) if i % 16 == 5 else ln
              for i, ln in enumerate(lines)]
    dgrams.insert(7, gzip.compress(lines[7] + b" gzip padding"))
    dgrams.insert(20, b"")
    dgrams.insert(30, b"\x78\x9c" + b"garbage!")
    dgrams.insert(40, b"\x1f\x8b\x08" + b"\x00" * 30)
    dgrams.insert(50, zlib.compress(b"a" * (65_527 * 5 + 100)))
    return dgrams


def _send_udp(dgrams):
    def drive(side):
        port = _bound(side)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i, d in enumerate(dgrams):
                s.sendto(d, ("127.0.0.1", port))
                if i % 8 == 7:
                    time.sleep(0.002)  # paced: loopback drops a burst
    return drive


@pytest.mark.parametrize("case", ["tpu_per_datagram", "tpu_recvmmsg",
                                  "scalar"])
def test_udp_matches_reference(tmp_path, monkeypatch, capsys, case):
    """UDP: every datagram a record, bare error lines, zlib and gzip
    inflated, the corrupt ones and the bomb reported.  ``tpu_recvmmsg``
    is the batch handler's span ingest (its plain and compressed
    datagrams of one receive come in no fixed order: compared as
    multisets); the other two receive one datagram a call."""
    from flowgger_tpu.utils import recvmmsg as rrm
    from flowgger_tpu_torch.utils import recvmmsg as prm

    if case == "tpu_recvmmsg":
        if not prm.available():
            pytest.skip("recvmmsg unavailable on this platform")
        spans = []
        real = B.BatchHandler.ingest_spans

        def counted(self, chunk, starts, lens):
            spans.append(len(starts))
            return real(self, chunk, starts, lens)

        monkeypatch.setattr(B.BatchHandler, "ingest_spans", counted)
    else:
        monkeypatch.setattr(prm, "available", lambda: False)
        monkeypatch.setattr(rrm, "available", lambda: False)
    fmt = "rfc5424" if case == "scalar" else "rfc5424_tpu"
    dgrams = _datagrams(240, 12)
    same = _as_multiset if case == "tpu_recvmmsg" else (lambda a, b: a == b)
    got, errs = _pair(tmp_path, monkeypatch, capsys, fmt,
                      'type = "udp"\nlisten = "127.0.0.1:0"\n',
                      _send_udp(dgrams), same=same)
    assert errs.count("Corrupted compressed (gzip/zlib) record") == 2
    assert errs.count("Corrupted compressed (gzip) record") == 1
    assert not any(e.endswith("]") for e in errs)  # bare error lines
    assert got.count(b"\0") > 200
    if case == "tpu_recvmmsg":
        assert sum(spans) > 200


def _file_keys(root):
    """Each side's directory, with a file there before the input starts
    (tailed from its end): the [input] keys of its glob."""
    def keys(name):
        d = root / name
        d.mkdir()
        (d / "a.log").write_bytes(b"old line, never read\n")
        return f'type = "file"\nsrc = "{d}/*.log"\n'
    return keys


def _file_scenario(root, lines, fmt):
    """The file input's life: appends to the tailed file, a new file
    (read from its start), a truncation, and logrotate's rename-create;
    after each step, the side's output holds that step's records."""

    def drive(side):
        d = root / side.name
        a, b = d / "a.log", d / "b.log"
        time.sleep(0.4)  # the worker seeks to the end of a.log
        pos, want = [0], [0]

        def step(path, mode, n):
            data = b"".join(ln + b"\n" for ln in lines[pos[0]:pos[0] + n])
            pos[0] += n
            with open(path, mode) as fd:
                fd.write(data)
            want[0] += scalar_expectation(data, fmt=fmt)[0].count(b"\0")
            _poll(lambda: side.records() >= want[0], "the file's records")

        step(a, "ab", 40)
        step(b, "wb", 30)
        with open(a, "r+b") as fd:
            fd.truncate(0)
        time.sleep(0.4)  # the worker sees the file shrink
        step(a, "ab", 20)
        a.rename(d / "a.log.1")
        time.sleep(0.4)  # the old worker ends; logrotate creates anew
        step(a, "wb", 25)
    return drive


@pytest.mark.parametrize("case", ["tpu_inotify", "scalar_poll"])
def test_file_matches_reference(tmp_path, monkeypatch, capsys, case):
    from flowgger_tpu.inputs import file_input as rfi
    from flowgger_tpu_torch.inputs import file_input as pfi

    if case == "scalar_poll":
        monkeypatch.setattr(pfi._ino, "available", lambda: False)
        monkeypatch.setattr(rfi._ino, "available", lambda: False)
    elif not pfi._ino.available():
        pytest.skip("inotify unavailable on this platform")
    fmt, corpus = ("rfc5424_tpu", "rfc5424") if case == "tpu_inotify" \
        else ("dns", "dns")
    lines = CORPORA[corpus](115, 13)[0]
    got, errs = _pair(tmp_path, monkeypatch, capsys, fmt, _file_keys(tmp_path),
                      _file_scenario(tmp_path, lines, corpus))
    exp, exp_errs = scalar_expectation(
        b"".join(ln + b"\n" for ln in lines), fmt=corpus)
    assert got == exp and errs == exp_errs


def test_one_batch_handler_serves_every_connection(tmp_path, capsys):
    """Three tcp connections of a ``*_tpu`` pipeline share ONE batch
    handler (built once); a scalar pipeline hands each connection a
    ``ScalarHandler`` of its own."""
    built = []
    real = B.BatchHandler.__init__

    def counting(self, *a, **k):
        built.append(self)
        real(self, *a, **k)

    B.BatchHandler.__init__ = counting
    try:
        port = PortSide(tmp_path, "rfc5424_tpu",
                        'type = "tcp"\nlisten = "127.0.0.1:0"\n')
        line = "<13>1 2015-08-05T15:53:45Z shared app 1 2 - via conn %d"
        conns = [socket.create_connection(("127.0.0.1", _bound(port)),
                                          timeout=WAIT) for _ in range(3)]
        for i, c in enumerate(conns):
            c.sendall((line % i + "\n").encode())
        _poll(lambda: port.records() >= 3, "three records")
        for c in conns:
            c.close()
        data = port.finish()
    finally:
        B.BatchHandler.__init__ = real
    assert len(built) == 1 and port.pipe._handler is built[0]
    assert port.pipe.handler_factory() is built[0]
    for i in range(3):
        assert f"via conn {i}".encode() in data
    assert capsys.readouterr().out.count("Connection over TCP from") == 3
    scalar = pipeline.Pipeline(Config.from_string(
        '[input]\ntype = "tcp"\nlisten = "127.0.0.1:0"\nformat = "ltsv"\n'
        '[output]\ntype = "debug"\n'), device="cpu")
    h1, h2 = scalar.handler_factory(), scalar.handler_factory(peer="1.2.3.4")
    assert h1 is not h2 and type(h1).__name__ == "ScalarHandler"


def test_shared_handler_concurrent_connections_no_loss(tmp_path):
    """Twelve connections pushing into the shared handler at once, small
    batches and a 20 ms timer: every message comes out exactly once, and
    each connection's in its order (the reference's
    ``test_shared_handler_concurrent_connections_no_loss``, 8 × 200)."""
    port = PortSide(tmp_path, "rfc5424_tpu",
                    'type = "tcp"\nlisten = "127.0.0.1:0"\n'
                    'tpu_batch_size = 64\ntpu_flush_ms = 20\n')
    n_conns, per_conn = 12, 200
    bound = _bound(port)

    def sender(cid):
        with socket.create_connection(("127.0.0.1", bound),
                                      timeout=WAIT) as s:
            for i in range(per_conn):
                s.sendall(
                    (f"<13>1 2015-08-05T15:53:45.{i % 1000:03d}Z h app "
                     f"{cid} m - c{cid}-m{i}\n").encode())

    threads = [threading.Thread(target=sender, args=(c,))
               for c in range(n_conns)]
    # more connection threads than cores, switched often: a lost update
    # of the shared handler's session list or counts would drop records
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
        assert not any(th.is_alive() for th in threads)
        _poll(lambda: port.records() >= n_conns * per_conn, "every record")
    finally:
        sys.setswitchinterval(interval)
    data = port.finish()
    recs = [r for r in data.split(b"\0") if r]
    assert len(recs) == n_conns * per_conn
    for c in range(n_conns):
        mine = [r for r in recs if b'"process_id":"%d"' % c in r]
        assert [m.split(b'"short_message":"')[1].split(b'"')[0]
                for m in mine] == [b"c%d-m%d" % (c, i)
                                   for i in range(per_conn)]


def _failing(real, nth: int, calls: list):
    def wrapper(*a, **k):
        calls[0] += 1
        if calls[0] == nth:
            raise RuntimeError("CUDA kernel failed to launch (cudaError 719)")
        return real(*a, **k)
    return wrapper


def test_a_failure_on_a_connection_thread_ends_the_run(tmp_path,
                                                       monkeypatch, capsys):
    """K2's plain version raises on its third call, on the connection's
    thread (its size flush frames the batch): the run ends — ``run()``
    raises, as the CLI's exit does — and the two batches submitted before
    it are in the output, nothing after them."""
    lines, _ = make_corpus(1200, 31)
    rows = []
    submit = B.BatchHandler._submit

    def counting(self, packed, lane=None):
        rows.append(int(packed[5]))
        return submit(self, packed, lane)

    monkeypatch.setattr(B.BatchHandler, "_submit", counting)
    monkeypatch.setattr(F, "sep_spans", _failing(F.sep_spans, 3, [0]))
    port = PortSide(tmp_path, "rfc5424_tpu",
                    'type = "tcp"\nlisten = "127.0.0.1:0"\n'
                    'tpu_flush_ms = 600000\n')
    with socket.create_connection(("127.0.0.1", _bound(port)),
                                  timeout=WAIT) as s:
        try:
            for i in range(0, len(lines), 100):
                s.sendall(b"".join(ln + b"\n" for ln in lines[i:i + 100]))
                time.sleep(0.01)
        except OSError:
            pass  # the failed run closed the connection
    port.thread.join(WAIT)
    assert not port.thread.is_alive(), "the failure did not end the run"
    assert port.exc and "cudaError 719" in str(port.exc[0])
    first_two = rows[0] + rows[1]
    exp, errs = scalar_expectation(b"\n".join(lines[:first_two]) + b"\n")
    assert port.out.read_bytes() == exp and len(exp) > 10000
    assert capsys.readouterr().err.splitlines()[:len(errs)] == errs


def test_a_failure_the_flush_timer_meets_ends_the_run(tmp_path, monkeypatch,
                                                      capsys):
    """A connection sends three 100-line chunks, each flushed by the
    20 ms timer (and emitted before the next is sent); F1's probe fails
    on its third call, on the lane's fetcher thread, and the timer's
    fence meets it.  The connection then stays open and idle: the run
    still ends at once (the handler tells the pipeline), with the first
    two batches in the output."""
    lines, _ = make_tier_corpus(1000, 32)
    rows = []
    submit = B.BatchHandler._submit

    def counting(self, packed, lane=None):
        rows.append(int(packed[5]))
        return submit(self, packed, lane)

    monkeypatch.setattr(B.BatchHandler, "_submit", counting)
    calls = [0]
    monkeypatch.setattr(FR._FusedRows, "probe",
                        _failing(FR._FusedRows.probe, 3, calls))
    port = PortSide(tmp_path, "rfc5424_tpu",
                    'type = "tcp"\nlisten = "127.0.0.1:0"\n'
                    'tpu_flush_ms = 20\ntimeout = 60\n')
    with socket.create_connection(("127.0.0.1", _bound(port)),
                                  timeout=WAIT) as s:
        for i in range(0, 300, 100):
            chunk = b"".join(ln + b"\n" for ln in lines[i:i + 100])
            want = port.records() + scalar_expectation(chunk)[0].count(b"\0")
            s.sendall(chunk)
            if i < 200:
                # each chunk's batch emitted before the next is sent
                _poll(lambda: port.records() >= want, "a chunk's batch")
        # the connection stays open, idle: no push raises the failure
        port.thread.join(WAIT)
    assert not port.thread.is_alive(), "the failure did not end the run"
    assert port.exc and "cudaError 719" in str(port.exc[0])
    assert calls[0] == 3 and len(rows) == 3
    exp, errs = scalar_expectation(
        b"\n".join(lines[:rows[0] + rows[1]]) + b"\n")
    assert port.out.read_bytes() == exp and len(exp) > 10000
    assert capsys.readouterr().err.splitlines() == errs


def test_shutdown_closes_the_listener_quietly(tmp_path, capsys):
    """``Pipeline.shutdown`` stops each network input: the accept loop
    returns without its "accept loop exiting" line, and the listener is
    closed."""
    for itype in ("tcp", "tcp_co", "udp"):
        port = PortSide(tmp_path, "rfc5424", f'type = "{itype}"\n'
                        'listen = "127.0.0.1:0"\n', name=itype)
        bound = _bound(port)
        assert port.finish() == b""
        if itype != "udp":
            with pytest.raises(OSError):
                socket.create_connection(("127.0.0.1", bound), timeout=2)
    assert "accept loop exiting" not in capsys.readouterr().err


def test_handle_record_encodes_on_the_host(tmp_path):
    """The capnp splitter's records through a ``ScalarHandler`` and the
    batch handler's ``handle_record`` reach the queue encoded, the batch
    handler's behind a fence."""
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.record import Record
    from flowgger_tpu_torch.splitters import ScalarHandler

    rec = Record(ts=1438790025.5, hostname="h", facility=1, severity=5,
                 appname="a", procid="p", msgid="m", msg="hi")
    enc = GelfEncoder(Config.from_string(""))
    tx = queue.Queue()
    ScalarHandler(tx, None, enc).handle_record(rec)
    h = B.BatchHandler(tx, enc, Config.from_string(""), NulMerger(),
                       torch.device("cpu"), start_timer=False)
    h.handle_record(rec)
    assert tx.get_nowait() == tx.get_nowait() == enc.encode(rec)
