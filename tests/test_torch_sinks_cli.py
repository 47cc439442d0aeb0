"""The port's CLI (``--device cpu``) beside the JAX package's, both at
once, over this slice's surfaces: redis → ``rfc5424_tpu`` → Kafka
(capnp, snappy; ended by SIGTERM), tcp → the TLS sink (GELF; SIGTERM),
stdin → a rotating, buffered file (GELF), and a config without
``output.type`` (the Kafka default).  Each pair must agree on the exit
code (0), the output (the broker fake's records, the TLS server's bytes,
the files), stdout and stderr (as a multiset; ports and paths masked).
Every wait is bounded."""

import signal
import socket
import subprocess
import time

import pytest
import torch

import chip_smoke
from flowgger_tpu_torch.corpus import make_corpus, scalar_expectation
from test_torch_sinks import (T0, _TlsServer, _mask, _records,
                              _rotations_apart)
from torch_cli import PACKAGES, ROOT, argv_env, cli_pair

WAIT = 120.0
LINES = make_corpus(500, 41)[0]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _poll(cond, what: str, wait: float = WAIT):
    deadline = time.monotonic() + wait
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _input_keys(pkg: str) -> str:
    """The reference flushes by size and at the end only: its batch
    timer can land a batch behind a later one on a loaded host."""
    ref = pkg == "flowgger_tpu"
    return ('format = "rfc5424_tpu"\ntpu_encode_economics = false\n'
            f'tpu_batch_size = 256\ntpu_flush_ms = {600000 if ref else 30}\n'
            + ('tpu_fuse = "off"\n' if ref else ""))


def _spawn(pkg: str, cfg, stdin=subprocess.DEVNULL):
    argv, env = argv_env(pkg, cfg)
    return subprocess.Popen(argv, stdin=stdin, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, cwd=str(ROOT))


def _finish(procs: dict, sig=None, data: bytes = None) -> dict:
    """Signal (or feed stdin to) every CLI and collect {pkg: (exit code,
    stdout lines, stderr lines)}, ports and paths masked."""
    out = {}
    for pkg, (proc, tmp) in procs.items():
        if sig is not None:
            proc.send_signal(sig)
    for pkg, (proc, tmp) in procs.items():
        try:
            stdout, stderr = proc.communicate(data, timeout=WAIT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out[pkg] = (proc.returncode,
                    _mask(stdout.decode().splitlines()),
                    sorted(_mask(stderr.decode().replace(
                        str(tmp), "<dir>").splitlines())))
    return out


def test_redis_kafka_cli_pair(tmp_path):
    fakes = {pkg: (chip_smoke.RespFake(), chip_smoke.KafkaFake())
             for pkg in PACKAGES}
    try:
        procs = {}
        for pkg, (resp, kafka) in fakes.items():
            resp.lpush("logs", LINES)
            cfg = tmp_path / f"{pkg}.toml"
            cfg.write_text(
                f'[input]\ntype = "redis"\nredis_connect = "{resp.connect}"\n'
                + _input_keys(pkg) + '[output]\ntype = "kafka"\n'
                f'format = "capnp"\nkafka_brokers = ["{kafka.broker}"]\n'
                'kafka_topic = "logs"\nkafka_compression = "snappy"\n'
                'kafka_coalesce = 100\nkafka_acks = 1\n')
            procs[pkg] = (_spawn(pkg, cfg), tmp_path)
        for pkg, (resp, _) in fakes.items():
            _poll(lambda: resp.popped >= len(LINES) and not resp.llen("logs")
                  and not resp.llen("logs.tmp.0"), f"{pkg} to drain")
        said = _finish(procs, signal.SIGTERM)
        records = {pkg: _records(kafka) for pkg, (_, kafka) in fakes.items()}
    finally:
        for resp, kafka in fakes.values():
            resp.close()
            kafka.close()
    assert said["flowgger_tpu_torch"] == said["flowgger_tpu"]
    rc, stdout, stderr = said["flowgger_tpu_torch"]
    assert rc == 0 and stdout[1:] == [
        "Connected to Redis [127.0.0.1:<port>], pulling messages from key "
        "[logs]"]
    assert "Received signal 15, draining and exiting" in stderr
    assert records["flowgger_tpu_torch"] == records["flowgger_tpu"]
    assert len(records["flowgger_tpu"]) > len(LINES) * 0.9


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tcp_into_the_tls_sink_cli_pair(tmp_path, session_pem):
    data = b"\n".join(LINES) + b"\n"
    want = scalar_expectation(data)[0]
    servers = {pkg: _TlsServer(session_pem) for pkg in PACKAGES}
    try:
        procs, ports = {}, {}
        for pkg, server in servers.items():
            ports[pkg] = _free_port()
            cfg = tmp_path / f"{pkg}.toml"
            cfg.write_text(
                f'[input]\ntype = "tcp"\nlisten = "127.0.0.1:{ports[pkg]}"\n'
                + _input_keys(pkg) + '[output]\ntype = "tls"\n'
                f'format = "gelf"\nconnect = ["127.0.0.1:{server.port}"]\n'
                'timeout = 30\n')
            procs[pkg] = (_spawn(pkg, cfg), tmp_path)

        def listening(port):
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                return True
            except OSError:
                return False

        for pkg in PACKAGES:
            _poll(lambda: listening(ports[pkg]), f"{pkg}'s listener")
            with socket.create_connection(("127.0.0.1", ports[pkg]),
                                          timeout=WAIT) as s:
                s.sendall(data)
        for pkg, server in servers.items():
            _poll(lambda: server.live >= len(want), f"{pkg}'s records")
        said = _finish(procs, signal.SIGTERM)
        for server in servers.values():
            _poll(lambda: server.received, "the sink's close")
        got = {pkg: b"".join(s.received) for pkg, s in servers.items()}
    finally:
        for server in servers.values():
            server.close()
    assert said["flowgger_tpu_torch"] == said["flowgger_tpu"]
    rc, _, stderr = said["flowgger_tpu_torch"]
    assert rc == 0 and "Completed SSL handshake with 127.0.0.1:<port>" \
        in stderr
    assert got["flowgger_tpu_torch"] == got["flowgger_tpu"] == want


def test_stdin_into_a_rotating_buffered_file_cli_pair(tmp_path):
    data = b"\n".join(LINES)
    outs = cli_pair(tmp_path, data, 'format = "rfc5424_tpu"\n',
                    'format = "gelf"\nfile_rotation_size = 16384\n'
                    'file_rotation_maxfiles = 100\n'
                    'file_buffer_size = 2048\n', concurrent=True)
    files = {pkg: {p.suffix: p.read_bytes()
                   for p in tmp_path.glob(f"{pkg}.*")
                   if p.suffix not in (".toml",)} for pkg in PACKAGES}
    assert files["flowgger_tpu_torch"] == files["flowgger_tpu"]
    assert len(files["flowgger_tpu"]) >= 4
    said = {pkg: (o[1], _rotations_apart([ln.replace(pkg, "<pkg>")
                                          for ln in o[2]]))
            for pkg, o in outs.items()}
    assert said["flowgger_tpu_torch"] == said["flowgger_tpu"]
    rotations = said["flowgger_tpu"][1][0]
    assert len(rotations) == len(files["flowgger_tpu"]) - 1


def test_config_without_an_output_type_runs_into_kafka(tmp_path):
    data = b"\n".join(LINES)
    fakes = {pkg: chip_smoke.KafkaFake() for pkg in PACKAGES}
    try:
        procs = {}
        for pkg, kafka in fakes.items():
            cfg = tmp_path / f"{pkg}.toml"
            cfg.write_text(
                '[input]\ntype = "stdin"\n' + _input_keys(pkg)
                + f'[output]\nkafka_brokers = ["{kafka.broker}"]\n'
                'kafka_topic = "logs"\n')
            procs[pkg] = (_spawn(pkg, cfg, subprocess.PIPE), tmp_path)
        said = _finish(procs, data=data)
        records = {pkg: kafka.records()[0] for pkg, kafka in fakes.items()}
    finally:
        for kafka in fakes.values():
            kafka.close()
    assert said["flowgger_tpu_torch"] == said["flowgger_tpu"]
    assert said["flowgger_tpu"][0] == 0
    from flowgger_tpu_torch.corpus import mask_wall_stamps

    # the default output is GELF, one record a message (noop framing)
    want = scalar_expectation(data, merger=None)[0]
    for pkg in PACKAGES:
        assert mask_wall_stamps(b"".join(records[pkg]), T0) == \
            mask_wall_stamps(want, T0)
    assert records["flowgger_tpu_torch"] == records["flowgger_tpu"]
