"""SIGTERM / SIGINT drain of the port's CLI (``--device cpu``) beside the
JAX package's (``python -m flowgger_tpu``, JAX on the CPU), after the JAX
package's ``tests/test_signal_drain.py``: both processes get the same
config, the same input and the same signal mid-stream, and must agree on
the exit code (0), the output bytes, stdout and stderr ("Received signal
N, draining and exiting", then the batch's error lines).  The port's
output is also held against the scalar path's expectation.

The batch handler holds every line (a batch size and a flush timer no
stream here reaches), so only the drain can write them: stdin stays open
(the process is mid-stream, not at EOF), and a tcp connection stays open
while the signal comes.  The two CLIs run at once; every wait is
bounded."""

import fcntl
import signal
import socket
import subprocess
import termios
import time
from pathlib import Path

import pytest
import torch

from flowgger_tpu_torch.corpus import make_corpus, scalar_expectation
from torch_cli import PACKAGES, ROOT, argv_env

WAIT = 15.0
# bound on each CLI's drain: the reference compiles its decode (JAX) for
# the drained batch's shape, which a loaded box can stretch
DRAIN_WAIT = 90.0
N_LINES = 500


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, pkg: str, in_keys: str) -> tuple:
    """(config, output path) of ``pkg``'s CLI; the reference runs its host
    encode tier (``tpu_fuse = "off"``, as in ``torch_cli``)."""
    out = tmp_path / f"{pkg}.out"
    cfg = tmp_path / f"{pkg}.toml"
    cfg.write_text(
        '[input]\nformat = "rfc5424_tpu"\ntpu_encode_economics = false\n'
        'tpu_batch_size = 100000\ntpu_flush_ms = 600000\n'
        + ('tpu_fuse = "off"\n' if pkg == "flowgger_tpu" else "") + in_keys
        + f'[output]\ntype = "file"\nformat = "gelf"\nfile_path = "{out}"\n')
    return cfg, out


def _spawn(pkg: str, cfg: Path, stdin=subprocess.DEVNULL):
    argv, env = argv_env(pkg, cfg)
    return subprocess.Popen(argv, stdin=stdin, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, cwd=str(ROOT))


def _unread(fd: int) -> int:
    """Bytes written to a pipe and not read yet (FIONREAD)."""
    return int.from_bytes(fcntl.ioctl(fd, termios.FIONREAD, b"\0" * 4),
                          "little", signed=True)


def _finish(procs: dict, signum) -> dict:
    """Signal every CLI, then ``{pkg: (exit code, stdout, stderr)}``."""
    for proc in procs.values():
        proc.send_signal(signum)
    done = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=DRAIN_WAIT)
        done[pkg] = (proc.returncode, out.decode(), err.decode())
    return done


def _kill(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def _agree(done: dict, outs: dict, signum, stdout=lambda s: s) -> str:
    """Both CLIs exited 0 with the same output, stdout (through
    ``stdout``) and stderr, the signal's line first; returns the port's
    stderr."""
    port, ref = (done[pkg] for pkg in PACKAGES)
    for pkg, (rc, _, err) in done.items():
        assert rc == 0, (pkg, err[-2000:])
    port_out, ref_out = (outs[pkg].read_bytes() for pkg in PACKAGES)
    assert port_out == ref_out
    assert stdout(port[1]) == stdout(ref[1])
    assert port[2].splitlines() == ref[2].splitlines(), \
        (port[2][-1000:], ref[2][-1000:])
    assert port[2].startswith(
        f"Received signal {int(signum)}, draining and exiting\n")
    return port[2]


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGINT])
def test_signal_mid_stream_drains_every_line(tmp_path, signum):
    lines, _ = make_corpus(N_LINES, 61)
    data = b"".join(ln + b"\n" for ln in lines)
    cfgs = {pkg: _config(tmp_path, pkg, 'type = "stdin"\n')
            for pkg in PACKAGES}
    procs = {pkg: _spawn(pkg, cfgs[pkg][0], stdin=subprocess.PIPE)
             for pkg in PACKAGES}
    try:
        for proc in procs.values():
            proc.stdin.write(data)
            proc.stdin.flush()
        # stdin stays open; wait until each process has read every byte
        deadline = time.monotonic() + 60
        for pkg, proc in procs.items():
            while _unread(proc.stdin.fileno()) > 0:
                assert time.monotonic() < deadline, f"{pkg} never read stdin"
                assert proc.poll() is None, f"{pkg} died"
                time.sleep(0.05)
        time.sleep(0.5)
        for _, out in cfgs.values():
            assert not out.exists() or out.stat().st_size == 0
        done = _finish(procs, signum)
    finally:
        for proc in procs.values():
            proc.stdin.close()
        _kill(procs)
    stderr = _agree(done, {pkg: cfgs[pkg][1] for pkg in PACKAGES}, signum)
    exp, errs = scalar_expectation(data)
    got = cfgs[PACKAGES[0]][1].read_bytes()
    assert got == exp and exp.count(b"\0") > N_LINES / 2
    assert stderr.splitlines()[1:] == errs


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _connect(port: int, proc) -> socket.socket:
    deadline = time.monotonic() + 60
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port),
                                            timeout=WAIT)
        except OSError:
            assert time.monotonic() < deadline, "the CLI never listened"
            assert proc.poll() is None, "the CLI died"
            time.sleep(0.1)


def test_sigterm_drains_an_open_tcp_connection(tmp_path):
    """A tcp connection still open when SIGTERM comes: each drain waits
    for its thread (2 s), flushes the shared handler — the connection's
    session included — and exits 0 with every line, the two CLIs alike."""
    lines, _ = make_corpus(N_LINES, 62)
    data = b"".join(ln + b"\n" for ln in lines)
    cfgs, procs, conns = {}, {}, []
    try:
        for pkg in PACKAGES:
            port = _free_port()
            cfgs[pkg] = _config(tmp_path, pkg,
                                f'type = "tcp"\nlisten = "127.0.0.1:{port}"\n')
            procs[pkg] = _spawn(pkg, cfgs[pkg][0])
            cfgs[pkg] += (port,)
        for pkg, proc in procs.items():
            conns.append(_connect(cfgs[pkg][2], proc))
            conns[-1].sendall(data)
        time.sleep(1.0)
        done = _finish(procs, signal.SIGTERM)
    finally:
        for conn in conns:
            conn.close()
        _kill(procs)

    def peerless(stdout: str) -> list:
        # the connection line's client port differs
        return [ln.rsplit(":", 1)[0] for ln in stdout.splitlines()]

    stderr = _agree(done, {pkg: cfgs[pkg][1] for pkg in PACKAGES},
                    signal.SIGTERM, stdout=peerless)
    assert peerless(done[PACKAGES[0]][1])[-1] == \
        "Connection over TCP from [127.0.0.1"
    exp, errs = scalar_expectation(data)
    assert cfgs[PACKAGES[0]][1].read_bytes() == exp
    assert stderr.splitlines()[1:] == errs
