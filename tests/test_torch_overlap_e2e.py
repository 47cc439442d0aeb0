"""The overlap executor end to end, in process on the CPU: the port's
pipeline at ``tpu_inflight`` 0 and 2 and at ``tpu_lanes = 3`` (depth 1
and 2), with every pop held for a seeded random time so that the lanes
finish out of order, gives the same output bytes and the same stderr
lines, in order, as one run of the JAX package's CLI.  The same holds for
``auto_tpu`` in the default window and for syslen framing at three lanes
(stderr compared as the CLI tests of those paths compare it).  A kernel that fails on the third batch — on the
ingest thread (device framing) or on a lane's fetcher thread (the fused
route), also where the flush timer's fence meets it — ends the run with
its exception out of ``pipeline.start``, after the batches before it have
reached the sink in order.

The port's economics is off (``tpu_encode_economics = false``) but in
one test: on the CPU its tiers run their plain versions, which measure
slow and would buy host batches and print switch notices;
tests/test_torch_overlap.py holds the economics itself, and the one test
here scripts its answers to hold the handler's wiring of it."""

import io
import random
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.corpus import (make_auto_corpus, make_corpus,
                                       make_tier_corpus, mask_wall_stamps,
                                       scalar_expectation, syslen_stream)
from flowgger_tpu_torch.mergers import LineMerger
from flowgger_tpu_torch.tpu import batch as B
from flowgger_tpu_torch.tpu import framing as F
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import overlap as O

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_cli  # noqa: E402

T0 = time.time()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, here and in the reference's CLI child (see
    torch_cli.run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_EXECUTORS = {"inflight0": "tpu_inflight = 0\n", "inflight2": "",
              "lanes3_depth1": "tpu_lanes = 3\ntpu_inflight = 1\n",
              "lanes3_depth2": "tpu_lanes = 3\n"}


def _config(path: Path, out: Path, fmt: str, framing: str,
            executor: str = "", port: bool = True, flush_ms: int = 600000,
            economics: bool = False) -> Path:
    path.write_text(
        '[input]\ntype = "stdin"\n'
        f'format = "{fmt}"\nframing = "{framing}"\n'
        f'tpu_flush_ms = {flush_ms}\ntpu_batch_size = 256\n'
        + ((("" if economics else "tpu_encode_economics = false\n")
            + executor) if port else 'tpu_fuse = "off"\n')
        + f'[output]\ntype = "file"\nformat = "gelf"\nframing = "line"\n'
        f'file_path = "{out}"\n')
    return path


def _reference(tmp_path, fmt, framing, data):
    """(output bytes, stdout, stderr lines) of the JAX package's CLI."""
    out = tmp_path / "ref.out"
    cfg = _config(tmp_path / "ref.toml", out, fmt, framing, port=False)
    proc = torch_cli.run("flowgger_tpu", cfg, data)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    return out.read_bytes(), proc.stdout, proc.stderr.decode().splitlines()


def _jittered_pops(monkeypatch, seed):
    """Every pop of the port's handler first sleeps a seeded random time
    (up to 30 ms), so lanes finish out of submit order; returns the
    (lane, thread name) of each pop."""
    rng = random.Random(seed)
    lock = threading.Lock()
    seen = []
    pop = B.BatchHandler._pop_emit

    def jittered(self, payload, lane=0):
        with lock:
            delay = rng.choice((0.0, 0.005, 0.015, 0.03))
            seen.append((lane, threading.current_thread().name))
        time.sleep(delay)
        return pop(self, payload, lane)

    monkeypatch.setattr(B.BatchHandler, "_pop_emit", jittered)
    return seen


def _port(tmp_path, monkeypatch, capsys, fmt, framing, data, executor,
          name):
    """(output bytes, stdout, stderr lines, pops) of the port's pipeline
    in process."""
    out = tmp_path / f"{name}.out"
    cfg = _config(tmp_path / f"{name}.toml", out, fmt, framing, executor)
    seen = _jittered_pops(monkeypatch, seed=len(name))
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    pipeline.start(str(cfg), device="cpu")
    got = capsys.readouterr()
    return (out.read_bytes(), got.out.encode(), got.err.splitlines(),
            seen)


@pytest.fixture(scope="module")
def rfc5424_stream(tmp_path_factory):
    """The rfc5424 line mix with its edge rows (malformed, escapes,
    7-24 pairs, long, CR, non-ASCII: the tiers decline batches of it)
    and a partial frame at EOF, with the reference CLI's run of it."""
    lines, _ = make_corpus(1800, seed=181)
    data = b"\n".join(lines) + b"\n<13>1 2015-08-05T15:53:45Z h a p m - eof"
    return data, _reference(tmp_path_factory.mktemp("ref5424"), "rfc5424_tpu",
                            "line", data)


@pytest.mark.parametrize("executor", list(_EXECUTORS))
def test_rfc5424_every_executor_matches_the_reference(
        tmp_path, monkeypatch, capsys, rfc5424_stream, executor):
    data, ref = rfc5424_stream
    got = _port(tmp_path, monkeypatch, capsys, "rfc5424_tpu", "line", data,
                _EXECUTORS[executor], executor)
    assert got[0] == ref[0] and len(ref[0]) > 100000
    assert got[2] == ref[2] and ref[2]
    exp, errs = scalar_expectation(data, merger=LineMerger())
    assert got[0] == exp and got[2] == errs
    lanes = {lane for lane, _ in got[3]}
    threads = {t for _, t in got[3]}
    assert len(got[3]) >= 5
    if executor.startswith("lanes3"):
        assert lanes == {0, 1, 2} and len(threads) == 3
    elif executor == "inflight0":
        # strictly serial: every pop on the ingest thread (the pipeline's
        # accept thread: the caller's thread waits for it)
        assert lanes == {0} and threads == {"input-accept"}
    else:
        assert lanes == {0} and len(threads) == 1 \
            and threading.current_thread().name not in threads


def test_auto_in_the_window_matches_the_reference(tmp_path, monkeypatch,
                                                  capsys):
    """auto at the default window: its legs' decoders print their own
    notices (stdout) and rfc3164 lines (stderr) on the fetcher thread,
    as they decode, so one fetcher keeps them in order (with several
    lanes they interleave, in the reference too)."""
    lines = make_auto_corpus(700, seed=182)[0] \
        + make_auto_corpus(500, seed=183, tier=True)[0]
    data = b"\n".join(lines) + b"\ntime:1\thost:tail\tpartial:1"
    ref = _reference(tmp_path, "auto_tpu", "line", data)
    got = _port(tmp_path, monkeypatch, capsys, "auto_tpu", "line", data,
                _EXECUTORS["inflight2"], "auto")
    assert mask_wall_stamps(got[0], T0) == mask_wall_stamps(ref[0], T0)
    # the decoder's notices on stdout, after the CLI's banner line
    banner, notices = ref[1].split(b"\n", 1)
    assert banner.startswith(b"Flowgger") and got[1] == notices
    # the reference prints the rfc3164 decoder's own lines as a batch's
    # legs encode, on its fetcher thread: each kind in order
    own = "Unable to parse the rfc3164 input: "
    for keep in (True, False):
        assert [x for x in got[2] if x.startswith(own) == keep] == \
            [x for x in ref[2] if x.startswith(own) == keep]
    assert len(got[3]) >= 3 and {lane for lane, _ in got[3]} == {0}


def test_syslen_at_three_lanes_matches_the_reference(tmp_path, monkeypatch,
                                                     capsys):
    lines, _ = make_corpus(1500, seed=184)
    data = syslen_stream(lines)
    ref = _reference(tmp_path, "rfc5424_tpu", "syslen", data)
    got = _port(tmp_path, monkeypatch, capsys, "rfc5424_tpu", "syslen",
                data, _EXECUTORS["lanes3_depth2"], "syslen")
    assert got[0] == ref[0] and len(ref[0]) > 100000
    # the reference prints its end-of-stream message before its
    # per-record errors: compared as a multiset
    assert sorted(got[2]) == sorted(ref[2]) and ref[2]
    assert {lane for lane, _ in got[3]} == {0, 1, 2}


@pytest.mark.parametrize("side", ["ingest", "fetcher"])
def test_a_kernel_failure_ends_the_run_after_the_batches_before_it(
        tmp_path, monkeypatch, capsys, side):
    """The third batch's kernel raises: on the ingest thread (K2, device
    framing) or on the lane's fetcher thread (F1's probe; depth 1, so no
    batch behind it is in flight).  The first two batches reach the sink
    in order, nothing of the third does, and the exception comes out of
    ``pipeline.start``: the port carries on neither on the CPU nor
    through a plain version."""
    lines, _ = make_corpus(2400, seed=185)
    data = b"\n".join(lines) + b"\n"
    rows = []
    submit = B.BatchHandler._submit

    def counting(self, packed, lane=None):
        rows.append(int(packed[5]))
        return submit(self, packed, lane)

    monkeypatch.setattr(B.BatchHandler, "_submit", counting)
    calls = [0]

    def failing(real):
        def wrapper(*a, **k):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("CUDA kernel failed to launch "
                                   "(cudaError 719)")
            return real(*a, **k)
        return wrapper

    if side == "ingest":
        monkeypatch.setattr(F, "sep_spans", failing(F.sep_spans))
        executor = ""
    else:
        monkeypatch.setattr(FR._FusedRows, "probe",
                            failing(FR._FusedRows.probe))
        executor = "tpu_inflight = 1\n"
    out = tmp_path / "out"
    cfg = _config(tmp_path / "cfg.toml", out, "rfc5424_tpu", "line",
                  executor)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    with pytest.raises(RuntimeError, match="cudaError 719"):
        pipeline.start(str(cfg), device="cpu")
    assert len(rows) >= 2
    first_two = rows[0] + rows[1]
    exp, errs = scalar_expectation(b"\n".join(lines[:first_two]) + b"\n",
                                   merger=LineMerger())
    assert out.read_bytes() == exp and len(exp) > 10000
    assert capsys.readouterr().err.splitlines() == errs


class _Trickle:
    """A stdin whose chunks arrive ``gap`` seconds apart (a slow live
    stream: the flush timer, not the batch size, flushes each one)."""

    def __init__(self, chunks, gap):
        self.buffer = self
        self._chunks = list(chunks)
        self._gap = gap
        self._started = False

    def read1(self, n):
        if not self._chunks:
            return b""
        if self._started:
            time.sleep(self._gap)
        self._started = True
        chunk = self._chunks.pop(0)
        if len(chunk) > n:
            self._chunks.insert(0, chunk[n:])
            chunk = chunk[:n]
        return chunk


def test_a_fetcher_failure_met_by_the_timer_flush_ends_the_run(
        tmp_path, monkeypatch, capsys):
    """A slow stream of 100-line chunks 150 ms apart, flushed by the
    20 ms timer, whose fence meets the third batch's failure (F1's probe,
    on the lane's fetcher thread, in the default window).  The timer
    keeps it for the ingest thread, which raises it at its next push: it
    comes out of ``pipeline.start``, the first two batches have reached
    the sink in order and nothing after them has."""
    lines, _ = make_tier_corpus(1200, seed=187)
    chunks = [b"".join(ln + b"\n" for ln in lines[i:i + 100])
              for i in range(0, len(lines), 100)]
    rows = []
    submit = B.BatchHandler._submit

    def counting(self, packed, lane=None):
        rows.append(int(packed[5]))
        return submit(self, packed, lane)

    monkeypatch.setattr(B.BatchHandler, "_submit", counting)
    probe = FR._FusedRows.probe
    calls = [0]

    def failing(*a, **k):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("CUDA kernel failed to launch "
                               "(cudaError 719)")
        return probe(*a, **k)

    monkeypatch.setattr(FR._FusedRows, "probe", failing)
    out = tmp_path / "out"
    cfg = _config(tmp_path / "cfg.toml", out, "rfc5424_tpu", "line",
                  flush_ms=20)
    monkeypatch.setattr(sys, "stdin", _Trickle(chunks, 0.15))
    with pytest.raises(RuntimeError, match="cudaError 719"):
        pipeline.start(str(cfg), device="cpu")
    assert 3 <= len(rows) < len(chunks) and calls[0] == 3
    first_two = rows[0] + rows[1]
    exp, errs = scalar_expectation(b"\n".join(lines[:first_two]) + b"\n",
                                   merger=LineMerger())
    assert out.read_bytes() == exp and len(exp) > 10000
    assert capsys.readouterr().err.splitlines() == errs


def test_route_economics_steers_the_handlers_batches(tmp_path, monkeypatch,
                                                     capsys):
    """Economics on (the default), its answers scripted: a batch whose
    ``allow_fused()`` is False takes the split path (``econ_split`` on
    the fused route's counts), and of the split batches one whose
    ``allow_device()`` is False takes the host block encoder
    (``econ_host`` on the split tier's).  Each batch's emit feeds
    ``observe`` its path and its rows, in submit order.  The bytes and
    stderr are the reference CLI's."""
    lines, _ = make_tier_corpus(2000, seed=186)
    data = b"\n".join(lines) + b"\n"
    ref = _reference(tmp_path, "rfc5424_tpu", "line", data)
    fused_says = [True, False, False, True, False]
    device_says = [False, True, False]
    asked = {"fused": [], "device": []}
    observed = []

    def scripted(arm, script):
        def allow(self):
            i = len(asked[arm])
            asked[arm].append(script[i] if i < len(script) else True)
            return asked[arm][-1]
        return allow

    def observe(self, path, rows, seconds):
        observed.append((path, rows, seconds))

    monkeypatch.setattr(O.RouteEconomics, "allow_fused",
                        scripted("fused", fused_says))
    monkeypatch.setattr(O.RouteEconomics, "allow_device",
                        scripted("device", device_says))
    monkeypatch.setattr(O.RouteEconomics, "observe", observe)
    rows = []
    submit = B.BatchHandler._submit

    def counting(self, packed, lane=None):
        rows.append(int(packed[5]))
        return submit(self, packed, lane)

    monkeypatch.setattr(B.BatchHandler, "_submit", counting)
    out = tmp_path / "port.out"
    cfg = _config(tmp_path / "port.toml", out, "rfc5424_tpu", "line",
                  economics=True)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    capsys.readouterr()
    pipe = pipeline.start(str(cfg), device="cpu")
    got = capsys.readouterr()
    assert out.read_bytes() == ref[0] and len(ref[0]) > 100000
    assert got.err.splitlines() == ref[2]
    # one allow_fused() a batch, one allow_device() a split batch
    assert len(asked["fused"]) == len(rows) >= 5
    assert len(asked["device"]) == asked["fused"].count(False)
    device = iter(asked["device"])
    want = [("fused" if f else "device" if next(device) else "host", n)
            for f, n in zip(asked["fused"], rows)]
    assert [(p, n) for p, n, _ in observed] == want
    assert {p for p, _ in want} == {"fused", "device", "host"}
    assert all(s > 0 for _, _, s in observed)
    state = pipe._handler.route_state
    fused = [v for k, v in state.items() if k.startswith("fused:")]
    assert len(fused) == 1 and fused[0]["econ_split"] == 3
    assert state["rfc5424"]["econ_host"] == 2
    assert not fused[0].get("declined") and not state["rfc5424"].get(
        "declined")
