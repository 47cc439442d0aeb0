"""The port's decode circuit breaker (``tpu/breaker.py``) against the JAX
package's, on the CPU.

- The same call sequence (``allow``, ``observe_batch``,
  ``record_success`` and clock steps, made from a numpy seed) on both
  breakers under an injected clock: the same answers, states,
  ``transitions`` and stderr lines.
- ``from_config``: the reference's defaults, ``tpu_breaker = false`` and
  its ConfigError words.
- A stdin stream whose batches send nearly every row to the scalar
  oracle (rows longer than ``tpu_max_line_len``), ``rfc5424_tpu`` into
  GELF with ``tpu_breaker_window = 2``, through each package in process:
  the breaker trips at the same batch, and the output bytes (0 differing
  bytes) and stderr are the same.  With a long cooldown every later
  batch takes the oracle; with ``tpu_breaker_cooldown_ms = 0`` each
  batch probes the card, the oracle-bound probes re-open the breaker and
  the first clean probe closes it.  ``tpu_breaker = false`` never trips.

Both packages run serially (``tpu_inflight = 0``) with one batch a
64 KiB stdin read (``tpu_batch_size = 1``): the trip is judged when a
batch is emitted, so with batches in flight the batch that first meets
the open breaker would hang on the fetcher thread's timing.
"""

import io
import sys

import numpy as np
import pytest
import torch

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import make_corpus
from flowgger_tpu_torch.tpu import breaker as BR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _ops(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.3:
            ops.append(("allow", None))
        elif r < 0.7:
            rows = int(rng.integers(1, 200))
            # mostly oracle-bound batches, some clean ones
            fb = rows if rng.random() < 0.7 else int(rng.integers(0, rows))
            ops.append(("observe", (rows, fb)))
        elif r < 0.85:
            ops.append(("success", None))
        else:
            ops.append(("tick", float(rng.choice([0.01, 0.2, 0.6]))))
    return ops


def _drive(breaker, clock, ops):
    seen = []
    for op, arg in ops:
        if op == "allow":
            seen.append(breaker.allow())
        elif op == "observe":
            breaker.observe_batch(*arg)
        elif op == "success":
            breaker.record_success()
        else:
            clock.t += arg
        seen.append(breaker.state)
    return seen


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_state_machine_matches_reference(capsys, seed):
    from flowgger_tpu.tpu import breaker as RBR

    ops = _ops(seed)
    capsys.readouterr()
    pc, rc = _Clock(), _Clock()
    port = BR.DecodeBreaker(cooldown_ms=500, window=3, clock=pc)
    got = _drive(port, pc, ops)
    port_err = capsys.readouterr().err.splitlines()
    ref = RBR.DecodeBreaker(cooldown_ms=500, window=3, clock=rc)
    want = _drive(ref, rc, ops)
    ref_err = capsys.readouterr().err.splitlines()
    assert got == want
    assert port.transitions == ref.transitions
    assert port_err == ref_err
    states = {t[2] for t in port.transitions}
    assert states == {BR.OPEN, BR.HALF_OPEN, BR.CLOSED}
    assert port.trips == sum(1 for ln in port_err if "tripping" in ln) > 0


@pytest.mark.parametrize("text,words", [
    ("", None),
    ("[input]\ntpu_breaker = false\n", "off"),
    ("[input]\ntpu_breaker_fallback_ratio = 0.0\n",
     "input.tpu_breaker_fallback_ratio must be a number in (0, 1]"),
    ("[input]\ntpu_breaker_fallback_ratio = 1.5\n",
     "input.tpu_breaker_fallback_ratio must be a number in (0, 1]"),
    ('[input]\ntpu_breaker_failures = "3"\n',
     "input.tpu_breaker_failures must be an integer"),
    ('[input]\ntpu_breaker_window = "x"\n',
     "input.tpu_breaker_window must be an integer (batches)"),
    ('[input]\ntpu_breaker_cooldown_ms = 1.5\n',
     "input.tpu_breaker_cooldown_ms must be an integer (ms)"),
    ('[input]\ntpu_breaker = "yes"\n', "input.tpu_breaker must be a boolean"),
    ("[input]\ntpu_breaker_window = 2\ntpu_breaker_cooldown_ms = 7\n"
     "tpu_breaker_fallback_ratio = 1\n", None),
])
def test_from_config_matches_reference(text, words):
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.config import ConfigError as RConfigError
    from flowgger_tpu.tpu.breaker import DecodeBreaker as RBreaker

    if words is None or words == "off":
        port = BR.DecodeBreaker.from_config(Config.from_string(text))
        ref = RBreaker.from_config(RConfig.from_string(text))
        if words == "off":
            assert port is None and ref is None
            return
        assert (port.failures, port.cooldown_ms, port.window,
                port.fallback_ratio) == (ref.failures, ref.cooldown_ms,
                                         ref.window, ref.fallback_ratio)
        return
    with pytest.raises(ConfigError) as exc:
        BR.DecodeBreaker.from_config(Config.from_string(text))
    with pytest.raises(RConfigError) as rexc:
        RBreaker.from_config(RConfig.from_string(text))
    assert str(exc.value) == str(rexc.value) == words


def _long_line(i: int, rng) -> bytes:
    """A valid RFC5424 line longer than 256 bytes: an oracle row."""
    body = "".join(rng.choice(list("abcdefgh ")) for _ in range(300))
    return (f"<13>1 2015-08-05T15:53:{i % 60:02d}Z host app {i} m - "
            f"{body}").encode()


def _stream(seed: int, n_long: int, n_clean: int) -> bytes:
    """``n_long`` rows, 39 of every 40 longer than 256 bytes, then
    ``n_clean`` short rows from the mixed corpus."""
    rng = np.random.default_rng(seed)
    short, _ = make_corpus(n_long // 40 + n_clean + 1, seed)
    rows, k = [], 0
    for i in range(n_long):
        if i % 40 == 39:
            rows.append(short[k])
            k += 1
        else:
            rows.append(_long_line(i, rng))
    rows += short[k:k + n_clean]
    return b"\n".join(rows) + b"\n"


def _run_pair(tmp_path, monkeypatch, capsys, data: bytes, keys: str):
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.pipeline import Pipeline as RPipeline

    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    got = {}
    for side in ("port", "ref"):
        out = tmp_path / f"{side}.out"
        text = ('[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\n'
                'tpu_encode_economics = false\ntpu_fuse = "off"\n'
                'tpu_inflight = 0\ntpu_batch_size = 1\n'
                'tpu_flush_ms = 600000\ntpu_max_line_len = 256\n' + keys
                + f'[output]\ntype = "file"\nformat = "gelf"\n'
                f'file_path = "{out}"\n')
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(data)))
        capsys.readouterr()
        if side == "ref":
            RPipeline(RConfig.from_string(text)).run()
            breaker = None
        else:
            pipe = pipeline.Pipeline(Config.from_string(text), device="cpu")
            pipe.run()
            breaker = pipe._handler._breaker
        got[side] = (out.read_bytes(), capsys.readouterr().err.splitlines(),
                     breaker)
    port, ref = got["port"], got["ref"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    # the breaker's own lines (the corpus's bad rows print theirs)
    return port[0], [ln for ln in port[1] if "breaker" in ln], port[2]


TRIP = ("device-decode breaker tripping: fallback ratio > 0.95 over the "
        "last 2 batches")


def test_the_breaker_trips_at_the_same_batch(tmp_path, monkeypatch, capsys):
    data = _stream(5, n_long=1200, n_clean=300)
    assert len(data) > 5 * (1 << 16)
    out, err, breaker = _run_pair(
        tmp_path, monkeypatch, capsys, data,
        "tpu_breaker_window = 2\ntpu_breaker_cooldown_ms = 600000\n")
    assert err == [TRIP, "device-decode breaker: closed -> open"]
    assert breaker.trips == 1 and breaker.state == BR.OPEN
    assert out.count(b"\0") > 1200


def test_probes_reopen_then_close(tmp_path, monkeypatch, capsys):
    data = _stream(6, n_long=1200, n_clean=900)
    out, err, breaker = _run_pair(
        tmp_path, monkeypatch, capsys, data,
        "tpu_breaker_window = 2\ntpu_breaker_cooldown_ms = 0\n")
    assert err[:2] == [TRIP, "device-decode breaker: closed -> open"]
    probes = err.count("device-decode breaker: open -> half_open")
    assert probes >= 2 and breaker.probes == probes
    assert err.count("device-decode breaker: half_open -> open") \
        == probes - 1
    assert err[-1] == "device-decode breaker: half_open -> closed"
    assert breaker.trips == 1 and breaker.state == BR.CLOSED


def test_breaker_off_never_trips(tmp_path, monkeypatch, capsys):
    data = _stream(7, n_long=800, n_clean=0)
    out, err, breaker = _run_pair(tmp_path, monkeypatch, capsys, data,
                                  "tpu_breaker = false\n")
    assert err == [] and breaker is None
    assert out.count(b"\0") > 780
