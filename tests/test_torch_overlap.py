"""The port's overlap executor (flowgger_tpu_torch/tpu/overlap.py) against
the JAX package's (flowgger_tpu/tpu/overlap.py): each scripted scenario of
the reference's own window and lane tests runs through both classes and
must come out the same — FIFO order under random pop latency,
backpressure, a fence that waits for an in-flight pop, an exception
ferried to ``fence`` / ``submit``, depth 0 inline, a ``None`` emit, a
ticket released after a failing pop and after a refused submit, fence-all
across three lanes.  Route economics: one scripted ``observe()`` sequence
through both trackers, ``allow_device()`` / ``allow_fused()`` compared
call by call and the switch notices' text line by line.  The config
errors of ``tpu_inflight``, ``tpu_lanes`` and ``tpu_lanes`` with
``tpu_mesh`` carry the reference's messages, also out of the port's
BatchHandler.  The lane device context (stream, pinned staging) needs a
card; on the CPU a lane has neither."""

import queue
import random
import threading
import time

import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.config import ConfigError as RConfigError
from flowgger_tpu.tpu import overlap as R
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger
from flowgger_tpu_torch.tpu import overlap as P
from flowgger_tpu_torch.tpu.batch import BatchHandler

IMPLS = {"port": P, "reference": R}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: this file's handlers run tiny batches beside
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(scenario):
    """The scenario's result through the port's classes, equal to the
    reference's."""
    got = {name: scenario(m) for name, m in IMPLS.items()}
    assert got["port"] == got["reference"], got
    return got["port"]


# ---------------------------------------------------------------------------
# InflightWindow and LaneSet
# ---------------------------------------------------------------------------

def test_window_fifo_under_random_pop_latency():
    def run(m):
        rng = random.Random(3)
        sleeps = [rng.choice((0.0, 0.0, 0.002, 0.004)) for _ in range(24)]
        done = []

        def pop(item):
            time.sleep(sleeps[item])
            done.append(item)

        w = m.InflightWindow(2, pop)
        for i in range(24):
            w.submit(i)
        w.fence()
        w.close()
        return done

    assert _both(run) == list(range(24))


def test_laneset_fifo_under_random_pop_latency():
    def run(m):
        rng = random.Random(4)
        sleeps = [rng.choice((0.0, 0.001, 0.003, 0.006)) for _ in range(30)]
        done = []

        def pop(item, lane):
            time.sleep(sleeps[item])
            return lambda: done.append((item, lane))

        ls = m.LaneSet(2, pop, lanes=3)
        for i in range(30):
            ls.submit(ls.next_lane(), i)
        ls.fence()
        ls.close()
        return done

    assert _both(run) == [(i, i % 3) for i in range(30)]


def test_window_backpressure():
    def run(m):
        gate = threading.Event()
        done = []

        def pop(item):
            gate.wait(5.0)
            done.append(item)

        w = m.InflightWindow(2, pop)
        w.submit(1)
        w.submit(2)  # full: 1 popping + 1 queued
        t = threading.Thread(target=lambda: w.submit(3))
        t.start()
        time.sleep(0.05)
        blocked = t.is_alive()
        gate.set()
        t.join(timeout=5)
        w.fence()
        w.close()
        return blocked, t.is_alive(), done

    assert _both(run) == (True, False, [1, 2, 3])


def test_fence_waits_for_an_inflight_pop():
    def run(m):
        slow = threading.Event()
        done = []

        def pop(item):
            slow.wait(2.0)
            done.append(item)

        w = m.InflightWindow(4, pop)
        w.submit("a")
        threading.Timer(0.05, slow.set).start()
        w.fence()
        landed = list(done)
        w.close()
        return landed

    assert _both(run) == ["a"]


@pytest.mark.parametrize("where", ["fence", "submit"])
def test_exception_ferried_to_the_ingest_thread(where):
    """A pop's exception comes out of the next fence (or submit) on the
    ingest thread, once; the window stays usable."""
    def run(m):
        done = []

        def pop(item):
            if item == "boom":
                raise RuntimeError("kernel failed")
            done.append(item)

        w = m.InflightWindow(2, pop)
        w.submit("ok")
        w.submit("boom")
        caught = None
        if where == "fence":
            try:
                w.fence()
            except RuntimeError as e:
                caught = str(e)
        else:
            deadline = time.time() + 5
            while w.pending() and time.time() < deadline:
                time.sleep(0.005)
            try:
                w.submit("refused")
            except RuntimeError as e:
                caught = str(e)
        w.fence()
        w.submit("ok2")
        w.fence()
        w.close()
        return caught, done

    assert _both(run) == ("kernel failed", ["ok", "ok2"])


def test_depth_zero_runs_inline():
    def run(m):
        done = []
        seen_thread = []

        def pop(item):
            seen_thread.append(threading.current_thread() is me)
            done.append(item)

        me = threading.current_thread()
        w = m.InflightWindow(0, pop)
        w.submit(1)
        now = list(done)
        w.fence()
        w.close()
        ls = m.LaneSet(0, lambda item, lane: (lambda: done.append(-item)),
                       lanes=2)
        ls.submit(ls.next_lane(), 5)
        now.append(list(done))
        return now, seen_thread

    assert _both(run) == ([1, [1, -5]], [True])


def test_none_emit_releases_its_ticket():
    def run(m):
        seen, done = [], []

        def pop(item, lane):
            seen.append(item)
            return None if item % 2 else (lambda: done.append(item))

        ls = m.LaneSet(2, pop, lanes=2)
        for i in range(8):
            ls.submit(ls.next_lane(), i)
        ls.fence()
        ls.close()
        return sorted(seen), done

    assert _both(run) == (list(range(8)), [0, 2, 4, 6])


def test_ticket_released_after_a_failing_pop():
    def run(m):
        done = []
        gate = threading.Event()

        def pop(item, lane):
            gate.wait(5.0)
            if item == 3:
                raise RuntimeError("device died")
            return lambda: done.append(item)

        ls = m.LaneSet(4, pop, lanes=2)
        for i in range(8):
            ls.submit(ls.next_lane(), i)
        gate.set()
        caught = None
        try:
            ls.fence()
        except RuntimeError as e:
            caught = str(e)
        ls.fence()
        ls.submit(ls.next_lane(), 9)
        ls.fence()
        ls.close()
        return caught, done

    assert _both(run) == ("device died", [0, 1, 2, 4, 5, 6, 7, 9])


def test_ticket_released_after_a_refused_submit():
    def run(m):
        done = []

        def pop(item, lane):
            if item == "boom":
                raise RuntimeError("boom")
            return lambda: done.append(item)

        ls = m.LaneSet(2, pop, lanes=1)
        ls.submit(0, "boom")
        deadline = time.time() + 5
        while ls.pending() and time.time() < deadline:
            time.sleep(0.005)
        caught = None
        try:
            ls.submit(0, "a")  # the ferried exception: "a" never queued
        except RuntimeError as e:
            caught = str(e)
        ls.submit(0, "b")
        ls.submit(0, "c")
        ls.fence()
        ls.close()
        return caught, done

    assert _both(run) == ("boom", ["b", "c"])


def test_fence_all_across_three_lanes():
    def run(m):
        gates = [threading.Event() for _ in range(3)]
        done = []

        def pop(item, lane):
            gates[lane].wait(5.0)
            return lambda: done.append(item)

        ls = m.LaneSet(2, pop, lanes=3)
        for i, name in enumerate("abc"):
            ls.submit(i, name)
        t = threading.Thread(target=ls.fence)
        t.start()
        alive = []
        for g in (2, 0, 1):
            time.sleep(0.05)
            alive.append(t.is_alive())
            gates[g].set()
        t.join(timeout=5)
        alive.append(t.is_alive())
        ls.close()
        return alive, done

    assert _both(run) == ([True, True, True, False], ["a", "b", "c"])


# ---------------------------------------------------------------------------
# RouteEconomics
# ---------------------------------------------------------------------------

# (arm, path, rows, seconds): allow_fused / allow_device asked before
# each observe; a slow device tier, a faster host, then the device
# recovering; a slow fused route against the split path
_SCRIPT = [("device", 1000, 1.0), ("host", 1000, 0.1), ("device", 500, 0.4),
           ("host", 800, 0.07), ("fused", 1000, 2.0), ("device", 1000, 0.001),
           ("device", 1000, 0.0005), ("device", 2000, 0.0008),
           ("host", 1000, 0.2), ("fused", 1000, 0.0001),
           ("fused", 1000, 0.00005), ("host", 0, 1.0), ("bogus", 10, 1.0)]


@pytest.mark.parametrize("enabled,probe_every,label", [
    (True, 4, None), (True, 256, "lane1"), (False, 4, None)])
def test_economics_matches_the_reference_call_by_call(capsys, enabled,
                                                      probe_every, label):
    trackers = {name: m.RouteEconomics(enabled=enabled,
                                       probe_every=probe_every, label=label)
                for name, m in IMPLS.items()}
    calls = {name: [] for name in IMPLS}
    notices = {}
    for name, e in trackers.items():
        capsys.readouterr()
        for path, rows, secs in _SCRIPT:
            calls[name].append((e.allow_fused(), e.allow_device(),
                                e.allow_device(), e.allow_fused()))
            e.observe(path, rows, secs)
        calls[name].append(tuple(e.allow_device() for _ in range(12)))
        calls[name].append(tuple(e.allow_fused() for _ in range(12)))
        calls[name].append(e.snapshot())
        notices[name] = capsys.readouterr().err.splitlines()
    assert calls["port"] == calls["reference"]
    assert notices["port"] == notices["reference"]
    if enabled:
        lane = label or "lane0"
        assert f"route economics [{lane}/split]: device -> host " \
            "(measured 0.000" in notices["port"][0]
        assert any(f"[{lane}/fused]" in n for n in notices["port"])
    else:
        assert notices["port"] == []


def test_healthy_device_never_pays_a_host_probe():
    def run(m):
        e = m.RouteEconomics(probe_every=10)
        first = e.allow_device()
        e.observe("device", 1_000_000, 1.0)   # 1 us a row
        return first, [e.allow_device() for _ in range(20)]

    assert _both(run) == (True, [True] * 20)


@pytest.mark.parametrize("toml", [
    "", "[input]\ntpu_encode_economics = false\n",
    "[input]\ntpu_encode_probe_every = 7\n",
    "[input]\ntpu_encode_probe_every = 1\ntpu_encode_economics = true\n"])
def test_economics_from_config(toml):
    got = {}
    for name, m in IMPLS.items():
        cfg = (Config if name == "port" else RConfig).from_string(toml)
        e = m.RouteEconomics.from_config(cfg)
        got[name] = (e.enabled, e.probe_every, e.margin, e.ok_spr)
    assert got["port"] == got["reference"]
    assert (P.DEFAULT_INFLIGHT, P.DEFAULT_PROBE_EVERY, P.ECON_MARGIN,
            P.ECON_ALPHA, P.DEVICE_OK_SPR) == \
        (R.DEFAULT_INFLIGHT, R.DEFAULT_PROBE_EVERY, R.ECON_MARGIN,
         R.ECON_ALPHA, R.DEVICE_OK_SPR)


# ---------------------------------------------------------------------------
# config: depth, lanes, and their errors
# ---------------------------------------------------------------------------

def _err(fn):
    try:
        return ("ok", fn())
    except (ConfigError, RConfigError) as e:
        return ("error", str(e))


@pytest.mark.parametrize("toml", [
    "", "tpu_inflight = 0\n", "tpu_inflight = 5\n", "tpu_inflight = -1\n",
    'tpu_inflight = "two"\n'])
def test_inflight_depth_and_its_errors(toml):
    cfg = "[input]\n" + toml
    port = _err(lambda: P.inflight_depth_from_config(Config.from_string(cfg)))
    ref = _err(lambda: R.inflight_depth_from_config(RConfig.from_string(cfg)))
    assert port == ref


@pytest.mark.parametrize("toml,mesh", [
    ("", "auto"), ("tpu_lanes = 1\n", "auto"), ("tpu_lanes = 3\n", "auto"),
    ("tpu_lanes = 0\n", "auto"), ("tpu_lanes = -2\n", "auto"),
    ('tpu_lanes = "x"\n', "auto"), ("tpu_lanes = 2\n", "on"),
    ("tpu_lanes = 1\n", "on"), ("", "on")])
def test_lanes_and_their_errors(toml, mesh):
    """Lane counts on the CPU and the config errors, against the
    reference's; the port reads ``tpu_mesh`` from the config for the
    lanes-with-mesh check, the reference takes it from its handler."""
    port = _err(lambda: P.resolve_lanes(
        Config.from_string(f'[input]\n{toml}tpu_mesh = "{mesh}"\n'),
        torch.device("cpu")))
    ref = _err(lambda: R.resolve_lanes(RConfig.from_string("[input]\n" + toml),
                                       mesh))
    assert port[0] == ref[0]
    if port[0] == "error":
        assert port[1] == ref[1]
    else:
        count, devs = port[1]
        assert count == ref[1][0] and len(devs) == count
        assert all(d == torch.device("cpu") for d in devs)


@pytest.mark.parametrize("bad,msg", [
    ("tpu_inflight = -1\n", "input.tpu_inflight must be >= 0"),
    ("tpu_lanes = 0\n", "input.tpu_lanes must be >= 1"),
    ('tpu_lanes = 2\ntpu_mesh = "on"\n', "mutually exclusive"),
    ("tpu_encode_economics = 3\n",
     "input.tpu_encode_economics must be a boolean"),
    ('tpu_encode_probe_every = "x"\n',
     "input.tpu_encode_probe_every must be an integer (batches)")])
def test_handler_refuses_what_the_reference_refuses(bad, msg):
    cfg = Config.from_string("[input]\n" + bad)
    with pytest.raises(ConfigError, match=msg.replace("(", r"\(")
                       .replace(")", r"\)")):
        BatchHandler(queue.Queue(), GelfEncoder(cfg), cfg, LineMerger(),
                     torch.device("cpu"), start_timer=False)


def test_handler_lanes_on_the_cpu():
    """``tpu_lanes = 3`` engages three lanes with three economics
    trackers labelled by lane; a CPU lane has no stream and no staging,
    and its scope changes nothing."""
    cfg = Config.from_string("[input]\ntpu_lanes = 3\ntpu_inflight = 1\n")
    h = BatchHandler(queue.Queue(), GelfEncoder(cfg), cfg, LineMerger(),
                     torch.device("cpu"), start_timer=False)
    assert h._window.lanes == 3 and h._window.depth == 1
    assert [e.label for e in h._econs] == ["lane0", "lane1", "lane2"]
    assert all(ln.stream is None and ln.staging is None for ln in h._lanes)
    with h._lanes[1].scope():
        pass
    assert len(h.economics()) == 3
    h.close()
