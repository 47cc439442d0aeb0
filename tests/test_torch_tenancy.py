"""The port's serving front (``tenancy/``, ``tpu/encode_passthrough.py``)
against the JAX package's, on the CPU, with the same inputs made from a
numpy seed and 0 differing output bytes:

- ``TenantRegistry``: resolution by CIDR, exact IP, label and ``*``
  (first match in declaration order), the ``[tenant]`` defaults and
  ``[tenants.default]``, and the reference's ConfigError words;
- ``TokenBucket`` under an injected clock, call by call;
- ``WeightedFairQueue``: the same puts (tenant-tagged, with the
  ``queue_pressure`` plan) give the same dequeue order and the same
  sheds, item by item and tenant by tenant;
- a tcp pipeline with two tenants bound to 127.0.0.2 and 127.0.0.3, one
  rate-limited under a ``tenant_flood`` plan: the same records written
  and shed, the same stderr;
- ``tenant.templates`` into GELF, with and without
  ``tenant.template_enrich``: the same bytes, the same template IDs and
  texts; ``examples/tenants.toml``'s ``[tenant]`` / ``[tenants.*]``
  tables over stdin into a file (its ``[metrics]`` table left out: the
  observability slice);
- ``encode_rfc5424_passthrough`` row for row, and the Record path's
  dispatch to it.
"""

import io
import socket
import sys
import threading
import time
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch import pipeline, tenancy
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import make_corpus
from flowgger_tpu_torch.encoders import PassthroughEncoder
from flowgger_tpu_torch.tenancy import admission as AD
from flowgger_tpu_torch.tenancy import fairqueue as FQ
from flowgger_tpu_torch.tenancy.registry import TenantRegistry
from flowgger_tpu_torch.tpu import batch as B
from flowgger_tpu_torch.tpu import encode_passthrough as EP
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.rfc5424 import decode_rfc5424_host
from flowgger_tpu_torch.utils import faultinject as FI

ROOT = Path(__file__).resolve().parent.parent
WAIT = 30.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_state():
    """Neither package's fault plan nor thread tag outlives a test."""
    from flowgger_tpu import tenancy as rtenancy
    from flowgger_tpu.utils import faultinject as RFI

    yield
    FI.reset()
    RFI.reset()
    tenancy.set_current(None)
    rtenancy.set_current(None)


def _ref_metrics():
    from flowgger_tpu.utils.metrics import registry

    return registry


TENANTS = """
[tenant]
default_weight = 2
default_queue_policy = "drop_newest"
[tenants.bulk]
peers = ["10.0.0.0/8", "192.0.2.7"]
rate = 50
burst = 10
queue_policy = "drop_oldest"
[tenants.pay]
peers = ["10.1.2.3", "/var/log/app.log", "2001:db8::/32"]
weight = 8
queue_policy = "block"
[tenants.rest]
peers = ["*"]
"""


def test_registry_resolution_matches_reference():
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.tenancy.registry import TenantRegistry as RRegistry

    port = TenantRegistry.from_config(Config.from_string(TENANTS))
    ref = RRegistry.from_config(RConfig.from_string(TENANTS))
    peers = [None, "10.1.2.3", "10.9.9.9", "192.0.2.7", "192.0.2.8",
             "/var/log/app.log", "/var/log/other.log", "2001:db8::1",
             "::1", "127.0.0.1", "not-an-address"]
    got = [port.resolve_name(p) for p in peers]
    assert got == [ref.resolve_name(p) for p in peers]
    # first match in declaration order: the CIDR before the exact IP
    assert got[1] == "bulk" and got[5] == "pay" and got[-1] == "rest"
    for name in ("bulk", "pay", "rest", "default", "nobody"):
        ps, rs = port.spec(name), ref.spec(name)
        assert (ps.name, ps.rate, ps.burst, ps.weight, ps.queue_policy,
                ps.limited) == (rs.name, rs.rate, rs.burst, rs.weight,
                                rs.queue_policy, rs.limited)
    exact = '[tenants.a]\npeers = ["127.0.0.2"]\n[tenants.default]\nrate = 5\n'
    port = TenantRegistry.from_config(Config.from_string(exact))
    assert port.resolve_name("127.0.0.2") == "a"
    assert port.resolve("9.9.9.9").spec.rate == 5
    assert TenantRegistry.from_config(Config.from_string("")) is None
    rated = TenantRegistry.from_config(Config.from_string(
        "[tenant]\ndefault_rate = 3\n"))
    assert rated is not None and rated.resolve("1.2.3.4").spec.limited


@pytest.mark.parametrize("text", [
    "[tenant]\ndefault_weight = 0\n[tenants.a]\n",
    '[tenant]\ndefault_queue_policy = "bogus"\n[tenants.a]\n',
    "[tenant]\ndefault_rate = -1\n",
    "[tenants.a]\nspeed = 3\n",
    "[tenants.a]\npeers = \"10.0.0.1\"\n",
    '[tenants.a]\nqueue_policy = "later"\n',
    '[tenants.a]\ntemplates = "yes"\n',
    "[tenants.a]\nweight = 0\n",
    "[tenants.a]\nrate = -4\n",
    "[tenants]\na = 3\n",
    '[tenant]\ndefault_rate = "fast"\n',
])
def test_registry_errors_match_reference(text):
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.config import ConfigError as RConfigError
    from flowgger_tpu.tenancy.registry import TenantRegistry as RRegistry

    with pytest.raises(ConfigError) as exc:
        TenantRegistry.from_config(Config.from_string(text))
    with pytest.raises(RConfigError) as rexc:
        RRegistry.from_config(RConfig.from_string(text))
    assert str(exc.value) == str(rexc.value)


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("rate,burst", [(100, 0), (10, 25), (0, 0)])
def test_token_bucket_matches_reference(rate, burst):
    from flowgger_tpu.tenancy.admission import TokenBucket as RBucket

    rng = np.random.default_rng(rate + burst)
    pc, rc = _Clock(), _Clock()
    port, ref = AD.TokenBucket(rate, burst, pc), RBucket(rate, burst, rc)
    got, want = [], []
    for _ in range(500):
        if rng.random() < 0.3:
            dt = float(rng.choice([0.001, 0.05, 0.3, 2.0]))
            pc.t += dt
            rc.t += dt
            continue
        n = float(rng.integers(1, 20))
        got.append(port.try_take(n))
        want.append(ref.try_take(n))
    assert got == want
    assert (True in got) and (False in got or rate == 0)


def _fq_script(seed: int, n: int = 600):
    rng = np.random.default_rng(seed)
    names = ["bulk", "pay", "rest", "default", None]
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.62:
            size = int(rng.integers(1, 40000))
            ops.append(("put", (names[int(rng.integers(0, 5))],
                                f"{i}:".encode() + b"x" * size)))
        elif r < 0.64:
            ops.append(("put", (None, None)))
        else:
            ops.append(("get", None))
    return ops


def _fq_play(q, ops, set_current):
    seen = []
    for op, arg in ops:
        if op == "put":
            name, item = arg
            set_current(name)
            try:
                q.put(item, block=False)
                seen.append("ok")
            except Exception as e:  # noqa: BLE001 - compared as a name
                seen.append(type(e).__name__)
        else:
            try:
                item = q.get(block=False)
                seen.append(item[:8] if item is not None else None)
                q.task_done()
            except Exception as e:  # noqa: BLE001 - compared as a name
                seen.append(type(e).__name__)
    set_current(None)
    return seen


@pytest.mark.parametrize("plan", [None, "every:5"])
@pytest.mark.parametrize("maxsize", [6, 0])
def test_fair_queue_matches_reference(plan, maxsize):
    from flowgger_tpu import tenancy as rtenancy
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.tenancy.fairqueue import WeightedFairQueue as RWFQ
    from flowgger_tpu.tenancy.registry import TenantRegistry as RRegistry
    from flowgger_tpu.utils import faultinject as RFI

    specs = {"queue_pressure": plan} if plan else {}
    FI.configure(specs)
    RFI.configure(specs)
    preg = TenantRegistry.from_config(Config.from_string(TENANTS))
    rreg = RRegistry.from_config(RConfig.from_string(TENANTS))
    reg = _ref_metrics()
    before = {k: reg.get(k) for k in ("queue_dropped", "tenant_bulk_shed",
                                      "tenant_default_shed",
                                      "tenant_rest_shed")}
    ops = _fq_script(seed=maxsize * 3 + (1 if plan else 0))
    port, ref = FQ.WeightedFairQueue(maxsize, preg), RWFQ(maxsize, rreg)
    got = _fq_play(port, ops, tenancy.set_current)
    want = _fq_play(ref, ops, rtenancy.set_current)
    assert got == want
    assert port.lane_depths() == ref.lane_depths()
    assert port.unfinished_tasks == ref.unfinished_tasks
    assert port.dropped == reg.get("queue_dropped") - before["queue_dropped"]
    for name in ("bulk", "default", "rest"):
        assert preg.state(name).shed == (reg.get(f"tenant_{name}_shed")
                                         - before[f"tenant_{name}_shed"])
    if maxsize or plan:
        assert port.dropped > 0
    # the weight-8 lane is served first in a two-lane tie
    q = FQ.WeightedFairQueue(0, preg)
    for name in ("bulk", "pay", "bulk", "pay"):
        tenancy.set_current(name)
        q.put(name.encode() * 5000)
    tenancy.set_current(None)
    order = [q.get()[:3] for _ in range(4)]
    assert order.count(b"pay") == 2 and order[:2].count(b"pay") >= 1


def _stdin(monkeypatch, data: bytes):
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))


def _stdin_pair(tmp_path, monkeypatch, capsys, data: bytes, text: str):
    """One config over the same stdin through each package in process:
    (output bytes, stderr lines, the port's pipeline, the reference's)."""
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.pipeline import Pipeline as RPipeline

    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    got = {}
    for side in ("port", "ref"):
        out = tmp_path / f"{side}.out"
        full = text.replace("@OUT@", str(out))
        if side == "ref":
            full = full.replace("[input]\n",
                                '[input]\ntpu_fuse = "off"\n', 1)
        _stdin(monkeypatch, data)
        capsys.readouterr()
        if side == "ref":
            pipe = RPipeline(RConfig.from_string(full))
        else:
            pipe = pipeline.Pipeline(Config.from_string(full), device="cpu")
        pipe.run()
        got[side] = (out.read_bytes(), capsys.readouterr().err.splitlines(),
                     pipe)
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    return got["port"][0], got["port"][1], got["port"][2], got["ref"][2]


_STDIN_GELF = ('[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\n'
               'tpu_encode_economics = false\ntpu_batch_size = 256\n'
               'tpu_flush_ms = 600000\n'
               '[output]\ntype = "file"\nformat = "gelf"\n'
               'file_path = "@OUT@"\n')


@pytest.mark.parametrize("enrich", [False, True], ids=["mine", "enrich"])
def test_templates_match_reference(tmp_path, monkeypatch, capsys, enrich):
    lines, _ = make_corpus(700, seed=33)
    data = b"\n".join(lines) + b"\n"
    keys = ('[tenant]\ntemplates = "on"\ntemplate_sim = 0.4\n'
            'template_depth = 3\ntemplate_max_templates = 500\n'
            + ("template_enrich = true\n" if enrich else ""))
    out, err, port, ref = _stdin_pair(tmp_path, monkeypatch, capsys, data,
                                      _STDIN_GELF + keys)
    pm = port._handler._miners.miner("default")
    rm = ref._handlers[0]._miners.miner("default")
    assert pm.templates() == rm.templates()
    assert pm.distinct() > 20
    notice = ("flowgger-tpu: columnar block route disabled for format "
              "'rfc5424' (tenant.template_enrich is set (per-record "
              "_template_id rides the Record path)); throughput falls to "
              "the per-record path (~30x slower)")
    assert (err[0] == notice) == enrich
    assert (b'"_template_id":' in out) == enrich
    if not enrich:
        # mining pins the host block path and leaves the bytes alone
        assert not port._handler.route_state.get("rfc5424", {}).get("taken")
        plain = tmp_path / "plain.out"
        cfg = Config.from_string(_STDIN_GELF.replace("@OUT@", str(plain)))
        _stdin(monkeypatch, data)
        pipeline.Pipeline(cfg, device="cpu").run()
        assert plain.read_bytes() == out


def test_mining_order_holds_at_every_lane_count(tmp_path, monkeypatch,
                                                capsys):
    """The miner observes each batch inside the sequenced emit, so the
    template IDs follow batch order whatever the lanes do: three lanes
    whose pops finish out of order (a seeded sleep before each) give the
    serial run's templates, IDs and bytes."""
    import random

    lines, _ = make_corpus(900, seed=39)
    data = b"\n".join(lines) + b"\n"
    rng = random.Random(39)
    pop = B.BatchHandler._pop_emit

    def jittered(self, payload, lane=0):
        time.sleep(rng.choice((0.0, 0.005, 0.02)))
        return pop(self, payload, lane)

    got = {}
    for name, keys in (("serial", "tpu_inflight = 0\n"),
                       ("lanes", "tpu_lanes = 3\n")):
        out = tmp_path / f"{name}.out"
        text = (_STDIN_GELF.replace("@OUT@", str(out)).replace(
            "tpu_batch_size = 256\n", "tpu_batch_size = 64\n" + keys)
            + '[tenant]\ntemplates = "on"\n')
        if name == "lanes":
            monkeypatch.setattr(B.BatchHandler, "_pop_emit", jittered)
        _stdin(monkeypatch, data)
        pipe = pipeline.Pipeline(Config.from_string(text), device="cpu")
        pipe.run()
        got[name] = (out.read_bytes(),
                     pipe._handler._miners.miner("default").templates())
    assert got["lanes"] == got["serial"]
    assert len(got["serial"][1]) > 20


def test_scalar_pipeline_mines_through_its_record_hook(tmp_path,
                                                       monkeypatch, capsys):
    lines, _ = make_corpus(300, seed=34)
    data = b"\n".join(lines) + b"\n"
    text = (_STDIN_GELF.replace('"rfc5424_tpu"', '"rfc5424"')
            + '[tenant]\ntemplates = "on"\ntemplate_enrich = true\n')
    out, err, port, ref = _stdin_pair(tmp_path, monkeypatch, capsys, data,
                                      text)
    assert b'"_template_id":' in out
    assert (port._scalar_miners.miner("default").templates()
            == ref._scalar_miners.miner("default").templates())


def test_tenants_example_over_stdin(tmp_path, monkeypatch, capsys):
    """examples/tenants.toml's tenancy tables (stdin: the default
    tenant; the fair queue; the miner) into a file."""
    example = tomllib.loads((ROOT / "examples/tenants.toml").read_text())
    lines = []
    for section in ("tenant", "tenants"):
        table = example[section]
        if section == "tenant":
            lines.append("[tenant]")
            lines += [f"{k} = {v!r}".replace("'", '"')
                      for k, v in table.items()]
            continue
        for name, sub in table.items():
            lines.append(f'[tenants."{name}"]')
            for k, v in sub.items():
                lines.append(f"{k} = {v!r}".replace("'", '"'))
    text = (_STDIN_GELF.replace(
        "tpu_flush_ms = 600000\n",
        f"tpu_flush_ms = 600000\nqueuesize = "
        f"{example['input']['queuesize']}\nqueue_policy = "
        f"\"{example['input']['queue_policy']}\"\n")
        + "\n".join(lines) + "\n")
    corpus, _ = make_corpus(500, seed=35)
    data = b"\n".join(corpus) + b"\n"
    out, err, port, ref = _stdin_pair(tmp_path, monkeypatch, capsys, data,
                                      text)
    assert isinstance(port.tx, FQ.WeightedFairQueue)
    assert port.tenants.resolve_name("10.2.3.4") == "bulk-fleet"
    assert port.tenants.resolve_name("192.0.2.8") == "payments"
    assert out.count(b"\0") > 450
    assert (port._handler._miners.miner("default").templates()
            == ref._handlers[0]._miners.miner("default").templates())


# -- tcp, two tenants on loopback aliases -----------------------------------

_TCP = ('[input]\ntype = "tcp"\nlisten = "127.0.0.1:0"\n'
        'format = "rfc5424_tpu"\nframing = "line"\ntimeout = 5\n'
        'tpu_encode_economics = false\ntpu_batch_size = 1000000\n'
        'tpu_flush_ms = 600000\n@REF@'
        '[output]\ntype = "file"\nformat = "gelf"\nfile_path = "@OUT@"\n'
        '[tenants.bulk]\npeers = ["127.0.0.2"]\nrate = 1000000\n'
        'queue_policy = "drop_oldest"\n'
        '[tenants.pay]\npeers = ["127.0.0.3"]\nweight = 8\n'
        '[faults]\ntenant_flood = "every:2"\n')


def _poll(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _send_from(source: str, port: int, data: bytes) -> None:
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT,
                                  source_address=(source, 0)) as s:
        s.sendall(data)


def _tcp_side(tmp_path, name, ref: bool):
    out = tmp_path / f"{name}.out"
    text = _TCP.replace("@OUT@", str(out)).replace(
        "@REF@", 'tpu_fuse = "off"\ntpu_framing = "on"\n' if ref else "")
    if ref:
        from flowgger_tpu.config import Config as RConfig
        from flowgger_tpu.pipeline import Pipeline as RPipeline
        from flowgger_tpu.utils import faultinject as RFI

        pipe = RPipeline(RConfig.from_string(text))
        pipe.start_output()
        threading.Thread(target=pipe.input.accept,
                         args=(pipe.handler_factory,), daemon=True).start()
        checks = lambda: RFI._plan.count("tenant_flood")  # noqa: E731
    else:
        pipe = pipeline.Pipeline(Config.from_string(text), device="cpu")
        threading.Thread(target=pipe.run, daemon=True).start()
        checks = lambda: FI.count("tenant_flood")  # noqa: E731
    _poll(lambda: pipe.input.bound_port is not None, "the listener")
    return pipe, out, checks


def test_tcp_tenants_with_a_flood_plan(tmp_path, monkeypatch, capsys):
    """Connections alternate between the rate-limited tenant (from
    127.0.0.2) and the weight-8 one (127.0.0.3), one at a time; the
    flood plan denies every second region of the limited tenant, whole.
    Each connection's region is framed at its end of stream (no size or
    timer flush), so each is one admission check in both packages."""
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    rng_lines, _ = make_corpus(6 * 40, seed=36)
    conns = [("127.0.0.2" if i % 2 == 0 else "127.0.0.3",
              b"\n".join(rng_lines[i * 40:(i + 1) * 40]) + b"\n")
             for i in range(6)]
    results = {}
    for name in ("port", "ref"):
        capsys.readouterr()
        pipe, out, checks = _tcp_side(tmp_path, name, name == "ref")
        recs = lambda: (out.read_bytes().count(b"\0")  # noqa: E731
                        if out.exists() else 0)
        expect_recs, expect_checks = 0, 0
        for i, (source, data) in enumerate(conns):
            _send_from(source, pipe.input.bound_port, data)
            if source == "127.0.0.2":
                expect_checks += 1
                _poll(lambda: checks() >= expect_checks, "the check")
                if expect_checks % 2 == 0:
                    continue
            n0 = expect_recs
            expect_recs = n0 + 1
            _poll(lambda: recs() >= expect_recs, "the records")
            time.sleep(0.3)
            expect_recs = recs()
        if name == "port":
            pipe.shutdown(timeout=WAIT)
            shed = pipe.tenants.state("bulk").drops
        else:
            for h in pipe._handlers:
                h.flush()
            time.sleep(0.2)
            shed = _ref_metrics().get("tenant_bulk_drops")
        err = [ln for ln in capsys.readouterr().err.splitlines()
               if "tenant" in ln or "faultinject" in ln]
        results[name] = (out.read_bytes(), err, shed)
    port, ref = results["port"], results["ref"]
    assert port[0] == ref[0]
    assert port[1] == ref[1] == [
        "faultinject: active plan {'tenant_flood': 'every:2'}",
        "tenant [bulk] over admission rate; shedding "
        "(tenant_bulk_drops counts lines)"]
    assert port[2] == 40
    # the pay tenant's three connections and two of bulk's, in order
    exp = b"".join(
        c for i, c in enumerate(conns) if i != 2 for c in [c[1]])
    from flowgger_tpu_torch.corpus import scalar_expectation
    want, _ = scalar_expectation(exp)
    assert port[0] == want


# -- the passthrough span encode ---------------------------------------------

def test_passthrough_encode_matches_reference():
    """Row for row: decode-ok ASCII rows emit their raw line, the others
    (flagged, over-length, non-ASCII, invalid UTF-8) take the scalar
    decoder and the encoder, as the reference's do."""
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.encoders import PassthroughEncoder as RPassthrough
    from flowgger_tpu.tpu import encode_passthrough as REP
    from flowgger_tpu.tpu import pack as rpack
    from flowgger_tpu.tpu.rfc5424 import decode_rfc5424_host as rdecode

    lines, _ = make_corpus(400, seed=37)
    lines += [b"\xff\xfe bad utf-8", b"<13>1 2015-08-05T15:53:45Z h a p m - "
              + b"y" * 300, b"", "<13>1 - h a p m - café".encode()]
    packed = pack.pack_lines_2d(lines, 256)
    rpacked = rpack.pack_lines_2d(lines, 256)
    batch, lens, chunk, starts, orig_lens, n = packed
    host = decode_rfc5424_host(torch.from_numpy(batch), torch.from_numpy(lens))
    rhost = rdecode(rpacked[0], rpacked[1])
    got = EP.encode_rfc5424_passthrough(
        chunk, starts, orig_lens, host, n, 256,
        PassthroughEncoder(Config.from_string("")))
    want = REP.encode_rfc5424_passthrough(
        rpacked[2], rpacked[3], rpacked[4], rhost, rpacked[5], 256,
        RPassthrough(RConfig.from_string("")))
    assert [(r.encoded, r.error, r.line) for r in got] == \
        [(r.encoded, r.error, r.line) for r in want]
    assert sum(r.encoded is None for r in got) > 10


@pytest.mark.parametrize("prepend", [False, True])
def test_record_path_passthrough_dispatch(monkeypatch, prepend):
    """The Record path takes the passthrough span encode for rfc5424 into
    passthrough without a prepend format (its rows are the reference's
    ``_encode_packed_rfc5424_gelf``'s); with a prepend format the
    handler's block route is off and the Record path runs the encoder on
    every row (both packages: the reference's ``_fast_encode`` is off for
    such a config).  A pipeline config without a prepend format takes the
    block route, so no pipeline reaches the span encode."""
    import queue

    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.encoders import PassthroughEncoder as RPassthrough
    from flowgger_tpu.tpu import batch as RB

    text = ('[output]\nsyslog_prepend_timestamp = "[year]"\n'
            if prepend else "")
    cfg = Config.from_string("[input]\ntpu_encode_economics = false\n"
                             + text)
    lines, _ = make_corpus(300, seed=38)
    packed = pack.pack_lines_2d(lines, 512)
    called = []
    real = EP.encode_rfc5424_passthrough
    monkeypatch.setattr(EP, "encode_rfc5424_passthrough",
                        lambda *a: called.append(1) or real(*a))
    tx = queue.Queue()
    h = B.BatchHandler(tx, PassthroughEncoder(cfg), cfg, None,
                       torch.device("cpu"), start_timer=False)
    assert h._block_ok == (not prepend)
    h._emit_record_path((torch.from_numpy(packed[0]),
                         torch.from_numpy(packed[1]), *packed[2:]))
    got = [tx.get_nowait() for _ in range(tx.qsize())]
    assert called == ([] if prepend else [1])
    renc = RPassthrough(RConfig.from_string(text))
    if prepend:
        assert len(got) > 200 and all(g.startswith(b"20") for g in got)
        return
    want = [r.encoded for r in RB._encode_packed_rfc5424_gelf(
        packed, renc) if r.encoded is not None]
    assert got == want and len(got) > 200
