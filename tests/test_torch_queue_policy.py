"""The port's bounded queue (``utils/bounded_queue.PolicyQueue``) and its
``queue_pressure`` fault site against the JAX package's, on the CPU.

- The same put / get script, made from a numpy seed, on both packages'
  queues for each policy (``block``, ``drop_newest``, ``drop_oldest``),
  with the SHUTDOWN sentinel among the puts and a ``queue_pressure``
  plan: the same items come out in the same order, the same puts raise
  ``queue.Full``, and the port's ``dropped`` equals the reference's
  ``queue_dropped`` counter.
- A pipeline with ``input.queue_policy = "drop_newest"`` and
  ``[faults] queue_pressure = "every:N"``, each package in process on
  the same stdin: the same records written (0 differing bytes), the
  same stderr, and the number of records the port did not write equals
  the reference's ``queue_dropped``.  One config is a scalar format
  (one queue item a record), one ``rfc5424_tpu`` into RFC3164 (the
  Record path: one queue item a record, so which records drop does not
  hang on batch boundaries).
"""

import io
import queue
import sys

import numpy as np
import pytest
import torch

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import make_corpus
from flowgger_tpu_torch.utils import bounded_queue as BQ
from flowgger_tpu_torch.utils import faultinject as FI


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_plans():
    """Neither package's fault plan outlives a test."""
    from flowgger_tpu.utils import faultinject as RFI

    yield
    FI.reset()
    RFI.reset()


def _ref_metrics():
    from flowgger_tpu.utils.metrics import registry

    return registry


def _script(seed: int, n: int = 400):
    """(op, arg) pairs: ("put", item) with about one sentinel in 25,
    ("get", None)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.58:
            ops.append(("put", None if rng.random() < 0.04 else f"m{i}"))
        else:
            ops.append(("get", None))
    return ops


def _play(q, ops):
    """What each op gave: the item a get returned ("empty" when none was
    queued), or "full" for a put that raised."""
    seen = []
    for op, arg in ops:
        if op == "put":
            try:
                q.put(arg, block=False)
                seen.append("ok")
            except queue.Full:
                seen.append("full")
        else:
            try:
                seen.append(q.get(block=False))
                q.task_done()
            except queue.Empty:
                seen.append("empty")
    return seen


@pytest.mark.parametrize("policy", BQ.POLICIES)
@pytest.mark.parametrize("plan", [None, "every:3"])
def test_policy_queue_matches_reference(policy, plan):
    from flowgger_tpu.utils import bounded_queue as RBQ
    from flowgger_tpu.utils import faultinject as RFI

    ops = _script(seed=BQ.POLICIES.index(policy) * 10 + (7 if plan else 0))
    specs = {"queue_pressure": plan} if plan else {}
    FI.configure(specs)
    RFI.configure(specs)
    reg = _ref_metrics()
    before = reg.get("queue_dropped")
    port_q, ref_q = BQ.PolicyQueue(3, policy), RBQ.PolicyQueue(3, policy)
    got, want = _play(port_q, ops), _play(ref_q, ops)
    assert got == want
    assert port_q.dropped == reg.get("queue_dropped") - before
    assert list(port_q.queue) == list(ref_q.queue)
    assert port_q.unfinished_tasks == ref_q.unfinished_tasks
    if policy != "block" and plan:
        assert port_q.dropped > 0
    if policy == "block":
        assert port_q.dropped == 0 and "full" in got


def test_the_sentinel_is_never_shed():
    """drop_oldest with the sentinel at the head: the sentinel goes back
    in and the incoming item is dropped, in both packages; drop_newest
    with a pressure plan still delivers the sentinel."""
    from flowgger_tpu.utils import bounded_queue as RBQ
    from flowgger_tpu.utils import faultinject as RFI

    for mod in (BQ, RBQ):
        q = mod.PolicyQueue(2, "drop_oldest")
        q.put(None)
        q.put("a")
        q.put("b")
        assert list(q.queue) == ["a", None]
        assert q.unfinished_tasks == 2
    FI.configure({"queue_pressure": "every:1"})
    RFI.configure({"queue_pressure": "every:1"})
    for mod in (BQ, RBQ):
        q = mod.PolicyQueue(0, "drop_newest")
        q.put("x")
        q.put(None)
        assert list(q.queue) == [None]
    q = BQ.PolicyQueue(0, "drop_newest")
    q.mark_draining()
    assert q.draining and q.fill_fraction() == 0.0
    with pytest.raises(ValueError, match="unknown queue policy: bogus"):
        BQ.PolicyQueue(1, "bogus")


def _stdin(monkeypatch, data: bytes):
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))


@pytest.mark.parametrize("fmt,out_fmt,every", [
    ("rfc5424", "gelf", 4), ("rfc5424_tpu", "rfc3164", 3)],
    ids=["scalar", "tpu_record_path"])
def test_pipeline_drop_newest_under_pressure(tmp_path, monkeypatch, capsys,
                                             fmt, out_fmt, every):
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.pipeline import Pipeline as RPipeline

    lines, _ = make_corpus(300, seed=51)
    data = b"\n".join(lines) + b"\n"
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    outs, errs = {}, {}
    for side in ("port", "ref", "clean"):
        out = tmp_path / f"{side}.out"
        faults = ("" if side == "clean" else
                  f'[faults]\nqueue_pressure = "every:{every}"\n')
        text = ('[input]\ntype = "stdin"\ntpu_encode_economics = false\n'
                f'format = "{fmt}"\ntpu_fuse = "off"\ntpu_batch_size = 128\n'
                'tpu_flush_ms = 600000\nqueue_policy = "drop_newest"\n'
                f'[output]\ntype = "file"\nformat = "{out_fmt}"\n'
                f'framing = "line"\nfile_path = "{out}"\n' + faults)
        _stdin(monkeypatch, data)
        capsys.readouterr()
        if side == "ref":
            before = _ref_metrics().get("queue_dropped")
            RPipeline(RConfig.from_string(text)).run()
            ref_dropped = _ref_metrics().get("queue_dropped") - before
        else:
            pipe = pipeline.Pipeline(Config.from_string(text), device="cpu")
            pipe.run()
            if side == "port":
                port_dropped = pipe.tx.dropped
        outs[side] = out.read_bytes()
        errs[side] = capsys.readouterr().err.splitlines()
    assert outs["port"] == outs["ref"]
    assert errs["port"] == errs["ref"]
    assert errs["port"][0] == ("faultinject: active plan {'queue_pressure': "
                               f"'every:{every}'}}")
    written = outs["port"].splitlines()
    clean = outs["clean"].splitlines()
    assert port_dropped == ref_dropped > 0
    assert len(clean) - len(written) == ref_dropped
    # every N-th record put is the one missing
    assert written == [r for i, r in enumerate(clean) if (i + 1) % every]
