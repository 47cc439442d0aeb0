"""The region cap of a raw-framing session, against the JAX package.

A session forces a flush once its buffered region reaches 4 MiB, however
few records the batch-size trigger has counted (the reference's
``_RAW_REGION_CAP``).  The same 64 KiB reads of a ~10 MB line-framed
stream go into a ``_RawSession`` of each package with a batch size only
the cap can reach, and each handler's ``flush`` replaced by a recorder
that does to the session what a flush does to its buffers (the region
taken, the tail after its last separator kept as carry) without
decoding: both force their flushes at the same reads, with the same
region bytes.  Then the port's handler, with a small cap, flushes for
real through the cap and emits the scalar path's bytes.
"""

import queue

import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders import RFC5424Decoder as RDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.tpu import batch as RB

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import make_tier_corpus, scalar_expectation
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger
from flowgger_tpu_torch.splitters import _CHUNK
from flowgger_tpu_torch.tpu import batch as B


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers (on a
    loaded box a pool of one thread a core runs the plain versions
    several times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BIG_BATCH = "[input]\ntpu_encode_economics = false\ntpu_batch_size = 100000\n"


def _stream(n_bytes: int, seed: int) -> bytes:
    """Newline-framed RFC5424 records of ~450 bytes, ``n_bytes`` or a
    little more."""
    rng = np.random.default_rng(seed)
    head = b"<13>1 2023-09-20T12:35:45Z host app 42 - - "
    out, size = [], 0
    while size < n_bytes:
        rec = head + b"m" * int(rng.integers(300, 520)) + b"\n"
        out.append(rec)
        size += len(rec)
    return b"".join(out)


def _reads(data: bytes):
    return [data[i:i + _CHUNK] for i in range(0, len(data), _CHUNK)]


def _forced_flushes(handler, sess, reads):
    """(read index, region bytes) of each flush the pushes force."""
    log, at = [], [0]

    def flush(*_args, **_kw):
        region = sess.carry + b"".join(sess.chunks)
        log.append((at[0], len(region)))
        sess.carry = region[region.rfind(b"\n") + 1:]
        sess.chunks = []
        sess.nbytes = 0
        handler._raw_est -= sess.est
        sess.est = 0

    handler.flush = flush
    for i, chunk in enumerate(reads):
        at[0] = i
        assert sess.push(chunk)
    return log


def test_region_cap_forces_the_reference_flushes():
    reads = _reads(_stream(10 << 20, seed=51))
    ref = RB.BatchHandler(queue.Queue(), RDecoder(),
                          RGelfEncoder(RConfig.from_string("")),
                          RConfig.from_string(BIG_BATCH), start_timer=False)
    cfg = Config.from_string(BIG_BATCH)
    port = B.BatchHandler(queue.Queue(), GelfEncoder(cfg), cfg, LineMerger(),
                          torch.device("cpu"), start_timer=False)
    got = {}
    for name, h in (("reference", ref), ("port", port)):
        got[name] = _forced_flushes(h, h.open_raw("line"), reads)
    assert got["port"] == got["reference"]
    assert len(got["port"]) == 2
    assert all(size >= B._RAW_REGION_CAP for _, size in got["port"])


def test_region_cap_flushes_keep_the_bytes(monkeypatch, capsys):
    """A 24 KiB cap on ~130 KiB of the tier mix in 4 KiB reads: the cap
    alone flushes mid-stream, records cut across reads and flushes
    carry over, and the output is the scalar path's."""
    monkeypatch.setattr(B, "_RAW_REGION_CAP", 24 << 10)
    lines, _ = make_tier_corpus(900, seed=52)
    data = b"\n".join(lines) + b"\n"
    cfg = Config.from_string(BIG_BATCH + "tpu_max_line_len = 512\n")
    tx = queue.Queue()
    handler = B.BatchHandler(tx, GelfEncoder(cfg), cfg, LineMerger(),
                             torch.device("cpu"), start_timer=False)
    sess = handler.open_raw("line")
    flushes = []
    real_flush = handler.flush

    def flush(drain=True):
        flushes.append(len(sess.carry) + sum(map(len, sess.chunks)))
        real_flush(drain)

    handler.flush = flush
    for i in range(0, len(data), 4096):
        assert sess.push(data[i:i + 4096])
    forced = len(flushes)
    sess.finish()
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(data, merger=LineMerger())
    assert forced >= 3 and all(f >= 24 << 10 for f in flushes[:forced])
    assert got == exp
    assert capsys.readouterr().err.splitlines() == errs


@pytest.mark.parametrize("framing", ["syslen", "nul"])
def test_region_cap_counts_every_framing(framing):
    """The cap counts bytes, not records: a syslen or NUL session whose
    reads hold no separator at all flushes at the cap."""
    cfg = Config.from_string(BIG_BATCH)
    h = B.BatchHandler(queue.Queue(), GelfEncoder(cfg), cfg, LineMerger(),
                       torch.device("cpu"), start_timer=False)
    sess = h.open_raw(framing)
    calls = []
    h.flush = lambda *a, **kw: calls.append(sess.nbytes)
    chunk = b"x" * _CHUNK
    for _ in range(B._RAW_REGION_CAP // _CHUNK - 1):
        sess.push(chunk)
    assert calls == []
    sess.push(chunk)
    assert calls == [B._RAW_REGION_CAP]
