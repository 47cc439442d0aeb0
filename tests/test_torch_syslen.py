"""The port's octet-counted (syslen) framing on the CPU against the JAX
package: the plain span chain (the K4 kernel's plain version) against
``framing.frame_syslen_spans_jit`` and the Pallas kernel in interpret
mode over the JAX tests' edge matrix, the host scan, device framing
against the host scan, the splitter's stderr against the JAX package's
host splitter (short read, bad prefix, idle close), the batch handler
across chunk and flush boundaries, and the CLI end to end.  Every
comparison is exact; where the reference declines a region, only the
decline itself is compared (the host re-frames it).  One region size
and one span capacity keep the JAX side at a few compiled shapes."""

import io
import os
import queue
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu.tpu import framing as jframing
from flowgger_tpu.tpu import pallas_kernels as PK
from flowgger_tpu import splitters as jsplitters
from flowgger_tpu.config import Config as JConfig
from flowgger_tpu.decoders import RFC5424Decoder as JRFC5424Decoder
from flowgger_tpu.encoders.gelf import GelfEncoder as JGelfEncoder
from flowgger_tpu_torch import splitters as tsplitters
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, scalar_expectation,
                                       syslen_stream)
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import NulMerger
from flowgger_tpu_torch.tpu import framing as F
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler


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


ROOT = Path(__file__).resolve().parent.parent
B, NCAP, MAX_LEN = 4096, 64, 96
SPAN_KEYS = ("starts", "lens", "n", "consumed", "err")


def _region(recs, extra=b""):
    raw = b"".join(b"%d " % len(r) + r for r in recs) + extra
    assert len(raw) <= B
    buf = np.zeros(B, np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    return buf, len(raw)


def _random_case(trial):
    rng = np.random.default_rng(100 + trial)
    nrec = int(rng.integers(0, 12))
    recs = [bytes(rng.integers(33, 127, size=int(rng.integers(0, 50)))
                  .astype(np.uint8)) for _ in range(nrec)]
    extra = [b"", b"12", b"12 abc", b"garbage no prefix", b"0 "][trial % 5]
    return recs, extra


# the JAX tests' edges (tests/test_pallas_kernels.py): empty, exact one,
# partial body, > 9-digit prefix (a decline), space at offset 0, empty
# records, span overflow (a decline), chain then garbage, leading zero;
# plus a prefix of exactly 9 digits, digits to the end, and a bad prefix
# with a space far behind it
EDGES = {
    "empty": ([], b""),
    "exact-one": ([], b"5 hello"),
    "partial-body": ([], b"5 hel"),
    "too-long-prefix": ([], b"9999999999 x"),
    "space-at-0": ([], b" leading-space"),
    "empty-records": ([b""] * 5, b""),
    "overflow": ([b"x"] * 100, b""),
    "chain-then-garbage": ([], b"3 abc12 nodigitspace"),
    "leading-zero": ([], b"03 abc"),
    "nine-digits": ([], b"000000003 abc"),
    "ten-digits": ([b"ok"], b"0000000003 abc"),
    "digits-to-end": ([b"ab"], b"123456"),
    "bad-prefix-far-space": ([b"ab"], b"1x" + b"y" * 200 + b" z"),
    "no-space-garbage": ([b"ab"], b"1x" + b"y" * 200),
}
CASES = [(f"random-{t}", *_random_case(t)) for t in range(12)] + [
    (k, *v) for k, v in EDGES.items()]


@pytest.mark.parametrize("name,recs,extra", CASES, ids=[c[0] for c in CASES])
def test_syslen_spans_match_jax(name, recs, extra):
    reg, rlen = _region(recs, extra)
    got = F.frame_syslen_spans(torch.from_numpy(reg), rlen, ncap=NCAP)
    jit = jframing.frame_syslen_spans_jit(reg, rlen, ncap=NCAP,
                                          max_hops=jframing.syslen_hops(B))
    pal = PK.frame_syslen_spans_pallas(reg, np.int32(rlen), ncap=NCAP,
                                       interpret=True)
    declined = bool(got["decline"])
    assert declined == (name in ("too-long-prefix", "overflow",
                                 "ten-digits"))
    for ref in (jit, pal):
        assert bool(ref["decline"]) == declined
        if not declined:
            for k in SPAN_KEYS:
                a, b = np.asarray(ref[k]), got[k].numpy()
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, k)
    if not declined:
        # the host scan the splitter rides agrees frame for frame
        hs, hl, hn, hcons, herr = tsplitters._scan_syslen_region(
            reg[:rlen].tobytes())
        assert int(got["n"]) == hn and int(got["consumed"]) == hcons
        assert bool(got["err"]) == herr
        assert np.array_equal(got["starts"][:hn].numpy(), hs)
        assert np.array_equal(got["lens"][:hn].numpy(), hl)


@pytest.mark.parametrize("blob", [
    b"5 hello14 hello world!!3 abc12 trunc", b"", b"0 0 0 ", b"x 1",
    b"99999999999 a", b"2147483648 a", b"3 abc 4 abcd", b"12"],
    ids=["chain", "empty", "zeros", "bad", "huge", "int32-max", "space-tail",
         "prefix-only"])
def test_host_scan_matches_jax(blob):
    """The port's pure-Python host scan equals the JAX package's."""
    got = tsplitters._scan_syslen_region(blob)
    ref = jsplitters._scan_syslen_region(blob)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert tuple(got[2:]) == tuple(ref[2:])


@pytest.mark.parametrize("cut", [0, 5])
def test_device_frame_region_matches_host_scan(cut):
    """The packed tuple of the port's device framing (plain versions on
    the CPU) equals the host scan + pack of the same region, with the
    gather at ``bucket_rows(n)`` rows (ncap, from the space count, is
    only an upper bound)."""
    lines, _ = make_corpus(300, seed=31)
    region = syslen_stream(lines, cut=cut)
    packed, consumed, err = F.device_frame_region(
        region, "syslen", MAX_LEN, n_records=region.count(b" "),
        device=torch.device("cpu"))
    starts, lens, n, hcons, herr = tsplitters._scan_syslen_region(region)
    ref = pack.pack_spans_2d(region[:hcons], starts, lens, MAX_LEN)
    assert (consumed, err, packed[5]) == (hcons, herr, n)
    assert n == (300 if cut == 0 else 299)
    assert packed[0].shape == (pack.bucket_rows(n), MAX_LEN)
    assert np.array_equal(packed[0].numpy(), ref[0])
    assert np.array_equal(packed[1].numpy(), ref[1])
    assert np.array_equal(packed[3], ref[3])
    assert np.array_equal(packed[4], ref[4])


def test_oversized_prefix_declines():
    """A reachable prefix of more than nine digits is the host's to
    frame: the device tier declines the region."""
    with pytest.raises(F.FramingDeclined):
        F.device_frame_region(b"2 ab0000000003 abc", "syslen", MAX_LEN,
                              n_records=2, device=torch.device("cpu"))


class _Stream:
    """Reads from a list of chunks; a ``TimeoutError`` item raises (an
    idle connection)."""

    def __init__(self, items):
        self.items = list(items)

    def read(self, n):
        if not self.items:
            return b""
        item = self.items.pop(0)
        if item is TimeoutError:
            raise TimeoutError()
        return item


def _frames(*bodies):
    return b"".join(b"%d %s" % (len(b), b) for b in bodies)


def _pieces(data, size):
    return [data[i:i + size] for i in range(0, len(data), size)]


GOOD = b"<13>1 2015-08-05T15:53:45Z host app 1 ID - hello"
BAD = b"<13>2 2015-08-05T15:53:45Z h a p m - version"

STREAMS = {
    "short-read": [_frames(GOOD, BAD), b"40 <13>1 2015"],
    "bad-prefix": [_frames(GOOD), b"1x2 ", _frames(GOOD)],
    "idle-between-frames": [_frames(GOOD, GOOD), TimeoutError],
    "idle-mid-body": [_frames(GOOD), b"99 <13>1", TimeoutError],
    "idle-mid-prefix": [_frames(GOOD), b"12", TimeoutError],
    "eof-mid-prefix": [_frames(GOOD, BAD), b"12"],
    "chunked": _pieces(_frames(GOOD, BAD, GOOD, b"", GOOD), 7),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_syslen_splitter_stderr_parity(capsys, name):
    """The port's raw-session syslen path prints what the JAX package's
    host splitter prints (per-record errors, then the short-read, idle or
    bad-length message) and emits the same GELF records."""
    jenc = JGelfEncoder(JConfig.from_string(""))
    jtx = queue.Queue()
    jhandler = jsplitters.ScalarHandler(jtx, JRFC5424Decoder(), jenc)
    jsplitters.SyslenSplitter().run(_Stream(STREAMS[name]), jhandler)
    jerr = capsys.readouterr().err.splitlines()
    want = [jtx.get_nowait() for _ in range(jtx.qsize())]

    cfg = Config.from_string("[input]\ntpu_encode_economics = false\n"
                             "tpu_batch_size = 2\n")
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, None,
                           torch.device("cpu"), start_timer=False)
    tsplitters.SyslenSplitter().run(_Stream(STREAMS[name]), handler)
    err = capsys.readouterr().err.splitlines()
    got = [m for _ in range(tx.qsize()) for m in tx.get_nowait().iter_unframed()]
    assert err == jerr and err
    assert got == want


class _Chunks:
    def __init__(self, data, size):
        self.buf = io.BytesIO(data)
        self.size = size

    def read(self, n):
        return self.buf.read(min(n, self.size))


@pytest.mark.parametrize("chunk,batch,n_lines", [
    (61, 64, 120), (4093, 300, 300), (1 << 16, 16384, 500)])
def test_batch_handler_syslen_across_chunk_and_flush_boundaries(
        capsys, chunk, batch, n_lines):
    lines, _ = make_corpus(n_lines, seed=12)
    data = syslen_stream(lines)
    # a narrow batch keeps the CPU decode of every small flush cheap;
    # longer lines take the scalar oracle
    cfg = Config.from_string(f"[input]\ntpu_encode_economics = false\n"
                             f"tpu_batch_size = {batch}\n"
                             "tpu_max_line_len = 128\n")
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, NulMerger(),
                           torch.device("cpu"), start_timer=False)
    tsplitters.SyslenSplitter().run(_Chunks(data, chunk), handler)
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(data, "syslen")
    assert got == exp
    assert capsys.readouterr().err.splitlines() == errs
    assert errs[-1] == "failed to fill whole buffer"


def test_batch_handler_reframes_declined_region(capsys):
    """A ten-digit prefix declines the device tier; the host scan frames
    the same bytes and the output is unchanged."""
    lines, _ = make_corpus(40, seed=3)
    data = syslen_stream(lines[:20], cut=0) + b"%010d " % len(lines[20]) \
        + lines[20] + syslen_stream(lines[21:], cut=0)
    cfg = Config.from_string("")
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, NulMerger(),
                           torch.device("cpu"), start_timer=False)
    before = F.DECLINES["syslen"]
    tsplitters.SyslenSplitter().run(_Chunks(data, 1 << 16), handler)
    assert F.DECLINES["syslen"] == before + 1
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(data, "syslen")
    assert got == exp and len(exp) > 0
    assert capsys.readouterr().err.splitlines() == errs


def test_cli_syslen_matches_jax_package(tmp_path):
    """``framing = "syslen"`` through both CLIs: the same output bytes
    and stderr lines.  The JAX package prints its end-of-stream message
    before its block pipeline drains the per-record errors, so its lines
    are compared as a multiset, and in order once that message is taken
    out; the port's order is the scalar path's."""
    lines, _ = make_corpus(600, seed=23)
    data = syslen_stream(lines)
    assert len(data) > 1 << 16
    outs = {}
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               FLOWGGER_DEVICE_ENCODE="0", PYTHONPATH=str(ROOT))
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "rfc5424_tpu"\n'
            'framing = "syslen"\ntpu_flush_ms = 600000\ntpu_fuse = "off"\n'
            '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\n')
        extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
        proc = subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                              input=data, capture_output=True, env=env,
                              cwd=str(ROOT), timeout=300)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (out.read_bytes(), proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    exp, errs = scalar_expectation(data, "syslen")
    assert port[0] == ref[0] == exp
    assert port[1] == errs and sorted(ref[1]) == sorted(errs)
    assert errs[-1] == "failed to fill whole buffer"
    # the end-of-stream message is the only line the reference reorders
    assert ref[1].count(errs[-1]) == 1
    assert [ln for ln in ref[1] if ln != errs[-1]] == errs[:-1]
