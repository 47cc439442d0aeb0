"""The port's LTSV output on the CPU, against the JAX package.

- Each input's LTSV block encoder (``encode_ltsv_block``'s rfc5424,
  rfc3164, ltsv and gelf encoders, ``encode_jsonl_block.
  encode_jsonl_ltsv_block``) against the reference's, fed the same
  decode channels (the port's plain decodes, which their own tests hold
  equal to the reference's), × line / NUL / syslen mergers, with and
  without an ``ltsv_extra`` whose key holds a ':' and a leading '_' and
  whose value holds a tab: block bytes and bounds, errors, oracle rows;
  and the scalar path's bytes.
- ``LTSVEncoder`` against the reference's on the Records every scalar
  decoder makes of its corpus (with and without the extra).
- The Record path into LTSV: an ltsv handler with
  ``corpus.LTSV_SCHEMA_10`` (the block route refuses a typed schema and
  says so at start-up, as the reference does) writes the scalar path's
  bytes; and the rest of the ladder on the CPU: a handler of every input
  into LTSV writes the scalar path's bytes and stderr.
"""

import contextlib
import io
import queue
import time

import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders import gelf as rgelf
from flowgger_tpu.decoders import jsonl as rjsonl
from flowgger_tpu.decoders import ltsv as rltsv
from flowgger_tpu.decoders import rfc3164 as r3164
from flowgger_tpu.decoders import rfc5424 as r5424
from flowgger_tpu.decoders.dns import DNSDecoder as RDNSDecoder
from flowgger_tpu.encoders.ltsv import LTSVEncoder as RLTSVEncoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import encode_jsonl_block as RJB
from flowgger_tpu.tpu import encode_ltsv_block as RLB

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (LTSV_SCHEMA_10, make_corpus,
                                       make_dns_corpus, make_gelf_tier_corpus,
                                       make_jsonl_corpus, make_ltsv_corpus,
                                       make_ltsv_out_tier_corpus,
                                       make_rfc3164_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.decoders import (DecodeError, DNSDecoder,
                                         GelfDecoder, JSONLDecoder,
                                         LTSVDecoder, RFC3164Decoder,
                                         RFC5424Decoder)
from flowgger_tpu_torch.encoders import LTSVEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import encode_jsonl_block as JB
from flowgger_tpu_torch.tpu import encode_ltsv_block as LB
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import _ROUTES, BatchHandler, block_submit

L = 256
T0 = time.time() - 1.0
EXTRA = ('[output.ltsv_extra]\n"_zone:a" = "eu\\tw1"\nrelay = "r1"\n'
         '"_" = "u"\n')
MERGERS = [(LineMerger, RLineMerger), (NulMerger, RNulMerger),
           (SyslenMerger, RSyslenMerger)]


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


def _corpus(fmt):
    if fmt == "rfc5424":
        return (make_ltsv_out_tier_corpus(200, 71)[0]
                + make_corpus(300, 72)[0]
                + [b'<13>1 2015-08-05T15:53:45Z h a p m [x k:y="v"] colon',
                   b"<13>1 2015-08-05T15:53:45Z h a p m - tab\there",
                   b"<165>1 2015-08-05T15:53:45Z h a p m - fac 20"])
    if fmt == "rfc3164":
        return make_rfc3164_corpus(400, 73)[0]
    if fmt == "ltsv":
        return make_ltsv_corpus(400, 74)[0] + [
            b"time:1\thost:h\tmessage:m\tmessage:twice",
            b"time:1.5\thost:h\tlevel:3\tk:v\x0bw"]
    if fmt == "gelf":
        return make_gelf_tier_corpus(400, 75)[0] + [
            b'{"version":"1.1","host":"h","short_message":"m",'
            b'"timestamp":1.5,"_a":1,"_a":2}',
            b'{"version":"1.1","host":"h","short_message":"m",'
            b'"timestamp":2,"_t":true,"_f":false,"_n":null}']
    return [ln for ln, k in zip(*make_jsonl_corpus(600, 76))
            if k != "long"][:400] + [
        b'{"timestamp":1,"host":"h","message":"m","a:b":1}',
        b'{"timestamp":1,"host":"h","message":"m","_x":"y","z":true}']


def _encoders(fmt, toml):
    if fmt == "ltsv":
        return (LB.encode_ltsv_ltsv_block, RLB.encode_ltsv_ltsv_block,
                (LTSVDecoder(Config.from_string("")),),
                (rltsv.LTSVDecoder(RConfig.from_string("")),))
    return ({"rfc5424": LB.encode_rfc5424_ltsv_block,
             "rfc3164": LB.encode_rfc3164_ltsv_block,
             "gelf": LB.encode_gelf_ltsv_block,
             "jsonl": JB.encode_jsonl_ltsv_block}[fmt],
            {"rfc5424": RLB.encode_rfc5424_ltsv_block,
             "rfc3164": RLB.encode_rfc3164_ltsv_block,
             "gelf": RLB.encode_gelf_ltsv_block,
             "jsonl": RJB.encode_jsonl_ltsv_block}[fmt], (), ())


@pytest.mark.parametrize("extra", [False, True], ids=["plain", "extra"])
@pytest.mark.parametrize("merger", MERGERS, ids=["line", "nul", "syslen"])
@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164", "ltsv", "gelf",
                                 "jsonl"])
def test_ltsv_block_matches_reference(fmt, merger, extra):
    lines = _corpus(fmt)
    packed = pack.pack_lines_2d(lines, L)
    batch, lens, chunk, starts, orig, n = packed
    tp = (torch.from_numpy(batch), torch.from_numpy(lens)) + packed[2:]
    host = _ROUTES[fmt][1](block_submit(fmt, tp))
    toml = EXTRA if extra else ""
    enc = LTSVEncoder(Config.from_string(toml))
    renc = RLTSVEncoder(RConfig.from_string(toml))
    fn, rfn, dec, rdec = _encoders(fmt, toml)
    m, rm = merger[0](), merger[1]()
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(said):
        got = fn(chunk, starts, orig, host, n, L, enc, m, *dec)
    with contextlib.redirect_stdout(rsaid):
        want = rfn(chunk, starts, orig, dict(host), n, L, renc, rm, *rdec)
    assert got.block.data == want.block.data
    assert np.array_equal(got.block.bounds, want.block.bounds)
    assert got.errors == want.errors
    assert got.fallback_rows == want.fallback_rows
    assert said.getvalue() == rsaid.getvalue()
    # both tiers of the block: rows it writes, rows of the oracle
    assert 0 < got.fallback_rows < n
    exp, _ = scalar_expectation(b"\n".join(lines) + b"\n",
                                config=Config.from_string(toml), merger=m,
                                fmt=fmt, output="ltsv")
    assert got.block.data == exp
    if extra:
        assert b"zone_a:eu w1\trelay:r1\t:u\t" in got.block.data


def test_gelf_colon_key_follows_the_reference_block():
    """A gelf key with a ':' into LTSV: the reference's block encoder
    (``encode_gelf_ltsv_block``) writes the key raw, where its scalar path
    (LTSVEncoder's key escape) writes '_'.  The port's block follows the
    reference's block byte for byte (ROADMAP queue C)."""
    line = (b'{"version":"1.1","host":"h","short_message":"m",'
            b'"timestamp":2,"_k:x":"v"}')
    packed = pack.pack_lines_2d([line], L)
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    host = _ROUTES["gelf"][1](block_submit("gelf", tp))
    got = LB.encode_gelf_ltsv_block(*packed[2:5], host, packed[5], L,
                                    LTSVEncoder(Config.from_string("")),
                                    LineMerger())
    want = RLB.encode_gelf_ltsv_block(*packed[2:5], dict(host), packed[5], L,
                                      RLTSVEncoder(RConfig.from_string("")),
                                      RLineMerger())
    assert got.block.data == want.block.data == \
        b"k:x:v\thost:h\ttime:2\tmessage:m\n"
    exp, _ = scalar_expectation(line + b"\n", merger=LineMerger(),
                                fmt="gelf", output="ltsv")
    assert exp == b"k_x:v\thost:h\ttime:2\tmessage:m\n"


_DECODERS = {
    "rfc5424": (RFC5424Decoder, r5424.RFC5424Decoder, make_corpus),
    "rfc3164": (RFC3164Decoder, r3164.RFC3164Decoder, make_rfc3164_corpus),
    "gelf": (GelfDecoder, rgelf.GelfDecoder, make_gelf_tier_corpus),
    "jsonl": (JSONLDecoder, rjsonl.JSONLDecoder, make_jsonl_corpus),
    "dns": (DNSDecoder, RDNSDecoder, make_dns_corpus),
}


@pytest.mark.parametrize("extra", [False, True], ids=["plain", "extra"])
def test_ltsv_encoder_matches_reference(extra):
    """The Record path's encoder: every scalar decoder's Records of its
    corpus (and the ltsv decoder's with a typed schema) through both
    packages' LTSVEncoder, byte for byte."""
    toml = EXTRA if extra else ""
    enc = LTSVEncoder(Config.from_string(toml))
    renc = RLTSVEncoder(RConfig.from_string(toml))
    pairs = [(make(300, 77)[0], dec(), rdec())
             for dec, rdec, make in _DECODERS.values()]
    pairs.append((make_ltsv_corpus(300, 78)[0],
                  LTSVDecoder(Config.from_string(LTSV_SCHEMA_10)),
                  rltsv.LTSVDecoder(RConfig.from_string(LTSV_SCHEMA_10))))
    n_ok = 0
    for lines, dec, rdec in pairs:
        for raw in lines:
            try:
                line = raw.decode("utf-8")
            except UnicodeDecodeError:
                continue
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                try:
                    rec = dec.decode(line)
                except DecodeError:
                    rec = None
                try:
                    rrec = rdec.decode(line)
                except Exception:  # noqa: BLE001 - the reference's DecodeError
                    rrec = None
            assert (rec is None) == (rrec is None), raw
            if rec is not None:
                if rec.ts >= T0:
                    # a row without a stamp: both take the wall clock
                    rec.ts = rrec.ts = 0.0
                assert enc.encode(rec) == renc.encode(rrec), raw
                n_ok += 1
    assert n_ok > 1000


def _handler(fmt, toml, lines, framing="line"):
    config = Config.from_string("[input]\ntpu_encode_economics = false\n"
                                "tpu_batch_size = 256\n" + toml)
    tx = queue.Queue()
    data = b"\n".join(lines) + b"\n"
    err, said = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(said):
        h = BatchHandler(tx, LTSVEncoder(config), config, LineMerger(),
                         torch.device("cpu"), start_timer=False, fmt=fmt)
        sess = h.open_raw(framing)
        for i in range(0, len(data), 9000):
            sess.push(data[i:i + 9000])
        sess.finish()
        h.flush()
    got = []
    while not tx.empty():
        item = tx.get_nowait()
        got.append(item.data if hasattr(item, "data") else
                   LineMerger().frame(item))
    exp, errs = scalar_expectation(data, config=config, merger=LineMerger(),
                                   fmt=fmt, output="ltsv")
    return h, b"".join(got), err.getvalue().splitlines(), exp, errs


def test_record_path_ltsv_schema_into_ltsv():
    """ltsv with the 10-key typed schema into LTSV: the start-up notice,
    then one Record a row, the scalar path's bytes."""
    lines = make_ltsv_corpus(400, 79)[0]
    h, got, err, exp, errs = _handler("ltsv", LTSV_SCHEMA_10, lines)
    assert not h._block_ok
    assert err[0] == (
        "flowgger-tpu: columnar block route disabled for format 'ltsv' "
        "(input.ltsv_schema is set); throughput falls to the per-record "
        "path (~30x slower)")
    assert got == exp and err[1:] == errs and len(got) > 10000


@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164", "ltsv", "gelf",
                                 "jsonl", "dns"])
def test_handler_into_ltsv_matches_scalar_path(fmt):
    lines = _corpus(fmt) if fmt != "dns" else make_dns_corpus(600, 80)[0]
    h, got, err, exp, errs = _handler(fmt, EXTRA, lines)
    assert h._block_ok
    assert got == exp and len(got) > 10000
    if fmt == "rfc3164":
        # the rfc3164 decoder prints its own line before a batch's error
        # lines: each kind in order
        assert sorted(err) == sorted(errs)
    else:
        assert err == errs
