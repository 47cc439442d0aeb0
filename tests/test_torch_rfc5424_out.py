"""The port's RFC5424 output on the CPU, against the JAX package.

- ``RFC5424Encoder``, ``unix_to_rfc3339_ms`` and ``format_rfc3164_header_
  ts`` against the reference's: the float64 millisecond truncation
  (``.002`` comes out ``.001``), a zero fraction (dropped), a ``+02:00``
  offset, pre-1970 stamps, five-digit years, and a missing facility
  (the ``<13>`` default), on the Records every scalar decoder makes of
  its corpus.
- Each input's RFC5424 block encoder (``encode_rfc5424_block``'s rfc5424,
  rfc3164, gelf and ltsv encoders) against the reference's, fed the same
  decode channels (the port's plain decodes, which their own tests hold
  equal to the reference's), × line / NUL / syslen mergers: block bytes
  and bounds, errors, oracle rows; and the scalar path's bytes.
- The native ``fg_r5`` row writer against the numpy segment plan beside
  it (``native.r5_rows_available`` patched to False), × the three
  mergers.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders import gelf as rgelf
from flowgger_tpu.decoders import jsonl as rjsonl
from flowgger_tpu.decoders import ltsv as rltsv
from flowgger_tpu.decoders import rfc3164 as r3164
from flowgger_tpu.decoders import rfc5424 as r5424
from flowgger_tpu.encoders.rfc3164 import RFC3164Encoder as RRFC3164Encoder
from flowgger_tpu.encoders.rfc5424 import RFC5424Encoder as RRFC5424Encoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import encode_rfc5424_block as RRB
from flowgger_tpu.utils import timeparse as RT

from flowgger_tpu_torch import native
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_gelf_tier_corpus,
                                       make_jsonl_corpus, make_ltsv_corpus,
                                       make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, scalar_expectation)
from flowgger_tpu_torch.decoders import (DecodeError, GelfDecoder,
                                         JSONLDecoder, LTSVDecoder,
                                         RFC3164Decoder, RFC5424Decoder)
from flowgger_tpu_torch.encoders import (EncodeError, RFC3164Encoder,
                                         RFC5424Encoder)
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.record import Record
from flowgger_tpu_torch.tpu import encode_rfc5424_block as RB
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import _ROUTES, block_submit
from flowgger_tpu_torch.utils import timeparse as T

L = 256
MERGERS = [(LineMerger, RLineMerger), (NulMerger, RNulMerger),
           (SyslenMerger, RSyslenMerger)]
STAMPS = (1672740000.002, 1672740000.0, 1672732800.5, 1438790025.637824,
          0.0, -0.001, -1.5, -86400.25, -62135596800.0, 253402300799.999,
          253402300800.0, 32503680000.125, 1e-9, 1760000000.999999)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_timestamp_renderers_match_reference():
    """unix_to_rfc3339_ms (float64 millisecond truncation, floor division
    for pre-1970 stamps, five-digit years), format_rfc3164_header_ts and
    the prepend format against the reference's."""
    for ts in STAMPS:
        assert T.unix_to_rfc3339_ms(ts) == RT.unix_to_rfc3339_ms(ts), ts
        assert T.format_rfc3164_header_ts(ts) == \
            RT.format_rfc3164_header_ts(ts), ts
        for fmt in ("[year][month][day]T[hour][minute][second]Z",
                    "[month repr:short] [day padding:none] [day] x "):
            assert T.format_time_description(fmt, ts) == \
                RT.format_time_description(fmt, ts)
    # a decoded .002 lies just under it in float64
    ms2 = T.rfc3339_to_unix("2023-01-03T10:00:00.002Z")
    assert ms2 == RT.rfc3339_to_unix("2023-01-03T10:00:00.002Z")
    assert T.unix_to_rfc3339_ms(ms2) == "2023-01-03T10:00:00.001Z"
    assert T.unix_to_rfc3339_ms(1672740000.0) == "2023-01-03T10:00:00Z"
    for z in range(-800000, 3000000, 9973):
        assert T.civil_from_days(z) == RT.civil_from_days(z)
    with pytest.raises(ValueError):
        T.format_time_description("[week]", 0.0)


def test_rfc5424_encoder_matches_reference():
    """RFC5424Encoder on the Records every scalar decoder makes of its
    corpus, plus a '+02:00' stamp, a missing facility and an absent
    appname, against the reference's; the error strings are the
    reference's."""
    enc, renc = RFC5424Encoder(), RRFC5424Encoder()
    rows = [(make_corpus(300, 80)[0], RFC5424Decoder(),
             r5424.RFC5424Decoder()),
            (make_rfc3164_corpus(300, 81)[0], RFC3164Decoder(),
             r3164.RFC3164Decoder()),
            (make_gelf_tier_corpus(200, 82)[0], GelfDecoder(),
             rgelf.GelfDecoder()),
            (make_jsonl_corpus(200, 83)[0], JSONLDecoder(),
             rjsonl.JSONLDecoder()),
            (make_ltsv_corpus(200, 84)[0],
             LTSVDecoder(Config.from_string("")),
             rltsv.LTSVDecoder(RConfig.from_string("")))]
    extra = [b"<13>1 2023-01-03T10:00:00.000+02:00 h a p m - off",
             b"<13>1 1969-12-31T23:59:59.999Z h - - - - pre-1970",
             b"<190>1 2023-01-03T10:00:00.002Z h a p m [x a=\"b\"] ms"]
    rows.append((extra, RFC5424Decoder(), r5424.RFC5424Decoder()))
    n = 0
    for lines, dec, rdec in rows:
        for raw in lines:
            line = raw.decode("utf-8", "replace")
            said = io.StringIO()
            with contextlib.redirect_stdout(said), \
                    contextlib.redirect_stderr(said):
                try:
                    rec = dec.decode(line)
                    rrec = rdec.decode(line)
                except (DecodeError, Exception):
                    continue
            assert enc.encode(rec) == renc.encode(rrec), line
            n += 1
    assert n > 800
    bare = Record(ts=1438790025.5, hostname="h", facility=None,
                  severity=None, appname=None, procid=None, msgid=None,
                  msg=None, full_msg=None, sd=None)
    assert enc.encode(bare) == b"<13>1 2015-08-05T15:53:45.5Z h - - - "
    with pytest.raises(EncodeError, match="Failed to parse date"):
        enc.encode(Record(ts=float("nan"), hostname="h", facility=None,
                          severity=None, appname=None, procid=None,
                          msgid=None, msg=None, full_msg=None, sd=None))
    with pytest.raises(EncodeError,
                       match="Failed to parse unix timestamp in RFC3164"):
        RFC3164Encoder(Config.from_string("")).encode(
            Record(ts=float("inf"), hostname="h", facility=None,
                   severity=None, appname=None, procid=None, msgid=None,
                   msg=None, full_msg=None, sd=None))
    r3 = RFC3164Encoder(Config.from_string(""))
    rr3 = RRFC3164Encoder(RConfig.from_string(""))
    for raw in make_rfc3164_corpus(100, 85)[0] + make_corpus(100, 86)[0]:
        line = raw.decode("utf-8", "replace")
        for dec, rdec in ((RFC3164Decoder(), r3164.RFC3164Decoder()),
                          (RFC5424Decoder(), r5424.RFC5424Decoder())):
            said = io.StringIO()
            with contextlib.redirect_stderr(said):
                try:
                    rec, rrec = dec.decode(line), rdec.decode(line)
                except Exception:
                    continue
            assert r3.encode(rec) == rr3.encode(rrec)


def _corpus(fmt):
    if fmt == "rfc5424":
        return (make_tier_corpus(200, 91)[0] + make_corpus(300, 92)[0]
                + [b'<13>1 2015-08-05T15:53:45Z h a p m [a][b c="d"][e] x',
                   b'<13>1 2015-08-05T15:53:45Z h a p m [x k="a\\"b"] esc',
                   b"<191>1 2023-01-03T10:00:00.002Z h - - - - ms"])
    if fmt == "rfc3164":
        return (make_rfc3164_tier_corpus(200, 93)[0]
                + make_rfc3164_corpus(200, 94)[0])
    if fmt == "ltsv":
        return make_ltsv_corpus(400, 95)[0] + [
            b"time:1\thost:h\tmessage:m\tmessage:twice",
            b"time:1.5\thost:h\tlevel:3\tk:v"]
    return make_gelf_tier_corpus(400, 96)[0] + [
        b'{"version":"1.1","host":"h","short_message":"m",'
        b'"timestamp":1.5,"_a":1,"_a":2}',
        b'{"version":"1.1","host":"h","short_message":"m",'
        b'"timestamp":2,"_t":true,"_f":false,"_n":null}']


_BLOCKS = {"rfc5424": ("encode_rfc5424_rfc5424_block",),
           "rfc3164": ("encode_rfc3164_rfc5424_block",),
           "gelf": ("encode_gelf_rfc5424_block",),
           "ltsv": ("encode_ltsv_rfc5424_block",)}


def _host(fmt, packed):
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    return _ROUTES[fmt][1](block_submit(fmt, tp))


@pytest.mark.parametrize("merger", MERGERS, ids=["line", "nul", "syslen"])
@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164", "gelf", "ltsv"])
def test_block_encoders_match_reference(fmt, merger):
    lines = _corpus(fmt)
    packed = pack.pack_lines_2d(lines, L)
    chunk, starts, orig, n = packed[2:]
    host = _host(fmt, packed)
    name = _BLOCKS[fmt][0]
    fn, rfn = getattr(RB, name), getattr(RRB, name)
    dec = (LTSVDecoder(Config.from_string("")),) if fmt == "ltsv" else ()
    rdec = (rltsv.LTSVDecoder(RConfig.from_string("")),) \
        if fmt == "ltsv" else ()
    m, rm = merger[0](), merger[1]()
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(said):
        got = fn(chunk, starts, orig, host, n, L, RFC5424Encoder(), m, *dec)
    with contextlib.redirect_stdout(rsaid):
        want = rfn(chunk, starts, orig, dict(host), n, L, RRFC5424Encoder(),
                   rm, *rdec)
    assert got.block.data == want.block.data
    assert np.array_equal(got.block.bounds, want.block.bounds)
    if want.block.prefix_lens is not None:
        assert np.array_equal(got.block.prefix_lens, want.block.prefix_lens)
    assert got.errors == want.errors
    assert got.fallback_rows == want.fallback_rows
    assert said.getvalue() == rsaid.getvalue()
    assert 0 < got.fallback_rows < n
    exp, _ = scalar_expectation(b"\n".join(lines) + b"\n", merger=m,
                                fmt=fmt, output="rfc5424")
    assert got.block.data == exp


@pytest.mark.parametrize("merger", MERGERS, ids=["line", "nul", "syslen"])
def test_native_rows_match_numpy(monkeypatch, merger):
    """The rfc5424 → RFC5424 block through the native fg_r5 row writer
    and through the numpy segment plan: the same block, and the writer
    ran once per block."""
    lines = _corpus("rfc5424")
    packed = pack.pack_lines_2d(lines, L)
    chunk, starts, orig, n = packed[2:]
    host = _host("rfc5424", packed)
    native.reset_calls()
    got = RB.encode_rfc5424_rfc5424_block(chunk, starts, orig, host, n, L,
                                          RFC5424Encoder(), merger[0]())
    assert native.CALLS["fg_r5_lens"] == native.CALLS["fg_r5_write"] == 1
    monkeypatch.setattr(native, "r5_rows_available", lambda: False)
    want = RB.encode_rfc5424_rfc5424_block(chunk, starts, orig, host, n, L,
                                           RFC5424Encoder(), merger[0]())
    assert native.CALLS["fg_r5_write"] == 1
    assert got.block.data == want.block.data
    assert np.array_equal(got.block.bounds, want.block.bounds)
    if want.block.prefix_lens is not None:
        assert np.array_equal(got.block.prefix_lens, want.block.prefix_lens)
    assert got.errors == want.errors
