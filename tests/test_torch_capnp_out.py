"""The port's Cap'n Proto output on the CPU, against the JAX package.

- ``capnp_wire.encode_record`` and ``CapnpEncoder`` against the
  reference's: the Records every scalar decoder makes of its corpus
  (typed GELF values among them), Records with every value kind (string,
  bool, f64, i64, u64, null), a missing facility and severity (0xff),
  several SD blocks (only ``sd[0]`` is written) and a ``capnp_extra``;
  the encoder's ConfigError on a non-string extra.
- Each input's capnp block encoder (``encode_capnp_block``'s rfc5424,
  rfc3164, ltsv and gelf encoders) against the reference's, fed the same
  decode channels (the port's plain decodes, which their own tests hold
  equal to the reference's), × noop / line / NUL / syslen framing, with
  and without a ``capnp_extra``: block bytes and bounds, errors, oracle
  rows; the scalar path's bytes; and every emitted message parsed back
  by the reference's reader (``flowgger_tpu.capnp_wire.parse_message``)
  into the Record the scalar decoder made of its line.
- The gelf block's typed values: true / false / null, negative, 18- and
  19-digit and >= 2**63 integers, floats and duplicate keys.
- ``corpus.mask_capnp_stamps`` on every framing.
"""

import contextlib
import io
import time

import numpy as np
import pytest
import torch

from flowgger_tpu import capnp_wire as RW
from flowgger_tpu import record as RR
from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders import gelf as rgelf
from flowgger_tpu.decoders import jsonl as rjsonl
from flowgger_tpu.decoders import ltsv as rltsv
from flowgger_tpu.decoders import rfc3164 as r3164
from flowgger_tpu.decoders import rfc5424 as r5424
from flowgger_tpu.encoders.capnp import CapnpEncoder as RCapnpEncoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import encode_capnp_block as RCB

from flowgger_tpu_torch import capnp_wire as W
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import (make_corpus, make_gelf_corpus,
                                       make_gelf_tier_corpus,
                                       make_jsonl_corpus, make_ltsv_corpus,
                                       make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, capnp_messages,
                                       mask_capnp_stamps, scalar_expectation)
from flowgger_tpu_torch.decoders import (GelfDecoder, JSONLDecoder,
                                         LTSVDecoder, RFC3164Decoder,
                                         RFC5424Decoder)
from flowgger_tpu_torch.encoders import CapnpEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.record import Record, SDValue, StructuredData
from flowgger_tpu_torch.tpu import encode_capnp_block as CB
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import _ROUTES, block_submit

L = 256
MERGERS = [(None, None), (LineMerger, RLineMerger), (NulMerger, RNulMerger),
           (SyslenMerger, RSyslenMerger)]
EXTRA = '[output.capnp_extra]\nenv = "prod"\ndc = "eu-west-1"\n'


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet(fn, *a):
    said = io.StringIO()
    with contextlib.redirect_stdout(said), contextlib.redirect_stderr(said):
        return fn(*a)


def test_capnp_encoder_matches_reference():
    """CapnpEncoder on the Records every scalar decoder makes of its
    corpus, with and without a capnp_extra, against the reference's."""
    rows = [(make_corpus(200, 70)[0], RFC5424Decoder(),
             r5424.RFC5424Decoder()),
            (make_rfc3164_corpus(200, 71)[0], RFC3164Decoder(),
             r3164.RFC3164Decoder()),
            (make_gelf_corpus(200, 72)[0], GelfDecoder(),
             rgelf.GelfDecoder()),
            (make_jsonl_corpus(200, 73)[0], JSONLDecoder(),
             rjsonl.JSONLDecoder()),
            (make_ltsv_corpus(200, 74)[0],
             LTSVDecoder(Config.from_string("")),
             rltsv.LTSVDecoder(RConfig.from_string("")))]
    n = 0
    t0 = time.time() - 1.0
    for text in ("", EXTRA):
        enc = CapnpEncoder(Config.from_string(text))
        renc = RCapnpEncoder(RConfig.from_string(text))
        assert enc.extra == renc.extra
        for lines, dec, rdec in rows:
            for raw in lines:
                line = raw.decode("utf-8", "replace")
                try:
                    rec = _quiet(dec.decode, line)
                    rrec = _quiet(rdec.decode, line)
                except Exception:
                    continue
                if rrec.ts >= t0:
                    # a gelf or jsonl row without a stamp takes the wall
                    # clock in both packages
                    assert rec.ts >= t0
                    rec.ts = rrec.ts
                assert enc.encode(rec) == renc.encode(rrec), line
                n += 1
    assert n > 1200
    with pytest.raises(ConfigError, match="values must be strings"):
        CapnpEncoder(Config.from_string("[output.capnp_extra]\nx = 1\n"))


def _record(mod, i, fac, sev, sd, msg):
    """One Record of the port (``mod`` its record module, ``i`` 0) or of
    the reference (1); ``sd`` a list of (sd_id, [(name, port value,
    reference value)])."""
    sds = None if sd is None else [
        mod.StructuredData(sid, [(k, p[i]) for k, *p in ps])
        for sid, ps in sd]
    return mod.Record(ts=1438790025.637824, hostname="h", facility=fac,
                      severity=sev, appname="app" if msg else None,
                      procid=None, msgid="id" if msg else None, msg=msg,
                      full_msg="full" if msg else None, sd=sds)


def test_encode_record_typed_values_and_gates():
    """encode_record's union discriminants (bool at bit 16, f64 / i64 /
    u64 in data word 1, null a discriminant only), the 0xff of a missing
    facility or severity, only sd[0] written, absent optional texts and
    extras, against the reference's."""
    import flowgger_tpu_torch.record as PR

    values = [("string", ("v",)), ("string", ("",)), ("bool_", (True,)),
              ("bool_", (False,)), ("f64", (1.5,)), ("f64", (-0.0,)),
              ("i64", (-42,)), ("u64", (2 ** 64 - 1,)), ("u64", (0,)),
              ("null", ())]
    pairs = [(f"_k{i}", getattr(SDValue, kind)(*v),
              getattr(RR.SDValue, kind)(*v))
             for i, (kind, v) in enumerate(values)]
    for fac, sev in ((None, None), (3, 6), (23, None)):
        for sd in (None, [("id@1", pairs)],
                   [(None, pairs[:3]), ("b", pairs[3:])]):
            for msg in (None, "", "m"):
                for extra in ([], [("env", "prod"), ("dc", "eu")]):
                    got = W.encode_record(
                        _record(PR, 0, fac, sev, sd, msg), extra)
                    assert got == RW.encode_record(
                        _record(RR, 1, fac, sev, sd, msg), extra)
                    back = RW.parse_message(got)
                    assert back.get_facility() == (0xFF if fac is None
                                                   else fac)
                    assert back.get_severity() == (0xFF if sev is None
                                                   else sev)
                    want = [] if sd is None else [
                        (k, r.kind, r.value) for k, _, r in sd[0][1]]
                    assert [(k, v.kind, v.value)
                            for k, v in back.get_pairs()] == want


def _corpus(fmt):
    if fmt == "rfc5424":
        return (make_tier_corpus(150, 81)[0] + make_corpus(200, 82)[0]
                + [b'<13>1 2015-08-05T15:53:45Z h a p m [a][b c="d"][e] x',
                   b'<13>1 2015-08-05T15:53:45Z h a p m [x k="a\\"b"] esc',
                   b'<13>1 2015-08-05T15:53:45Z h a p m [a b="1"]'
                   b'[c d="x\\"y"] esc in sd 1',
                   b'<13>1 2015-08-05T15:53:45Z - - - - -',
                   b'<13>1 2015-08-05T15:53:45Z h - - - [only] ',
                   b"<191>1 2023-01-03T10:00:00.002Z h - - - - ms"])
    if fmt == "rfc3164":
        return (make_rfc3164_tier_corpus(150, 83)[0]
                + make_rfc3164_corpus(150, 84)[0]
                + [b"<34>Oct 11 22:14:15 h", b"Oct 11 22:14:15 nopri x"])
    if fmt == "ltsv":
        return make_ltsv_corpus(300, 85)[0] + [
            b"time:1\thost:h\tmessage:m\tmessage:twice",
            b"time:1.5\thost:h\tlevel:3\tk:v",
            b"time:2015-08-05T15:53:45Z\thost:h\tk:v\tk2:"]
    return make_gelf_tier_corpus(300, 86)[0] + GELF_TYPED


GELF_HEAD = (b'{"version":"1.1","host":"h","short_message":"m",'
             b'"timestamp":1438790025.5')
GELF_TYPED = [GELF_HEAD + v + b"}" for v in (
    b',"_t":true,"_f":false,"_n":null',
    b',"_neg":-42,"_zero":0,"_s":"str"',
    b',"_d18":123456789012345678,"_nd18":-123456789012345678',
    b',"_d19":1234567890123456789',
    b',"_big":18446744073709551615',
    b',"_flt":1.5',
    b',"_a":1,"_a":2',
    b',"_e":"",' + b'"full_message":"f"',
    b'')]


def _same_record(back, rec, extra):
    """A message read back by the reference's reader holds ``rec``: its
    stamp, facility and severity (0xff when missing), texts (a null text
    reads ""), sd[0]'s id and typed pairs, and the extra pairs."""
    assert back.get_ts() == rec.ts
    assert back.get_facility() == (0xFF if rec.facility is None
                                   else rec.facility)
    assert back.get_severity() == (0xFF if rec.severity is None
                                   else rec.severity)
    for name in ("hostname", "appname", "procid", "msgid", "msg",
                 "full_msg"):
        assert getattr(back, f"get_{name}")() == (getattr(rec, name) or "")
    sd = rec.sd[0] if rec.sd else None
    assert back.get_sd_id() == ((sd.sd_id or "") if sd else "")
    pairs = [(k, v.kind, v.value) for k, v in back.get_pairs()]
    assert pairs == ([(k, v.kind, v.value) for k, v in sd.pairs] if sd
                     else [])
    assert [(k, v.value) for k, v in back.get_extra()] == list(extra)


def _host(fmt, packed):
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    return _ROUTES[fmt][1](block_submit(fmt, tp))


def _messages(data: bytes, framing: str):
    """The messages of a framed capnp block, in order."""
    return [data[a:b] for a, b in capnp_messages(data, framing)]


@pytest.mark.parametrize("extra", ["", EXTRA], ids=["plain", "extra"])
@pytest.mark.parametrize("merger", MERGERS,
                         ids=["noop", "line", "nul", "syslen"])
@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164", "ltsv", "gelf"])
def test_block_encoders_match_reference(fmt, merger, extra):
    lines = _corpus(fmt)
    packed = pack.pack_lines_2d(lines, L)
    chunk, starts, orig, n = packed[2:]
    host = _host(fmt, packed)
    fn = getattr(CB, f"encode_{fmt}_capnp_block")
    rfn = getattr(RCB, f"encode_{fmt}_capnp_block")
    dec = (LTSVDecoder(Config.from_string("")),) if fmt == "ltsv" else ()
    rdec = (rltsv.LTSVDecoder(RConfig.from_string("")),) \
        if fmt == "ltsv" else ()
    m = merger[0]() if merger[0] else None
    rm = merger[1]() if merger[1] else None
    enc = CapnpEncoder(Config.from_string(extra))
    renc = RCapnpEncoder(RConfig.from_string(extra))
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(said):
        got = fn(chunk, starts, orig, host, n, L, enc, m, *dec)
    with contextlib.redirect_stdout(rsaid):
        want = rfn(chunk, starts, orig, dict(host), n, L, renc, rm, *rdec)
    assert got.block.data == want.block.data
    assert np.array_equal(got.block.bounds, want.block.bounds)
    if want.block.prefix_lens is not None:
        assert np.array_equal(got.block.prefix_lens, want.block.prefix_lens)
    assert got.errors == want.errors
    assert got.fallback_rows == want.fallback_rows
    assert said.getvalue() == rsaid.getvalue()
    assert 0 < got.fallback_rows < n
    exp, _ = scalar_expectation(b"\n".join(lines) + b"\n", merger=m,
                                fmt=fmt, output="capnp",
                                config=Config.from_string(extra))
    assert got.block.data == exp
    # every message parses back with the reference's reader into its line
    # (the sdid's and the pairs' values as the scalar decoder reads them)
    framing = {None: "noop", LineMerger: "line", NulMerger: "nul",
               SyslenMerger: "syslen"}[merger[0]]
    msgs = _messages(got.block.data, framing)
    assert len(msgs) == int(got.emit.sum())
    decoder = {"rfc5424": RFC5424Decoder, "rfc3164": RFC3164Decoder,
               "gelf": GelfDecoder}.get(fmt, lambda: dec[0])()
    for i, msg in zip(np.flatnonzero(got.emit).tolist(), msgs):
        _same_record(RW.parse_message(msg),
                     _quiet(decoder.decode, lines[i].decode()), enc.extra)


def test_gelf_typed_values_take_the_tier_or_the_oracle():
    """The gelf block writes bools, null and integers of up to 18 digits
    as typed data on its tier; a 19-digit integer, a float and a
    duplicate key go to the oracle, as in the reference; both give the
    scalar encoder's bytes."""
    packed = pack.pack_lines_2d(GELF_TYPED, L)
    chunk, starts, orig, n = packed[2:]
    host = _host("gelf", packed)
    enc = CapnpEncoder(Config.from_string(""))
    got = CB.encode_gelf_capnp_block(chunk, starts, orig, host, n, L, enc,
                                     None)
    assert got.fallback_rows == 4      # 19 digits, 2**64 - 1, 1.5, dup
    exp, _ = scalar_expectation(b"\n".join(GELF_TYPED) + b"\n", merger=None,
                                fmt="gelf", output="capnp")
    assert got.block.data == exp
    first = RW.parse_message(_messages(got.block.data, "noop")[0])
    got_pairs = {k: (v.kind, v.value) for k, v in first.get_pairs()}
    assert got_pairs == {"_t": ("bool", True), "_f": ("bool", False),
                         "_n": ("null", None)}


@pytest.mark.parametrize("framing", ["noop", "line", "nul", "syslen"])
def test_mask_capnp_stamps(framing):
    """The walker zeroes the stamps at or past ``since`` of every
    message and nothing else."""
    enc = CapnpEncoder(Config.from_string(EXTRA))
    merger = {"noop": None, "line": LineMerger(), "nul": NulMerger(),
              "syslen": SyslenMerger()}[framing]
    stamps = [1438790025.5, 1e10, 1760000000.25, 2e10, 0.0]
    data = b""
    for i, ts in enumerate(stamps):
        rec = Record(ts=ts, hostname=f"h{i}" * (i + 1), facility=None,
                     severity=None, appname=None, procid=None, msgid=None,
                     msg="m" * i, full_msg=None,
                     sd=[StructuredData("x", [("_a", SDValue.string("b"))])])
        payload = enc.encode(rec)
        data += merger.frame(payload) if merger else payload
    masked = mask_capnp_stamps(data, 5e9, framing)
    assert len(masked) == len(data)
    got = [RW.parse_message(m).get_ts()
           for m in _messages(masked, framing)]
    assert got == [1438790025.5, 0.0, 1760000000.25, 0.0, 0.0]
    assert mask_capnp_stamps(data, 3e10, framing) == data
