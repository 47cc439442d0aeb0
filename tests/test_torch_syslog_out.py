"""The port's passthrough and RFC3164 outputs and the block-off dispatch
on the CPU, against the JAX package.

- The passthrough block encoders (``encode_passthrough_block``'s rfc5424
  and rfc3164 encoders) and the rfc3164 → RFC3164 block encoder
  (``encode_rfc3164_3164_block``) against the reference's, fed the same
  decode channels, × line / NUL / syslen mergers: block bytes and
  bounds, errors and oracle rows; and the scalar path's bytes.  With
  ``syslog_prepend_timestamp`` set, both packages' block encoders refuse
  the batch (None).
- ``PassthroughEncoder`` and ``RFC3164Encoder`` with a prepend format,
  and the warn-and-default of a legacy ``%`` format, against the
  reference's (the wall-clock prefix masked).
- A handler with ``syslog_prepend_timestamp`` (rfc5424 and rfc3164 into
  passthrough, rfc3164 into RFC3164) takes the Record path: the start-up
  notice, and every row of the scalar path's bytes with the prefix
  masked, as ``corpus.mask_wall_stamps`` masks GELF stamps.
- The block-off dispatch: a handler of rfc5424 into RFC3164 (no block
  encoder) takes the Record path — not the rfc5424 → GELF per-row span
  encode, which only GELF output takes — and writes what the JAX
  package's scalar decoder and encoder write, row for row, with its
  errors.
- Output framing inference for every output format × stdout / debug /
  file / kafka against the reference's ``infer_output_framing``.
"""

import contextlib
import io
import queue
import re

import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders import rfc5424 as r5424
from flowgger_tpu.encoders import passthrough as rpass
from flowgger_tpu.encoders.rfc3164 import RFC3164Encoder as RRFC3164Encoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import encode_passthrough_block as RPB
from flowgger_tpu.tpu import encode_rfc3164_3164_block as R33

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, scalar_expectation)
from flowgger_tpu_torch.encoders import (PassthroughEncoder, RFC3164Encoder,
                                         config_get_prepend_ts)
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import batch as batch_mod
from flowgger_tpu_torch.tpu import encode_passthrough_block as PB
from flowgger_tpu_torch.tpu import encode_rfc3164_3164_block as B33
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import _ROUTES, BatchHandler, block_submit

L = 256
MERGERS = [(LineMerger, RLineMerger), (NulMerger, RNulMerger),
           (SyslenMerger, RSyslenMerger)]
PREPEND = "[year]-[month]-[day]T[hour]:[minute]:[second]Z "
PREPEND_TOML = f'[output]\nsyslog_prepend_timestamp = "{PREPEND}"\n'
_WALL = re.compile(rb"(^|[\n\0])\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ ")
NOTICE = "flowgger-tpu: columnar block route disabled for format "


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mask(data: bytes) -> bytes:
    return _WALL.sub(rb"\1<wall> ", data)


def _corpus(fmt):
    if fmt == "rfc5424":
        return (make_tier_corpus(200, 301)[0] + make_corpus(200, 302)[0]
                + [b"\xef\xbb\xbf<13>1 2015-08-05T15:53:45Z h a p m - bom",
                   b"<13>1 2015-08-05T15:53:45Z h a p m - trailing   "])
    return (make_rfc3164_tier_corpus(200, 303)[0]
            + make_rfc3164_corpus(200, 304)[0])


# (input, port block encoder, reference block encoder, encoder kind)
BLOCKS = {
    "rfc5424_passthrough": ("rfc5424", PB.encode_rfc5424_passthrough_block,
                            RPB.encode_rfc5424_passthrough_block,
                            "passthrough"),
    "rfc3164_passthrough": ("rfc3164", PB.encode_rfc3164_passthrough_block,
                            RPB.encode_rfc3164_passthrough_block,
                            "passthrough"),
    "rfc3164_rfc3164": ("rfc3164", B33.encode_rfc3164_3164_block,
                        R33.encode_rfc3164_3164_block, "rfc3164"),
}


def _encoders(kind, toml=""):
    if kind == "passthrough":
        return (PassthroughEncoder(Config.from_string(toml)),
                rpass.PassthroughEncoder(RConfig.from_string(toml)))
    return (RFC3164Encoder(Config.from_string(toml)),
            RRFC3164Encoder(RConfig.from_string(toml)))


def _host(fmt, packed):
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    return _ROUTES[fmt][1](block_submit(fmt, tp))


@pytest.mark.parametrize("merger", MERGERS, ids=["line", "nul", "syslen"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_encoders_match_reference(name, merger):
    fmt, fn, rfn, kind = BLOCKS[name]
    lines = _corpus(fmt)
    packed = pack.pack_lines_2d(lines, L)
    chunk, starts, orig, n = packed[2:]
    host = _host(fmt, packed)
    enc, renc = _encoders(kind)
    m, rm = merger[0](), merger[1]()
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(said):
        got = fn(chunk, starts, orig, host, n, L, enc, m)
    with contextlib.redirect_stderr(rsaid):
        want = rfn(chunk, starts, orig, dict(host), n, L, renc, rm)
    assert got.block.data == want.block.data
    assert np.array_equal(got.block.bounds, want.block.bounds)
    if want.block.prefix_lens is not None:
        assert np.array_equal(got.block.prefix_lens, want.block.prefix_lens)
    assert got.errors == want.errors
    assert got.fallback_rows == want.fallback_rows
    assert said.getvalue() == rsaid.getvalue()
    assert 0 < got.fallback_rows < n
    exp, _ = scalar_expectation(b"\n".join(lines) + b"\n", merger=m,
                                fmt=fmt, output=kind)
    assert got.block.data == exp
    # a prepend format: both block encoders refuse the batch
    enc, renc = _encoders(kind, PREPEND_TOML)
    assert fn(chunk, starts, orig, host, n, L, enc, m) is None
    assert rfn(chunk, starts, orig, dict(host), n, L, renc, rm) is None


def test_prepend_encoders_match_reference():
    """The prepend header of both syslog encoders, and a legacy '%'
    format's warning and default, as the reference's."""
    dec = r5424.RFC5424Decoder()
    recs = []
    for raw in make_corpus(80, 305)[0]:
        try:
            recs.append(dec.decode(raw.decode()))
        except Exception:
            continue
    for kind in ("passthrough", "rfc3164"):
        enc, renc = _encoders(kind, PREPEND_TOML)
        for r in recs:
            assert _mask(enc.encode(r)) == _mask(renc.encode(r))
            assert _mask(enc.encode(r)).startswith(b"<wall> ")
    legacy = '[output]\nsyslog_prepend_timestamp = "%Y-%m"\n'
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(said):
        got = config_get_prepend_ts(Config.from_string(legacy))
    from flowgger_tpu.encoders import config_get_prepend_ts as rget

    with contextlib.redirect_stderr(rsaid):
        want = rget(RConfig.from_string(legacy))
    assert got == want and said.getvalue() == rsaid.getvalue()
    assert "WARNING: Wrong syslog_prepend_timestamp" in said.getvalue()
    esc = '[output]\nsyslog_prepend_timestamp = "[year]\\\\%"\n'
    assert config_get_prepend_ts(Config.from_string(esc)) == \
        rget(RConfig.from_string(esc)) == "[year]%"


def _handler(fmt, encoder, config, merger):
    tx = queue.Queue()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        h = BatchHandler(tx, encoder, config, merger, torch.device("cpu"),
                         start_timer=False, fmt=fmt)
    return h, tx, err


def _drain(tx, merger):
    out = []
    while not tx.empty():
        item = tx.get_nowait()
        data = getattr(item, "data", None)
        out.append(data if data is not None else
                   (merger.frame(item) if merger is not None else item))
    return b"".join(out)


@pytest.mark.parametrize("fmt,kind", [("rfc5424", "passthrough"),
                                      ("rfc3164", "passthrough"),
                                      ("rfc3164", "rfc3164")])
def test_prepend_takes_the_record_path(fmt, kind):
    """With syslog_prepend_timestamp the block route is off for the
    config: the reference's start-up notice, then the Record path, every
    row the scalar path's with its wall-clock prefix."""
    config = Config.from_string(PREPEND_TOML)
    enc = _encoders(kind, PREPEND_TOML)[0]
    merger = LineMerger()
    h, tx, err = _handler(fmt, enc, config, merger)
    assert err.getvalue().splitlines() == [
        f"{NOTICE}'{fmt}' (output.syslog_prepend_timestamp is set); "
        "throughput falls to the per-record path (~30x slower)"]
    lines = _corpus(fmt)
    data = b"\n".join(lines) + b"\n"
    with contextlib.redirect_stderr(err):
        h._dispatch(pack.pack_region_2d(data, 512))
    got = _drain(tx, merger)
    exp, errs = scalar_expectation(data, merger=merger, fmt=fmt,
                                   config=config, output=kind)
    assert _mask(got) == _mask(exp)
    assert _mask(got).count(b"<wall> ") > 300
    assert sorted(err.getvalue().splitlines()[1:]) == sorted(errs)


def test_rfc5424_into_rfc3164_takes_the_record_path(monkeypatch):
    """rfc5424 into RFC3164 has no block encoder: the handler says so at
    start-up and runs the Record path (the GELF-only per-row span encode
    is never called), each row what the JAX package's scalar decoder and
    RFC3164 encoder make of it, and each rejected row's error line."""

    def no_span_encode(*a, **kw):
        raise AssertionError("the per-row span encode is GELF output's")

    monkeypatch.setattr(batch_mod, "encode_rfc5424_gelf", no_span_encode)
    config = Config.from_string("")
    merger = LineMerger()
    h, tx, err = _handler("rfc5424", RFC3164Encoder(config), config, merger)
    assert not h._block_ok
    lines = _corpus("rfc5424")
    data = b"\n".join(lines) + b"\n"
    with contextlib.redirect_stderr(err):
        h._dispatch(pack.pack_region_2d(data, 512))
    got = _drain(tx, merger)
    rdec = r5424.RFC5424Decoder()
    renc = RRFC3164Encoder(RConfig.from_string(""))
    want, errs = [], []
    for raw in lines:
        line = raw.decode("utf-8")
        try:
            want.append(renc.encode(rdec.decode(line)) + b"\n")
        except Exception as e:
            errs.append(f"{e}: [{line.strip()}]")
    assert got == b"".join(want) and len(want) > 300
    said = err.getvalue().splitlines()
    assert said[0] == (
        f"{NOTICE}'rfc5424' (output.format RFC3164Encoder has no columnar "
        "encoder for input format 'rfc5424'); throughput falls to the "
        "per-record path (~30x slower)")
    assert said[1:] == errs and errs


@pytest.mark.parametrize("output_type", ["stdout", "debug", "file", "kafka"])
def test_output_framing_inference_matches_reference(output_type):
    """Framing inference when ``output.framing`` is absent, for every
    output format the port writes (and capnp), against the reference's
    ``infer_output_framing`` (flowgger_tpu/pipeline.py:166-174): json
    and the syslog formats get ``noop`` on stdout and a file, ``line``
    on debug."""
    from flowgger_tpu.pipeline import infer_output_framing as rinfer

    from flowgger_tpu_torch.pipeline import infer_output_framing

    for fmt in ("gelf", "json", "ltsv", "rfc5424", "rfc3164", "passthrough",
                "capnp"):
        assert infer_output_framing(fmt, output_type) == \
            rinfer(fmt, output_type), fmt
    assert infer_output_framing("json", "stdout") == "noop"
    assert infer_output_framing("json", "debug") == "line"
