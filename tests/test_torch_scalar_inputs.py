"""The scalar input formats and the capnp input: ``python -m
flowgger_tpu_torch --device cpu`` against ``python -m flowgger_tpu`` on one
config and one input (output bytes, stdout and stderr lines), for every
scalar ``input.format`` — rfc5424, rfc3164, gelf, ltsv, jsonl, dns and
the default when ``format`` is absent — over line, NUL and syslen
framing; then the capnp input: the port's own capnp output read back
into GELF, truncated segment tables and messages, a bad timestamp,
``rfc5424_tpu`` with ``framing = "capnp"`` (the batch handler's
``handle_record``), and the port's ``capnp_wire`` reader against the
reference's on the same bytes.

The scalar path runs on the host in both packages (a ``ScalarHandler``
a stream, the host splitters); the gelf and jsonl inputs stamp a row
without a timestamp with the wall clock, so those stamps are masked."""

import io
import queue
import struct
import time

import pytest
import torch

from flowgger_tpu_torch import capnp_wire
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_dns_corpus,
                                       make_gelf_corpus, make_jsonl_corpus,
                                       make_ltsv_corpus, make_rfc3164_corpus,
                                       mask_wall_stamps, scalar_expectation,
                                       syslen_stream)
from flowgger_tpu_torch.decoders import InvalidDecoder, RFC5424Decoder
from flowgger_tpu_torch.encoders import CapnpEncoder, GelfEncoder
from flowgger_tpu_torch.record import SDValue
from flowgger_tpu_torch.splitters import CapnpSplitter, ScalarHandler

from torch_cli import cli_pair


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (``torch_cli``
    sets OMP_NUM_THREADS=1 for them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T0 = time.time() - 1.0
CORPORA = {"rfc5424": make_corpus, "rfc3164": make_rfc3164_corpus,
           "gelf": make_gelf_corpus, "ltsv": make_ltsv_corpus,
           "jsonl": make_jsonl_corpus, "dns": make_dns_corpus}
# input.format → the corpus; None: no format key (the default, rfc5424)
FORMATS = {"rfc5424": "rfc5424", "rfc3164": "rfc3164", "gelf": "gelf",
           "ltsv": "ltsv", "jsonl": "jsonl", "dns": "dns", "default": None}


def _stream(corpus: str, framing: str, n: int, seed: int) -> bytes:
    lines, _ = CORPORA[corpus](n, seed)
    if framing == "syslen":
        return syslen_stream(lines)
    sep = b"\0" if framing == "nul" else b"\n"
    # the last record has no separator: the end-of-stream partial frame
    return sep.join(lines)


def _same_outputs(outs) -> None:
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert mask_wall_stamps(port[0], T0) == mask_wall_stamps(ref[0], T0)
    assert port[1] == ref[1] and port[2] == ref[2]


@pytest.mark.parametrize("framing", ["line", "nul", "syslen"])
@pytest.mark.parametrize("name", list(FORMATS))
def test_cli_scalar_format_matches_jax_package(tmp_path, name, framing):
    fmt = FORMATS[name]
    corpus = fmt or "rfc5424"
    data = _stream(corpus, framing, 150, 40 + len(name) + len(framing))
    fmt_key = f'format = "{fmt}"\n' if fmt else ""
    outs = cli_pair(tmp_path, data, fmt_key + f'framing = "{framing}"\n',
                    'format = "gelf"\n', concurrent=True)
    _same_outputs(outs)
    notices = []
    exp, errs = scalar_expectation(data, framing, fmt=corpus,
                                   notices=notices)
    port = outs["flowgger_tpu_torch"]
    assert mask_wall_stamps(port[0], T0) == mask_wall_stamps(exp, T0)
    assert port[2] == errs and port[1].decode().splitlines()[1:] == notices
    assert exp.count(b"\0") > 100


def _capnp_messages(n: int, seed: int):
    """The port's capnp encoding of ``n`` corpus records (those the
    scalar decoder takes), one message each, with a capnp_extra."""
    enc = CapnpEncoder(Config.from_string(
        '[output.capnp_extra]\nenv = "prod"\n'))
    dec = RFC5424Decoder()
    msgs = []
    for ln in make_corpus(n, seed)[0]:
        try:
            rec = dec.decode(ln.decode("utf-8"))
        except Exception:  # noqa: BLE001 - the corpus's malformed rows
            continue
        msgs.append(enc.encode(rec))
    return msgs


def test_cli_capnp_input_reads_the_ports_capnp_output(tmp_path):
    """``format = "capnp"`` with ``framing = "capnp"``: the port's own
    capnp messages back into GELF, byte for byte the reference's; a
    message with a bad timestamp is reported and skipped."""
    msgs = _capnp_messages(160, 51)
    rec = RFC5424Decoder().decode("<13>1 2015-08-05T15:53:45Z h a p m - x")
    rec.ts = 0.0
    msgs.insert(9, capnp_wire.encode_record(rec, []))
    outs = cli_pair(tmp_path, b"".join(msgs),
                    'format = "capnp"\nframing = "capnp"\n',
                    'format = "gelf"\n', concurrent=True)
    _same_outputs(outs)
    port = outs["flowgger_tpu_torch"]
    assert port[2] == ["Missing timestamp"]
    assert port[0].count(b"\0") == len(msgs) - 1 > 100


def test_cli_capnp_framing_into_the_batch_handler(tmp_path):
    """``rfc5424_tpu`` with ``framing = "capnp"``: the records reach the
    batch handler's ``handle_record`` (encoded on the host behind a
    fence); a truncated message at the end is reported."""
    msgs = _capnp_messages(120, 52)
    data = b"".join(msgs) + msgs[0][:40]
    outs = cli_pair(tmp_path, data,
                    'format = "rfc5424_tpu"\nframing = "capnp"\n',
                    'format = "gelf"\n', concurrent=True)
    _same_outputs(outs)
    port = outs["flowgger_tpu_torch"]
    assert port[2] == ["Capnp decoding error: truncated message"]
    assert port[0].count(b"\0") == len(msgs)


def _split_both(data: bytes, capsys):
    """The capnp splitter of each package over ``data`` into GELF:
    (queue items, stderr lines) each."""
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.decoders import InvalidDecoder as RInvalid
    from flowgger_tpu.encoders import GelfEncoder as RGelf
    from flowgger_tpu.splitters import CapnpSplitter as RSplitter
    from flowgger_tpu.splitters import ScalarHandler as RScalar

    got = []
    for split, handler in (
            (CapnpSplitter(), lambda tx: ScalarHandler(
                tx, InvalidDecoder(), GelfEncoder(Config.from_string("")))),
            (RSplitter(), lambda tx: RScalar(
                tx, RInvalid(), RGelf(RConfig.from_string(""))))):
        capsys.readouterr()
        tx = queue.Queue()
        split.run(io.BytesIO(data), handler(tx))
        items = []
        while not tx.empty():
            items.append(tx.get_nowait())
        got.append((items, capsys.readouterr().err.splitlines()))
    return got


@pytest.mark.parametrize("cut", ["head", "table", "message", "pointer"])
def test_capnp_splitter_truncations_match_reference(capsys, cut):
    """A stream ending in a message cut inside its head, inside its
    segment table or inside its body, or holding a message whose root
    pointer is a list pointer (the stream ends there): the same records
    and the same stderr lines as the reference's splitter."""
    msgs = _capnp_messages(20, 53)
    bad_root = struct.pack("<II", 0, 1) + struct.pack("<Q", 1)
    data = b"".join(msgs[:10]) + {
        "head": msgs[0][:2], "table": msgs[0][:6], "message": msgs[0][:-8],
        "pointer": bad_root + b"".join(msgs[10:])}[cut]
    (port, perr), (ref, rerr) = _split_both(data, capsys)
    assert port == ref and perr == rerr and len(port) == 10
    assert perr == {
        "head": [], "table": ["Capnp decoding error: truncated segment table"],
        "message": ["Capnp decoding error: truncated message"],
        "pointer": ["Capnp decoding error: expected struct pointer"]}[cut]


def test_capnp_reader_matches_reference():
    """``parse_message`` and ``RecordReader`` of both packages on the same
    bytes: every field, the pairs and the extra pairs, and the errors of
    malformed messages."""
    from flowgger_tpu import capnp_wire as R

    rec = RFC5424Decoder().decode(
        '<13>1 2015-08-05T15:53:45.25Z host app 42 mid [x@1 a="1" b="two"] '
        "hello")
    rec.sd[0].pairs += [("_f", SDValue.f64(1.5)), ("_i", SDValue.i64(-3)),
                        ("_u", SDValue.u64(7)), ("_b", SDValue.bool_(True)),
                        ("_n", SDValue.null())]
    msgs = _capnp_messages(40, 54) + [
        capnp_wire.encode_record(rec, [("env", "prod")])]

    def fields(mod, data):
        try:
            r = mod.parse_message(data)
            return (r.get_ts(), r.get_facility(), r.get_severity(),
                    r.get_hostname(), r.get_appname(), r.get_procid(),
                    r.get_msgid(), r.get_msg(), r.get_full_msg(),
                    r.get_sd_id(),
                    [(k, v.kind, v.value) for k, v in r.get_pairs()],
                    [(k, v.kind, v.value) for k, v in r.get_extra()])
        except Exception as e:  # noqa: BLE001 - compared by type and text
            return (type(e).__name__, str(e))

    bad = [b"", b"\0\0\0\0", msgs[0][:16],
           struct.pack("<II", 0, 1) + struct.pack("<Q", 2),
           struct.pack("<II", 0, 1) + struct.pack("<Q", 0x7fff0)]
    for data in msgs + bad:
        assert fields(capnp_wire, data) == fields(R, data)
    assert fields(capnp_wire, msgs[-1])[10][-5:] == [
        ("_f", "f64", 1.5), ("_i", "i64", -3), ("_u", "u64", 7),
        ("_b", "bool", True), ("_n", "null", None)]
