"""The port's JSON-lines path on the CPU against the JAX package: the
plain structural index (the K5 kernel's plain version) channel for
channel on every row, the decode fetch with its 24-field rescue, the
scalar oracle, the block encoder under every merger, the batch handler
across chunk and flush boundaries, and the CLI end to end.  Every
comparison is exact.  One batch geometry ([256, 512]) keeps the JAX side
at a few compiled programs."""

import io
import os
import queue
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from flowgger_tpu.decoders import DecodeError as JDecodeError
from flowgger_tpu.decoders import JSONLDecoder as JJSONLDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as JGelfEncoder
from flowgger_tpu.config import Config as JConfig
from flowgger_tpu.mergers import LineMerger as JLineMerger
from flowgger_tpu.mergers import NulMerger as JNulMerger
from flowgger_tpu.mergers import SyslenMerger as JSyslenMerger
from flowgger_tpu.tpu import encode_jsonl_block as JB
from flowgger_tpu.tpu import jsonidx as JI
from flowgger_tpu.tpu import jsonl as JL
from flowgger_tpu.tpu import rfc5424 as JR
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import make_jsonl_corpus, scalar_expectation
from flowgger_tpu_torch.decoders import DecodeError, JSONLDecoder
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.splitters import LineSplitter, NulSplitter
from flowgger_tpu_torch.tpu import jsonidx as TI
from flowgger_tpu_torch.tpu import jsonl as TL
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler
from flowgger_tpu_torch.tpu.encode_jsonl_block import encode_jsonl_gelf_block
from flowgger_tpu_torch.tpu.materialize_jsonl import materialize_jsonl


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
L = 512

# the JAX package's JSON-lines corpus (tests/test_tpu_jsonl.py) plus the
# backslash runs on both sides of the escape cap and rows for the
# lookaround window, the field budgets and the depth cap
EDGE_LINES = [
    '{"timestamp":1438790025.42,"host":"h1","message":"hello world",'
    '"level":3,"user":"bob","n":42}',
    '{"host":"h"}',
    '{"timestamp":1,"host":"h"}',
    '{"timestamp":-1.5,"host":"h"}',
    '{"timestamp":2,"x":null,"b":true,"c":false}',
    '{"timestamp":3,"n":-3,"f":1.5,"big":18446744073709551615}',
    '{"timestamp":4,"esc":"a\\"b\\\\c\\n\\u00e9"}',
    '{"timestamp":5,"uni":"ünïcode"}',
    '{ "timestamp" : 6 , "k" : "v" }',
    '{"timestamp":7,"z":1,"a":2,"m":3}',
    '{"timestamp":8,"dup":1,"dup":2}',
    '{"timestamp":9,"_pre":"kept","x":"_prefixed"}',
    '{"timestamp":10,"empty":""}',
    '{"timestamp":11,"k":{"a":1,"b":[2,3]},"z":"s"}',
    '{"timestamp":12,"k":[{"x":"}"},null]}',
    '{"timestamp":13,"k":{}}',
    '{"timestamp":14,"deep":{"a":{"b":{"c":{"d":{"e":1}}}}}}',
    '{"timestamp":15,"short_message":"a pair, not a special"}',
    '{"timestamp":16,"version":"1.1"}',
    "{}",
    '{"timestamp":"a string"}',
    '{"host": 42}',
    '{"message": 42, "timestamp":17}',
    '{"level": 8, "timestamp":18}',
    '{"level": true, "timestamp":19}',
    "[1,2,3]",
    "not json at all",
    "",
    '{"timestamp":20,}',
    '{"timestamp":21 "k":1}',
    '{"timestamp":22,"k":}',
    '{"timestamp":23,"k":01}',
    '{"timestamp":24,"k":truex}',
    '{"timestamp":25,"k":[1,2}',
    '{"timestamp":26,"k":fals}',
    '{"timestamp":27,"k":nul}',
    '{"timestamp":28,         "k":1}',        # 9 spaces: past the window
    '{"timestamp":29,       "k":1}',          # 7: the quote in the window
    '{"timestamp":30,"k":"a:b,c"}',
    '{"a:b":1}',
    '\t{"timestamp":31,"k":"v"}  ',
    '{"timestamp":32,"k":"v"}}',
    '{"timestamp":33,"k":"v"} x',
    '{"timestamp":34,"k":[[[1]]]}',
    '{"timestamp":35,"k":[[[[1]]]]}',
    '{"timestamp":36,"k":"\\\\"}',
    '{"timestamp":37,"k":"v" "w"}',
    '"{\\"a\\":1}"',
] + [
    '{"timestamp":40,' + ",".join(f'"k{i:02d}":{i}' for i in range(n)) + "}"
    for n in (7, 8, 12, 23, 24, 30)
] + [
    '{"s":"' + "\\" * n + 'q"}' for n in (15, 16, 21)
] + [
    '{"timestamp":41,"s":"' + "\\" * n + '"}' for n in (14, 16, 24)
]


def _batch(lines):
    """One [256, 512] batch: the edge lines, then the seeded corpus."""
    raw = [ln.encode() for ln in lines]
    raw += make_jsonl_corpus(256 - len(raw), seed=11)[0]
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(raw, L)
    assert batch.shape == (256, L) and n == 256
    return raw, batch, lens


RAW, BATCH, LENS = _batch(EDGE_LINES)


def _jax_index(max_fields, nested):
    return jax.jit(lambda b, ln: JI.structural_index(
        b, ln, max_fields=max_fields, scan_impl="lax", extract_impl="sum",
        nested=nested, string_impl="nfa"))(BATCH, LENS)


def test_shared_constants_match_jax():
    """The state shared across the packages: the automaton table, the
    value classes, the window and the field budgets."""
    assert TI.NFA_TABLE == JI.NFA_TABLE
    assert TI.NFA_IDENT == JI.NFA_IDENT
    assert (TI.VT_STRING, TI.VT_NUMBER, TI.VT_TRUE, TI.VT_FALSE, TI.VT_NULL,
            TI.VT_OBJECT, TI.VT_ARRAY) == (
        JI.VT_STRING, JI.VT_NUMBER, JI.VT_TRUE, JI.VT_FALSE, JI.VT_NULL,
        JI.VT_OBJECT, JI.VT_ARRAY)
    assert TI.WS_WINDOW == JI.WS_WINDOW
    assert (TL.DEFAULT_MAX_FIELDS, TL.RESCUE_MAX_FIELDS, TL.NESTED_DEPTH) == (
        JL.DEFAULT_MAX_FIELDS, JL.RESCUE_MAX_FIELDS, JL.NESTED_DEPTH)
    from flowgger_tpu_torch.tpu.rfc5424 import ESC_RUN_CAP

    assert ESC_RUN_CAP == JR.ESC_RUN_CAP


@pytest.mark.parametrize("max_fields,nested", [(8, 4), (24, 4), (8, 0)])
def test_structural_index_matches_jax(max_fields, nested):
    """Every channel of every row — rejected and padding rows included —
    equals the JAX package's structural index (NFA string machine, sum
    extraction)."""
    ref = _jax_index(max_fields, nested)
    got = TI.structural_index(torch.from_numpy(BATCH), torch.from_numpy(LENS),
                              max_fields, nested=nested)
    assert set(got) == set(ref)
    for k, v in ref.items():
        a, b = np.asarray(v), got[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (
            k, np.argwhere(a != b)[:4].tolist())
    ok = got["ok"].numpy()
    assert ok.any() and not ok.all()


def test_escape_cap_rows_flag():
    """A quote after 16 or more backslashes flags the row, 14 does not
    (the NFA machine's parity is exact either way), and a gap past the
    lookaround window flags it too."""
    got = TI.structural_index(torch.from_numpy(BATCH), torch.from_numpy(LENS),
                              8, nested=4)
    ok = dict(zip(RAW, got["ok"].tolist()))

    def run(n):
        return b'{"timestamp":41,"s":"' + b"\\" * n + b'"}'

    assert ok[run(14)] is True
    assert ok[run(16)] is False and ok[run(24)] is False
    assert ok[b'{"s":"' + b"\\" * 16 + b'q"}'] is True
    assert ok[b'{"timestamp":28,         "k":1}'] is False
    assert ok[b'{"timestamp":29,       "k":1}'] is True


def _assert_matches_parity_tier(ref, got):
    """The JAX package's XLA tier classifies strings with a parity ladder
    that caps backslash runs at ESC_RUN_CAP (its Pallas tier and the
    port use the exact NFA machine): ``ok`` and ``n_fields`` agree on
    every row, every channel on every row without such a run."""
    exact = np.array([b"\\" * JR.ESC_RUN_CAP not in r for r in RAW])
    assert not exact.all()
    assert set(got) == set(ref)
    for k, v in ref.items():
        a, b = np.asarray(v), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in ("ok", "n_fields"):
            assert np.array_equal(a, b), k
        assert np.array_equal(a[exact], b[exact]), k


def test_decode_jsonl_matches_jax_decoder():
    """The port's decode against the JAX package's ``decode_jsonl``."""
    ref = jax.jit(JL.decode_jsonl)(BATCH, LENS)
    got = TL.decode_jsonl(torch.from_numpy(BATCH), torch.from_numpy(LENS))
    _assert_matches_parity_tier(ref, {k: v.numpy() for k, v in got.items()})


def test_fetch_with_rescue_matches_jax():
    """decode_jsonl_fetch re-dispatches the 9-24-key rows at 24 fields
    and widens the field channels, exactly as the JAX package does."""
    ref = JL.decode_jsonl_fetch(JL.decode_jsonl_submit(BATCH, LENS))
    got = TL.decode_jsonl_fetch(TL.decode_jsonl_submit(
        torch.from_numpy(BATCH), torch.from_numpy(LENS)))
    assert got["key_start"].shape == (256, TL.RESCUE_MAX_FIELDS)
    _assert_matches_parity_tier(ref, got)
    nf = got["n_fields"]
    rescued = got["ok"] & (nf > TL.DEFAULT_MAX_FIELDS)
    assert rescued.any()


def _records_equal(a, b):
    return (a.ts, a.hostname, a.severity, a.msg) == (b.ts, b.hostname,
                                                     b.severity, b.msg) \
        and [(p.sd_id, [(n, repr(v)) for n, v in p.pairs])
             for p in (a.sd or [])] == [
            (p.sd_id, [(n, repr(v)) for n, v in p.pairs]) for p in (b.sd or [])]


def test_decoder_matches_jax_decoder():
    """The port's scalar oracle decodes every line as the JAX package's
    does (rows with a timestamp; errors by message)."""
    for raw in RAW:
        line = raw.decode("utf-8")
        if '"timestamp"' not in line:
            continue
        try:
            want = ("rec", JJSONLDecoder().decode(line))
        except JDecodeError as e:
            want = ("err", str(e))
        try:
            got = ("rec", JSONLDecoder().decode(line))
        except DecodeError as e:
            got = ("err", str(e))
        assert got[0] == want[0], line
        if got[0] == "err":
            assert got[1] == want[1], line
        else:
            assert _records_equal(got[1], want[1]), line


def test_materialize_matches_oracle():
    """Span materialization gives the oracle's record or error on every
    row the index accepted (and the oracle's on the rest)."""
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(RAW, L)
    host = TL.decode_jsonl_host(torch.from_numpy(batch),
                                torch.from_numpy(lens))
    res = materialize_jsonl(chunk, starts, orig, host, n, L)
    for raw, r in zip(RAW, res):
        line = raw.decode("utf-8")
        if '"timestamp"' not in line:
            continue
        try:
            want = JSONLDecoder().decode(line)
        except DecodeError as e:
            assert r.record is None and r.error == str(e), line
            continue
        assert r.error is None and _records_equal(r.record, want), line


MERGERS = [(NulMerger(), JNulMerger()), (LineMerger(), JLineMerger()),
           (SyslenMerger(), JSyslenMerger())]


@pytest.mark.parametrize("merger,jmerger", MERGERS,
                         ids=["nul", "line", "syslen"])
def test_jsonl_gelf_block_matches_scalar_oracle(merger, jmerger):
    """encode_jsonl_gelf_block over the port's fetch equals the scalar
    decoder + GelfEncoder + merger row for row, and the JAX package's
    block encoder over its own fetch, byte for byte."""
    lines = [r for r in RAW if b'"timestamp"' in r or not r.startswith(b"{")]
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(lines, L)
    host = TL.decode_jsonl_host(torch.from_numpy(batch),
                                torch.from_numpy(lens))
    res = encode_jsonl_gelf_block(chunk, starts, orig, host, n, L,
                                  GelfEncoder(Config.from_string("")), merger)
    exp, errs = scalar_expectation(b"\n".join(lines) + b"\n", merger=merger,
                                   fmt="jsonl")
    assert res.block.data == exp
    assert [f"{e}: [{ln.strip()}]" for e, ln in res.errors] == errs
    assert 0 < res.fallback_rows < n
    jhost = JL.decode_jsonl_fetch(JL.decode_jsonl_submit(batch, lens))
    jres = JB.encode_jsonl_gelf_block(chunk, starts, orig, jhost, n, L,
                                      JGelfEncoder(JConfig.from_string("")),
                                      jmerger)
    assert jres.block.data == res.block.data
    assert [e for e, _ in jres.errors] == [e for e, _ in res.errors]


class _Chunks:
    """A stream whose reads return at most ``size`` bytes."""

    def __init__(self, data, size):
        self.buf = io.BytesIO(data)
        self.size = size

    def read(self, n):
        return self.buf.read(min(n, self.size))


def _stream(framing, n_lines=500, seed=8):
    lines, _ = make_jsonl_corpus(n_lines, seed)
    sep = b"\0" if framing == "nul" else b"\n"
    return sep.join(lines) + sep + b'{"timestamp":7,"message":"partial"}'


@pytest.mark.parametrize("framing,chunk,batch", [
    ("line", 97, 64), ("nul", 4093, 100), ("line", 1 << 16, 16384)])
def test_batch_handler_jsonl_across_chunk_and_flush_boundaries(
        capsys, framing, chunk, batch):
    data = _stream(framing)
    cfg = Config.from_string(f"[input]\ntpu_encode_economics = false\n"
                             f"tpu_batch_size = {batch}\n")
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, NulMerger(),
                           torch.device("cpu"), start_timer=False,
                           fmt="jsonl")
    splitter = NulSplitter() if framing == "nul" else LineSplitter()
    splitter.run(_Chunks(data, chunk), handler)
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(data, framing, fmt="jsonl")
    assert got == exp
    assert capsys.readouterr().err.splitlines() == errs


def _mask_now(bs: bytes) -> bytes:
    """Mask receive-time stamps (rows without a timestamp are stamped
    with the time they were decoded)."""
    def repl(m):
        try:
            now = abs(float(m.group(2)) - time.time()) < 86400
        except ValueError:
            now = False
        return m.group(1) + b"NOW" if now else m.group(0)

    return re.sub(rb'("timestamp":)([0-9.e+-]+)', repl, bs)


def _run(pkg, cfg, data, extra=()):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               FLOWGGER_DEVICE_ENCODE="0", PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=300)


@pytest.mark.parametrize("framing,out_type", [("line", "file"),
                                              ("nul", "stdout")])
def test_cli_jsonl_matches_jax_package(tmp_path, framing, out_type):
    """``examples/jsonl.toml``'s configuration through both CLIs: the
    same output bytes and stderr lines (a row without a timestamp is
    stamped with receive time and masked)."""
    lines, _ = make_jsonl_corpus(700, seed=13)
    lines.insert(5, b'{"host":"no-timestamp","message":"stamped now"}')
    sep = b"\0" if framing == "nul" else b"\n"
    data = sep.join(lines) + sep + b'{"timestamp":1,"message":"tail"}'
    assert len(data) > 1 << 16
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "jsonl_tpu"\n'
            f'framing = "{framing}"\ntpu_flush_ms = 600000\n'
            'tpu_fuse = "off"\n'
            f'[output]\ntype = "{out_type}"\nformat = "gelf"\n'
            f'file_path = "{out}"\n')
        extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
        proc = _run(pkg, cfg, data, extra)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        body = out.read_bytes() if out_type == "file" else proc.stdout
        outs[pkg] = (_mask_now(body), proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[0] == ref[0] and b'"timestamp":NOW' in port[0]
    assert port[1] == ref[1] and port[1]
