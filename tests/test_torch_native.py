"""The port's native host tier (flowgger_tpu_torch/native.py over
csrc/flowgger_host.cpp): each export against its plain numpy or Python
version and against the JAX package's library (flowgger_tpu.native) on
the same bytes; the RFC5424 → GELF block encoder with the native engine,
the numpy engine and the JAX package's encoder on the same decode
channels; the loader; and the C++ self-test under ASan and UBSan."""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu import native as jnative
from flowgger_tpu.encoders import GelfEncoder as JGelfEncoder
from flowgger_tpu.mergers import LineMerger as JLineMerger
from flowgger_tpu.mergers import NulMerger as JNulMerger
from flowgger_tpu.mergers import SyslenMerger as JSyslenMerger
from flowgger_tpu.tpu.encode_gelf_block import (
    encode_rfc5424_gelf_block as jencode_block)

from flowgger_tpu_torch import native
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import make_corpus, scalar_expectation
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import assemble, device_common, pack
from flowgger_tpu_torch.tpu.encode_gelf_block import encode_rfc5424_gelf_block
from flowgger_tpu_torch.tpu.rfc5424 import decode_rfc5424_host
from flowgger_tpu_torch.utils.rustfmt import json_f64


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
MAX_LEN = 512


def _same(a, b):
    """Equal tuples of arrays, ints, bools and bytes (dtypes included)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("nseg", [0, 3, 20000])
def test_concat_segments(nseg):
    """Zero-length segments, a total of 0, and a threaded gather."""
    rng = np.random.default_rng(nseg)
    src = rng.integers(0, 256, 4096, dtype=np.uint8)
    seg_len = rng.integers(0, 9, nseg).astype(np.int64)
    seg_len[::3] = 0
    seg_src = rng.integers(0, src.size - 8, nseg).astype(np.int64)
    dst0 = assemble.exclusive_cumsum(seg_len)
    got = assemble.concat_segments(src, seg_src, seg_len, dst0)
    want = assemble._concat_segments_np(src, seg_src, seg_len)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ref = jnative.concat_segments_native(src, seg_src, seg_len, dst0,
                                         int(dst0[-1]))
    assert np.array_equal(got, ref)
    zero = assemble.concat_segments(src, seg_src, np.zeros(nseg, np.int64))
    assert zero.size == 0


BAD_CONCAT = {
    # (seg_src, seg_len, dst_off, total) with a segment outside a buffer
    "src-end": ([0, 4090], [4, 8], [0, 4], 12),
    "src-negative": ([0, -1], [4, 2], [0, 4], 6),
    "len-negative": ([0, 8], [4, -2], [0, 4], 6),
    "dst-negative": ([0, 8], [4, 2], [-4, 4], 6),
    "dst-middle-past-total": ([0, 8, 16], [4, 2, 1], [0, 9, 6], 7),
}


@pytest.mark.parametrize("name", list(BAD_CONCAT))
def test_concat_segments_refuses_segments_outside(name):
    src = np.arange(4096, dtype=np.int64).astype(np.uint8)
    seg_src, seg_len, dst_off, total = BAD_CONCAT[name]
    with pytest.raises(ValueError):
        native.concat_segments_native(src, np.array(seg_src),
                                      np.array(seg_len), np.array(dst_off),
                                      total)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_exports_do_not_depend_on_the_thread_count(threads, monkeypatch):
    """Above the library's threading thresholds, any worker count gives
    the same bytes."""
    rng = np.random.default_rng(threads)
    src = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    seg_len = rng.integers(0, 40, 30000).astype(np.int64)
    seg_src = rng.integers(0, src.size - 40, seg_len.size).astype(np.int64)
    vals = _f64_fuzz(20000, seed=threads)
    monkeypatch.setattr(native, "_DEFAULT_THREADS", threads)
    got = assemble.concat_segments(src, seg_src, seg_len)
    txt, lens = native.format_f64_json_native(vals, device_common.TS_W)
    assert np.array_equal(got,
                          assemble._concat_segments_np(src, seg_src, seg_len))
    rtxt, rlens = jnative.format_f64_json_native(vals, device_common.TS_W)
    assert np.array_equal(txt, rtxt) and np.array_equal(lens, rlens)


def _f64_fuzz(n=10000, seed=5):
    rng = np.random.default_rng(seed)
    parts = [
        rng.uniform(1.0e9, 2.0e9, n // 5).round(6),          # stamps
        -rng.uniform(0, 1e6, n // 10),
        rng.integers(-10**6, 10**6, n // 10).astype(np.float64),
        10.0 ** rng.uniform(15, 21, n // 10),                 # 1e15-1e21
        np.sign(rng.standard_normal(n // 5))
        * 10.0 ** rng.uniform(-320, 308, n // 5),             # exponents
        rng.standard_normal(n // 5) * 1e-4,
        np.array([0.0, -0.0, 1e16, 1e15, 1e21, 1e-4, 1e-5, 5e-324,
                  1.7976931348623157e308, 0.1, 123456789012345680.0,
                  np.nan, np.inf, -np.inf]),
    ]
    return np.concatenate(parts)


def test_format_f64_json():
    vals = _f64_fuzz()
    txt, lens = native.format_f64_json_native(vals, device_common.TS_W)
    rtxt, rlens = jnative.format_f64_json_native(vals, device_common.TS_W)
    assert np.array_equal(txt, rtxt) and np.array_equal(lens, rlens)
    for i, v in enumerate(vals.tolist()):
        s = json_f64(v).encode()
        assert bytes(txt[i, :lens[i]]) == s, (v, s)
        assert not txt[i, lens[i]:].any()
    # a text wider than the row gets length 0 and a zero row
    t, ln = native.format_f64_json_native(np.array([1.25, 1438790025.5]), 6)
    assert ln.tolist() == [4, 0] and not t[1].any()


def test_ts_text_block_matches_its_plain_version():
    rng = np.random.default_rng(2)
    n = 3000
    small = {"ok": rng.random(n) < 0.9,
             "days": rng.integers(16000, 20000, n).astype(np.int32),
             "sod": rng.integers(0, 86400, n).astype(np.int32),
             "off": rng.integers(-720, 720, n).astype(np.int32),
             "nanos": (rng.integers(0, 10**6, n) * 1000).astype(np.int32)}
    small["nanos"][::7] = 0
    got = device_common.ts_text_block(small)
    _same(got, device_common._ts_text_block_np(small))


def _decoded(lines):
    packed = pack.pack_lines_2d(lines, MAX_LEN)
    batch, lens, chunk, starts, orig_lens, n = packed
    host = decode_rfc5424_host(torch.from_numpy(batch), torch.from_numpy(lens))
    return chunk, starts, orig_lens, host, n


MERGERS = {"line": (LineMerger, JLineMerger), "nul": (NulMerger, JNulMerger),
           "syslen": (SyslenMerger, JSyslenMerger)}


@pytest.mark.parametrize("merger", list(MERGERS))
def test_block_encoder_engines(merger, monkeypatch):
    """512 rows of the corpus, decoded once by the port's plain K1: the
    native engine, the numpy engine and the JAX package's block encoder
    give the same bytes and errors; the oracle rows are exactly the
    native rule's complement, and the numpy engine sends more rows
    there."""
    lines, _ = make_corpus(512, seed=20261016)
    chunk, starts, orig_lens, host, n = _decoded(lines)
    tm, jm = MERGERS[merger]
    enc = GelfEncoder(Config.from_string(""))
    args = (chunk, starts, orig_lens, host, n, MAX_LEN)
    native.reset_calls()
    nat = encode_rfc5424_gelf_block(*args, enc, tm())
    assert native.CALLS["fg_gelf_lens_v2"] == 1
    assert native.CALLS["fg_gelf_write_v2"] == 1
    with monkeypatch.context() as m:
        m.setattr(native, "gelf_rows_available", lambda: False)
        nump = encode_rfc5424_gelf_block(*args, enc, tm())
    ref = jencode_block(*args, JGelfEncoder(Config.from_string("")), jm())
    exp, errs = scalar_expectation(b"\n".join(lines) + b"\n", merger=tm())
    for res in (nat, nump, ref):
        assert bytes(res.block.data) == exp
        assert [f"{e}: [{ln.strip()}]" for e, ln in res.errors] == errs
    rule = (host["ok"][:n].astype(bool) & (orig_lens[:n] <= MAX_LEN)
            & ~host["has_high"][:n].astype(bool))
    assert nat.fallback_rows == ref.fallback_rows == int((~rule).sum())
    assert nump.fallback_rows > nat.fallback_rows


def test_rows_only_the_native_engine_keeps(monkeypatch):
    """An escaped SD value, a duplicate name and a 49-byte name stay in
    the native engine's tier and go to the oracle under the numpy
    engine; the bytes equal the scalar path's either way."""
    head = b"<13>1 2015-08-05T15:53:45.5Z host app 42 m "
    lines = [head + b'[id k="a\\"b\\]c\\\\d"] escaped',
             head + b'[id k="1" z="x" k="2"] duplicate',
             head + b'[id ' + b"n" * 49 + b'="v"] long name',
             head + b'[id k="v"] plain']
    chunk, starts, orig_lens, host, n = _decoded(lines)
    enc = GelfEncoder(Config.from_string(""))
    exp, errs = scalar_expectation(b"\n".join(lines) + b"\n",
                                   merger=LineMerger())
    assert not errs
    nat = encode_rfc5424_gelf_block(chunk, starts, orig_lens, host, n,
                                    MAX_LEN, enc, LineMerger())
    monkeypatch.setattr(native, "gelf_rows_available", lambda: False)
    nump = encode_rfc5424_gelf_block(chunk, starts, orig_lens, host, n,
                                     MAX_LEN, enc, LineMerger())
    assert bytes(nat.block.data) == bytes(nump.block.data) == exp
    assert (nat.fallback_rows, nump.fallback_rows) == (0, 3)


def test_gelf_rows_refuses_spans_outside_the_chunk():
    meta = np.zeros((1, 17), np.int32)
    meta[0, 2] = 9   # host end past an 8-byte chunk
    empty = np.zeros((1, 0), np.int32)
    with pytest.raises(ValueError):
        native.gelf_rows_native(b"x" * 8, meta, empty, empty, empty, empty,
                                empty, b"", b"\n", False)


BAD_GELF = {
    # meta column (M_* order) or pair table -> value, over one row of an
    # 8-byte chunk with a 4-byte timestamp scratch and one pair
    "host-reversed": ("meta", 1, 3),
    "app-reversed": ("meta", 3, 3),
    "proc-reversed": ("meta", 5, 4),
    "full-message-reversed": ("meta", 8, 2),
    "sd-id-reversed": ("meta", 13, 2),
    "ts-past-scratch": ("meta", 14, 2),
    "ts-length-negative": ("meta", 15, -1),
    "pairs-over-table": ("meta", 16, 2),
    "pairs-negative": ("meta", 16, -1),
    "name-reversed": ("pne", 0, 3),
    "value-reversed": ("pve", 0, 5),
    "value-past-chunk": ("pve", 0, 9),
}


@pytest.mark.parametrize("name", list(BAD_GELF))
def test_gelf_rows_refuses_bad_spans(name):
    """Every span the engine reads is checked before the call: inside
    its buffer, its end at or past its start, the pair count within the
    table."""
    meta = np.zeros((1, 17), np.int32)
    # host 0-1, app 1-2, proc 2-3, message and full message 3-8, SD id
    # 3-4 in a row with structured data, timestamp 0-4, one pair
    meta[0, 1:10] = [0, 1, 1, 2, 2, 3, 3, 8, 3]
    meta[0, 11:17] = [1, 3, 4, 0, 4, 1]
    tables = {k: np.array([[v]], np.int32)
              for k, v in (("pns", 4), ("pne", 5), ("pvs", 6), ("pve", 8))}
    args = lambda: (b"x" * 8, meta, tables["pns"], tables["pne"],  # noqa
                    tables["pvs"], tables["pve"],
                    np.zeros((1, 1), np.int32), b"1234", b"\n", False)
    native.gelf_rows_native(*args())   # the row as built is accepted
    where, col, val = BAD_GELF[name]
    if where == "meta":
        meta[0, col] = val
    else:
        tables[where][0, col] = val
    with pytest.raises(ValueError):
        native.gelf_rows_native(*args())


def test_loader_builds_once_under_build_host(tmp_path, monkeypatch):
    res = native.build()
    assert Path(res["path"]).parent == ROOT / "build" / "host"
    assert Path(res["path"]).exists() and res["flags"] == " ".join(
        native.CXX_FLAGS)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "host")
    fresh, cached = native.build(), native.build()
    assert not fresh["cached"] and cached["cached"]
    assert fresh["path"] == cached["path"]
    assert [p.name for p in (tmp_path / "host").iterdir()] == [
        Path(fresh["path"]).name]


def test_loader_raises_without_a_compiler(tmp_path, monkeypatch):
    """No g++: every wrapper raises, none returns None; a source that
    does not compile raises with the compiler's output."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "host")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.concat_segments_native(np.zeros(4, np.uint8), [0], [1], [0],
                                      1)
    with pytest.raises(RuntimeError, match="not found"):
        native.gelf_rows_available()
    monkeypatch.setattr(native, "CXX", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "_SRC", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.format_f64_json_native(np.ones(3), 32)
    assert native._lib is None


def test_host_library_under_sanitizers(tmp_path):
    """The copied C++ self-test, built with ASan and UBSan over the
    port's source, runs clean."""
    exe = tmp_path / "test_host"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fno-omit-frame-pointer", "-std=c++17",
         "-pthread", "-Wall", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-o", str(exe),
         str(ROOT / "flowgger_tpu_torch" / "csrc" / "flowgger_host.cpp"),
         str(ROOT / "tests" / "native_host" / "test_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "native self-test ok" in run.stdout
