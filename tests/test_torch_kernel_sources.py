"""The CUDA kernel sources of flowgger_tpu_torch/csrc, compiled for the
CPU with g++ through the host emulation in tests/cuda_host, against the
plain PyTorch versions they replace.

A CUDA kernel has no interpret mode, and this box has no nvcc and no
card; the emulation runs every CUDA thread of a block as a host thread
(barriers for __syncthreads, a slot exchange for warp shuffles, ballots
and reductions), so the kernels' indexing, scans and per-row logic are
checked here exactly as written, and each emulated intrinsic is checked
against its definition.  Speed and the GPU memory model are not:
chip_smoke.py holds the nvcc builds against the same plain versions on
the card.
"""

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import (make_corpus, make_jsonl_corpus,
                                       syslen_stream)
from flowgger_tpu_torch.tpu import framing as F
from flowgger_tpu_torch.tpu import jsonidx as JI
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as T

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_host")
    names = ("decode_rfc5424", "frame_sep_spans", "frame_gather",
             "frame_syslen_spans", "structural_index")
    with ThreadPoolExecutor(len(names) + 1) as ex:
        probe = ex.submit(host_build.build, "intrinsics_probe", out,
                          host_build.HERE)
        paths = dict(zip(names, ex.map(
            lambda n: host_build.build(n, out), names)))
        paths["probe"] = probe.result()
    libs = {n: ctypes.CDLL(str(p)) for n, p in paths.items()}
    for p in (6, 16):
        fn = getattr(libs["decode_rfc5424"], f"fg_decode_rfc5424_sd4_p{p}")
        fn.argtypes, fn.restype = [_P, _P, _P, _I, _I, _P], _I
    fn = libs["frame_sep_spans"].fg_frame_sep_spans
    fn.argtypes, fn.restype = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I
    fn = libs["frame_gather"].fg_frame_gather
    fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _I, _I, _P, _P, _P]
    fn.restype = _I
    fn = libs["frame_syslen_spans"].fg_frame_syslen_spans
    fn.argtypes, fn.restype = [_P, _I, _I, _P, _P, _P, _P], _I
    for f in (8, 24):
        fn = getattr(libs["structural_index"], f"fg_structural_index_f{f}")
        fn.argtypes, fn.restype = [_P, _P, _P, _I, _I, _I, _P], _I
    fn = libs["probe"].fg_probe_intrinsics
    fn.argtypes, fn.restype = [_P, _P, _P], _I
    return libs


def test_emulated_intrinsics_match_definitions(libs):
    """Each warp intrinsic and atomic of cuda_host/cuda_runtime.h, run by
    two warps on seeded values (zero and negative ones included), equals
    its definition."""
    rng = np.random.default_rng(5)
    v = rng.integers(-2 ** 31, 2 ** 31, 64, dtype=np.int64)
    v[[0, 9, 40]] = 0
    v[[3, 33]] = -1
    v[[5, 50]] = 1 << 20
    x = v.astype(np.int32)
    out = np.full((64, 10), -7, np.int32)
    acc = np.zeros(4, np.uint32)
    assert libs["probe"].fg_probe_intrinsics(_ptr(x), _ptr(out),
                                             _ptr(acc)) == 0
    u = v & 0xFFFFFFFF
    for t in range(64):
        w, lane = t & ~31, t & 31
        warp = u[w:w + 32]
        ballot = sum(int(b & 1) << k for k, b in enumerate(warp))
        want = [
            x[w | ((lane * 7 + 3) & 31)],             # __shfl_sync
            x[t - 3] if lane >= 3 else x[t],           # __shfl_up_sync
            x[t + 5] if lane + 5 < 32 else x[t],       # __shfl_down_sync
            x[w | (lane ^ 6)],                         # __shfl_xor_sync
            np.uint32(ballot).view(np.int32),          # __ballot_sync
            np.uint32(int(warp.sum()) & 0xFFFFFFFF).view(np.int32),
            bin(int(u[t])).count("1"),                 # __popc
            (int(u[t]) & -int(u[t])).bit_length(),     # __ffs
            32 - int(u[t]).bit_length(),               # __clz
            x[w | ((lane + 1) & 31)],                  # __syncwarp
        ]
        assert list(out[t]) == [int(a) for a in want], t
    assert list(acc) == [int(u[k::4].sum()) & 0xFFFFFFFF for k in range(4)]


def _lines():
    from test_torch_rfc5424 import _escape_lines, _pairs_lines

    lines, _ = make_corpus(150, seed=17)
    return lines + _pairs_lines() + _escape_lines()


def _decode_check(libs, lines, L, max_pairs):
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    out = np.full((T.n_channels(4, max_pairs), batch.shape[0]), -7, np.int32)
    fn = getattr(libs["decode_rfc5424"], f"fg_decode_rfc5424_sd4_p{max_pairs}")
    assert fn(_ptr(batch), _ptr(lens), _ptr(out), batch.shape[0], L,
              None) == 0
    got = T.unpack_channels(torch.from_numpy(out), 4, max_pairs)
    ref = T.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens),
                           max_pairs=max_pairs)
    assert ref["ok"].any() and not ref["ok"].all()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("L", [512, 96])
@pytest.mark.parametrize("max_pairs", [6, 16])
def test_decode_kernel_source_matches_plain(libs, L, max_pairs):
    """Every channel on every row — padding and rejected rows included —
    equals the plain version (the stricter form of chip_smoke's rule)."""
    _decode_check(libs, _lines(), L, max_pairs)


HEAD = "<13>1 2015-08-05T15:53:45.123Z {host} app 42 m1 "
# structures that the hostname shifts across every lane of a 32-byte
# chunk: escape runs of 1-3, 15-17 and 31-33 backslashes (a run of 16 or
# more before a quote rejects the row), quotes, ']', '=', empty values,
# several SD elements, a dash SD with quotes and ']' in the message
BOUNDARY_SD = [
    '[id k="v" k2="a\\\\\\"b"][x@1 y="z" w=""] m',
    '[id k="' + "\\" * 15 + '" j="' + "\\" * 16 + '"] m',
    '[id k="' + "\\" * 17 + 'x" l="a' + "\\" * 2 + '"] m',
    '[id k="' + "\\" * 31 + 'x" l="' + "\\" * 33 + '"][b c="d"] m',
    '[id k="' + "\\" * 32 + '"] m',
    '- msg  with "quotes" ] and = signs  ',
    '[a b="c"][d e="f"][g h="i"][j k="l"] m',
]


def _boundary_lines(L):
    """Rows whose structure lands on lanes 0 and 31 and straddles 32-byte
    chunk boundaries (the hostname grows one byte at a time, with and
    without a BOM), and rows of length 31, 32, 33, L - 1, L and L + 1."""
    out = []
    for sd in BOUNDARY_SD:
        for shift in range(33):
            line = HEAD.format(host="h" * (1 + shift)) + sd
            out.append(("\ufeff" if shift % 11 == 5 else "") + line)
    base = HEAD.format(host="host") + '[id k="v"] message'
    for n in (31, 32, 33):
        out.append(base[:n])
        out.append(base[:n - 1] + " ")
    for n in (L - 1, L, L + 1):
        out.append(base + "x" * (n - len(base)))
        out.append(base[:-7] + " " * (n - len(base) + 7))
    return [ln.encode() for ln in out]


@pytest.mark.parametrize("L", [512, 96, 100])
@pytest.mark.parametrize("max_pairs", [6, 16])
def test_decode_kernel_source_chunk_boundaries(libs, L, max_pairs):
    """The warp-per-row scans carry state across 32-position chunks: every
    channel of every boundary row equals the plain version, at a row
    width that is a multiple of 16 bytes (vector staging) and at one
    that is not (byte staging)."""
    _decode_check(libs, _boundary_lines(L), L, max_pairs)


def _spans(libs, reg, rlen, sep, strip_cr, ncap):
    ntiles = max(1, -(-rlen // 4096))
    scratch = np.zeros(2 * ntiles, np.int32)
    starts = np.full(ncap, -7, np.int32)
    lens = np.full(ncap, -7, np.int32)
    meta = np.full(4, -7, np.int32)
    rc = libs["frame_sep_spans"].fg_frame_sep_spans(
        _ptr(reg), rlen, sep, int(strip_cr), ncap, _ptr(scratch),
        _ptr(scratch[ntiles:]), _ptr(starts), _ptr(lens), _ptr(meta), None)
    assert rc == 0
    return starts, lens, meta


@pytest.mark.parametrize("sep,strip_cr,n_recs,tail,ncap", [
    (10, True, 900, b"", 1024),          # several 4 KiB tiles
    (10, True, 900, b"partial", 512),    # span overflow
    (0, False, 300, b"x\r", 512),
    (10, True, 0, b"no separator", 256),
    (10, False, 50, b"", 64),
])
def test_sep_spans_kernel_source_matches_plain(libs, sep, strip_cr, n_recs,
                                               tail, ncap):
    rng = np.random.default_rng(n_recs + ncap)
    recs = [bytes(rng.integers(32, 127, int(rng.integers(0, 70)))
                  .astype(np.uint8)) + (b"\r" if i % 4 == 0 else b"")
            for i in range(n_recs)]
    blob = b"".join(r + bytes([sep]) for r in recs) + tail
    reg = np.zeros(F.region_bucket(len(blob)), np.uint8)
    reg[:len(blob)] = np.frombuffer(blob, np.uint8)
    starts, lens, meta = _spans(libs, reg, len(blob), sep, strip_cr, ncap)
    ref = F.frame_sep_spans(torch.from_numpy(reg), len(blob), sep=sep,
                            strip_cr=strip_cr, ncap=ncap)
    assert np.array_equal(starts, ref["starts"].numpy())
    assert np.array_equal(lens, ref["lens"].numpy())
    assert list(meta[:3]) == [int(ref["n"]), int(ref["consumed"]),
                              int(ref["overflow"])]


def test_gather_kernel_source_matches_plain(libs):
    rng = np.random.default_rng(2)
    recs = [bytes(rng.integers(32, 127, int(rng.integers(0, 200)))
                  .astype(np.uint8)) for _ in range(200)]
    blob = b"".join(r + b"\n" for r in recs)
    reg = np.zeros(F.region_bucket(len(blob)), np.uint8)
    reg[:len(blob)] = np.frombuffer(blob, np.uint8)
    starts, lens, _ = _spans(libs, reg, len(blob), 10, True, 256)
    max_len = 128   # records longer than this clip
    out = np.zeros((256, max_len), np.uint8)
    lens_c = np.zeros(256, np.int32)
    assert libs["frame_gather"].fg_frame_gather(
        _ptr(reg), reg.shape[0], _ptr(starts), _ptr(lens), 256, max_len,
        _ptr(out), _ptr(lens_c), None) == 0
    rb, rl = F.frame_gather(torch.from_numpy(reg), torch.from_numpy(starts),
                            torch.from_numpy(lens), max_len)
    assert np.array_equal(out, rb.numpy()) and np.array_equal(lens_c,
                                                              rl.numpy())


def _json_lines():
    from test_torch_jsonl import EDGE_LINES

    return ([ln.encode() for ln in EDGE_LINES]
            + make_jsonl_corpus(300, seed=19)[0])


def _index_check(libs, lines, L, max_fields):
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    out = np.full((JI.n_channels(max_fields), batch.shape[0]), -7, np.int32)
    fn = getattr(libs["structural_index"], f"fg_structural_index_f{max_fields}")
    assert fn(_ptr(batch), _ptr(lens), _ptr(out), batch.shape[0], L, 4,
              None) == 0
    got = JI.unpack_channels(torch.from_numpy(out), max_fields)
    ref = JI.structural_index(torch.from_numpy(batch), torch.from_numpy(lens),
                              max_fields, nested=4)
    assert ref["ok"].any() and not ref["ok"].all()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("L", [512, 96])
@pytest.mark.parametrize("max_fields", [8, 24])
def test_structural_index_kernel_source_matches_plain(libs, L, max_fields):
    """Every channel on every row — padding, rejected and over-long rows
    included — equals the plain structural index."""
    _index_check(libs, _json_lines(), L, max_fields)


def _keys(n):
    return ",".join(f'"k{j}":{j}' for j in range(n))


# structures (the text after the shifting first field) whose running
# state the warp scans carry across 32-position chunks: backslash runs
# before a quote (16 or more flag the row), outside-string whitespace
# runs of 8 and 9 (9 flags it), previous / next significant bytes 1-9
# positions away (the window holds 8), literal words, depth changes and
# nested closes, and more keys than either field budget
JSON_FEATURES = (
    ['"s":"' + "\\" * r + ('"' if r % 2 == 0 else 'x"') + ',"t":1'
     for r in (15, 16, 17, 31, 32, 33, 40)]
    + ['"k":' + " " * w + '1,"t":2' for w in (8, 9)]
    + ['"k":1' + " " * w + ',"t":2' for w in (8, 9)]
    + ['"k":' + " " * w + '"v"' for w in range(9)]
    + ['"k"' + " " * w + ':"v"' for w in range(9)]
    + ['"k":"v"' + " " * w + ',"t":1' for w in range(9)]
    + ['"k":[1' + " " * w + '],"t":1' for w in range(9)]
    + ['"k":' + v + ',"t":1' for v in ("true", "false", "null", "truex",
                                       "fals", "nul", "-12.5e3")]
    + ['"k":' + v for v in ("true", "false", "null")]
    + ['"k":{"a":[1,{"b":2}],"c":{}},"t":[]',
       '"k":[[[[[1]]]]]',
       '"k":[[[[1]]]]',
       '"k":{"a":1}x,"t":1',
       '"k":{"a":"}"}]',
       '"k":[1,2}',
       _keys(9), _keys(24), _keys(25)])


def _json_boundary_lines(L):
    """Each feature starting at positions 24-40 (a padding string value
    grows one byte at a time), and ending at the row's last bytes: rows
    of L - 3 to L bytes and over-long rows clipped inside the feature."""
    out, head = [], '{"p":"'
    for feat in JSON_FEATURES:
        for start in range(24, 41):
            pad = start - len(head) - 2
            out.append(head + "a" * pad + '",' + feat + "}")
        tail = '",' + feat + "}"
        for total in (L - 3, L - 2, L - 1, L, L + 1, L + 3):
            pad = total - len(head) - len(tail)
            if pad >= 0:
                out.append(head + "a" * pad + tail)
    out += ['{"p":' + " " * 9 + "1}", '{"p":1}' + " " * 8, "{" + " " * 40,
            '{"p":"' + "\\" * 40 + '"}']
    # a row cut inside a literal word after eight rows that hold the word
    # whole: the kernel reuses a warp's staging slot from block to block,
    # and bytes past a row's length must read as 0, not as the last row's
    out += [""] * (-len(out) % 8)
    for word in ("true", "false", "null"):
        out += ['{"p":1,"k":' + word + "}"] * 8 + ['{"p":1,"k":' + word[:-1]] * 8
    return [ln.encode() for ln in out]


@pytest.mark.parametrize("L", [512, 96, 100])
@pytest.mark.parametrize("max_fields", [8, 24])
def test_structural_index_kernel_source_chunk_boundaries(libs, L, max_fields):
    """The warp-per-row scans carry state across 32-position chunks: every
    channel of every boundary row equals the plain structural index, at
    a row width that is a multiple of 16 bytes (vector staging) and at
    one that is not (byte staging)."""
    _index_check(libs, _json_boundary_lines(L), L, max_fields)


def _syslen_cases():
    from test_torch_syslen import CASES, _region

    out = [(name, *_region(recs, extra), 64) for name, recs, extra in CASES]
    lines, _ = make_corpus(600, seed=29)
    blob = syslen_stream(lines)
    reg = np.zeros(F.region_bucket(len(blob)), np.uint8)
    reg[:len(blob)] = np.frombuffer(blob, np.uint8)
    out.append(("corpus", reg, len(blob), 1024))
    out.append(("corpus-overflow", reg, len(blob), 512))
    return out


def _syslen_check(libs, name, reg, rlen, ncap):
    fn = libs["frame_syslen_spans"].fg_frame_syslen_spans
    starts = np.full(ncap, -7, np.int32)
    lens = np.full(ncap, -7, np.int32)
    meta = np.full(4, -7, np.int32)
    assert fn(_ptr(reg), rlen, ncap, _ptr(starts), _ptr(lens), _ptr(meta),
              None) == 0
    ref = F.frame_syslen_spans(torch.from_numpy(reg), rlen, ncap=ncap)
    assert bool(meta[3]) == bool(ref["decline"]), name
    if not meta[3]:
        assert np.array_equal(starts, ref["starts"].numpy()), name
        assert np.array_equal(lens, ref["lens"].numpy()), name
        assert list(meta[:3]) == [int(ref["n"]), int(ref["consumed"]),
                                  int(ref["err"])], name
    return meta


def test_syslen_spans_kernel_source_matches_plain(libs):
    """The chain walk equals the plain version wherever the plain version
    does not decline, and declines exactly where it does."""
    for name, reg, rlen, ncap in _syslen_cases():
        _syslen_check(libs, name, reg, rlen, ncap)


WINDOW = 200 * 1024   # bytes a window stages (kWindow, frame_syslen_spans.cu)


def _as_region(blob: bytes, offset: int = 0):
    """blob as a u8 array exactly rlen long, starting ``offset`` bytes
    past a 16-byte boundary (an offset stages the window byte by byte)."""
    buf = np.zeros(len(blob) + 32, np.uint8)
    at = -buf.ctypes.data % 16 + offset
    reg = buf[at:at + len(blob)]
    reg[:] = np.frombuffer(blob, np.uint8)
    return reg


@pytest.mark.parametrize("offset", [0, 1])
def test_syslen_spans_kernel_source_refills_window(libs, offset):
    """A corpus region larger than one shared-memory window: the walk
    refills the window from a head and goes on; the span capacity ends
    the chain inside the second window (a decline) one frame early."""
    lines, _ = make_corpus(1400, seed=31)
    blob = syslen_stream(lines)
    assert len(blob) > WINDOW + 16 * 1024
    reg = _as_region(blob, offset)
    meta = _syslen_check(libs, "corpus-large", reg, len(blob), 2048)
    assert meta[3] == 0 and meta[0] == 1399 and meta[1] < len(blob)
    meta = _syslen_check(libs, "corpus-large-overflow", reg, len(blob),
                         int(meta[0]) - 1)
    assert meta[3] == 1


def _frame(body: bytes) -> bytes:
    return b"%d " % len(body) + body


def _filler_to(head: int) -> bytes:
    """One frame whose successor starts at ``head``."""
    for digits in range(1, 8):
        n = head - digits - 1
        if len(str(n)) == digits:
            return b"%d " % n + b"a" * n
    raise ValueError(head)


# what follows the window-edge head, and whether the chain runs past it
EDGE_TAILS = {
    "frames": _frame(b"x" * 12345) + _frame(b"hello") + b"3 ab",
    "ten-digit-prefix": b"0000000003 abc",        # decline
    "forty-digit-prefix": b"1" * 40 + b" x",      # decline (slow path)
    "forty-digits-garbage": b"1" * 40 + b"x y",   # stop, err (slow path)
    "bad-prefix": b"12x 5 abc",                   # stop, err
    "empty-prefix": b" 5 abc",                    # stop, err
    "no-space-after": b"77x",                     # stop, no err
}
# heads around the first window's edge: a hop reads 32 bytes, so a head
# past WINDOW - 32 refills; a 5-digit prefix at WINDOW - 3 straddles it
EDGE_HEADS = [WINDOW - 40, WINDOW - 33, WINDOW - 32, WINDOW - 31,
              WINDOW - 3, WINDOW + 7]


@pytest.mark.parametrize("head", EDGE_HEADS)
@pytest.mark.parametrize("tail", list(EDGE_TAILS))
def test_syslen_spans_kernel_source_window_edge(libs, head, tail):
    blob = _filler_to(head) + EDGE_TAILS[tail]
    meta = _syslen_check(libs, tail, _as_region(blob), len(blob), 16)
    assert meta[0] >= 1
