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
import functools
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from flowgger_tpu_torch.corpus import (make_corpus, make_jsonl_corpus,
                                       syslen_stream)
from flowgger_tpu_torch.tpu import device_gelf as DG
from flowgger_tpu_torch.tpu import framing as F
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import jsonidx as JI
from flowgger_tpu_torch.tpu import kernels as K
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
             "frame_syslen_spans", "structural_index", "fused_gelf")
    with ThreadPoolExecutor(len(names) + 2) as ex:
        probe = ex.submit(host_build.build, "intrinsics_probe", out,
                          host_build.HERE)
        lookback = ex.submit(host_build.build, "lookback_probe", out,
                             host_build.HERE)
        paths = dict(zip(names, ex.map(
            lambda n: host_build.build(n, out), names)))
        paths["probe"] = probe.result()
        paths["lookback"] = lookback.result()
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
    fn = libs["fused_gelf"].fg_fused_rfc5424_gelf_probe
    fn.argtypes, fn.restype = [_P] * 3 + [_I] * 3 + [_P] * 5, _I
    fn = libs["probe"].fg_probe_intrinsics
    fn.argtypes, fn.restype = [_P, _P, _P], _I
    fn = libs["lookback"].fg_probe_lookback
    fn.argtypes, fn.restype = [_P, _P, _I, _P], _I
    return libs


def test_emulated_intrinsics_match_definitions(libs):
    """Each warp intrinsic, atomic and fence of cuda_host/cuda_runtime.h,
    run by two warps on seeded values (zero and negative ones included),
    equals its definition (the fence: a value stored before it is read
    by a thread that saw the flag stored after it)."""
    rng = np.random.default_rng(5)
    v = rng.integers(-2 ** 31, 2 ** 31, 64, dtype=np.int64)
    v[[0, 9, 40]] = 0
    v[[3, 33]] = -1
    v[[5, 50]] = 1 << 20
    x = v.astype(np.int32)
    out = np.full((64, 12), -7, np.int32)
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
            np.uint32(warp.max()).view(np.int32),     # __reduce_max_sync
            x[32] if t == 0 else x[t],                 # __threadfence
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


def _exact_rows(lines, L):
    """``lines`` packed at width ``L``, exactly one row a line (no
    padding rows: the other cases cover those)."""
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    n = len(lines)
    return (np.ascontiguousarray(batch[:n]),
            np.ascontiguousarray(lens[:n]).astype(np.int32))


def _k1_rows_check(libs, batch, lens, L, max_pairs):
    """Every K1 channel of every row equal to the plain version; returns
    the plain decode."""
    out = np.full((T.n_channels(4, max_pairs), batch.shape[0]), -7, np.int32)
    fn = getattr(libs["decode_rfc5424"], f"fg_decode_rfc5424_sd4_p{max_pairs}")
    assert fn(_ptr(batch), _ptr(lens), _ptr(out), batch.shape[0], L,
              None) == 0
    got = T.unpack_channels(torch.from_numpy(out), 4, max_pairs)
    ref = T.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens),
                           max_pairs=max_pairs)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    return ref


def _fused_probe_check(libs, batch, lens, L):
    """F1's probe on every row of ``batch`` against the plain route: the
    base tier bit and length, the small channels and every tier row's
    carried channels (the word-parallel decode as F1 runs it).  Returns
    the tier rows."""
    N = n = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    route = "rfc5424_gelf"
    dec = {k: v for k, v in T.decode_rfc5424(bt, lt).items()
           if k in FR.DEMAND[route]}
    _, table = DG.kernel_consts(b"\n")
    tier = np.full(N, 7, np.uint8)
    base_len = np.full(N, -1, np.int32)
    small = np.full((5, N), -9, np.int32)
    chan = np.full((N, K.FUSED_CARRY["rfc5424"]), -5, np.int32)
    assert libs["fused_gelf"].fg_fused_rfc5424_gelf_probe(
        _ptr(batch), _ptr(lens), table, N, n, L, _ptr(tier), _ptr(base_len),
        _ptr(small), _ptr(chan), None) == 0
    ref_base, ref_len = DG.encode_rows(bt, lt, dec, assemble=False, n=n,
                                       suffix=b"\n", max_sd=4)
    assert (tier == ref_base.numpy()).all()
    assert (base_len == ref_len.numpy()).all()
    want = np.stack([dec[k].to(torch.int32).numpy()
                     for k in ("ok", "days", "sod", "off", "nanos")])
    assert (small == want).all()
    on = tier.astype(bool)
    assert (chan[on] == FR.carried_plain(dec, route).numpy()[on]).all()
    assert (chan[~on] == -5).all()
    return int(on.sum())


def _bitmask_lines(L):
    """Rows aimed at the word-parallel rfc5424 decode: backslash runs of
    14-17 and 31-33 that straddle a 32-position word (a run of 16 or more
    before a quote rejects the row), a quote after a capped run, ']', '='
    and spaces inside quotes across words, and rows of length 0, 1, 31,
    32, 33, L - 1, L and more than L.  At L > 1024 a long first value
    pushes the structures into the second round of 32 words."""
    pad = '[p q="' + "y" * 1000 + '"]' if L > 1024 else ""
    head = "<13>1 2015-08-05T15:53:45.5+01:00 {host} app 42 m1 " + pad
    sds = []
    for run in (14, 15, 16, 17, 31, 32, 33):
        sds.append('[id k="' + "\\" * run + '" j="v"] m')
        sds.append('[id k="a' + "\\" * run + 'x" j="' + "\\" * (run - 1)
                   + '"] m')
    sds += [
        '[id k="' + "\\" * 16 + '"x" y="z"] m',          # capped, then a quote
        '[id k="' + "\\" * 17 + '"" y="z"] m',
        '[id k="a ] b = c ]] = " n="  ]  = "][x@2 y="] ="] msg ] = "',
        '[id k="' + " " * 40 + "]" * 33 + "=" * 33 + '" z=""] m',
        '[id  k="v"] m', '[id k ="v"] m', '[id k="v" ] m', '[id k="v"]m',
    ]
    out = []
    for sd in sds:
        for shift in (0, 9, 18, 27):
            out.append(head.format(host="h" * (1 + shift)) + sd)
    base = head.format(host="host") + '[id k="v" w="x y"] message'
    # a message from the second word to the row's end (over two rounds
    # of words at L > 1024)
    dash = "<13>1 2015-08-05T15:53:45Z h app 42 m1 -  msg" + " m" * L
    for n in (0, 1, 31, 32, 33, L - 1, L, L + 1, L + 40):
        out.append((base + "z" * max(0, n - len(base)))[:n])
        out.append(dash[:n])
    out = [ln.encode("latin-1") for ln in out]
    out.append(b"<13>1 2015-08-05T15:53:45Z h a p m [id k=\"\xc3\xa9\"] \xff")
    return out


@pytest.mark.parametrize("L", [4, 100, 512, 1100])
@pytest.mark.parametrize("max_pairs", [6, 16])
def test_decode_kernel_source_bitmask_rows(libs, L, max_pairs):
    """K1 (both pair widths) and F1's probe on rows aimed at the
    word-parallel decode, at widths below one word, not a multiple of
    16, of one round of words and of two: every K1 channel of every row,
    and F1's tier bits, lengths and carried channels, equal the plain
    version."""
    batch, lens = _exact_rows(_bitmask_lines(L), L)
    ref = _k1_rows_check(libs, batch, lens, L, max_pairs)
    if L >= 100:
        assert ref["ok"].any() and not ref["ok"].all()
    if max_pairs == 6:
        kept = _fused_probe_check(libs, batch, lens, L)
        assert kept > 0 or L < 100


@settings(max_examples=6, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.sampled_from([512, 1100]), st.lists(st.tuples(
    st.integers(0, 40), st.text(alphabet='\\"] =[ab\t\x85' + "é",
                                max_size=90)), min_size=1, max_size=16))
def test_decode_kernel_source_bitmask_hypothesis(libs, L, rows):
    """Bounded random SD tails behind hostnames of every length, at one
    round of words (L = 512) or two (L = 1100): K1 and F1's probe equal
    the plain version on every row."""
    pad = '[p q="' + "y" * 1000 + '"]' if L > 1024 else ""
    lines = [("<13>1 2015-08-05T15:53:45Z " + "h" * (1 + h) + " app 42 m1 "
              + pad + "[id k=\"" + tail).encode() for h, tail in rows]
    batch, lens = _exact_rows(lines, L)
    _k1_rows_check(libs, batch, lens, L, 6)
    _fused_probe_check(libs, batch, lens, L)


TILE = 16384   # kTile, frame_sep_spans.cu


def _sep_scratch(ntiles: int) -> np.ndarray:
    """The look-back scratch as the wrapper keeps it: int64 word 0 the two
    uint32 counters, words 1.. one status word a tile, zero."""
    return np.zeros(1 + ntiles, np.int64)


def _spans(libs, reg, rlen, sep, strip_cr, ncap, scratch=None):
    """One launch of the kernel source; the scratch must come back
    zero."""
    if scratch is None:
        scratch = _sep_scratch(max(1, -(-rlen // TILE)))
    starts = np.full(ncap, -7, np.int32)
    lens = np.full(ncap, -7, np.int32)
    meta = np.full(4, -7, np.int32)
    rc = libs["frame_sep_spans"].fg_frame_sep_spans(
        _ptr(reg), rlen, sep, int(strip_cr), ncap, _ptr(scratch),
        _ptr(scratch[1:]), _ptr(starts), _ptr(lens), _ptr(meta), None)
    assert rc == 0
    assert not scratch.any(), "the launch left its look-back scratch set"
    return starts, lens, meta


def _spans_check(libs, reg, rlen, sep, strip_cr, ncap, scratch=None):
    """Every slot and meta word equal to the plain version."""
    starts, lens, meta = _spans(libs, reg, rlen, sep, strip_cr, ncap,
                                scratch)
    ref = F.frame_sep_spans(torch.from_numpy(reg), rlen, sep=sep,
                            strip_cr=strip_cr, ncap=ncap)
    assert np.array_equal(starts, ref["starts"].numpy())
    assert np.array_equal(lens, ref["lens"].numpy())
    assert list(meta) == [int(ref["n"]), int(ref["consumed"]),
                          int(ref["overflow"]), 0]
    return meta


@pytest.mark.parametrize("sep,strip_cr,n_recs,tail,ncap", [
    (10, True, 900, b"", 1024),          # several tiles
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
    _spans_check(libs, reg, len(blob), sep, strip_cr, ncap)


def _records(rng, n, sep, hi=200):
    """n random printable records, every fourth ending in a CR, each
    closed by ``sep``."""
    return b"".join(bytes(rng.integers(32, 127, int(rng.integers(0, hi)))
                          .astype(np.uint8))
                    + (b"\r" if i % 4 == 0 else b"") + bytes([sep])
                    for i in range(n))


def _placed(size, at, sep, fill=b"a"):
    """``size`` bytes of ``fill`` with ``sep`` at each offset of ``at``
    (a negative offset from the end), a CR before every separator whose
    offset is odd."""
    buf = bytearray(fill * size)
    for p in at:
        p %= size
        buf[p] = sep
        if p % 2 and p > 0:
            buf[p - 1] = 13
    return bytes(buf)


@functools.lru_cache(maxsize=None)
def _sep_cases():
    """{name: (blob, B, sep, strip_cr, ncap, region offset)} for the
    single-pass scan's edges."""
    rng = np.random.default_rng(41)
    many = _records(rng, 11600, 10)           # >= 70 tiles
    assert len(many) >= 70 * TILE
    long_rec = (_records(rng, 20, 10) + b"b" * (3 * TILE + 777) + b"\n"
                + _records(rng, 20, 10))   # 3 tiles without a separator
    edges = _placed(4 * TILE, [0, 31, 32, 33, TILE - 1, TILE, TILE + 1,
                               2 * TILE - 1, 2 * TILE, 3 * TILE - 2,
                               3 * TILE - 1, -1], 10)
    edges_nul = edges.replace(b"\n", b"\0")
    cr_edge = bytearray(_placed(3 * TILE, [100, 3 * TILE - 1], 10))
    cr_edge[TILE - 1:TILE + 1] = b"\r\n"     # a CR ends tile 0
    cr_edge[2 * TILE - 1:2 * TILE + 1] = b"x\n"
    cr_edge[63:65] = b"\r\n"                 # a CR ends a thread's bytes
    mid = _records(rng, 300, 10, hi=40)
    many_nul = many.replace(b"\n", b"\0")
    return {
        "many-tiles": (many, len(many), 10, True, 16384, 0),
        "long-record": (long_rec, len(long_rec), 10, True, 64, 0),
        "tile-edges": (edges, len(edges), 10, True, 32, 0),
        "tile-edges-nul": (edges_nul, len(edges_nul), 0, False, 32, 0),
        "cr-before-tile-edge": (bytes(cr_edge), len(cr_edge), 10, True, 8, 0),
        # separators in [rlen, B) are not records
        "newlines-past-rlen": (mid, len(mid) + 4096, 10, True, 512, 0),
        "empty": (b"", F.MIN_REGION_BYTES, 10, True, 256, 0),
        # the ncap-th separator lies mid-tile; n > ncap
        "overflow-mid-tile": (many, len(many), 10, True, 2500, 0),
        "overflow-nul": (many_nul, len(many), 0, False, 1300, 0),
        # an unaligned region takes the byte path
        "unaligned": (edges, len(edges), 10, True, 32, 3),
    }


SEP_CASES = ["many-tiles", "long-record", "tile-edges", "tile-edges-nul",
             "cr-before-tile-edge", "newlines-past-rlen", "empty",
             "overflow-mid-tile", "overflow-nul", "unaligned"]


@pytest.mark.parametrize("name", SEP_CASES)
def test_sep_spans_kernel_source_tiles(libs, name):
    """The single-pass scan at its edges, every slot and meta word equal
    to the plain version: a look-back over 70+ tiles, a record across
    tiles with no separator, separators on a tile's (and a thread's)
    first and last byte, a CR ending one tile before a separator opening
    the next, separator bytes past rlen, rlen = 0, overflow mid-tile, an
    unaligned region."""
    blob, B, sep, strip_cr, ncap, offset = _sep_cases()[name]
    if name == "newlines-past-rlen":
        rlen = len(blob) - 4096
        blob = blob + b"\n" * (B - len(blob))
    else:
        rlen = len(blob)
    buf = np.full(B + 32, 10 if sep == 10 else 0, np.uint8)
    at = -buf.ctypes.data % 16 + offset
    reg = buf[at:at + B]
    reg[:len(blob)] = np.frombuffer(blob, np.uint8)
    meta = _spans_check(libs, reg, rlen, sep, strip_cr, ncap)
    assert (meta[2] == 1) == name.startswith("overflow")


def test_sep_spans_kernel_source_reuses_scratch(libs):
    """Two launches on one scratch, the second over a larger region:
    the first leaves its status words and counters zero, so the second
    starts clean.  The wrapper sizes the scratch by the source's tile."""
    from flowgger_tpu_torch.tpu import kernels

    lib = libs["frame_sep_spans"]
    lib.fg_frame_sep_tile_bytes.restype = _I
    assert lib.fg_frame_sep_tile_bytes() == kernels._TILE_BYTES == TILE
    rng = np.random.default_rng(43)
    scratch = _sep_scratch(64)
    for n in (300, 2400):
        blob = _records(rng, n, 10)
        reg = np.zeros(F.region_bucket(len(blob)), np.uint8)
        reg[:len(blob)] = np.frombuffer(blob, np.uint8)
        meta = _spans_check(libs, reg, len(blob), 10, True, 4096, scratch)
        assert meta[0] == n


def _lookback_words(rng, ntiles, p_incl):
    """Status words for ``ntiles`` tiles: tile 0 inclusive, each later
    tile inclusive with probability ``p_incl``, else its aggregate; and
    the exclusive prefix (count, last + 1) each tile must get."""
    cnt = rng.integers(0, 1 << 13, ntiles)
    last1 = np.where(rng.random(ntiles) < 0.8,
                     np.arange(ntiles) * TILE + rng.integers(1, TILE, ntiles),
                     0)
    inc_c, inc_l = np.cumsum(cnt), np.maximum.accumulate(last1)
    incl = rng.random(ntiles) < p_incl
    incl[0] = True
    words = [((2 if i else 1) << 62) | (int(c) << 31) | int(l)
             for i, c, l in zip(incl, np.where(incl, inc_c, cnt),
                                np.where(incl, inc_l, last1))]
    excl = np.stack([np.concatenate([[0], inc_c[:-1]]),
                     np.concatenate([[0], inc_l[:-1]])], 1)
    return np.array(words, np.uint64), excl


@pytest.mark.parametrize("p_incl", [0.0, 0.05, 0.5, 1.0])
def test_lookback_sums_to_the_nearest_inclusive_word(libs, p_incl):
    """lookback() over a hand-made mix of aggregate and inclusive words
    (none in a 128-word window, several in one, the nearest 1-299 tiles
    back) returns each tile's exclusive prefix; the kernel run by the
    emulation meets only an inclusive word one tile back."""
    rng = np.random.default_rng(int(p_incl * 100))
    words, excl = _lookback_words(rng, 300, p_incl)
    tiles = np.arange(1, 300, dtype=np.int32)
    out = np.full((tiles.size, 2), 7, np.uint32)
    assert libs["lookback"].fg_probe_lookback(
        _ptr(words), _ptr(tiles), tiles.size, _ptr(out)) == 0
    assert np.array_equal(out, excl[tiles].astype(np.uint32))


def _gather_check(libs, reg, starts, lens, max_len):
    rows = starts.shape[0]
    out = np.full((rows, max_len), 0xEE, np.uint8)
    lens_c = np.full(rows, -7, np.int32)
    assert libs["frame_gather"].fg_frame_gather(
        _ptr(reg), reg.shape[0], _ptr(starts), _ptr(lens), rows, max_len,
        _ptr(out), _ptr(lens_c), None) == 0
    rb, rl = F.frame_gather(torch.from_numpy(reg), torch.from_numpy(starts),
                            torch.from_numpy(lens), max_len)
    assert np.array_equal(out, rb.numpy()) and np.array_equal(lens_c,
                                                              rl.numpy())


def test_gather_kernel_source_matches_plain(libs):
    rng = np.random.default_rng(2)
    recs = [bytes(rng.integers(32, 127, int(rng.integers(0, 200)))
                  .astype(np.uint8)) for _ in range(200)]
    blob = b"".join(r + b"\n" for r in recs)
    reg = np.zeros(F.region_bucket(len(blob)), np.uint8)
    reg[:len(blob)] = np.frombuffer(blob, np.uint8)
    starts, lens, _ = _spans(libs, reg, len(blob), 10, True, 256)
    _gather_check(libs, reg, starts, lens, 128)   # longer records clip


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("max_len", [512, 128, 100])
def test_gather_kernel_source_alignments(libs, max_len, offset):
    """257 rows: sources at every alignment 0-15 with lengths 0, 1,
    15-17, 31-33, max_len - 1 to max_len + 1 and far beyond, records
    ending on the last byte of a region whose size is not a multiple of
    16, a region whose address is ``offset`` bytes past a 16-byte
    boundary, and rows not 16-byte aligned when max_len is 100."""
    B = 3 * 1024 + 13
    rng = np.random.default_rng(max_len + offset)
    buf = np.zeros(B + 32, np.uint8)
    at = -buf.ctypes.data % 16 + offset
    reg = buf[at:at + B]
    reg[:] = rng.integers(1, 256, B)
    lengths = [0, 1, 15, 16, 17, 31, 32, 33, max_len - 1, max_len,
               max_len + 1, 5 * max_len]
    starts, lens = [], []
    for a in range(16):
        for j, ln in enumerate(lengths):
            starts.append(a + 16 * ((7 * a + j) % 90))
            lens.append(ln)
    for ln in (1, 15, 16, 17, 100, max_len - 1, max_len):
        starts.append(B - ln)
        lens.append(ln)
    while len(starts) < 257:
        starts.append(int(rng.integers(0, B - max_len)))
        lens.append(int(rng.integers(0, max_len + 1)))
    _gather_check(libs, reg, np.array(starts, np.int32),
                  np.array(lens, np.int32), max_len)


# Runs in a child process: a region that ends where an inaccessible page
# begins, so a read past its last byte kills the child, not the test run.
GUARDED = r"""
import ctypes, mmap, sys
import numpy as np

gather, spans, out_dir, offset = sys.argv[1:5]
offset = int(offset)
libc = ctypes.CDLL(None)
libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
page = mmap.PAGESIZE
mem = mmap.mmap(-1, 4 * page)
base = ctypes.addressof(ctypes.c_char.from_buffer(mem))
assert libc.mprotect(base + 3 * page, page, 0) == 0
B = 2 * page - offset
region = np.frombuffer(mem, np.uint8, B, page + offset)
rng = np.random.default_rng(offset)
region[:] = rng.integers(32, 127, B)
region[rng.integers(0, B, 40)] = 10
region[-1] = 10
P, I = ctypes.c_void_p, ctypes.c_int
f = ctypes.CDLL(spans).fg_frame_sep_spans
f.argtypes, f.restype = [P, I, I, I, I, P, P, P, P, P, P], I
scratch = np.zeros(8, np.int64)
starts = np.zeros(64, np.int32)
lens = np.zeros(64, np.int32)
meta = np.zeros(4, np.int32)
p = lambda a: a.ctypes.data
assert f(p(region), B, 10, 1, 64, p(scratch), p(scratch[1:]), p(starts),
         p(lens), p(meta), None) == 0
g = ctypes.CDLL(gather).fg_frame_gather
g.argtypes, g.restype = [P, ctypes.c_longlong, P, P, I, I, P, P, P], I
max_len = 100
gs = np.array([B - n for n in range(1, 33)] + [B - 100, B - 117],
              np.int32)
gl = np.array([B - s for s in gs], np.int32)
out = np.zeros((gs.size, max_len), np.uint8)
lens_c = np.zeros(gs.size, np.int32)
assert g(p(region), B, p(gs), p(gl), gs.size, max_len, p(out), p(lens_c),
         None) == 0
np.savez(out_dir + "/guarded.npz", region=region, starts=starts, lens=lens,
         meta=meta, gs=gs, gl=gl, out=out, lens_c=lens_c)
"""


@pytest.mark.parametrize("offset", [0, 16, 7])
def test_kernel_sources_read_nothing_past_the_region(libs, tmp_path, offset):
    """K2 and K3 over a region whose last byte is the last readable byte
    of a page (its size 16-byte aligned or not): no vector load reaches
    past it, and every slot and byte still equals the plain version
    (K3's rows all end on that last byte)."""
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-c", GUARDED, libs["frame_gather"]._name,
         libs["frame_sep_spans"]._name, str(tmp_path), str(offset)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    d = np.load(tmp_path / "guarded.npz")
    reg = torch.from_numpy(d["region"])
    ref = F.frame_sep_spans(reg, reg.shape[0], sep=10, strip_cr=True, ncap=64)
    assert np.array_equal(d["starts"], ref["starts"].numpy())
    assert np.array_equal(d["lens"], ref["lens"].numpy())
    assert list(d["meta"]) == [int(ref["n"]), int(ref["consumed"]),
                               int(ref["overflow"]), 0]
    rb, rl = F.frame_gather(reg, torch.from_numpy(d["gs"]),
                            torch.from_numpy(d["gl"]), 100)
    assert np.array_equal(d["out"], rb.numpy())
    assert np.array_equal(d["lens_c"], rl.numpy())


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
