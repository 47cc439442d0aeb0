"""K2, the line / NUL record-span kernel source (csrc/frame_sep_spans.cu),
and its look-back, compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against the plain PyTorch version it replaces (the
emulation and what it checks: tests/test_torch_kernel_sources.py)."""

import ctypes
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.tpu import framing as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


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


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    return hostlibs.load(("frame_sep_spans", "lookback"),
                         tmp_path_factory.mktemp("cuda_host"))


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
