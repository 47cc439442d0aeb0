"""The CUDA kernel sources of flowgger_tpu_torch/csrc, compiled for the
CPU with g++ through the host emulation in tests/cuda_host, against the
plain PyTorch versions they replace.  This file holds the
emulation's own checks and K1 (the rfc5424 decode, and F1's probe, which
runs its row decode); the other kernels' sources have a file each
(test_torch_*_kernel_source.py), so ``--dist loadfile`` spreads them.

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
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from flowgger_tpu_torch.corpus import make_corpus
from flowgger_tpu_torch.tpu import device_gelf as DG
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import kernels as K
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as T

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
    return hostlibs.load(("decode_rfc5424", "fused_gelf", "probe",
                          "barriers"),
                         tmp_path_factory.mktemp("cuda_host"))


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


@pytest.mark.parametrize("mode,message", [
    (0, None), (1, "lanes of a warp at different warp barriers"),
    (2, "lanes wait at a warp barrier the others never reach"), (3, None)],
    ids=["whole_warps", "skipped_shuffle", "skipped_syncthreads",
         "early_return"])
def test_emulation_fails_a_lane_that_skips_a_barrier(libs, capfd, mode,
                                                      message):
    """Every lane of a warp must reach each warp intrinsic and barrier at
    the same call site: a lane that skips one fails the launch with a
    message naming the warp (it does not hang), a lane that returns early
    leaves its barriers, and a launch that keeps the rule runs."""
    out = np.full(64, -7, np.int32)
    rc = libs["barriers"].fg_probe_barriers(mode, _ptr(out))
    err = capfd.readouterr().err
    if message is not None:
        assert rc != 0 and message in err and "block 0 warp 1" in err
        # the failure does not stick: the next launch runs
        assert libs["barriers"].fg_probe_barriers(0, _ptr(out)) == 0
        return
    assert rc == 0 and err == ""
    t = np.arange(64)
    x = t ^ 1
    v = 2 * (x + np.where(t % 32 < 31, np.roll(x, -1), x))
    want = np.where(t % 32 == 31, -v, v)
    warps = slice(0, 64) if mode == 0 else slice(0, 32)
    assert list(out[warps]) == list(want[warps])


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
