"""The CUDA kernel sources of flowgger_tpu_torch/csrc, compiled for the
CPU with g++ through the host emulation in tests/cuda_host, against the
plain PyTorch versions they replace.

A CUDA kernel has no interpret mode, and this box has no nvcc and no
card; the emulation runs every CUDA thread of a block as a host thread
(barriers for __syncthreads, a slot exchange for warp shuffles), so the
kernels' indexing, scans and per-row logic are checked here exactly as
written.  Speed and the GPU memory model are not: chip_smoke.py holds
the nvcc builds against the same plain versions on the card.
"""

import ctypes
import sys
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
    libs = {n: ctypes.CDLL(str(host_build.build(n, out)))
            for n in ("decode_rfc5424", "frame_sep_spans", "frame_gather",
                      "frame_syslen_spans", "structural_index")}
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
    return libs


def _lines():
    from test_torch_rfc5424 import _escape_lines, _pairs_lines

    lines, _ = make_corpus(300, seed=17)
    return lines + _pairs_lines() + _escape_lines()


@pytest.mark.parametrize("L", [512, 96])
@pytest.mark.parametrize("max_pairs", [6, 16])
def test_decode_kernel_source_matches_plain(libs, L, max_pairs):
    """Every channel on every row — padding and rejected rows included —
    equals the plain version (the stricter form of chip_smoke's rule)."""
    batch, lens, *_ = pack.pack_lines_2d(_lines(), L)
    out = np.zeros((T.n_channels(4, max_pairs), batch.shape[0]), np.int32)
    fn = getattr(libs["decode_rfc5424"], f"fg_decode_rfc5424_sd4_p{max_pairs}")
    assert fn(_ptr(batch), _ptr(lens), _ptr(out), batch.shape[0], L,
              None) == 0
    got = T.unpack_channels(torch.from_numpy(out), 4, max_pairs)
    ref = T.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens),
                           max_pairs=max_pairs)
    assert ref["ok"].any() and not ref["ok"].all()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


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


@pytest.mark.parametrize("L", [512, 96])
@pytest.mark.parametrize("max_fields", [8, 24])
def test_structural_index_kernel_source_matches_plain(libs, L, max_fields):
    """Every channel on every row — padding, rejected and over-long rows
    included — equals the plain structural index."""
    batch, lens, *_ = pack.pack_lines_2d(_json_lines(), L)
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


def test_syslen_spans_kernel_source_matches_plain(libs):
    """The chain walk equals the plain version wherever the plain version
    does not decline, and declines exactly where it does."""
    fn = libs["frame_syslen_spans"].fg_frame_syslen_spans
    for name, reg, rlen, ncap in _syslen_cases():
        starts = np.full(ncap, -7, np.int32)
        lens = np.full(ncap, -7, np.int32)
        meta = np.full(4, -7, np.int32)
        assert fn(_ptr(reg), rlen, ncap, _ptr(starts), _ptr(lens),
                  _ptr(meta), None) == 0
        ref = F.frame_syslen_spans(torch.from_numpy(reg), rlen, ncap=ncap)
        assert bool(meta[3]) == bool(ref["decline"]), name
        if not meta[3]:
            assert np.array_equal(starts, ref["starts"].numpy()), name
            assert np.array_equal(lens, ref["lens"].numpy()), name
            assert list(meta[:3]) == [int(ref["n"]), int(ref["consumed"]),
                                      int(ref["err"])], name
