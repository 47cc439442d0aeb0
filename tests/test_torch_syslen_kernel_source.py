"""K4, the octet-counted (syslen) span kernel source
(csrc/frame_syslen_spans.cu), compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against the plain PyTorch version it replaces (the
emulation and what it checks: tests/test_torch_kernel_sources.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_corpus, syslen_stream
from flowgger_tpu_torch.tpu import framing as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402


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
    return hostlibs.load(("frame_syslen_spans",),
                         tmp_path_factory.mktemp("cuda_host"))


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
