"""K3, the gather kernel source (csrc/frame_gather.cu), and K2 with K3 over
a region that ends at an inaccessible page, compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against the plain PyTorch version it replaces (the
emulation and what it checks: tests/test_torch_kernel_sources.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.tpu import framing as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402

from test_torch_sep_kernel_source import _spans  # noqa: E402


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
    return hostlibs.load(("frame_gather", "frame_sep_spans"),
                         tmp_path_factory.mktemp("cuda_host"))


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
