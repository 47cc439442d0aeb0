"""DN, the dns decode kernel source (csrc/decode_dns.cu), compiled for the
CPU with g++ through the host emulation in tests/cuda_host, against its
plain PyTorch version (``dns.decode_dns``): the dns mix with every edge
kind and the channel contract's corners (fewer and more than five tabs,
empty fields, long latencies, rows the width cuts), at row widths 512,
100 (byte loads) and 33, a batch that starts off a 16-byte boundary, and
padding rows past ``n`` that hold garbage: every channel of every row
exact, the padding rows an empty row's and never read."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_dns_corpus
from flowgger_tpu_torch.tpu import dns as D
from flowgger_tpu_torch.tpu import pack

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402

CORNERS = [
    b"", b"\t", b"\t\t\t\t\t", b"\t" * 9, b"1\t2\t3\t4\t5",
    b"1\tc\tq\tA\tR\t", b"1\tc\tq\tA\tR\t7\t8", b"1.\tc\tq\tA\tR\t7",
    b".1\tc\tq\tA\tR\t7", b"1.2.3\tc\tq\tA\tR\t7", b"1\t\tq\tA\tR\t7",
    b"1\tc\t\tA\tR\t7", b"1\tc\tq\t\t\t7", b"1\tc\tq\tA\tR\t" + b"9" * 19,
    b"1\tc\tq\tA\tR\t" + b"9" * 20, b"1\tc\tq\tA\tR\t07", b"1\tc\tq\tA\tR\t7x",
    b"+1\tc\tq\tA\tR\t7", b"1\tc\tq\xc3\xa9\tA\tR\t7",
    b"12\t" + b"x" * 600 + b"\tq\tA\tR\t5",
    b"1760000000.5\t10.0.0.1\t" + b"n" * 40 + b"\tA\tNOERROR\t" + b"1" * 7,
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    return hostlibs.load(("decode_dns",),
                         tmp_path_factory.mktemp("cuda_host"))["decode_dns"]


def _rows():
    lines, _ = make_dns_corpus(300, 131)
    return CORNERS + lines + [ln[:k] for ln in lines[:8] for k in (3, 17, 40)]


def _kernel(lib, batch, lens, n):
    N, L = batch.shape
    out = np.full((len(D.KEYS), N), -7, np.int32)
    assert lib.fg_decode_dns(batch.ctypes.data, lens.ctypes.data,
                             out.ctypes.data, N, n, L, None) == 0
    return out


def _check(got, batch, lens, n):
    want = D.decode_dns(torch.from_numpy(np.ascontiguousarray(batch)),
                        torch.from_numpy(lens), n=n)
    for i, k in enumerate(D.KEYS):
        assert np.array_equal(got[i], want[k].to(torch.int32).numpy()), k


@pytest.mark.parametrize("L", [512, 100, 33])
def test_dns_kernel_source_matches_plain(lib, L):
    batch, lens, _, _, orig, n = pack.pack_lines_2d(_rows(), L)
    assert (orig[:n] > L).any()
    # padding rows hold garbage the kernel must not read
    batch[n:] = 9
    lens[n:] = L
    _check(_kernel(lib, batch, lens, n), batch, lens, n)


def test_dns_kernel_source_unaligned_batch(lib):
    """A batch view that starts off a 16-byte boundary takes the byte
    loads at L = 64."""
    batch, lens, _, _, _, n = pack.pack_lines_2d(_rows(), 64)
    buf = np.zeros(batch.size + 1, np.uint8)
    shifted = buf[1:].reshape(batch.shape)
    shifted[:] = batch
    _check(_kernel(lib, shifted, lens, n), batch, lens, n)
