"""AC, the auto-detect classifier kernel source (csrc/classify_auto.cu),
compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against its plain PyTorch version
(``autodetect.classify_plain``): the classifier's edge rows
(``corpus.AUTO_EDGE``, each also cut to every length up to 12 bytes and
moved to every 16-byte residue of its row) and seeded rows built from
the bytes the decision table reads, at row widths 16, 19, 100 and 512,
every class code exact; and AC+dns (the dns overlay flag) on the auto
mix with the dns mix and its classifier edges (``corpus.AUTO_DNS_EDGE``)
and seeded dns-shaped rows, against ``classify_plain(..., dns=True)``.
Rows past ``n`` are never written."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import (AUTO_DNS_EDGE, AUTO_EDGE,
                                       make_auto_corpus)
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.autodetect import classify, classify_plain

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


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    return hostlibs.load(("classify_auto",),
                         tmp_path_factory.mktemp("cuda_host"))["classify_auto"]


def _rows():
    """The edge rows, their prefixes, the same rows behind a prefix of
    every length up to 15 (each residue mod 16 for the tab/colon scan),
    seeded rows over the decision table's bytes, and a slice of the auto
    mix."""
    rows = list(AUTO_EDGE)
    for r in AUTO_EDGE[:12]:
        rows.extend(r[:k] for k in range(13))
    rows.extend(b"p" * k + b"\t" + b"q" * (16 - k) + b":" for k in range(16))
    rows.extend(b"r" * k + b":" * (k % 2) + b"s" * 20 + b"\t" for k in range(40))
    rng = np.random.default_rng(20261018)
    alphabet = np.frombuffer(b"<>{}1 0129a\t:\xef\xbb\xbfx", np.uint8)
    for _ in range(300):
        n = int(rng.integers(0, 40))
        rows.append(alphabet[rng.integers(0, alphabet.size, n)].tobytes())
    rows.extend(make_auto_corpus(120, seed=7)[0])
    return rows


def _kernel(lib, batch, lens, n, dns=False):
    out = np.full(batch.shape[0] + 4, 99, np.int8)
    assert lib.fg_classify_auto(batch.ctypes.data, lens.ctypes.data,
                                out.ctypes.data, n, batch.shape[1],
                                int(dns), None) == 0
    assert (out[n:] == 99).all()
    return out[:n]


@pytest.mark.parametrize("L", [16, 19, 100, 512])
def test_classify_kernel_source_matches_plain(lib, L):
    rows = _rows()
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(rows, L)
    got = _kernel(lib, batch, lens, n)
    want = classify_plain(torch.from_numpy(batch),
                          torch.from_numpy(lens)).numpy()[:n]
    assert np.array_equal(got, want)
    # on rows the clip does not cut, the host classifier agrees too
    whole = orig[:n] <= L
    assert np.array_equal(
        got[whole], np.array([classify(r) for r in rows], np.int8)[whole])
    assert set(got.tolist()) == {0, 1, 2, 3}


def test_classify_kernel_source_unaligned_rows(lib):
    """Row widths off a multiple of 16 take the byte loads; a batch view
    that starts off a 16-byte boundary too."""
    rows = _rows()
    for L in (33, 47):
        batch, lens, _, _, _, n = pack.pack_lines_2d(rows, L)
        want = classify_plain(torch.from_numpy(batch),
                              torch.from_numpy(lens)).numpy()[:n]
        assert np.array_equal(_kernel(lib, batch, lens, n), want)
    batch, lens, _, _, _, n = pack.pack_lines_2d(rows, 64)
    buf = np.zeros(batch.size + 1, np.uint8)
    shifted = buf[1:].reshape(batch.shape)
    shifted[:] = batch
    assert np.array_equal(_kernel(lib, shifted, lens, n),
                          classify_plain(torch.from_numpy(batch),
                                         torch.from_numpy(lens)).numpy()[:n])


def _dns_rows():
    """The auto mix with dns, its edges, each cut short, and seeded rows
    over the bytes the dns rule reads (digits, dots, tabs, the class
    signatures, a BOM)."""
    rows = list(AUTO_DNS_EDGE) + make_auto_corpus(200, seed=9, dns=True)[0]
    for r in AUTO_DNS_EDGE[:5]:
        rows.extend(r[:k] for k in range(0, 30, 3))
    rng = np.random.default_rng(20261019)
    alphabet = np.frombuffer(b"0159..\t\t\t<{:a \xef\xbb\xbf", np.uint8)
    for _ in range(250):
        n = int(rng.integers(0, 40))
        rows.append(alphabet[rng.integers(0, alphabet.size, n)].tobytes())
    rows.extend(b"1" * k + b"\t" * 5 for k in range(1, 40))
    return rows


@pytest.mark.parametrize("L", [19, 64, 512])
def test_classify_kernel_source_dns_flag(lib, L):
    rows = _dns_rows()
    batch, lens, _, _, orig, n = pack.pack_lines_2d(rows, L)
    got = _kernel(lib, batch, lens, n, dns=True)
    want = classify_plain(torch.from_numpy(batch), torch.from_numpy(lens),
                          dns=True).numpy()[:n]
    assert np.array_equal(got, want)
    whole = orig[:n] <= L
    assert np.array_equal(
        got[whole],
        np.array([classify(r, ("dns",)) for r in rows], np.int8)[whole])
    if L >= 64:
        assert (got == 5).sum() > 20
    # without the flag, the four-class table
    assert np.array_equal(_kernel(lib, batch, lens, n),
                          classify_plain(torch.from_numpy(batch),
                                         torch.from_numpy(lens)).numpy()[:n])
