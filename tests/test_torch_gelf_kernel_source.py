"""The gelf slice's CUDA kernel sources, compiled for the CPU with g++
through the host emulation in tests/cuda_host (its notes:
tests/test_torch_kernel_sources.py), against their plain PyTorch
versions on every row: K5's flat mode (``nested = 0``, csrc/
structural_index.cu) at 8, 16 and 24 fields on every channel; EG
(``fg_encode_gelf_gelf_*``, csrc/encode_gelf.cu) at 8 and 16 fields, the
probe's tier bits, lengths and stamp channels and the assembled bytes of
every tier row; FG (``fg_fused_gelf_gelf_*``, csrc/fused_gelf.cu), its
probe with each tier row's carried selection and its assemble from it.
At a row width that is a multiple of 16 (vector staging) and one that is
not (byte staging), with rows whose structure crosses 32-position
chunks, padding rows past ``n`` and rows longer than the width."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_gelf_corpus, make_gelf_tier_corpus
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_gelf as DG
from flowgger_tpu_torch.tpu import device_gelf_gelf as EG
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import gelf as G
from flowgger_tpu_torch.tpu import jsonidx as JI
from flowgger_tpu_torch.tpu import kernels as K
from flowgger_tpu_torch.tpu import pack

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402

SUFFIX = b"\0"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
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
    return hostlibs.load(("structural_index", "encode_gelf", "fused_gelf"),
                         tmp_path_factory.mktemp("cuda_host"))


# structures the running state of the warp scans carries across
# 32-position chunks, each starting at positions 24-40 (a padding string
# grows one byte at a time): the special names and a stamp, backslash
# runs before a quote, whitespace runs of 8 and 9 outside strings, a
# bracket outside a string, literals and numbers the tier screens
FEATURES = [
    '"host":"h","timestamp":1760000000.125,"level":3,"k":12,"s":"v"',
    '"short_message":"m","host":"","timestamp":-5.5,"version":"1.1"',
    '"host":"h","timestamp":1,"s":"' + "\\" * 16 + 'q","t":true',
    '"host":"h","timestamp":1,"s":"a' + "\\" * 15 + '"',
    '"host":"h",' + " " * 8 + '"timestamp":2',
    '"host":"h",' + " " * 9 + '"timestamp":2',
    '"host":"h","timestamp":3,"a":[1]',
    '"host":"h","timestamp":3,"n":null,"f":false,"z":-0,"e":1e2',
    '"host":"h","timestamp":9007199254740993,"full_message":"x"',
]


def _lines(L):
    out = []
    for feat in FEATURES:
        for start in range(24, 41, 4):
            pad = start - len('{"p":"') - 2
            out.append('{"p":"' + "a" * pad + '",' + feat + "}")
    base = '{"host":"h","timestamp":1,"k":"'
    for n in (L - 1, L, L + 1):
        out.append(base + "x" * (n - len(base) - 2) + '"}')
    lines = [ln.encode() for ln in out]
    lines += make_gelf_tier_corpus(40, seed=61)[0]
    lines += make_gelf_corpus(24, seed=62)[0]
    return lines


def _batch(L):
    """The rows packed at width L, and 8 padding rows past them."""
    lines = _lines(L)
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    n = len(lines)
    N = n + 8
    b = np.ascontiguousarray(batch[:N])
    ln = np.ascontiguousarray(lens[:N]).astype(np.int32)
    b[n:] = 0x5A                 # padding rows past n hold garbage
    return b, ln, n


@pytest.mark.parametrize("L", [512, 100])
def test_flat_index_source_matches_plain(libs, L):
    """K5's flat mode at 8, 16 and 24 fields: every channel of every row
    (rejected, over-long and padding rows included) equals the plain
    index at nested = 0; the nested mode still runs beside it."""
    batch, lens, n = _batch(L)
    N = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    for F in (8, 16, 24):
        out = np.full((JI.n_channels(F), N), -7, np.int32)
        fn = getattr(libs["structural_index"], f"fg_structural_index_f{F}")
        assert fn(_ptr(batch), _ptr(lens), _ptr(out), N, L, 0, None) == 0
        got = JI.unpack_channels(torch.from_numpy(out), F)
        ref = G.decode_gelf(bt, lt, F)
        assert ref["ok"].any() and not ref["ok"].all()
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (F, k)


def _assemble_inputs(tier_base, base_len, small, N, L):
    """The stamp text of the probe's tier rows and their offsets, as the
    fetch driver makes them."""
    h = {k: small[i] for i, k in enumerate(EG.TS_KEYS)}
    h["ok"] = np.ones(N, bool)
    txt, tl = DC._ts_text_block_np(h, EG.ts_vals_gelf)
    txt, tl = np.ascontiguousarray(txt), tl.astype(np.int32)
    OW = EG.out_width(L, SUFFIX)
    length = base_len.astype(np.int64) + tl
    keep = tier_base.astype(bool) & (length <= OW)
    gated = np.where(keep, length, 0)
    row_off = np.where(keep, np.cumsum(gated) - gated, -1).astype(np.int64)
    return txt, tl, row_off, int(gated.sum()), OW


@pytest.mark.parametrize("L", [512, 100])
@pytest.mark.parametrize("F", [8, 16])
def test_split_encode_source_matches_plain(libs, L, F):
    """EG on the flat index's channels: the probe's tier bit, base length
    and stamp channels of every row (zeros past n), then the assembled
    bytes of every tier row at its offset, equal to the plain encode."""
    batch, lens, n = _batch(L)
    N = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = G.decode_gelf(bt, lt, F)
    ch = np.full((JI.n_channels(F), N), -7, np.int32)
    fn = getattr(libs["structural_index"], f"fg_structural_index_f{F}")
    assert fn(_ptr(batch), _ptr(lens), _ptr(ch), N, L, 0, None) == 0
    bank, table = EG.kernel_consts(SUFFIX)
    tier = np.full(N, 7, np.uint8)
    base_len = np.full(N, -1, np.int32)
    small = np.full((3, N), -9, np.int32)
    probe = getattr(libs["encode_gelf"], f"fg_encode_gelf_gelf_probe_f{F}")
    assert probe(_ptr(batch), _ptr(lens), _ptr(ch), table, N, n, L,
                 _ptr(tier), _ptr(base_len), _ptr(small), None) == 0
    rb, rl, rs = EG.encode_rows(bt, lt, dec, suffix=SUFFIX, assemble=False,
                                n=n)
    assert (tier == rb.numpy()).all() and (base_len == rl.numpy()).all()
    assert (small == rs.numpy()).all()
    if L == 512:
        assert 40 < tier.sum() < n

    txt, tl, row_off, total, OW = _assemble_inputs(tier, base_len, small, N,
                                                   L)
    flat = np.full(total, 0xEE, np.uint8)
    bank_np = np.frombuffer(bank, np.uint8).copy()
    asm = getattr(libs["encode_gelf"], f"fg_encode_gelf_gelf_assemble_f{F}")
    assert asm(_ptr(batch), _ptr(lens), _ptr(ch), _ptr(txt), _ptr(tl),
               _ptr(bank_np), table, N, n, L, OW, _ptr(row_off), _ptr(flat),
               None) == 0
    rows, out_len, _ = EG.encode_rows(bt, lt, dec, torch.from_numpy(txt),
                                      torch.from_numpy(tl), suffix=SUFFIX)
    want = DG.flat_rows(rows, out_len, torch.from_numpy(row_off), total)
    assert np.array_equal(flat, want.numpy())


@pytest.mark.parametrize("L", [512, 100])
def test_fused_gelf_source_matches_plain(libs, L):
    """FG: the probe (K5's flat row index and EG's probe in one warp)
    gives the split probe's outputs and, for each tier row only, the
    carried selection of ``fused_routes.carried_plain``; the assemble
    from it writes the plain encode's bytes."""
    batch, lens, n = _batch(L)
    N = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    lib = libs["fused_gelf"]
    C = K.FUSED_CARRY["gelf"]
    assert lib.fg_fused_gelf_carry(71) == C
    bank, table = EG.kernel_consts(SUFFIX)
    tier = np.full(N, 7, np.uint8)
    base_len = np.full(N, -1, np.int32)
    small = np.full((3, N), -9, np.int32)
    chan = np.full((N, C), -5, np.int32)
    assert lib.fg_fused_gelf_gelf_probe(
        _ptr(batch), _ptr(lens), table, N, n, L, _ptr(tier), _ptr(base_len),
        _ptr(small), _ptr(chan), None) == 0
    dec = G.decode_gelf(bt, lt)
    rb, rl, rs = EG.encode_rows(bt, lt, dec, suffix=SUFFIX, assemble=False,
                                n=n)
    assert (tier == rb.numpy()).all() and (base_len == rl.numpy()).all()
    assert (small == rs.numpy()).all()
    on = tier.astype(bool)
    carried = FR.carried_plain(dec, "gelf_gelf", bt, lt).numpy()
    assert (chan[on] == carried[on]).all() and (chan[~on] == -5).all()

    txt, tl, row_off, total, OW = _assemble_inputs(tier, base_len, small, N,
                                                   L)
    flat = np.full(total, 0xEE, np.uint8)
    bank_np = np.frombuffer(bank, np.uint8).copy()
    assert lib.fg_fused_gelf_gelf_assemble(
        _ptr(batch), _ptr(lens), _ptr(chan), _ptr(txt), _ptr(tl),
        _ptr(bank_np), table, N, n, L, OW, _ptr(row_off), _ptr(flat),
        None) == 0
    rows, out_len, _ = EG.encode_rows(bt, lt, dec, torch.from_numpy(txt),
                                      torch.from_numpy(tl), suffix=SUFFIX)
    want = DG.flat_rows(rows, out_len, torch.from_numpy(row_off), total)
    assert np.array_equal(flat, want.numpy())
