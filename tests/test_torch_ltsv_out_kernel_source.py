"""OL and FO/ltsv, the rfc5424 → LTSV kernel sources (csrc/
encode_ltsv_out.cu and csrc/fused_ltsv_out.cu, both on
encode_ltsv_out_row.cuh), compiled for the CPU with g++ through the host
emulation in tests/cuda_host, against their plain PyTorch versions
(``device_ltsv_out.encode_rows`` and the fused route's plain rows):

- OL's probe on K1's emulated channels (tier bit, elided length, gaps of
  every row, padding rows past ``n`` holding garbage) and its assemble
  (the bytes of the kept rows at their offsets), with and without an
  ``ltsv_extra``, at row widths 512 and 100 (byte loads);
- FO/ltsv's probe (the same outputs, the ok / stamp channels, the
  carried channels of its tier rows against ``carried_plain``) and its
  assemble from those carried channels, which must write OL's bytes.

A few hundred rows: the tier mix, the sourced mix and rows at the
screens' edges (a ':' in an SD name, a tab, an escaped value, a facility
of two digits, messages that leave the width)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_corpus, make_ltsv_out_tier_corpus
from flowgger_tpu_torch.tpu import device_ltsv_out as DO
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as R5
from flowgger_tpu_torch.tpu.device_gelf import flat_rows

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402

SUFFIX = b"\n"
HEAD = "<13>1 2015-08-05T15:53:45Z h a p m"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    return hostlibs.load(("decode_rfc5424", "encode_ltsv_out",
                          "fused_ltsv_out"),
                         tmp_path_factory.mktemp("cuda_host"))


def _rows():
    odd = [f'{HEAD} [x k:y="v"] colon in a name',
           f"{HEAD} - tab\tin the message",
           f'{HEAD} [x k="a\\"b"] escaped value',
           "<165>1 2015-08-05T15:53:45Z h a p m - facility 20",
           "<7>1 2015-08-05T15:53:45Z - - - - -",
           f"{HEAD} - " + "w" * 300, f"{HEAD} - " + "v" * 60,
           f'{HEAD} [a b="1" c="2"][d e="3"] m']
    return (make_ltsv_out_tier_corpus(150, 141)[0] + make_corpus(80, 142)[0]
            + [o.encode() for o in odd])


def _setup(libs, L, extras):
    rows = _rows()
    batch, lens, _, _, _, n = pack.pack_lines_2d(rows, L)
    N = batch.shape[0]
    ch = np.zeros((R5.n_channels(4, 6), N), np.int32)
    assert libs["decode_rfc5424"].fg_decode_rfc5424_sd4_p6(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, N, L, None) == 0
    # padding rows past n hold garbage neither kernel may read
    batch[n:] = 9
    lens[n:] = L
    bank, table = DO.kernel_consts(SUFFIX, extras)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = R5.decode_rfc5424(bt, lt)
    return batch, lens, n, ch, np.frombuffer(bank, np.uint8).copy(), table, \
        bt, lt, dec


def _offsets(tier, base_len, OW):
    keep = tier.astype(bool) & (base_len <= OW)
    lk = np.where(keep, base_len, 0).astype(np.int64)
    return keep, np.where(keep, np.cumsum(lk) - lk, -1).astype(np.int64), \
        int(lk.sum())


@pytest.mark.parametrize("L,extras", [(512, ()),
                                      (100, (("_zone:a", "eu\tw1"),))],
                         ids=["512", "100_extras"])
def test_ltsv_out_kernel_sources_match_plain(libs, L, extras):
    batch, lens, n, ch, bank, table, bt, lt, dec = _setup(libs, L, extras)
    N = batch.shape[0]
    tier = np.zeros(N, np.uint8)
    bl = np.zeros(N, np.int32)
    gaps = np.zeros((2, N), np.int32)
    assert libs["encode_ltsv_out"].fg_encode_ltsv_out_probe(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, table, N, n, L,
        tier.ctypes.data, bl.ctypes.data, gaps.ctypes.data, None) == 0
    base, base_len, pgaps = DO.encode_rows(bt, lt, dec, suffix=SUFFIX,
                                           extras=extras, assemble=False,
                                           n=n)
    assert np.array_equal(tier.astype(bool), base.numpy())
    assert np.array_equal(bl, base_len.numpy())
    assert np.array_equal(gaps, pgaps.numpy())
    OW = DO.out_width(L, SUFFIX, extras)
    keep, row_off, total = _offsets(tier, bl, OW)
    assert 50 < keep.sum() < n
    flat = np.zeros(total + 16, np.uint8)
    assert libs["encode_ltsv_out"].fg_encode_ltsv_out_assemble(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, bank.ctypes.data,
        table, N, n, L, OW, row_off.ctypes.data, flat.ctypes.data, None) == 0
    rows_p, out_len, _ = DO.encode_rows(bt, lt, dec, suffix=SUFFIX,
                                        extras=extras)
    want = flat_rows(rows_p, out_len, torch.from_numpy(row_off),
                     total).numpy()
    assert np.array_equal(flat[:total], want) and not flat[total:].any()

    # FO/ltsv: the same probe, the stamp channels and the carried rows
    t2 = np.zeros(N, np.uint8)
    bl2 = np.zeros(N, np.int32)
    g2 = np.zeros((2, N), np.int32)
    small = np.zeros((5, N), np.int32)
    chan = np.full((N, 38), -5, np.int32)
    assert libs["fused_ltsv_out"].fg_fused_ltsv_out_carry(0) == 38
    assert libs["fused_ltsv_out"].fg_fused_ltsv_out_probe(
        batch.ctypes.data, lens.ctypes.data, table, N, n, L, t2.ctypes.data,
        bl2.ctypes.data, g2.ctypes.data, small.ctypes.data, chan.ctypes.data,
        None) == 0
    assert np.array_equal(t2, tier) and np.array_equal(bl2, bl)
    assert np.array_equal(g2, gaps)
    live = np.arange(N) < n
    for i, k in enumerate(("ok", "days", "sod", "off", "nanos")):
        assert np.array_equal(small[i],
                              np.where(live, dec[k].to(torch.int32).numpy(),
                                       0)), k
    cp = FR.carried_plain(dec, "rfc5424_ltsv").numpy()
    t = tier.astype(bool)
    assert np.array_equal(chan[t], cp[t]) and (chan[~t] == -5).all()
    flat2 = np.zeros(total + 16, np.uint8)
    assert libs["fused_ltsv_out"].fg_fused_ltsv_out_assemble(
        batch.ctypes.data, lens.ctypes.data, chan.ctypes.data,
        bank.ctypes.data, table, N, n, L, OW, row_off.ctypes.data,
        flat2.ctypes.data, None) == 0
    assert np.array_equal(flat2, flat)
