"""O5, O5/3164 and FO/r5, the → RFC5424 kernel sources (csrc/
encode_rfc5424_out.cu and csrc/fused_rfc5424_out.cu, both on
encode_rfc5424_out_row.cuh), compiled for the CPU with g++ through the
host emulation in tests/cuda_host, against their plain PyTorch versions
(``device_rfc5424_out.encode_rows`` / ``encode_rows_3164`` and the fused
route's plain rows):

- O5's probe on K1's emulated channels (tier bit, elided length, fac8 /
  sev8 of every row, padding rows past ``n`` holding garbage) and its
  assemble (the bytes of the kept rows at their offsets), at row widths
  512 and 100 (byte loads), and once with the pair slots reversed in
  both the channels and the plain decode (blocks in order whatever order
  ``pair_sd`` comes in);
- O5/3164's probe and assemble on D3's emulated channels, with the host
  length and pri1;
- FO/r5's probes (the same outputs, the ok / stamp channels, the carried
  channels of their tier rows against ``carried_plain``) and assembles
  from those carried channels, which must write the split kernels' bytes.

A few hundred rows: the tier mixes, the sourced mixes and rows at the
screens' edges (five SD blocks, seven pairs, an escaped value, a
three-digit PRI, SD blocks without pairs, messages that leave the
width)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import (make_corpus, make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus)
from flowgger_tpu_torch.tpu import device_rfc5424_out as DO
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc3164 as R3
from flowgger_tpu_torch.tpu import rfc5424 as R5
from flowgger_tpu_torch.tpu.device_gelf import flat_rows

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402

SUFFIX = b"\n"
HEAD = "<13>1 2015-08-05T15:53:45Z h a p m"
YEAR = 2026


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
    return hostlibs.load(("decode_rfc5424", "decode_rfc3164",
                          "encode_rfc5424_out", "fused_rfc5424_out"),
                         tmp_path_factory.mktemp("cuda_host"))


def _rows5():
    odd = [f'{HEAD} [a b="1"][c][d e="2" f="3"][g h="4"][i j="5"] five',
           f'{HEAD} [a b="1" c="2" d="3" e="4" f="5" g="6" h="7"] seven',
           f'{HEAD} [x k="a\\"b"] escaped value',
           "<191>1 2015-08-05T15:53:45.002Z h a p m - pri 191",
           "<7>1 2015-08-05T15:53:45Z - - - - -",
           f"{HEAD} [only] [x y=\"z\"]",
           f'{HEAD} [a][b c="d"][e] empty blocks',
           f"{HEAD} - " + "w" * 600, f"{HEAD} - " + "v" * 60]
    return (make_tier_corpus(150, 151)[0] + make_corpus(80, 152)[0]
            + [o.encode() for o in odd])


def _rows3():
    return (make_rfc3164_tier_corpus(150, 153)[0]
            + make_rfc3164_corpus(80, 154)[0]
            + [b"<34>Oct 11 22:14:15 mymachine su: " + b"x" * 600,
               b"Oct  1 02:03:04 host-without-pri message", b"<999>Oct"])


def _pack(rows, L):
    batch, lens, _, _, _, n = pack.pack_lines_2d(rows, L)
    return batch, lens, n


def _offsets(tier, base_len, OW):
    keep = tier.astype(bool) & (base_len <= OW)
    lk = np.where(keep, base_len, 0).astype(np.int64)
    return keep, np.where(keep, np.cumsum(lk) - lk, -1).astype(np.int64), \
        int(lk.sum())


def _reverse_pairs(ch):
    """The first ``pair_count`` pair slots of each row in reverse order,
    in the packed channels, and the plain decode's dict of the result
    (pair_sd then falls where K1 never puts it)."""
    P = R5.DEFAULT_MAX_PAIRS
    c0 = R5.n_channels(4, 0)
    pc_row = R5._KEYS_1D.index("pair_count")
    ch = ch.copy()
    for r in range(ch.shape[1]):
        m = min(int(ch[pc_row, r]), P)
        for k in range(len(R5._KEYS_PAIR)):
            rows = c0 + k * P + np.arange(m)
            ch[rows, r] = ch[rows[::-1], r]
    return ch, R5.unpack_channels(torch.from_numpy(ch), 4, P)


@pytest.mark.parametrize("L,flip", [(512, False), (100, False), (512, True)],
                         ids=["512", "100", "512_pairs_reversed"])
def test_o5_kernel_sources_match_plain(libs, L, flip):
    rows = _rows5()
    batch, lens, n = _pack(rows, L)
    N = batch.shape[0]
    ch = np.zeros((R5.n_channels(4, 6), N), np.int32)
    assert libs["decode_rfc5424"].fg_decode_rfc5424_sd4_p6(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, N, L, None) == 0
    bt, lt = torch.from_numpy(batch.copy()), torch.from_numpy(lens.copy())
    dec = R5.decode_rfc5424(bt, lt)
    if flip:
        ch, dec = _reverse_pairs(ch)
    # padding rows past n hold garbage neither kernel may read
    batch[n:] = 9
    lens[n:] = L
    bank, table = DO.kernel_consts(SUFFIX)
    bank = np.frombuffer(bank, np.uint8).copy()
    tier = np.zeros(N, np.uint8)
    bl = np.zeros(N, np.int32)
    small8 = np.full((2, N), 7, np.uint8)
    assert libs["encode_rfc5424_out"].fg_encode_rfc5424_out_probe(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, table, N, n, L,
        tier.ctypes.data, bl.ctypes.data, small8.ctypes.data, None) == 0
    base, base_len, psmall = DO.encode_rows(bt, lt, dec, suffix=SUFFIX,
                                            assemble=False, n=n)
    assert np.array_equal(tier.astype(bool), base.numpy())
    assert np.array_equal(bl, base_len.numpy())
    assert np.array_equal(small8, psmall.numpy())
    OW = DO.out_width(L, SUFFIX)
    keep, row_off, total = _offsets(tier, bl, OW)
    assert 50 < keep.sum() < n
    flat = np.zeros(total + 16, np.uint8)
    assert libs["encode_rfc5424_out"].fg_encode_rfc5424_out_assemble(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, bank.ctypes.data,
        table, N, n, L, OW, row_off.ctypes.data, flat.ctypes.data, None) == 0
    rows_p, out_len, _ = DO.encode_rows(bt, lt, dec, suffix=SUFFIX)
    want = flat_rows(rows_p, out_len, torch.from_numpy(row_off),
                     total).numpy()
    assert np.array_equal(flat[:total], want) and not flat[total:].any()
    if flip:
        return

    # FO/r5 rfc5424: the same probe, the stamp channels, the carried rows
    t2 = np.zeros(N, np.uint8)
    bl2 = np.zeros(N, np.int32)
    s82 = np.zeros((2, N), np.uint8)
    small = np.zeros((5, N), np.int32)
    chan = np.full((N, 50), -5, np.int32)
    assert libs["fused_rfc5424_out"].fg_fused_rfc5424_out_carry(5424) == 50
    assert libs["fused_rfc5424_out"].fg_fused_rfc5424_rfc5424_probe(
        batch.ctypes.data, lens.ctypes.data, table, N, n, L, t2.ctypes.data,
        bl2.ctypes.data, small.ctypes.data, s82.ctypes.data,
        chan.ctypes.data, None) == 0
    assert np.array_equal(t2, tier) and np.array_equal(bl2, bl)
    assert np.array_equal(s82, small8)
    live = np.arange(N) < n
    for i, k in enumerate(("ok", "days", "sod", "off", "nanos")):
        assert np.array_equal(small[i],
                              np.where(live, dec[k].to(torch.int32).numpy(),
                                       0)), k
    cp = FR.carried_plain(dec, "rfc5424_rfc5424").numpy()
    t = tier.astype(bool)
    assert np.array_equal(chan[t], cp[t]) and (chan[~t] == -5).all()
    flat2 = np.zeros(total + 16, np.uint8)
    assert libs["fused_rfc5424_out"].fg_fused_rfc5424_rfc5424_assemble(
        batch.ctypes.data, lens.ctypes.data, chan.ctypes.data,
        bank.ctypes.data, table, N, n, L, OW, row_off.ctypes.data,
        flat2.ctypes.data, None) == 0
    assert np.array_equal(flat2, flat)


@pytest.mark.parametrize("L", [512, 100])
def test_o5_3164_kernel_sources_match_plain(libs, L):
    batch, lens, n = _pack(_rows3(), L)
    N = batch.shape[0]
    ch = np.zeros((len(R3.KEYS), N), np.int32)
    assert libs["decode_rfc3164"].fg_decode_rfc3164(
        batch.ctypes.data, lens.ctypes.data, YEAR, ch.ctypes.data, N, L,
        None) == 0
    bt, lt = torch.from_numpy(batch.copy()), torch.from_numpy(lens.copy())
    dec = R3.decode_rfc3164(bt, lt, YEAR)
    batch[n:] = 9
    lens[n:] = L
    bank, table = DO.kernel_consts(SUFFIX)
    bank = np.frombuffer(bank, np.uint8).copy()
    tier = np.zeros(N, np.uint8)
    bl = np.zeros(N, np.int32)
    small8 = np.full((3, N), 7, np.uint8)
    hostl = np.full(N, 7, np.uint16)
    lib = libs["encode_rfc5424_out"]
    assert lib.fg_encode_rfc3164_rfc5424_probe(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, table, N, n, L,
        tier.ctypes.data, bl.ctypes.data, small8.ctypes.data,
        hostl.ctypes.data, None) == 0
    base, base_len, psmall, phost = DO.encode_rows_3164(
        bt, lt, dec, suffix=SUFFIX, assemble=False, n=n)
    assert np.array_equal(tier.astype(bool), base.numpy())
    assert np.array_equal(bl, base_len.numpy())
    assert np.array_equal(small8, psmall.numpy())
    assert np.array_equal(hostl, phost.numpy())
    OW = DO.out_width(L, SUFFIX)
    keep, row_off, total = _offsets(tier, bl, OW)
    assert 50 < keep.sum() < n
    flat = np.zeros(total + 16, np.uint8)
    assert lib.fg_encode_rfc3164_rfc5424_assemble(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, bank.ctypes.data,
        table, N, n, L, OW, row_off.ctypes.data, flat.ctypes.data, None) == 0
    rows_p, out_len, _ = DO.encode_rows_3164(bt, lt, dec, suffix=SUFFIX)
    want = flat_rows(rows_p, out_len, torch.from_numpy(row_off),
                     total).numpy()
    assert np.array_equal(flat[:total], want) and not flat[total:].any()

    # FO/r5 rfc3164
    t2 = np.zeros(N, np.uint8)
    bl2 = np.zeros(N, np.int32)
    s82 = np.zeros((3, N), np.uint8)
    h2 = np.zeros(N, np.uint16)
    small = np.zeros((5, N), np.int32)
    chan = np.full((N, 3), -5, np.int32)
    fl = libs["fused_rfc5424_out"]
    assert fl.fg_fused_rfc5424_out_carry(3164) == 3
    assert fl.fg_fused_rfc3164_rfc5424_probe(
        batch.ctypes.data, lens.ctypes.data, YEAR, table, N, n, L,
        t2.ctypes.data, bl2.ctypes.data, small.ctypes.data, s82.ctypes.data,
        h2.ctypes.data, chan.ctypes.data, None) == 0
    assert np.array_equal(t2, tier) and np.array_equal(bl2, bl)
    assert np.array_equal(s82, small8) and np.array_equal(h2, hostl)
    live = np.arange(N) < n
    for i, k in enumerate(("ok", "days", "sod", "off", "nanos")):
        assert np.array_equal(small[i],
                              np.where(live, dec[k].to(torch.int32).numpy(),
                                       0)), k
    cp = FR.carried_plain(dec, "rfc3164_rfc5424").numpy()
    t = tier.astype(bool)
    assert np.array_equal(chan[t], cp[t]) and (chan[~t] == -5).all()
    flat2 = np.zeros(total + 16, np.uint8)
    assert fl.fg_fused_rfc3164_rfc5424_assemble(
        batch.ctypes.data, lens.ctypes.data, chan.ctypes.data,
        bank.ctypes.data, table, N, n, L, OW, row_off.ctypes.data,
        flat2.ctypes.data, None) == 0
    assert np.array_equal(flat2, flat)
