"""OC and FO/capnp, the → Cap'n Proto kernel sources (csrc/encode_capnp.cu
and csrc/fused_capnp_out.cu, both on encode_capnp_row.cuh), compiled for
the CPU with g++ through the host emulation in tests/cuda_host, against
their plain PyTorch versions (``device_capnp.encode_rows`` and the fused
route's plain rows):

- OC's probe on K1's emulated channels at 6 and 16 pairs (tier bit,
  elided length, fac8 / sev8 of every row, padding rows past ``n``
  holding garbage) and its assemble (the bytes of the kept rows at their
  offsets), with and without a ``capnp_extra``, at row widths 512 and
  100 (byte loads);
- FO/capnp's probe (the same outputs, the ok / stamp channels, the
  carried channels of its tier rows against ``carried_plain``) and its
  assemble from those carried channels, which must write the split
  kernel's bytes.

A few hundred rows: the tier mix, the sourced mix and rows at the
screens' edges (an escaped value in the second SD block, SD blocks
without pairs or without an id's pairs, ``-`` fields, an empty message,
seven pairs, messages that leave the width)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_corpus, make_tier_corpus
from flowgger_tpu_torch.tpu import device_capnp as DC
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as R5
from flowgger_tpu_torch.tpu.device_gelf import flat_rows

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402

HEAD = "<13>1 2015-08-05T15:53:45Z h a p m"
EXTRAS = (("env", "prod"), ("dc", "eu-west-1"))


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
    return hostlibs.load(("decode_rfc5424", "encode_capnp",
                          "fused_capnp_out"),
                         tmp_path_factory.mktemp("cuda_host"))


def edge_rows():
    """Rows at the edges of OC's gates (shared with the other capnp
    tests)."""
    odd = [f'{HEAD} [a b="1"][c d="x\\"y"] escape in the second block',
           f'{HEAD} [x k="a\\"b"] escaped value',
           f'{HEAD} [a b="1" c="2" d="3" e="4" f="5" g="6" h="7"] seven',
           f'{HEAD} [a b="1" c="2" d="3" e="4" f="5"][g h="6"] six',
           f'{HEAD} [only] empty block',
           f'{HEAD} [a][b c="d"][e] sd0 without pairs',
           f'{HEAD} [id@1 k="v"]',
           f'{HEAD} [id@1 k=""] empty value',
           "<191>1 2015-08-05T15:53:45.002Z h a p m - pri 191",
           "<7>1 2015-08-05T15:53:45Z - - - - -",
           "<13>1 2015-08-05T15:53:45Z h - - - - ",
           f"{HEAD} - " + "w" * 600, f"{HEAD} - " + "v" * 60,
           f"{HEAD} - {'y' * 7}", f"{HEAD} - {'y' * 8}"]
    return [o.encode() for o in odd]


def _rows():
    return (make_tier_corpus(150, 161)[0] + make_corpus(80, 162)[0]
            + edge_rows())


def _offsets(tier, base_len, OW):
    keep = tier.astype(bool) & (base_len <= OW)
    lk = np.where(keep, base_len, 0).astype(np.int64)
    return keep, np.where(keep, np.cumsum(lk) - lk, -1).astype(np.int64), \
        int(lk.sum())


@pytest.mark.parametrize("L,P,extras",
                         [(512, 6, ()), (512, 6, EXTRAS), (100, 6, EXTRAS),
                          (512, 16, EXTRAS)],
                         ids=["512_p6", "512_p6_extra", "100_p6_extra",
                              "512_p16_extra"])
def test_oc_kernel_sources_match_plain(libs, L, P, extras):
    batch, lens, _, _, _, n = pack.pack_lines_2d(_rows(), L)
    N = batch.shape[0]
    ch = np.zeros((R5.n_channels(4, P), N), np.int32)
    assert getattr(libs["decode_rfc5424"], f"fg_decode_rfc5424_sd4_p{P}")(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, N, L, None) == 0
    bt, lt = torch.from_numpy(batch.copy()), torch.from_numpy(lens.copy())
    dec = R5.decode_rfc5424(bt, lt, max_pairs=P)
    # padding rows past n hold garbage neither kernel may read
    batch[n:] = 9
    lens[n:] = L
    suffix = b"\n"
    bank, table = DC.kernel_consts(suffix, extras)
    bank = np.frombuffer(bank, np.uint8).copy()
    tier = np.zeros(N, np.uint8)
    bl = np.zeros(N, np.int32)
    small8 = np.full((2, N), 7, np.uint8)
    lib = libs["encode_capnp"]
    assert getattr(lib, f"fg_encode_capnp_probe_p{P}")(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, table, N, n, L,
        tier.ctypes.data, bl.ctypes.data, small8.ctypes.data, None) == 0
    base, base_len, psmall = DC.encode_rows(bt, lt, dec, suffix=suffix,
                                            extras=extras, assemble=False,
                                            n=n)
    assert np.array_equal(tier.astype(bool), base.numpy())
    assert np.array_equal(bl, base_len.numpy())
    assert np.array_equal(small8, psmall.numpy())
    OW = DC.out_width(L, suffix, extras, P)
    keep, row_off, total = _offsets(tier, bl, OW)
    assert 50 < keep.sum() < n
    flat = np.zeros(total + 16, np.uint8)
    assert getattr(lib, f"fg_encode_capnp_assemble_p{P}")(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, bank.ctypes.data,
        table, N, n, L, OW, row_off.ctypes.data, flat.ctypes.data, None) == 0
    rows_p, out_len, _ = DC.encode_rows(bt, lt, dec, suffix=suffix,
                                        extras=extras)
    want = flat_rows(rows_p, out_len, torch.from_numpy(row_off),
                     total).numpy()
    assert np.array_equal(flat[:total], want) and not flat[total:].any()
    if P != 6:
        return

    # FO/capnp: the same probe, the stamp channels, the carried rows
    t2 = np.zeros(N, np.uint8)
    bl2 = np.zeros(N, np.int32)
    s82 = np.zeros((2, N), np.uint8)
    small = np.zeros((5, N), np.int32)
    chan = np.full((N, 45), -5, np.int32)
    fl = libs["fused_capnp_out"]
    assert fl.fg_fused_capnp_out_carry() == 45
    assert fl.fg_fused_rfc5424_capnp_probe(
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
    cp = FR.carried_plain(dec, "rfc5424_capnp").numpy()
    t = tier.astype(bool)
    assert np.array_equal(chan[t], cp[t]) and (chan[~t] == -5).all()
    flat2 = np.zeros(total + 16, np.uint8)
    assert fl.fg_fused_rfc5424_capnp_assemble(
        batch.ctypes.data, lens.ctypes.data, chan.ctypes.data,
        bank.ctypes.data, table, N, n, L, OW, row_off.ctypes.data,
        flat2.ctypes.data, None) == 0
    assert np.array_equal(flat2, flat)
