"""The device GELF encode kernel (flowgger_tpu_torch/csrc/encode_gelf.cu),
compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against its plain PyTorch version
(``device_gelf.encode_rows``): the tier bit and length of every row from
the probe, and every kept row's bytes at its offset from the assemble,
at 6 and 16 pairs, on at most 64 rows each.  The tables the source
repeats (the sorting networks, the bank constants' order) are held
against the Python they copy."""

import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_corpus, make_tier_corpus
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_gelf as DG
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as T

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
SRC = host_build.CSRC / "encode_gelf.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    lib = ctypes.CDLL(str(host_build.build(
        "encode_gelf", tmp_path_factory.mktemp("cuda_host_enc"))))
    for p in (6, 16):
        fn = getattr(lib, f"fg_encode_gelf_probe_p{p}")
        fn.argtypes = [_P] * 6 + [_I] * 4 + [_P] * 3
        fn.restype = _I
        fn = getattr(lib, f"fg_encode_gelf_assemble_p{p}")
        fn.argtypes = [_P] * 7 + [_I] * 4 + [_P] * 3
        fn.restype = _I
    return lib


def packed_channels(dec, max_pairs):
    """The decode kernel's [C, N] int32 layout of a channel dict."""
    rows = [dec[k].to(torch.int32)[None] for k in T._KEYS_1D]
    rows += [dec[k].to(torch.int32).t() for k in T._KEYS_SD]
    rows += [dec[k].to(torch.int32).t() for k in T._KEYS_PAIR]
    out = torch.cat(rows).contiguous()
    assert out.shape[0] == T.n_channels(4, max_pairs)
    return out


HAND = [
    # quotes and tabs in the message, a \" value, a control byte
    b'<191>1 2023-06-30T23:59:59.999999Z h a p m [x@1 zz="1" aa="2" '
    b'mm="3"] msg with "quotes" and\ttabs',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - [x@1 k="a\\"b"] esc val',
    b'<13>1 2023-09-20T12:35:45Z h a - - - bell\x07here',
    # duplicate names; long names with one 8-byte prefix; a prefix pair
    b'<13>1 2023-09-20T12:35:45.123Z h a - - [x@1 dup="1" dup="2"] m',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 commonpreA="1" commonpreB="2"] m',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 abcdefgh="1" abcdefghi="2"] m',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 zeta="1" alpha="2" mike="3" bravo="4" yank="5" echo="6"] m',
    # empty host and message, many escapes, non-ASCII
    b'<0>1 2023-01-01T00:00:00Z - - - - - -',
    b'<13>1 2023-01-01T00:00:00Z - app - - -',
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'"\\' * 30,
    "<13>1 2023-09-20T12:35:45.123Z hést a - - - utf8".encode(),
    b'<13>1 2023-09-20T12:35:45Z h a - - [a@1 x="1"][b@2 y="2"][c@3] m',
    # a name that is a prefix of another with a digit after it (the key
    # pads with zeros, not with the '=' that follows the name)
    b'<13>1 2023-09-20T12:35:45Z h a - - [x@1 ab0="1" ab="2" a="3"] m',
    # exactly E_CAP escapes, and one more
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'"' * 56,
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'\\' * 57,
]


def _lines(max_pairs, n=64):
    lines, _ = make_tier_corpus(40, seed=31)
    more, _ = make_corpus(40, seed=32)
    lines = HAND + lines + more
    if max_pairs == 16:
        lines = [b'<13>1 2023-09-20T12:35:45Z h a - - [w@1 '
                 + b" ".join(b'n%02d="%d"' % (k, k)
                             for k in range(17 - i % 12)) + b'] wide'
                 for i in range(12)] + lines
    return lines[:n]


@pytest.mark.parametrize("extras", [(), (("x-origin", "port"),
                                         ("zzz", "last"))],
                         ids=["plain", "extras"])
@pytest.mark.parametrize("max_pairs", [6, 16])
def test_encode_kernel_source_matches_plain(lib, max_pairs, extras):
    L = 256
    lines = _lines(max_pairs)
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    n = len(lines)
    batch = np.ascontiguousarray(batch[:n])
    lens = np.ascontiguousarray(lens[:n]).astype(np.int32)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = T.decode_rfc5424(bt, lt, 4, max_pairs)
    ch = packed_channels(dec, max_pairs).numpy()
    suffix = b"\n"
    bank, table = DG.kernel_consts(suffix, extras)
    bank_np = np.frombuffer(bank, dtype=np.uint8).copy()
    OW = DG.out_width(L, suffix, extras)
    rng = np.random.default_rng(max_pairs)
    ts_len = rng.integers(3, DC.TS_W + 1, n).astype(np.int32)
    ts_text = rng.integers(48, 58, (n, DC.TS_W)).astype(np.uint8)

    tier = np.full(n, 7, np.uint8)
    out_len = np.full(n, -1, np.int32)
    assert getattr(lib, f"fg_encode_gelf_probe_p{max_pairs}")(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data,
        ts_len.ctypes.data, bank_np.ctypes.data, table, n, L, 4, OW,
        tier.ctypes.data, out_len.ctypes.data, None) == 0
    rows, ref_len, ref_tier = DG.encode_rows(
        bt, lt, dec, torch.from_numpy(ts_text), torch.from_numpy(ts_len),
        suffix=suffix, max_sd=4, extras=extras)
    assert (tier == ref_tier.numpy()).all()
    assert (out_len == ref_len.numpy()).all()
    assert 10 < ref_tier.sum() < n

    # assemble every tier row but one, at its offset
    keep = ref_tier.numpy().copy()
    keep[np.flatnonzero(keep)[1]] = False
    gated = np.where(keep, out_len, 0).astype(np.int64)
    row_off = np.where(keep, np.cumsum(gated) - gated, -1)
    total = int(gated.sum())
    flat = np.full(total + 16, 0xAB, np.uint8)
    assert getattr(lib, f"fg_encode_gelf_assemble_p{max_pairs}")(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data,
        ts_text.ctypes.data, ts_len.ctypes.data, bank_np.ctypes.data, table,
        n, L, 4, OW, row_off.ctypes.data, flat.ctypes.data, None) == 0
    want = DG.flat_rows(rows, ref_len, torch.from_numpy(row_off), total)
    assert (flat[:total] == want.numpy()).all()
    assert (flat[total:] == 0xAB).all()


def _source_networks():
    text = SRC.read_text()
    out = {}
    for n in (6, 16):
        body = re.search(r"void sort_net%d\(Pair\* p\) \{(.*?)\}" % n, text,
                         re.S).group(1)
        out[n] = tuple((int(a), int(b)) for a, b in
                       re.findall(r"CS\((\d+), (\d+)\)", body))
    return out


def test_encode_kernel_tables_match_python():
    """The sorting networks and the constants' order in the source are
    the ones device_common and device_gelf define."""
    nets = _source_networks()
    for n in (6, 16):
        assert nets[n] == DC._sort_network(n)
    enum = re.search(r"enum Const \{(.*?)\}", SRC.read_text(), re.S).group(1)
    names = [w.strip()[2:].lower() for w in enum.split(",")][:-1]
    assert tuple(names) == DG.KERNEL_CONSTS
