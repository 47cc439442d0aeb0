"""The device GELF encode kernel (flowgger_tpu_torch/csrc/encode_gelf.cu),
compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against its plain PyTorch version
(``device_gelf.encode_rows``): the base tier bit and base length of
every row from the probe (zeros at and past ``n``), and every kept
row's bytes at its offset from the assemble, at 6 and 16 pairs, on at
most 64 rows each.  The cases cover rows past ``n`` holding garbage,
row lengths around the 16-byte chunks and at the width, a width that is
not a multiple of 16 (the byte path), pair counts at and past each
width, fully tied and 8-byte-prefix-tied SD names, channels the decode
never writes for a row it passes, and output offsets at every residue
mod 16.  The tables the source repeats (channel rows,
the bank constants' order, the tier constants) are held against the
Python they copy, and the batch contract the kernel rests on (bytes past
a row's length are zero) against both producers of a batch."""

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
from flowgger_tpu_torch.tpu import framing as F
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as T

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


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


SRC = host_build.CSRC / "encode_gelf.cu"
# the row encode E1's kernels call, shared with the fused route
ROW_SRC = host_build.CSRC / "encode_gelf_row.cuh"
SUFFIX = b"\n"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    lib = ctypes.CDLL(str(host_build.build(
        "encode_gelf", tmp_path_factory.mktemp("cuda_host_enc"))))
    for p in (6, 16):
        fn = getattr(lib, f"fg_encode_gelf_probe_p{p}")
        fn.argtypes = [_P] * 4 + [_I] * 4 + [_P] * 3
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
    # fully tied names (one key, one length), twice and three times
    b'<13>1 2023-09-20T12:35:45.123Z h a - - [x@1 dup="1" dup="2"] m',
    b'<13>1 2023-09-20T12:35:45Z h a - - [x@1 q="1" zz="2" q="3" q="4"] m',
    # one 8-byte prefix: both names longer (ambiguous), one of 8 and one
    # of 9 (ordered), two of 8 (a full tie), 8 / 9 / 10 (the 9-10 pair
    # is ambiguous)
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 commonpreA="1" commonpreB="2"] m',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 abcdefgh="1" abcdefghi="2"] m',
    b'<13>1 2023-09-20T12:35:45Z h a - - [x@1 abcdefgh="1" abcdefgh="2"] m',
    b'<13>1 2023-09-20T12:35:45Z h a - - '
    b'[x@1 abcdefghXY="1" abcdefgh="2" abcdefghZ="3"] m',
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
    # each two-byte escape, and the control bytes that need \u00XX
    b'<13>1 2023-09-20T12:35:45Z h a - - - c\x08\x09\x0a\x0c\x0d"\\ end',
    b'<13>1 2023-09-20T12:35:45Z h a - - - vt\x0bhere',
    b'<13>1 2023-09-20T12:35:45Z h a - - - us\x1fhere',
    # exactly E_CAP escapes, and one more
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'"' * 56,
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'\\' * 57,
]


def _pairs_line(k: int, tag: bytes = b"w") -> bytes:
    """A row of ``k`` SD pairs with distinct names (no SD at 0)."""
    body = b" ".join(b'n%02d="%d"' % (j, j) for j in range(k))
    sd = b'[' + tag + b'@1 ' + body + b']' if k else b"-"
    return b'<13>1 2023-09-20T12:35:45Z h a - - ' + sd + b' pairs'



def _sized(L: int):
    """Rows of 0, 15, 16, 17, L - 1 and L bytes (the short ones are not
    valid RFC5424 and leave the tier; the long ones are in it)."""
    head = b'<13>1 2023-09-20T12:35:45Z h a - - [x@1 k="v"] '
    return [b"", b"<1>1 - - - - - ", b"<1>1 - - - - - -",
            b"<1>1 - - - - - -x"] + [
        head + b"x" * (size - len(head)) for size in (L - 1, L)]


TAMPER_ROW = 11


def _lines(max_pairs, L):
    """At most 64 rows: rows of the sizes above, pair counts 0, 6, 7, 16
    and 17 and the width's (and 7-17 at 16 pairs), the hand cases, then
    the tier and
    mixed corpora (cut to the width when it is narrow)."""
    lines = _sized(L) + [_pairs_line(k) for k in (0, 6, 7, 16, 17)]
    lines.append(_pairs_line(max_pairs, b"t"))    # TAMPER_ROW
    if max_pairs == 16:
        lines += [_pairs_line(17 - i % 12, b"v") for i in range(10)]
    lines += [ln for ln in HAND if len(ln) <= L]
    tier, _ = make_tier_corpus(60, seed=31)
    mixed, _ = make_corpus(40, seed=32)
    lines += [ln[:L] for ln in tier + mixed]
    assert all(len(ln) <= L for ln in lines[:5])
    return lines[:64]


def _probe(lib, P, batch, lens, ch, n, table):
    N, L = batch.shape
    tier = np.full(N, 7, np.uint8)
    base_len = np.full(N, -1, np.int32)
    assert getattr(lib, f"fg_encode_gelf_probe_p{P}")(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data, table, N, n, L,
        4, tier.ctypes.data, base_len.ctypes.data, None) == 0
    return tier, base_len


def _offsets(keep, lengths, flat_ptr):
    """Offsets of the kept rows in order, gaps between them so the k-th
    kept row starts at address residue k mod 16: (row_off, size)."""
    row_off = np.full(keep.size, -1, np.int64)
    at = 0
    for k, r in enumerate(np.flatnonzero(keep)):
        at += (k - (flat_ptr + at)) % 16
        row_off[r] = at
        at += int(lengths[r])
    return row_off, at


def _tamper(dec, bt, lt, max_pairs, rows):
    """Channels the decode never writes for a row it passes, on three
    tier rows: more pairs than the width (on the row of exactly that many
    distinct pairs, TAMPER_ROW), more SD elements than the channels hold
    (both leave the tier), an empty host span (the "unknown" constant
    takes its place)."""
    base, _ = DG.encode_rows(bt, lt, dec, assemble=False, suffix=SUFFIX,
                             max_sd=4)
    r_pc = TAMPER_ROW
    r_sd, r_host = [r for r in rows if base[r]][:2]
    assert base[r_pc]
    dec["pair_count"][r_pc] = max_pairs + 1
    dec["sd_count"][r_sd] = 5
    dec["host_end"][r_host] = dec["host_start"][r_host]
    return r_pc, r_sd, r_host


def _check(lib, max_pairs, extras, L, lines, n=None, garbage_rows=0,
           tamper=False):
    """Probe and assemble of ``lines`` packed at width ``L`` against the
    plain version; rows at and past ``n`` (default: all real) read as
    padding, and the last ``garbage_rows`` of them hold random bytes,
    lengths and channels; with ``tamper``, three rows of the last 20
    carry channels of :func:`_tamper`."""
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    N = len(lines) + garbage_rows
    batch = np.ascontiguousarray(batch[:N])
    lens = np.ascontiguousarray(lens[:N]).astype(np.int32)
    n = len(lines) if n is None else n
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = T.decode_rfc5424(bt, lt, 4, max_pairs)
    if tamper:
        tampered = _tamper(dec, bt, lt, max_pairs, range(n - 20, n))
    ch = packed_channels(dec, max_pairs).numpy()
    rng = np.random.default_rng(max_pairs * 1000 + L)
    if garbage_rows:
        g = slice(N - garbage_rows, N)
        batch[g] = rng.integers(0, 256, (garbage_rows, L))
        lens[g] = rng.integers(-5, 2 * L, garbage_rows)
        ch[:, g] = rng.integers(-3, 3 * L, (ch.shape[0], garbage_rows))
    bank, table = DG.kernel_consts(SUFFIX, extras)
    bank_np = np.frombuffer(bank, dtype=np.uint8).copy()
    OW = DG.out_width(L, SUFFIX, extras)
    ts_len = rng.integers(3, DC.TS_W + 1, N).astype(np.int32)
    ts_text = rng.integers(48, 58, (N, DC.TS_W)).astype(np.uint8)

    tier, base_len = _probe(lib, max_pairs, batch, lens, ch, n, table)
    kw = {"suffix": SUFFIX, "max_sd": 4, "extras": extras}
    ref_base, ref_len = DG.encode_rows(bt, lt, dec, assemble=False, n=n,
                                       **kw)
    assert (tier == ref_base.numpy()).all()
    assert (base_len == ref_len.numpy()).all()
    assert (tier[n:] == 0).all() and (base_len[n:] == 0).all()
    assert 5 < ref_base.sum() < n
    if tamper:
        assert list(tier[list(tampered)]) == [0, 0, 1]

    # assemble every tier row but one, each at its own residue mod 16
    rows, out_len, full_tier = DG.encode_rows(
        bt, lt, dec, torch.from_numpy(ts_text), torch.from_numpy(ts_len),
        **kw)
    assert (out_len.numpy() == np.where(tier, base_len + ts_len,
                                        out_len.numpy())).all()
    keep = full_tier.numpy() & (np.arange(N) < n)
    assert (keep <= tier).all()
    keep[np.flatnonzero(keep)[1]] = False
    flat = np.full(1 << 16, 0xAB, np.uint8)
    row_off, size = _offsets(keep, out_len.numpy(), flat.ctypes.data)
    assert size + 16 <= flat.size and keep.sum() >= 4
    assert getattr(lib, f"fg_encode_gelf_assemble_p{max_pairs}")(
        batch.ctypes.data, lens.ctypes.data, ch.ctypes.data,
        ts_text.ctypes.data, ts_len.ctypes.data, bank_np.ctypes.data, table,
        N, n, L, OW, row_off.ctypes.data, flat.ctypes.data, None) == 0
    want = np.full(flat.size, 0xAB, np.uint8)
    rows, out_len = rows.numpy(), out_len.numpy()
    for r in np.flatnonzero(keep):
        want[row_off[r]:row_off[r] + out_len[r]] = rows[r, :out_len[r]]
    assert (flat == want).all()
    return tier, int(keep.sum())


@pytest.mark.parametrize("extras", [(), (("x-origin", "port"),
                                         ("zzz", "last"))],
                         ids=["plain", "extras"])
@pytest.mark.parametrize("max_pairs", [6, 16])
def test_encode_kernel_source_matches_plain(lib, max_pairs, extras):
    lines = _lines(max_pairs, 256)
    tier, kept = _check(lib, max_pairs, extras, 256, lines, tamper=True)
    assert kept >= 16     # every start residue mod 16
    # the sized rows: the valid ones are in the tier; every pair count
    # past the width is out
    assert list(tier[:6]) == [0, 0, 0, 0, 1, 1]
    counts = dict(zip((0, 6, 7, 16, 17), tier[6:11]))
    assert counts == {k: int(k <= max_pairs) for k in counts}
    tied = [lines.index(ln) for ln in HAND[3:9]]
    assert list(tier[tied]) == [0, 0, 0, 1, 0, 0]
    ctl = [lines.index(ln) for ln in HAND[-5:-2]]
    assert list(tier[ctl]) == [1, 0, 0]


@pytest.mark.parametrize("max_pairs", [6, 16])
def test_encode_kernel_source_padding_rows_and_odd_width(lib, max_pairs):
    """Rows at and past ``n``, garbage included, give zeros (n < N), and
    at L = 100 (not a multiple of 16) the byte path stages the rows."""
    lines = _lines(max_pairs, 256)[:40]
    _check(lib, max_pairs, (), 256, lines, n=33, garbage_rows=8)
    short, _ = make_tier_corpus(400, seed=33)
    lines = _sized(100) + HAND[:3] + [ln for ln in short if len(ln) <= 100]
    tier, _ = _check(lib, max_pairs, (), 100, lines[:48])
    assert list(tier[:6]) == [0, 0, 0, 0, 1, 1]


def test_encode_kernel_tables_match_python():
    """The channel rows, the constants' order and the tier constants in
    the source are the ones rfc5424, device_common and device_gelf
    define."""
    text = SRC.read_text() + ROW_SRC.read_text()
    enum = re.search(r"enum Const \{(.*?)\}", text, re.S).group(1)
    names = [w.strip()[2:].lower() for w in enum.split(",")][:-1]
    assert tuple(names) == DG.KERNEL_CONSTS
    chans = re.search(r"enum Ch \{(.*?)\}", text, re.S).group(1)
    for name, idx in re.findall(r"C_(\w+) = (\d+)", chans):
        key = {"HOST_S": "host_start", "HOST_E": "host_end",
               "APP_S": "app_start", "APP_E": "app_end",
               "PROC_S": "proc_start", "PROC_E": "proc_end"}.get(
                   name, name.lower())
        assert T._KEYS_1D[int(idx)] == key, name
    consts = dict(re.findall(r"constexpr int (k\w+) = (\w+);", text))
    assert int(consts["kN1D"]) == len(T._KEYS_1D)
    assert int(consts["kECap"]) == DC.E_CAP
    assert int(consts["kAmbigLen"]) == DC._AMBIG_LEN
    assert int(consts["kBig"], 16) == DC._BIG


def test_batches_are_zero_past_each_row_length():
    """The contract the kernel reads name keys by: both producers of a
    batch — the host packer and the gather (its plain version; the
    kernel source's gather tests hold it to the same bytes) — leave
    every byte at and past a row's clipped length zero."""
    lines, _ = make_corpus(200, seed=34)
    region = b"\n".join(lines) + b"\n"
    L = 128
    batch, lens, *_ = pack.pack_region_2d(region, L)
    col = np.arange(L)[None, :]
    assert (batch[col >= lens[:, None]] == 0).all()
    buf = torch.frombuffer(bytearray(region), dtype=torch.uint8)
    spans = F.sep_spans(buf, len(region), 10, True, 256)
    gb, gl = F.gather(buf, spans["starts"], spans["lens"], L)
    gb, gl = gb.numpy(), gl.numpy()
    assert (gb[col >= np.maximum(gl, 0)[:, None]] == 0).all()
    assert (gl[:len(lines)] == lens[:len(lines)]).all()
