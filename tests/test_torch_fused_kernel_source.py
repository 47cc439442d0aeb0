"""The kernels of the rfc3164 and fused routes — D3
(``csrc/decode_rfc3164.cu``), E3 (the ``fg_encode_gelf3164_*`` entry
points of ``csrc/encode_gelf.cu``), F1 and F3 (``csrc/fused_gelf.cu``) —
compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against their plain PyTorch versions: every channel of
every row from D3 (padding rows included), and from E3, F1 and F3 the
probe's tier bit and base length (F1 and F3 also the ok and timestamp
channels; zeros at and past ``n``) and every kept row's bytes from the
assemble, at offsets of every residue mod 16, on at most 64 rows a case.
Exact on every channel and byte.  The tables the sources repeat (channel
rows, the bank constants' order) are held against the Python they copy.
"""

import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import (make_corpus, make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus)
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_gelf as DG
from flowgger_tpu_torch.tpu import device_rfc3164 as D3
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import kernels as K
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc3164 as R3
from flowgger_tpu_torch.tpu import rfc5424 as T

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
SUFFIX = b"\n"
YEAR = 2024


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# rfc3164 rows for every branch of D3: the day layouts A, B and C, Feb 29
# (valid in a leap year only), timezone-lookalike hosts and the two
# lowercase aliases, PRI forms, whitespace runs, escapes and control
# bytes in the message, short and empty rows
HAND_3164 = [
    b"<34>Oct 11 22:14:15 mymachine su: 'su root' failed for lonvick",
    b"<13>Oct  7 01:02:03 host.example.com app[42]: layout C",
    b"<13>Oct 7 01:02:03 10.0.0.1 app: layout B",
    b"Oct 17 01:02:03 nopri tag: no pri",
    b"<13>Feb 29 01:02:03 leap x: feb 29",
    b"<13>Feb 30 01:02:03 bad x: feb 30",
    b"<13>Mar  3 01:02:03 Gateway x: tz lookalike",
    b"<13>Mar  3 01:02:03 localtime x: alias",
    b"<13>Mar  3 01:02:03 posixrules x: alias",
    b"<13>Mar  3 01:02:03 posixrule x: not an alias",
    b"<13>Mar  3 01:02:03 EST5EDT x: digits in a zone",
    b"<13>Mar  3 01:02:03 Web.A x: a dot",
    b"<999>Jan  1 00:00:00 a b",
    b"<1a>Jan  1 00:00:00 a b",
    b"<>Jan  1 00:00:00 a b",
    b"<12",
    b"<5>",
    b"Jan  1 00:00:00 a  b",
    b"Jan  1 00:00:00 a b ",
    b" Jan  1 00:00:00 a b",
    b"Jan  1 00:00:00 a\tb",
    b"Jan  1 0:00:00 a b",
    b"Jan 31 23:59:5",
    b'<7>Dec 31 23:59:59 h x: "quoted" and \\ back\\slash',
    b"<7>Dec 31 23:59:59 h x: bell\x07here",
    b"<7>Dec 31 23:59:59 h x: caf\xc3\xa9",
    b"<7>Dec 31 23:59:59 h",
    b"<7>Dec 31 23:59:59 h ",
    b"",
    b"J",
]


def _lines_3164(L):
    rng = np.random.default_rng(L)
    alpha = list(b"<>0123456789 :JanFebOctDcv.aZ\t-/")
    rand = [bytes(rng.choice(alpha, int(rng.integers(0, 40))))
            for _ in range(8)]
    tier, _ = make_rfc3164_tier_corpus(14, seed=51)
    mixed, _ = make_rfc3164_corpus(12, seed=52)
    return (HAND_3164 + rand + [ln[:L] for ln in tier + mixed])[:64]


def _lines_5424(L):
    tier, _ = make_tier_corpus(48, seed=53)
    mixed, _ = make_corpus(16, seed=54)
    return [ln[:L] for ln in tier + mixed][:64]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_host_fused")
    libs = {n: ctypes.CDLL(str(host_build.build(n, out)))
            for n in ("decode_rfc3164", "encode_gelf", "fused_gelf")}
    for lib, sigs in ((libs["decode_rfc3164"], {
            "fg_decode_rfc3164": [_P, _P, _I, _P, _I, _I, _P]}),
            (libs["encode_gelf"], {
                "fg_encode_gelf3164_probe": [_P] * 4 + [_I] * 3 + [_P] * 3,
                "fg_encode_gelf3164_assemble": [_P] * 7 + [_I] * 4
                + [_P] * 3}),
            (libs["fused_gelf"], {
                "fg_fused_gelf_carry": [_I],
                "fg_fused_rfc5424_gelf_probe": [_P] * 3 + [_I] * 3
                + [_P] * 5,
                "fg_fused_rfc5424_gelf_assemble": [_P] * 7 + [_I] * 4
                + [_P] * 3,
                "fg_fused_rfc3164_gelf_probe": [_P, _P, _I, _P] + [_I] * 3
                + [_P] * 5,
                "fg_fused_rfc3164_gelf_assemble": [_P] * 7 + [_I] * 4
                + [_P] * 3})):
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _I
    return libs


def _pack(lines, L, garbage_rows=0, seed=0):
    """``lines`` at width ``L`` plus ``garbage_rows`` rows of random bytes
    and lengths: (batch, lens) numpy, N = len(lines) + garbage_rows."""
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    N = len(lines) + garbage_rows
    batch = np.ascontiguousarray(batch[:N])
    lens = np.ascontiguousarray(lens[:N]).astype(np.int32)
    if garbage_rows:
        rng = np.random.default_rng(seed)
        batch[N - garbage_rows:] = rng.integers(0, 256, (garbage_rows, L))
        lens[N - garbage_rows:] = rng.integers(-5, 2 * L, garbage_rows)
    return batch, lens


# ---------------------------------------------------------------------------
# D3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("year", [2024, 2025])
@pytest.mark.parametrize("L", [96, 100, 512])
def test_decode_rfc3164_source_matches_plain(libs, L, year):
    """Every channel of every row — rejected and padding rows included —
    equals the plain version, at widths with and without the 16-byte
    staging, in a leap and a non-leap year."""
    lines = _lines_3164(L)[:56]
    batch, lens = _pack(lines, L)
    batch = np.concatenate([batch, np.zeros((8, L), np.uint8)])
    lens = np.concatenate([lens, np.zeros(8, np.int32)])
    out = np.full((len(R3.KEYS), batch.shape[0]), -7, np.int32)
    assert libs["decode_rfc3164"].fg_decode_rfc3164(
        batch.ctypes.data, lens.ctypes.data, year, out.ctypes.data,
        batch.shape[0], L, None) == 0
    got = R3.unpack_channels(torch.from_numpy(out))
    ref = R3.decode_rfc3164(torch.from_numpy(batch), torch.from_numpy(lens),
                            year)
    assert ref["ok"].any() and not ref["ok"].all()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    leap = lines.index(b"<13>Feb 29 01:02:03 leap x: feb 29")
    assert bool(got["ok"][leap]) == (year % 4 == 0)


# ---------------------------------------------------------------------------
# E3, F1, F3: probe and assemble against the plain versions
# ---------------------------------------------------------------------------

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


def _route_check(kind, libs, L, lines, n=None, garbage_rows=0, extras=()):
    """The probe and the assemble of ``kind`` ("e3", "f1" or "f3") on
    ``lines`` at width ``L`` against the plain version; rows at and past
    ``n`` are padding, the last ``garbage_rows`` of them random."""
    batch, lens = _pack(lines, L, garbage_rows, seed=L)
    N = batch.shape[0]
    n = len(lines) if n is None else n
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    fmt = "rfc5424" if kind == "f1" else "rfc3164"
    split = DG if fmt == "rfc5424" else D3
    kw = {"suffix": SUFFIX, "extras": extras}
    if fmt == "rfc5424":
        kw["max_sd"] = 4
        dec = T.decode_rfc5424(bt, lt)
    else:
        dec = R3.decode_rfc3164(bt, lt, YEAR)
    if kind != "e3":
        # the fused plain version: the decode narrowed to the route's demand
        dec = {k: v for k, v in dec.items() if k in FR.DEMAND[f"{fmt}_gelf"]}
    bank, table = split.kernel_consts(SUFFIX, extras)
    bank_np = np.frombuffer(bank, dtype=np.uint8).copy()
    OW = split.out_width(L, SUFFIX, extras)
    rng = np.random.default_rng(L + N)
    ts_len = rng.integers(3, DC.TS_W + 1, N).astype(np.int32)
    ts_text = rng.integers(48, 58, (N, DC.TS_W)).astype(np.uint8)
    ptrs = (batch.ctypes.data, lens.ctypes.data)

    tier = np.full(N, 7, np.uint8)
    base_len = np.full(N, -1, np.int32)
    small = np.full((5, N), -9, np.int32)
    route = f"{fmt}_gelf"
    chan = np.full((N, K.FUSED_CARRY[fmt]), -5, np.int32)
    if kind == "e3":
        ch = np.stack([dec[k].to(torch.int32).numpy() for k in R3.KEYS])
        ch = np.ascontiguousarray(ch)
        assert libs["encode_gelf"].fg_encode_gelf3164_probe(
            *ptrs, ch.ctypes.data, table, N, n, L, tier.ctypes.data,
            base_len.ctypes.data, None) == 0
    else:
        yr = (YEAR,) if kind == "f3" else ()
        assert getattr(libs["fused_gelf"], f"fg_fused_{fmt}_gelf_probe")(
            *ptrs, *yr, table, N, n, L, tier.ctypes.data,
            base_len.ctypes.data, small.ctypes.data, chan.ctypes.data,
            None) == 0
        live = np.arange(N) < n
        want_small = np.stack([np.where(live, dec[k].to(torch.int32).numpy(),
                                        0)
                               for k in ("ok", "days", "sod", "off",
                                         "nanos")])
        assert (small == want_small).all()
    ref_base, ref_len = split.encode_rows(bt, lt, dec, assemble=False, n=n,
                                          **kw)
    assert (tier == ref_base.numpy()).all()
    assert (base_len == ref_len.numpy()).all()
    assert (tier[n:] == 0).all() and (base_len[n:] == 0).all()
    assert 3 < ref_base.sum() < n
    if kind != "e3":
        # the carried channels: the plain decode's on each tier row, and
        # nothing written on the other rows (padding rows included)
        on = tier.astype(bool)
        assert (chan[on] == FR.carried_plain(dec, route).numpy()[on]).all()
        assert (chan[~on] == -5).all()

    # assemble every tier row but one, each at its own residue mod 16
    rows, out_len, full_tier = split.encode_rows(
        bt, lt, dec, torch.from_numpy(ts_text), torch.from_numpy(ts_len),
        **kw)
    keep = full_tier.numpy() & (np.arange(N) < n)
    assert (keep <= tier).all()
    keep[np.flatnonzero(keep)[1]] = False
    flat = np.full(1 << 16, 0xAB, np.uint8)
    row_off, size = _offsets(keep, out_len.numpy(), flat.ctypes.data)
    assert size + 16 <= flat.size and keep.sum() >= 4
    tail = (ts_text.ctypes.data, ts_len.ctypes.data, bank_np.ctypes.data,
            table, N, n, L, OW, row_off.ctypes.data, flat.ctypes.data, None)
    if kind == "e3":
        rc = libs["encode_gelf"].fg_encode_gelf3164_assemble(
            *ptrs, ch.ctypes.data, *tail)
    else:
        # from the channels the probe carried: no decode runs again
        rc = getattr(libs["fused_gelf"], f"fg_fused_{fmt}_gelf_assemble")(
            *ptrs, chan.ctypes.data, *tail)
    assert rc == 0
    want = np.full(flat.size, 0xAB, np.uint8)
    rows, out_len = rows.numpy(), out_len.numpy()
    for r in np.flatnonzero(keep):
        want[row_off[r]:row_off[r] + out_len[r]] = rows[r, :out_len[r]]
    assert (flat == want).all()
    if kind != "e3":
        # the port's plain route on the same rows: probe, then assemble
        # with the probe's decode reused
        rows_cpu = FR._FusedRows(FR.ROUTES[fmt], bt, lt, SUFFIX, extras,
                                 YEAR)
        p_base, p_len = rows_cpu.probe(n)
        assert (p_base.numpy() == tier).all()
        assert (p_len.numpy() == base_len).all()
        gated = np.where(keep, out_len, 0)
        ro = torch.from_numpy(np.where(keep, np.cumsum(gated) - gated, -1))
        got = rows_cpu.assemble(torch.from_numpy(ts_text),
                                torch.from_numpy(ts_len), ro,
                                int(gated.sum()), n).numpy()
        packed = np.concatenate([flat[row_off[r]:row_off[r] + out_len[r]]
                                 for r in np.flatnonzero(keep)])
        assert np.array_equal(got, packed)
    return tier, int(keep.sum())


@pytest.mark.parametrize("extras", [(), (("a-first", "x"), ("kind", "h"), ("level2", "y"),
                                         ("zzz", "last"))],
                         ids=["plain", "extras"])
@pytest.mark.parametrize("kind", ["e3", "f3"])
def test_rfc3164_encode_sources_match_plain(libs, kind, extras):
    """E3 and F3 at [64, 256]: every row's tier bit and base length, and
    every kept row's bytes; static extras land in each constant slot,
    the level-to-short one in both of its forms."""
    tier, kept = _route_check(kind, libs, 256, _lines_3164(256),
                              extras=extras)
    assert kept >= 16
    hand = {ln: tier[i] for i, ln in enumerate(HAND_3164)}
    assert hand[HAND_3164[0]] and hand[HAND_3164[3]]        # pri, no pri
    assert not hand[HAND_3164[6]] and not hand[HAND_3164[7]]  # tz guard
    assert hand[HAND_3164[23]] and not hand[HAND_3164[24]]  # escape, ctl


@pytest.mark.parametrize("kind", ["e3", "f3"])
def test_rfc3164_encode_sources_padding_rows_and_odd_width(libs, kind):
    """Rows past ``n`` with garbage bytes and lengths give zeros and no
    bytes; a width that is not a multiple of 16 takes the byte paths."""
    lines = _lines_3164(100)[:40]
    _route_check(kind, libs, 100, lines, n=33, garbage_rows=8)


@pytest.mark.parametrize("L,n,garbage", [(256, None, 0), (100, 40, 8)],
                         ids=["256", "odd_width_padding"])
def test_fused_rfc5424_source_matches_plain(libs, L, n, garbage):
    """F1 — K1's row decode and E1 in one kernel — against K1's plain
    decode (narrowed to DEMAND) and E1's plain encode, probe and
    assemble."""
    lines = _lines_5424(L)[:48]
    _route_check("f1", libs, L, lines, n=n, garbage_rows=garbage)


@pytest.mark.parametrize("what", ["route", "no_chan", "no_tier"])
@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164"])
def test_fused_assemble_needs_the_probe_decode(fmt, what):
    """No path decodes again: the route's assemble before its probe
    raises, and so does the kernel wrapper's without the probe's carried
    channels or tier bits (before it touches a device)."""
    lines = _lines_5424(64) if fmt == "rfc5424" else _lines_3164(64)
    batch, lens = _pack(lines[:8], 64)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    N = bt.shape[0]
    ts_text = torch.zeros((N, DC.TS_W), dtype=torch.uint8)
    ts_len = torch.zeros(N, dtype=torch.int32)
    row_off = torch.full((N,), -1, dtype=torch.int64)
    if what == "route":
        rows = FR._FusedRows(FR.ROUTES[fmt], bt, lt, SUFFIX, (), YEAR)
        with pytest.raises(RuntimeError, match="probe"):
            rows.assemble(ts_text, ts_len, row_off, 0, N)
        return
    carried = {"chan": torch.zeros((N, K.FUSED_CARRY[fmt]),
                                   dtype=torch.int32),
               "tier": torch.zeros(N, dtype=torch.bool)}
    carried[what[3:]] = None
    with pytest.raises(ValueError, match="carried channels"):
        K.fused_gelf_cuda(fmt, bt, lt, N, torch.zeros(8, dtype=torch.uint8),
                          None, year=YEAR, OW=64, ts_text=ts_text,
                          ts_len=ts_len, row_off=row_off, total=0, **carried)


def test_fused_carry_widths_match_the_source(libs):
    """The carried row widths the source defines are the wrapper's and
    the DEMAND channels' (one entry a channel row of the split decode's
    layout)."""
    fn = libs["fused_gelf"].fg_fused_gelf_carry
    for route, fmt, code in (("rfc5424_gelf", "rfc5424", 5424),
                             ("rfc3164_gelf", "rfc3164", 3164)):
        assert fn(code) == K.FUSED_CARRY[fmt] == len(FR.carried_columns(route))
    assert fn(0) == -1


def test_rfc3164_tables_match_python():
    """The channel rows and bank constants the sources repeat are the
    ones rfc3164 and device_rfc3164 define."""
    text = (host_build.CSRC / "decode_rfc3164_row.cuh").read_text()
    enum = re.search(r"enum Ch3164 \{(.*?)\}", text, re.S).group(1)
    names = [w.strip()[2:].lower() for w in enum.split(",")][:-1]
    assert tuple(names) == tuple(k.replace("host_start", "host_s")
                                 .replace("host_end", "host_e")
                                 for k in R3.KEYS)
    text = (host_build.CSRC / "encode_gelf_row.cuh").read_text()
    enum = re.search(r"enum Const3164 \{(.*?)\}", text, re.S).group(1)
    names = [w.strip()[3:].lower() for w in enum.split(",")][:-1]
    assert tuple(names) == D3.KERNEL_CONSTS
    chans = re.search(r"enum Ch3164Enc \{(.*?)\}", text, re.S).group(1)
    for name, idx in re.findall(r"C3_(\w+) = (\d+)", chans):
        key = {"HOST_S": "host_start", "HOST_E": "host_end"}.get(
            name, name.lower())
        assert R3.KEYS[int(idx)] == key, name
