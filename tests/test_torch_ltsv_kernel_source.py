"""The kernels of the LTSV input — L1 (``csrc/decode_ltsv.cu``), EL (the
``fg_encode_gelf_ltsv_*`` entry points of ``csrc/encode_gelf.cu``, at 6
and 16 pairs) and FL (``fg_fused_ltsv_gelf_*`` in ``csrc/fused_gelf.cu``)
— compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against their plain PyTorch versions: every channel of
every row from L1 (padding rows with garbage bytes and lengths
included), and from EL and FL the probe's tier bit, base length and
narrowed stamp channels (FL also each tier row's carried selection;
zeros at and past ``n``) and every kept row's bytes from the assemble,
at offsets of every residue mod 16, on at most 64 rows a case.  Exact on
every channel and byte.  The tables the sources repeat (channel rows,
the bank constants' order) are held against the Python they copy.
"""

import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_ltsv_corpus, make_ltsv_tier_corpus
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_ltsv as DL
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import kernels as K
from flowgger_tpu_torch.tpu import ltsv as L1
from flowgger_tpu_torch.tpu import pack

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
SUFFIX = b"\n"
EXTRAS = (("a-first", "x"), ("kind", "h"), ("level2", "y"), ("zzz", "last"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# rows for every branch of L1 and of EL's tier rule: both stamp forms and
# the Apache one, brackets, signs, 16 and 17 digits, bad dates and
# offsets, the level forms, repeated and missing specials, colon-less and
# empty parts, more than 24 parts, 7-16 pairs, names the 8-byte key
# cannot order, escapes and control bytes, non-ASCII, empty rows
HAND = [
    b"time:2015-08-05T15:53:45.637824Z\thost:h\tmessage:m\tlevel:3\tk:v",
    b"time:[2015-08-05T15:53:45+02:00]\thost:h\tk:v\tk2:v2",
    b"time:1438790025.42\thost:web\tlevel:9",
    b"time:-1438790025.42\thost:web",
    b"time:+12345678901234567.5\thost:x",
    b"time:9007199254740992\thost:x\ta:1",
    b"time:9007199254740993\thost:x\ta:1",
    b"time:[10/Oct/2000:13:55:36 -0700]\thost:h",
    b"host:a\thost:b\ttime:1",
    b"nocolon\ttime:1\thost:h",
    b"time:1\thost:h\t" + b"\t".join(b"k%d:v" % i for i in range(30)),
    b"time:1\thost:h\t" + b"\t".join(b"k%02d:v%d" % (i, i) for i in range(9)),
    b"time:1\thost:h\t" + b"\t".join(b"z%02d:v" % (15 - i) for i in range(16)),
    b"time:1.2.3\thost:h", b"time:.5\thost:h", b"time:5.\thost:h",
    b"time:\thost:h", b"time:[]\thost:h",
    b"level:abc\ttime:1\thost:h", b"level:12345678901234\ttime:1\thost:h",
    b"level:007\ttime:1\thost:h", b"level:\ttime:1\thost:h",
    b"time:2016-02-29T23:59:59.123456789-11:45\thost:h",
    b"time:2015-13-05T15:53:45Z\thost:h",
    b"time:2015-08-05T15:53:45.Z\thost:h",
    b"time:2015-08-05t15:53:45z\thost:h",
    b"time:2015-08-05T15:53:45+24:00\thost:h",
    b"time:2015-08-05T15:53:45.1234567891Z\thost:h",
    b"a:b:c\tx::\t:y\ttime:1\thost:h\t", b"", b"\t\t\t",
    "host:café\ttime:1".encode(),
    b'time:1\thost:h\tq:say "hi" \\ there\tmessage:tab\\tesc',
    b"time:1\thost:h\tbell:x\x07y",
    b"time:1\thost:h\tlongname_a:1\tlongname_b:2",
    b"time:1\thost:h\tdup:1\tdup:2",
    b"time:1\thost:h\tabc:1\tabcdefgh:2\tabcdefghi:3",
    b"time:1\thost:\tmessage:",
    b"message:x\tmessage:y\ttime:1\thost:h",
]


def _lines(L):
    rng = np.random.default_rng(L)
    alpha = list(b"timehostmessagelevel:\t0123456789.-+TZ[]/ ")
    rand = [rng.choice(alpha, int(rng.integers(0, 60)))
            .astype(np.uint8).tobytes() for _ in range(6)]
    tier, _ = make_ltsv_tier_corpus(14, seed=71)
    mixed, _ = make_ltsv_corpus(8, seed=72)
    return (HAND + rand + [ln[:L] for ln in tier + mixed])[:64]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_host_ltsv")
    libs = {n: ctypes.CDLL(str(host_build.build(n, out)))
            for n in ("decode_ltsv", "encode_gelf", "fused_gelf")}
    sigs = {
        "decode_ltsv": {"fg_decode_ltsv": [_P, _P, _P, _I, _I, _I, _P]},
        "encode_gelf": {
            **{f"fg_encode_gelf_ltsv_probe_p{p}": [_P] * 4 + [_I] * 3
               + [_P] * 4 for p in (6, 16)},
            **{f"fg_encode_gelf_ltsv_assemble_p{p}": [_P] * 7 + [_I] * 4
               + [_P] * 3 for p in (6, 16)}},
        "fused_gelf": {
            "fg_fused_gelf_carry": [_I],
            "fg_fused_ltsv_gelf_probe": [_P] * 3 + [_I] * 3 + [_P] * 5,
            "fg_fused_ltsv_gelf_assemble": [_P] * 7 + [_I] * 4 + [_P] * 3},
    }
    for name, fns in sigs.items():
        for fn_name, args in fns.items():
            fn = getattr(libs[name], fn_name)
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


def _decode(libs, batch, lens, n):
    N, L = batch.shape
    out = np.full((L1.n_channels(), N), -7, np.int32)
    assert libs["decode_ltsv"].fg_decode_ltsv(
        batch.ctypes.data, lens.ctypes.data, out.ctypes.data, N, n, L,
        None) == 0
    return out


@pytest.mark.parametrize("L", [100, 256])
def test_decode_ltsv_source_matches_plain(libs, L):
    """Every channel of every row — rejected rows, rows of more than 24
    parts and padding rows with garbage bytes and lengths included —
    equals the plain version, at widths with and without the 16-byte
    staging."""
    lines = _lines(L)[:56]
    batch, lens = _pack(lines, L, garbage_rows=8, seed=L)
    n = len(lines)
    got = L1.unpack_channels(torch.from_numpy(_decode(libs, batch, lens, n)))
    ref = L1.decode_ltsv(torch.from_numpy(batch), torch.from_numpy(lens),
                         n=n)
    assert ref["ok"][:n].any() and not ref["ok"][:n].all()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    kinds = ref["ts_kind"][:n].tolist()
    assert {0, 1, 2} <= set(kinds)


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
    """The probe and the assemble of ``kind`` ("el6", "el16" or "fl") on
    ``lines`` at width ``L`` against the plain version; rows at and past
    ``n`` are padding, the last ``garbage_rows`` of them random."""
    batch, lens = _pack(lines, L, garbage_rows, seed=L)
    N = batch.shape[0]
    n = len(lines) if n is None else n
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    P = 16 if kind == "el16" else 6
    kw = {"suffix": SUFFIX, "extras": extras, "max_pairs": P}
    dec = L1.decode_ltsv(bt, lt, n=n)
    if kind == "fl":
        dec = {k: v for k, v in dec.items() if k in FR.DEMAND["ltsv_gelf"]}
    bank, table = DL.kernel_consts(SUFFIX, extras)
    bank_np = np.frombuffer(bank, dtype=np.uint8).copy()
    OW = DL.out_width(L, SUFFIX, extras)
    rng = np.random.default_rng(L + N)
    ts_len = rng.integers(3, DC.TS_W + 1, N).astype(np.int32)
    ts_text = rng.integers(48, 58, (N, DC.TS_W)).astype(np.uint8)
    ptrs = (batch.ctypes.data, lens.ctypes.data)

    tier = np.full(N, 7, np.uint8)
    base_len = np.full(N, -1, np.int32)
    small = np.full(DL.SMALL_BYTES * N, 0xA7, np.uint8)
    chan = np.full((N, K.FUSED_CARRY["ltsv"]), -5, np.int32)
    if kind == "fl":
        assert libs["fused_gelf"].fg_fused_ltsv_gelf_probe(
            *ptrs, table, N, n, L, tier.ctypes.data, base_len.ctypes.data,
            small.ctypes.data, chan.ctypes.data, None) == 0
    else:
        ch = _decode(libs, batch, lens, n)
        assert getattr(libs["encode_gelf"],
                       f"fg_encode_gelf_ltsv_probe_p{P}")(
            *ptrs, ch.ctypes.data, table, N, n, L, tier.ctypes.data,
            base_len.ctypes.data, small.ctypes.data, None) == 0
    # the narrowed stamp channels of every row (zeros at and past n)
    assert (small == DL.small_pack(dec, n).numpy()).all()
    ref_base, ref_len = DL.encode_rows(bt, lt, dec, assemble=False, n=n,
                                       **kw)
    assert (tier == ref_base.numpy()).all()
    assert (base_len == ref_len.numpy()).all()
    assert (tier[n:] == 0).all() and (base_len[n:] == 0).all()
    assert 3 < ref_base.sum() < n
    if kind == "fl":
        # the carried selection: the plain encode's on each tier row, and
        # nothing written on the other rows (padding rows included)
        on = tier.astype(bool)
        want = FR.carried_plain(dec, "ltsv_gelf", bt, lt).numpy()
        assert (chan[on] == want[on]).all()
        assert (chan[~on] == -5).all()

    # assemble every tier row but one, each at its own residue mod 16
    rows, out_len, full_tier = DL.encode_rows(
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
    if kind == "fl":
        # from the selection the probe carried: no decode runs again
        rc = libs["fused_gelf"].fg_fused_ltsv_gelf_assemble(
            *ptrs, chan.ctypes.data, *tail)
    else:
        rc = getattr(libs["encode_gelf"],
                     f"fg_encode_gelf_ltsv_assemble_p{P}")(
            *ptrs, ch.ctypes.data, *tail)
    assert rc == 0
    want = np.full(flat.size, 0xAB, np.uint8)
    rows, out_len = rows.numpy(), out_len.numpy()
    for r in np.flatnonzero(keep):
        want[row_off[r]:row_off[r] + out_len[r]] = rows[r, :out_len[r]]
    assert (flat == want).all()
    if kind == "fl":
        # the port's plain route on the same rows: probe, then assemble
        # with the probe's decode reused
        rows_cpu = FR._FusedRows(FR.ROUTES["ltsv"], bt, lt, SUFFIX, extras,
                                 None)
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


@pytest.mark.parametrize("extras", [(), EXTRAS], ids=["plain", "extras"])
@pytest.mark.parametrize("kind", ["el6", "el16", "fl"])
def test_ltsv_encode_sources_match_plain(libs, kind, extras):
    """EL at 6 and 16 pairs and FL at [64, 256]: every row's tier bit and
    base length, and every kept row's bytes; static extras land in each
    constant slot, the level-to-short one in both of its forms."""
    tier, kept = _route_check(kind, libs, 256, _lines(256), extras=extras)
    assert kept >= 12
    hand = {ln: tier[i] for i, ln in enumerate(HAND)}
    assert hand[HAND[0]] and hand[HAND[1]]          # rfc3339, bracketed
    assert not hand[HAND[3]] and not hand[HAND[7]]  # signed, apache
    assert hand[HAND[5]] and not hand[HAND[6]]      # 2**53 and past it
    assert not hand[HAND[8]] and not hand[HAND[9]]  # repeated, colon-less
    assert hand[HAND[11]] == (kind == "el16")       # 9 pairs
    assert not hand[HAND[34]] and not hand[HAND[35]]  # ambiguous, dup


@pytest.mark.parametrize("kind", ["el6", "fl"])
def test_ltsv_encode_sources_padding_rows_and_odd_width(libs, kind):
    """Rows past ``n`` with garbage bytes and lengths give zeros and no
    bytes; a width that is not a multiple of 16 takes the byte paths."""
    _route_check(kind, libs, 100, _lines(100)[:40], n=33, garbage_rows=8)


@pytest.mark.parametrize("what", ["route", "no_chan", "no_tier"])
def test_fused_ltsv_assemble_needs_the_probe(what):
    """FL's assemble before its probe raises, and so does the kernel
    wrapper's without the probe's carried selection or tier bits (before
    it touches a device)."""
    batch, lens = _pack(_lines(64)[:8], 64)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    N = bt.shape[0]
    ts_text = torch.zeros((N, DC.TS_W), dtype=torch.uint8)
    ts_len = torch.zeros(N, dtype=torch.int32)
    row_off = torch.full((N,), -1, dtype=torch.int64)
    if what == "route":
        rows = FR._FusedRows(FR.ROUTES["ltsv"], bt, lt, SUFFIX, (), None)
        with pytest.raises(RuntimeError, match="probe"):
            rows.assemble(ts_text, ts_len, row_off, 0, N)
        return
    carried = {"chan": torch.zeros((N, K.FUSED_CARRY["ltsv"]),
                                   dtype=torch.int32),
               "tier": torch.zeros(N, dtype=torch.bool)}
    carried[what[3:]] = None
    with pytest.raises(ValueError, match="carried channels"):
        K.fused_gelf_cuda("ltsv", bt, lt, N,
                          torch.zeros(8, dtype=torch.uint8), None, OW=64,
                          ts_text=ts_text, ts_len=ts_len, row_off=row_off,
                          total=0, **carried)


def test_ltsv_carry_width_and_tables_match_python(libs):
    """FL's carried row width is the wrapper's and carried_columns'; the
    channel rows and bank constants the sources repeat are the ones
    ltsv and device_ltsv define."""
    assert (libs["fused_gelf"].fg_fused_gelf_carry(76)
            == K.FUSED_CARRY["ltsv"]
            == len(FR.carried_columns("ltsv_gelf")))
    text = (host_build.CSRC / "decode_ltsv_row.cuh").read_text()
    enum = re.search(r"enum ChLtsv \{(.*?)kN1D,", text, re.S).group(1)
    names = [w.strip()[2:].lower() for w in enum.split(",") if w.strip()]
    short = {"host_start": "host_s", "host_end": "host_e",
             "msg_start": "msg_s", "msg_end": "msg_e"}
    assert names == [short.get(k, k) for k in L1.KEYS_1D]
    assert L1.n_channels() == 22 + 3 * 24
    text = (host_build.CSRC / "encode_ltsv_row.cuh").read_text()
    enum = re.search(r"enum ConstLtsv \{(.*?)\}", text, re.S).group(1)
    names = [w.strip()[3:].lower() for w in enum.split(",")][:-1]
    assert tuple(names) == DL.KERNEL_CONSTS
