"""The port's device GELF encode tier (tpu/device_gelf.py,
tpu/device_common.py) on the CPU, against the JAX package.

- The plain encode equals the reference's ``device_gelf._encode_kernel``
  (``elide=True``, under ``JAX_PLATFORMS=cpu``) on the tier mask of
  every row and on the length and bytes of every tier row, exactly, at 6
  and 16 pairs, for each merger's suffix, with and without static
  ``gelf_extra`` keys; each side decodes the batch itself.
- Batch for batch, the port's BatchHandler takes or declines the tier
  as the reference's ``block_fetch_encode`` (what ``python -m
  flowgger_tpu`` runs for each batch) does — its counters against the
  port's ``route_state`` counts, through the wide escalation, three
  declines and the cooldown after them — and emits the same block and
  stderr lines.
- The slice through the port's entry point: the tier corpus engages the
  tier with output identical to the scalar path, and
  ``FLOWGGER_DEVICE_ENCODE=0`` turns the tier off with the same bytes.

Every JAX call here shares one batch shape ([256, 256]) and one set of
static arguments per width, so the reference compiles each kernel once.
"""

import io
import queue
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.tpu import batch as RB
from flowgger_tpu.tpu import device_gelf as RG
from flowgger_tpu.tpu import pack as RP
from flowgger_tpu.tpu import rfc5424 as RT
from flowgger_tpu.utils.metrics import registry as ref_metrics

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_line,
                                       make_tier_corpus, scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import (LineMerger, NulMerger,
                                        SyslenMerger)
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_gelf as DG
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as T
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

L = 256
EXTRAS = (("x-origin", "port"), ("zzz", "last"))
SUFFIX = {"none": b"", "line": b"\n", "nul": b"\0", "syslen": b"\n"}

HAND = [
    b'<13>1 2023-09-20T12:35:45.123Z host app 123 MSGID '
    b'[ex@32473 k="v" a="b"] hello world',
    b'<165>1 2003-10-11T22:14:15.003Z mymachine.example.com evntslog - '
    b'ID47 [exampleSDID@32473 iut="3" eventSource="Application" '
    b'eventID="1011"] An application event log entry',
    b'<0>1 2023-01-01T00:00:00Z - - - - - -',
    b'<191>1 2023-06-30T23:59:59.999999Z h a p m [x@1 zz="1" aa="2" '
    b'mm="3"] msg with "quotes" and\ttabs',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - [x@1 k="a\\"b"] esc val',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - [x@1 samekey="1" '
    b'samekey="2"] dup names',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 commonpreA="1" commonpreB="2"] m',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 abcdefgh="1" abcdefghi="2"] m',
    b'<13>1 2023-09-20T12:35:45.123Z h a - - '
    b'[x@1 zeta="1" alpha="2" mike="3" bravo="4" yank="5" echo="6"] m',
    "<13>1 2023-09-20T12:35:45.123Z hést a - - - utf8".encode(),
    b'<13>1 2023-09-20T12:35:45Z h a - - - bell\x07here',
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'"\\' * 30,
    b'<13>1 2023-09-20T12:35:45.5+05:30 h a - - [a@1 x="1"][b@2 y="2"]'
    b'[c@3] m',
    b'<13>1 2023-09-20T12:35:45Z h a - - [w@1 '
    + b" ".join(b'n%02d="%d"' % (k, k) for k in range(11)) + b'] wide',
    # a name that is a prefix of another with a digit after it (the key
    # pads with zeros, not with the '=' that follows the name)
    b'<13>1 2023-09-20T12:35:45Z h a - - [x@1 ab0="1" ab="2" a="3"] m',
    # exactly E_CAP escapes, and one more
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'"' * 56,
    b'<13>1 2023-01-01T00:00:00Z h a - - - ' + b'\\' * 57,
]


@pytest.fixture(scope="module", autouse=True)
def _ref_compile_deadline():
    """The reference's compile watchdog would decline a batch whose
    first compile outlasts 15 s; these tests hold tier decisions, not
    compile times.  The port's tensors here are small: one intra-op
    thread keeps this file from spinning a thread pool beside the other
    test workers."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FLOWGGER_COMPILE_TIMEOUT_MS", "600000")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()


def _batch_lines():
    tier, _ = make_tier_corpus(115, seed=41)
    mixed, _ = make_corpus(115, seed=42)
    return HAND + tier + mixed


def _ts(dec, n):
    """The tier's timestamp text of the first n rows."""
    small = {k: dec[k][:n].numpy() for k in ("ok", "days", "sod", "off",
                                             "nanos")}
    txt, ln = DC.ts_text_block(small)
    return txt, ln


@pytest.mark.parametrize("merger,extras,max_pairs", [
    ("none", (), 6), ("line", (), 6), ("nul", (), 6), ("syslen", (), 6),
    ("line", EXTRAS, 6), ("syslen", EXTRAS, 6),
    ("line", (), 16), ("syslen", (), 16)])
def test_plain_encode_matches_jax_kernel(merger, extras, max_pairs):
    lines = _batch_lines()
    batch, lens, _, _, _, n = pack.pack_lines_2d(lines, L)
    assert batch.shape == (256, L)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = T.decode_rfc5424(bt, lt, 4, max_pairs)
    txt, tl = _ts(dec, n)
    ts_text = np.zeros((256, DC.TS_W), np.uint8)
    ts_len = np.zeros(256, np.int32)
    ts_text[:n], ts_len[:n] = txt, tl

    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    rdec = RT.decode_rfc5424_jit(jb, jl, max_sd=4, max_pairs=max_pairs)
    acc, r_len, r_tier = RG._encode_kernel(
        jb, jl, dict(rdec), jnp.asarray(ts_text), jnp.asarray(ts_len),
        suffix=SUFFIX[merger], max_sd=4, impl=RT.best_scan_impl(),
        assemble=True, extras=extras, elide=True)
    acc, r_len, r_tier = (np.asarray(acc), np.asarray(r_len),
                          np.asarray(r_tier))

    # the probe's outputs composed as fetch_encode_driver composes them:
    # a row's length is base_len + its text's, the width test the host's
    kw = {"suffix": SUFFIX[merger], "max_sd": 4, "extras": extras}
    base, base_len = DG.encode_rows(bt, lt, dec, assemble=False, n=n, **kw)
    OW = DG.out_width(L, SUFFIX[merger], extras)
    p_len = base_len.numpy() + ts_len
    p_tier = base.numpy() & (p_len <= OW)
    rows, a_len, a_tier = DG.encode_rows(
        bt, lt, dec, torch.from_numpy(ts_text), torch.from_numpy(ts_len),
        **kw)
    rows = rows.numpy()
    assert (a_tier.numpy() == p_tier).all()
    assert (p_tier == r_tier).all()
    assert p_tier[:n].sum() > n // 2 and (~p_tier[:n]).sum() > 10
    t = np.flatnonzero(p_tier)
    assert (p_len[t] == r_len[t]).all()
    assert (a_len.numpy()[t] == r_len[t]).all()
    assert rows.shape == acc.shape
    for i in t:
        assert rows[i, :p_len[i]].tobytes() == acc[i, :r_len[i]].tobytes(), i


@pytest.mark.parametrize("corpus", ["rfc5424", "tier"])
def test_one_probe_matches_the_two_probe_rule(corpus):
    """fetch_encode_driver's one probe against the reference's two (its
    ``_encode_kernel`` at the pessimistic TS_W width, then with the real
    timestamp text, intersected): the phase-1 candidates are the same
    rows, intersecting with phase 2 changes none of them, and each
    one's length is ``base_len + ts_len``."""
    make = make_tier_corpus if corpus == "tier" else make_corpus
    lines, _ = make(250, seed=45)
    batch, lens, _, _, orig, n = pack.pack_lines_2d(lines, L)
    assert batch.shape == (256, L)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = T.decode_rfc5424(bt, lt, 4, 6)
    base, base_len = DG.encode_rows(bt, lt, dec, suffix=b"\n", max_sd=4,
                                    assemble=False, n=n)
    base, base_len = base.numpy()[:n], base_len.numpy()[:n]
    OW = DG.out_width(L, b"\n")
    short = orig[:n] <= L
    cand1 = base & (base_len + DC.TS_W <= OW) & short

    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    rdec = dict(RT.decode_rfc5424_jit(jb, jl, max_sd=4, max_pairs=6))

    def ref_probe(ts_text, ts_len):
        _, r_len, r_tier = RG._encode_kernel(
            jb, jl, rdec, jnp.asarray(ts_text), jnp.asarray(ts_len),
            suffix=b"\n", max_sd=4, impl=RT.best_scan_impl(),
            assemble=True, extras=(), elide=True)
        return np.asarray(r_len)[:n], np.asarray(r_tier)[:n]

    ts_text = np.zeros((256, DC.TS_W), np.uint8)
    _, r_tier1 = ref_probe(ts_text, np.full(256, DC.TS_W, np.int32))
    assert ((r_tier1 & short) == cand1).all()
    small = {k: dec[k][:n].numpy() for k in ("ok", "days", "sod", "off",
                                             "nanos")}
    small["ok"] = small["ok"].astype(bool) & cand1
    txt, tl = DC.ts_text_block(small)
    ts_len = np.zeros(256, np.int32)
    ts_text[:n], ts_len[:n] = txt, tl
    r_len2, r_tier2 = ref_probe(ts_text, ts_len)
    assert ((r_tier2 & cand1) == cand1).all()
    c = np.flatnonzero(cand1)
    assert (r_len2[c] == base_len[c] + tl[c]).all()
    assert 0.5 * n < c.size < n


def _wide_line(k):
    """A short row of 7-12 pairs: the 16-pair tier takes it."""
    return (b'<13>1 2023-09-20T12:35:45Z h a - - [w@1 '
            + b" ".join(b'n%02d="%d"' % (j, j) for j in range(7 + k % 6))
            + b'] wide')


def _batches():
    """Batches that walk the tier's decisions: taken, the wide
    escalation, a failed wide probe, three declines, the cooldown
    window, taken again."""
    rng = np.random.default_rng(43)
    # short enough that the output fits OW = 512 at this row width
    clean = [ln for ln in (make_line(rng, "tier") for _ in range(1200))
             if len(ln) <= 150]
    bad = [make_line(rng, "malformed") for _ in range(60)]
    out, c = [], iter(clean)

    def take(k):
        return [next(c) for _ in range(k)]

    out.append(HAND[:4] + take(16))                        # taken
    out.append(take(14) + [_wide_line(k) for k in range(6)])  # wide
    for i in range(3):                                     # declines
        out.append(take(12) + bad[8 * i:8 * i + 8])
    for _ in range(16):                                    # cooled
        out.append(take(16))
    out.append(take(20))                                   # taken
    out.append(take(10) + bad[30:40])                      # declined
    out.append(take(24) + bad[40:41])                      # taken
    return out


def test_handler_matches_reference_batch_for_batch(capsys, monkeypatch):
    # the reference's compile watchdog off: its device encode compiles
    # inline, so a compile another test left in flight on this worker
    # (the watchdog's single-flight slot) or a slow compile on a loaded
    # box cannot turn its taken batches into declines
    monkeypatch.setenv("FLOWGGER_COMPILE_TIMEOUT_MS", "0")
    ref_enc = RGelfEncoder(RConfig.from_string(""))
    ref_state = {}
    # the split tier, as block_fetch_encode runs it: the fused route off
    cfg = Config.from_string(f"[input]\ntpu_encode_economics = false\n"
                             f"tpu_max_line_len = {L}\n"
                             "tpu_batch_size = 100000\n"
                             'tpu_fuse = "off"\n')
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, LineMerger(),
                           torch.device("cpu"), start_timer=False)
    keys = ("taken", "declined", "cooled", "wide", "tier_rows")
    paths = []
    for lines in _batches():
        m0 = {k: ref_metrics.get(k) for k in (
            "device_encode_rows", "device_encode_declined",
            "device_encode_wide_batches")}
        packed = RP.pack_lines_2d(lines, L)
        handle = RT.decode_rfc5424_submit(packed[0], packed[1])
        stats = {}
        res, _, _ = RB.block_fetch_encode(
            "rfc5424", handle, packed, ref_enc, RLineMerger(),
            route_state=ref_state, stats=stats)
        m1 = {k: ref_metrics.get(k) - v for k, v in m0.items()}
        ref_errs = [f"{e}: [{ln.strip()}]" for e, ln in res.errors]

        s0 = dict(handler.route_state.get("rfc5424", {}))
        capsys.readouterr()
        for ln in lines:
            handler.handle_bytes(ln)
        handler.flush()
        got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
        errs = capsys.readouterr().err.splitlines()
        s1 = handler.route_state["rfc5424"]
        d = {k: s1.get(k, 0) - s0.get(k, 0) for k in keys}

        assert got == res.block.data
        assert errs == ref_errs
        exp, exp_errs = scalar_expectation(b"\n".join(lines) + b"\n",
                                           merger=LineMerger())
        assert got == exp and errs == exp_errs
        assert d["taken"] == (stats["path"] == "device")
        assert d["tier_rows"] == m1["device_encode_rows"]
        assert d["declined"] == m1["device_encode_declined"]
        assert d["wide"] == m1["device_encode_wide_batches"]
        paths.append("taken" if d["taken"] else "declined"
                     if d["declined"] else "cooled" if d["cooled"]
                     else "?")
    assert paths == (["taken"] * 2 + ["declined"] * 3 + ["cooled"] * 16
                     + ["taken", "declined", "taken"])
    assert handler.route_state["rfc5424"]["wide"] == 1


def test_route_ok_and_the_opt_out(monkeypatch):
    cfg = Config.from_string("")
    enc = GelfEncoder(cfg)
    for merger in (None, LineMerger(), NulMerger(), SyslenMerger()):
        assert DG.route_ok(enc, merger)
    dyn = GelfEncoder(Config.from_string(
        '[output.gelf_extra]\n_dyn = "x"\n'))
    assert not DG.route_ok(dyn, LineMerger())
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    assert not DG.route_ok(enc, LineMerger())


def test_tier_corpus_stays_under_the_decline_threshold():
    """One 8 192-row batch of the tier mix at the chip run's row width:
    every row of kind "tier" is in the tier, and the rows outside it
    stay near their 3 % share, well under FALLBACK_FRAC."""
    lines, kinds = make_tier_corpus(8192, seed=20261016)
    batch, lens, _, _, orig, n = pack.pack_lines_2d(lines, 512)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = T.decode_rfc5424(bt, lt)
    base, base_len = DG.encode_rows(bt, lt, dec, suffix=b"\0", max_sd=4,
                                    assemble=False, n=n)
    tier = base & (base_len + DC.TS_W <= DG.out_width(512, b"\0"))
    cand = tier.numpy()[:n] & (orig[:n] <= 512)
    kinds = np.asarray(kinds)
    assert cand[kinds == "tier"].all()
    assert 0.02 < 1 - cand.mean() < 0.04 < DG.FALLBACK_FRAC


@pytest.mark.parametrize("opt_out", [False, True], ids=["tier", "opt_out"])
def test_entry_point_engages_the_tier(tmp_path, monkeypatch, capsys,
                                      opt_out):
    """stdin → rfc5424_tpu → GELF through ``pipeline.start`` on the CPU,
    syslen output framing and static extras, the fused route off: the
    split tier takes both batches of the tier mix, and the bytes equal
    the scalar path's (with the tier switched off too)."""
    if opt_out:
        monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    lines, _ = make_tier_corpus(700, seed=44)
    data = b"\n".join(lines) + b"\n"
    out = tmp_path / "out.gelf"
    cfg = tmp_path / "cfg.toml"
    cfg.write_text(
        '[input]\ntpu_encode_economics = false\n'
        'type = "stdin"\nformat = "rfc5424_tpu"\n'
        'tpu_batch_size = 128\ntpu_flush_ms = 600000\ntpu_fuse = "off"\n'
        '[output]\ntype = "file"\nformat = "gelf"\nframing = "syslen"\n'
        f'file_path = "{out}"\n[output.gelf_extra]\nx-origin = "port"\n')
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    pipe = pipeline.start(str(cfg), device="cpu")
    exp, errs = scalar_expectation(data, config=Config.from_path(str(cfg)),
                                   merger=SyslenMerger())
    assert out.read_bytes() == exp
    assert capsys.readouterr().err.splitlines() == errs
    state = pipe._handler.route_state.get("rfc5424", {})
    if opt_out:
        assert state == {}
    else:
        # stdin's 64 KiB reads flush ~400 lines at a time
        assert state["taken"] == 2 and not state.get("declined")
        assert state["tier_rows"] > 0.95 * len(lines)
        assert state["fetch_bytes"] < state["emit_bytes"]
