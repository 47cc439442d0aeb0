"""The split device tier of the LTSV input on the CPU, against the JAX
package: EL's plain version (``device_ltsv.encode_rows``, probe and
assemble composed as the fetch driver composes them) against the reference's
``device_ltsv._encode_kernel(..., elide=True)`` at 6 and 16 pairs on
every row's tier bit and every tier row's length and bytes; the tier's
``fetch_encode`` against the reference's over a sequence of batches that
takes, escalates to 16 pairs, declines and cools down (bytes, errors and
the hysteresis state after every batch); and the schema gate of
``route_ok``.

The reference's encode runs eagerly (``jax.disable_jit``: compiling it
at 16 pairs costs more than running it once); in the ``fetch_encode``
comparison its driver runs on the plain encode, which the first test
holds equal to the reference's, so that comparison is of the two
drivers.  Batches of [256, 256] ([256, 512] for the fetch driver, whose wide
rows need its output width).  Exact on every bit and byte.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders.ltsv import LTSVDecoder as RDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.tpu import device_ltsv as RDL
from flowgger_tpu.tpu import ltsv as RL

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_ltsv_corpus, make_ltsv_line,
                                       make_ltsv_tier_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.decoders.ltsv import LTSVDecoder
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_ltsv as DL
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import ltsv as L1
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

L = 256
EXTRAS = (("a-first", "x"), ("kind", "h"), ("level2", "y"), ("zzz", "last"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wide_lines(n, seed):
    """Rows of 8-14 pairs that the 16-pair tier takes (RFC3339 stamps,
    no odd rows)."""
    rng = np.random.default_rng(seed)
    return [make_ltsv_line(rng, "rfc3339", i) for i in range(n)]


def _edge_lines():
    tier, _ = make_ltsv_tier_corpus(150, seed=91)
    mixed, _ = make_ltsv_corpus(60, seed=92)
    return (tier[:100] + mixed + _wide_lines(30, 93) + tier[100:]
            + [b'time:1\thost:h\tq:say "hi" \\ there\tmessage:tab\\tesc',
               b"time:1\thost:h\tbell:x\x07y",
               b"time:1\thost:h\tlongname_a:1\tlongname_b:2",
               b"time:1\thost:h\tabc:1\tabcdefgh:2\tabcdefghi:3",
               b"time:1\thost:\tmessage:", b"time:9007199254740992\thost:x",
               b"time:9007199254740993\thost:x"])


@pytest.mark.parametrize("P,suffix,extras", [(6, b"\0", ()),
                                             (16, b"\n", EXTRAS)],
                         ids=["p6", "p16_extras"])
def test_plain_encode_matches_reference(P, suffix, extras):
    """EL's plain version against the reference's _encode_kernel with
    elide=True: the tier mask of every row and the length and bytes of
    every tier row; the constant bank, elided constants and hysteresis
    constants are the reference's."""
    lines = _edge_lines()
    batch, lens, _, _, _, n = pack.pack_lines_2d(lines, L)
    assert batch.shape[0] == 256
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = L1.decode_ltsv(bt, lt)
    small = {k: dec[k][:n].numpy() for k in ("ok",) + DL.TS_KEYS}
    txt, tl = DC._ts_text_block_np(small, DL.ts_vals_ltsv)
    ts_text = np.zeros((256, DC.TS_W), np.uint8)
    ts_len = np.zeros(256, np.int32)
    ts_text[:n], ts_len[:n] = txt, tl

    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    rdec = RL.decode_ltsv_jit(jb, jl)
    with jax.disable_jit():
        acc, r_len, r_tier = RDL._encode_kernel(
            jb, jl, dict(rdec), jnp.asarray(ts_text), jnp.asarray(ts_len),
            suffix=suffix, impl="lax", assemble=True, extras=extras,
            max_pairs=P, elide=True)
    acc, r_len, r_tier = (np.asarray(acc), np.asarray(r_len),
                          np.asarray(r_tier))

    kw = {"suffix": suffix, "extras": extras, "max_pairs": P}
    base, base_len = DL.encode_rows(bt, lt, dec, assemble=False, n=n, **kw)
    OW = DL.out_width(L, suffix, extras)
    p_len = base_len.numpy() + ts_len
    p_tier = base.numpy() & (p_len <= OW)
    rows, a_len, a_tier = DL.encode_rows(
        bt, lt, dec, torch.from_numpy(ts_text), torch.from_numpy(ts_len),
        **kw)
    rows = rows.numpy()
    assert (a_tier.numpy()[:n] == p_tier[:n]).all()
    assert (p_tier[:n] == r_tier[:n]).all() and not p_tier[n:].any()
    assert p_tier[:n].sum() > n // 3 and (~p_tier[:n]).sum() > 20
    t = np.flatnonzero(p_tier)
    assert (p_len[t] == r_len[t]).all()
    assert (a_len.numpy()[t] == r_len[t]).all()
    assert rows.shape == acc.shape
    for i in t:
        assert rows[i, :p_len[i]].tobytes() == acc[i, :r_len[i]].tobytes(), i
    assert DL._bank(suffix, extras) == RDL._bank(suffix, extras)
    assert DL.elide_spec(suffix, extras) == RDL.elide_spec(suffix, extras)
    assert (DL.FALLBACK_FRAC, DL.DECLINE_LIMIT, DL.COOLDOWN,
            DL.MAX_DEV_PAIRS, DL.WIDE_DEV_PAIRS, DL.TS_KEYS) == (
        RDL.FALLBACK_FRAC, RDL.DECLINE_LIMIT, RDL.COOLDOWN,
        RDL.MAX_DEV_PAIRS, RDL.WIDE_DEV_PAIRS, RDL.TS_KEYS)
    # the 16-pair tier takes wide rows the 6-pair one cannot (at this
    # width the longest leave by their output width)
    wide = [lines.index(ln) for ln in _wide_lines(30, 93)]
    assert p_tier[wide].any() == (P == 16)


def _plain_kernel(batch, lens, dec, ts_text, ts_len, *, suffix, impl,
                  assemble=True, extras=(), max_pairs=6, elide=False):
    """The reference's _encode_kernel contract from EL's plain version."""
    assert elide
    tdec = {k: torch.from_numpy(np.array(v)) for k, v in dec.items()}
    rows, out_len, tier = DL.encode_rows(
        torch.from_numpy(np.array(batch)), torch.from_numpy(np.array(lens)),
        tdec, torch.from_numpy(np.array(ts_text)),
        torch.from_numpy(np.array(ts_len)), suffix=suffix, extras=extras,
        max_pairs=max_pairs)
    if not assemble:
        return jnp.asarray(tier.numpy())
    return (jnp.asarray(rows.numpy()), jnp.asarray(out_len.numpy()),
            jnp.asarray(tier.numpy()))


def test_fetch_encode_matches_reference(monkeypatch):
    """The split tier's fetch_encode against the reference's, batch for
    batch over taken, 16-pair, declined and cooled batches: the same
    BlockResult bytes, errors and oracle rows, and the same hysteresis
    state (declines, cooldown, wide_cooldown) after every batch."""
    monkeypatch.setattr(RDL, "_encode_kernel", _plain_kernel)
    # the reference's compile watchdog off: its device encode compiles
    # inline, so a compile another test left in flight on this worker
    # (the watchdog's single-flight slot) cannot turn its taken batches
    # into declines
    monkeypatch.setenv("FLOWGGER_COMPILE_TIMEOUT_MS", "0")
    tier, _ = make_ltsv_tier_corpus(240, seed=94)
    mixed, _ = make_ltsv_corpus(240, seed=95)
    batches = ([tier, _wide_lines(240, 96)] + [mixed] * 4 + [tier] * 2)
    enc, renc = GelfEncoder(Config.from_string("")), \
        RGelfEncoder(RConfig.from_string(""))
    dec, rdec = LTSVDecoder(Config.from_string("")), \
        RDecoder(RConfig.from_string(""))
    state, rstate = {}, {}
    seen = []
    for lines in batches:
        # at 512 bytes a row the output width (1024) holds the wide rows
        packed = pack.pack_lines_2d(lines, 512)
        bt, lt = torch.from_numpy(packed[0]), torch.from_numpy(packed[1])
        handle = L1.decode_ltsv_submit(bt, lt, packed[5])
        jb, jl = jnp.asarray(packed[0]), jnp.asarray(packed[1])
        rhandle = (RL.decode_ltsv_jit(jb, jl), jb, jl)
        out, rout = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out):
            got, _ = DL.fetch_encode(handle, packed, enc, NulMerger(), state,
                                     dec)
        with contextlib.redirect_stdout(rout):
            want, _ = RDL.fetch_encode(rhandle, packed, renc, RNulMerger(),
                                       rstate, rdec)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.block.data == want.block.data
            assert got.errors == want.errors
            assert got.fallback_rows == want.fallback_rows
            exp, _ = scalar_expectation(b"\n".join(lines), fmt="ltsv")
            assert got.block.data == exp
        assert out.getvalue() == rout.getvalue()
        for k in ("declines", "cooldown", "wide_cooldown"):
            assert state.get(k, 0) == rstate.get(k, 0), k
        seen.append((got is not None, state.get("wide", 0),
                     state.get("cooldown", 0)))
    assert state["taken"] == 2 and state["wide"] == 1
    assert state["declined"] == 3 and state["cooled"] == 3
    assert seen[1] == (True, 1, 0) and seen[4] == (False, 1, 16)


def test_route_ok_schema_gate(monkeypatch):
    """A typed ltsv_schema keeps the split tier and the fused route off
    (the host block encoder takes those batches); an empty schema table
    does not; gelf_extra keys this layout cannot place, other encoders,
    and FLOWGGER_DEVICE_ENCODE=0 keep the tier off too."""
    enc = GelfEncoder(Config.from_string(""))
    typed = LTSVDecoder(Config.from_string(
        '[input.ltsv_schema]\nstatus = "u64"\n'))
    empty = LTSVDecoder(Config.from_string("[input.ltsv_schema]\n"))
    for decoder, want in ((None, True), (LTSVDecoder(), True),
                          (empty, True), (typed, False)):
        assert DL.route_ok(enc, LineMerger(), decoder) is want
        assert RDL.route_ok(RGelfEncoder(RConfig.from_string("")),
                            RNulMerger(), getattr(decoder, "schema", None)
                            and RDecoder(RConfig.from_string(
                                '[input.ltsv_schema]\nstatus = "u64"\n'))) \
            is want
        route = FR.route_for("ltsv", enc, LineMerger(), decoder)
        assert (route is not None) is want
    bad = GelfEncoder(Config.from_string('[output.gelf_extra]\nhost = "x"\n'))
    assert not DL.route_ok(bad, LineMerger())
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    assert not DL.route_ok(enc, LineMerger())
    assert FR.route_for("ltsv", enc, LineMerger()) is None


def test_typed_schema_handler_takes_the_host_tier():
    """A handler with a typed schema runs no device tier on a mix the
    tiers would take, and writes the scalar path's bytes."""
    import queue

    toml = ('[input]\ntpu_encode_economics = false\n'
            '[input.ltsv_schema]\nstatus = "u64"\nreqtime = "f64"\n')
    config = Config.from_string(toml)
    tx = queue.Queue()
    h = BatchHandler(tx, GelfEncoder(config), config, NulMerger(),
                     torch.device("cpu"), start_timer=False, fmt="ltsv")
    lines, _ = make_ltsv_tier_corpus(300, seed=97)
    data = b"\n".join(lines) + b"\n"
    with contextlib.redirect_stderr(io.StringIO()), \
            contextlib.redirect_stdout(io.StringIO()):
        h._dispatch(pack.pack_region_2d(data, L))
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, _ = scalar_expectation(data, config=config, fmt="ltsv")
    assert got == exp
    assert h.route_state == {}
