"""The split device tier for capnp output (OC) on the CPU, against the JAX
package: the plain version (``device_capnp.encode_rows``, probe and
assemble as the fetch driver composes them) against the reference's
``_encode_kernel`` (``elide=True``) on every row's tier bit and probe
channels (``fac8``, ``sev8``) and every tier row's length and bytes, at 6
and 16 pairs, with and without a ``capnp_extra``, on rows at the edges of
its gates (``-`` fields, an empty message, no SD, an SD id with no pairs,
an escaped value in a second SD block); ``fetch_encode`` against the
reference's over a sequence of batches that is taken, declines and
cools down (bytes, errors and the hysteresis state after every batch);
the stamp's bytes and the head's splice; and the gate of ``route_ok``.

Both sides read the same decode channels (the port's plain decode, which
``test_torch_rfc5424.py`` holds equal to the reference's).  The
reference's encode runs eagerly (``jax.disable_jit``); in the
``fetch_encode`` comparison its driver runs on the plain encode, which
the first test holds equal to the reference's, so that comparison is of
the two drivers.  Batches of [256, 256].  Exact on every bit and byte."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.encoders.capnp import CapnpEncoder as RCapnpEncoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import device_capnp as RDC

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_tier_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.encoders import CapnpEncoder, RFC5424Encoder
from flowgger_tpu_torch.mergers import LineMerger, SyslenMerger
from flowgger_tpu_torch.tpu import device_capnp as DC
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as R5

jax.config.update("jax_platforms", "cpu")

L = 256
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


def _edge_lines():
    tier, _ = make_tier_corpus(160, seed=231)
    mixed, _ = make_corpus(60, seed=232)
    odd = [f'{HEAD} [a b="1"][c d="x\\"y"] escape in the second block',
           f'{HEAD} [x k="a\\"b"] escaped value',
           f'{HEAD} [a b="1" c="2" d="3" e="4" f="5" g="6" h="7"] seven',
           f'{HEAD} [only] an SD id, no pairs',
           f'{HEAD} [a][b c="d"][e] sd0 without pairs',
           f'{HEAD} [id@1 k="v"]',
           "<191>1 2015-08-05T15:53:45.002Z h a p m - pri 191",
           "<13>1 2015-08-05T15:53:45Z - - - - -",
           "<13>1 2015-08-05T15:53:45Z h - - - - ",
           f"{HEAD} - " + "w" * 230, f"{HEAD} - ", f"{HEAD} -",
           f'{HEAD} [a b="1"][c d="2"] two blocks, only the first written',
           f'{HEAD} [a@1 b=""] an empty value']
    return tier[:100] + mixed + [o.encode() for o in odd] + tier[100:]


def _jax(dec):
    return {k: jnp.asarray(v.numpy()) for k, v in dec.items()}


@pytest.mark.parametrize("P,extras,suffix",
                         [(6, (), b""), (6, EXTRAS, b"\n"),
                          (16, EXTRAS, b""), (16, (), b"\0")],
                         ids=["p6_noop", "p6_extra_line", "p16_extra_noop",
                              "p16_nul"])
def test_plain_encode_matches_reference(P, extras, suffix):
    """OC's plain version against the reference's _encode_kernel with
    elide=True; the bank (its blob the host tier's) and the ladder
    constants are the reference's."""
    lines = _edge_lines()[:256]
    batch, lens, _, _, _, n = pack.pack_lines_2d(lines, L)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = R5.decode_rfc5424(bt, lt, max_pairs=P)
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    ts_text = jnp.zeros((256, 32), jnp.uint8)
    ts_len = jnp.zeros(256, jnp.int32)
    with jax.disable_jit():
        probe = RDC._encode_kernel(jb, jl, _jax(dec), ts_text, ts_len,
                                   suffix=suffix, extras=extras,
                                   assemble=False, elide=True)
        acc, r_len, r_tier = RDC._encode_kernel(
            jb, jl, _jax(dec), ts_text, ts_len, suffix=suffix,
            extras=extras, assemble=True, elide=True)
    probe = {k: np.asarray(v) for k, v in probe.items()}
    acc, r_len, r_tier = np.asarray(acc), np.asarray(r_len), np.asarray(r_tier)

    base, base_len, small8 = (r.numpy() for r in DC.encode_rows(
        bt, lt, dec, suffix=suffix, extras=extras, assemble=False, n=n))
    OW = DC.out_width(L, suffix, extras, P)
    p_tier = base & (base_len <= OW)
    assert (p_tier[:n] == probe["tier"][:n]).all() and not p_tier[n:].any()
    assert (r_tier[:n] == probe["tier"][:n]).all()
    assert n // 2 < p_tier.sum() < n - 10
    for i, k in enumerate(("fac8", "sev8")):
        assert probe[k].dtype == np.uint8
        assert (small8[i][:n] == probe[k][:n]).all(), k
    t = np.flatnonzero(p_tier)
    assert (base_len[t] == r_len[t]).all()
    rows, a_len, a_tier = DC.encode_rows(bt, lt, dec, suffix=suffix,
                                         extras=extras)
    rows = rows.numpy()
    assert (a_tier.numpy()[:n] == p_tier[:n]).all()
    assert rows.shape == acc.shape
    for i in t:
        assert rows[i, :r_len[i]].tobytes() == acc[i, :r_len[i]].tobytes(), i
    # the edge rows: an escaped value in a second SD block leaves the tier
    # though that block is not written; seven pairs leave the 6-pair
    # decode (ok is false there); an SD without pairs and a row without a
    # message are decode errors; the others stay on the tier
    assert not p_tier[160] and not p_tier[161]
    assert p_tier[162] == (P == 16) and not p_tier[163:166].any()
    assert p_tier[166:174].all()
    assert DC._bank(suffix, extras) == RDC._bank(suffix, extras)
    assert (DC.FALLBACK_FRAC, DC.DECLINE_LIMIT, DC.COOLDOWN) == (
        RDC.FALLBACK_FRAC, RDC.DECLINE_LIMIT, RDC.COOLDOWN)


def test_stamp_bytes_and_head_splice_match_reference():
    """The stamp's bytes are struct.pack('<d'), the reference's; the head
    splice (nwords from the elided body, the root pointer, the stamp,
    fac8 / sev8, the suffix) is the reference's byte for byte."""
    for v in (1438790025.637824, 0.0, -1.5, 1e300, 2 ** 53 + 1.0):
        assert DC._render_le_f64(v) == RDC._render_le_f64(v) == \
            struct.pack("<d", v)
    rng = np.random.default_rng(7)
    lens = rng.integers(9, 40, size=6) * 8
    body = rng.integers(0, 256, size=int(lens.sum()), dtype=np.uint8)
    row_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    ridx = np.array([0, 2, 3, 5, 7, 8])
    small = {"fac8": rng.integers(0, 256, 9, dtype=np.uint8),
             "sev8": rng.integers(0, 256, 9, dtype=np.uint8)}
    ts = rng.integers(0, 256, (9, 32), dtype=np.uint8)
    tl = np.full(9, 8)
    for suffix in (b"", b"\n", b"\0"):
        got = DC.make_elide(suffix)(body, row_off, small, ts, tl, ridx)
        want = RDC.make_elide(suffix)(body, row_off, small, ts, tl, ridx)
        assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
        assert np.array_equal(got[1], want[1])


def _plain_kernel(batch, lens, dec, ts_text, ts_len, *, suffix, extras=(),
                  assemble=True, elide=False):
    """The reference's _encode_kernel contract from OC's plain version."""
    assert elide
    tdec = {k: torch.from_numpy(np.array(v)) for k, v in dec.items()}
    bt = torch.from_numpy(np.array(batch))
    lt = torch.from_numpy(np.array(lens))
    if not assemble:
        base, base_len, small8 = DC.encode_rows(bt, lt, tdec, suffix=suffix,
                                                extras=extras,
                                                assemble=False)
        OW = DC.out_width(bt.shape[1], suffix, extras,
                          tdec["name_start"].shape[1])
        return {"tier": jnp.asarray((base & (base_len <= OW)).numpy()),
                "fac8": jnp.asarray(small8[0].numpy()),
                "sev8": jnp.asarray(small8[1].numpy())}
    rows, out_len, tier = DC.encode_rows(bt, lt, tdec, suffix=suffix,
                                         extras=extras)
    return (jnp.asarray(rows.numpy()), jnp.asarray(out_len.numpy()),
            jnp.asarray(tier.numpy()))


@pytest.mark.parametrize("extra", ["", '[output.capnp_extra]\nenv = "prod"\n'
                                   'dc = "eu-west-1"\n'],
                         ids=["plain", "extra"])
def test_handler_matches_reference_batch_for_batch(monkeypatch, extra):
    """fetch_encode against the reference's, batch for batch over taken,
    declined and cooled batches (syslen framing without an extra, line
    framing with one): the same BlockResult bytes, errors and oracle
    rows, the scalar path's bytes, and the same hysteresis state after
    every batch."""
    monkeypatch.setattr(RDC, "_encode_kernel", _plain_kernel)
    monkeypatch.setenv("FLOWGGER_COMPILE_TIMEOUT_MS", "0")
    tier, _ = make_tier_corpus(240, seed=234)
    mixed, _ = make_corpus(240, seed=235)
    if extra:
        merger, rmerger = LineMerger(), RLineMerger()
    else:
        merger, rmerger = SyslenMerger(), RSyslenMerger()
    batches = [tier, tier] + [mixed] * 4 + [tier] * 2
    enc = CapnpEncoder(Config.from_string(extra))
    renc = RCapnpEncoder(RConfig.from_string(extra))
    state, rstate = {}, {}
    seen = []
    for lines in batches:
        packed = pack.pack_lines_2d(lines, L)
        bt, lt = torch.from_numpy(packed[0]), torch.from_numpy(packed[1])
        jb, jl = jnp.asarray(packed[0]), jnp.asarray(packed[1])
        handle = R5.decode_rfc5424_submit(bt, lt)
        rhandle = (_jax(R5.decode_rfc5424(bt, lt)), packed[0], packed[1], 4,
                   "sum", jb, jl)
        got, _ = DC.fetch_encode(handle, packed, enc, merger, state)
        want, _ = RDC.fetch_encode(rhandle, packed, renc, rmerger, rstate)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.block.data == want.block.data
            if want.block.prefix_lens is not None:
                assert np.array_equal(got.block.prefix_lens,
                                      want.block.prefix_lens)
            assert got.errors == want.errors
            assert got.fallback_rows == want.fallback_rows
            exp, _ = scalar_expectation(b"\n".join(lines), merger=merger,
                                        output="capnp",
                                        config=Config.from_string(extra))
            assert got.block.data == exp
        for k in ("declines", "cooldown"):
            assert state.get(k, 0) == rstate.get(k, 0), k
        seen.append((got is not None, state.get("cooldown", 0)))
    assert state["taken"] == 2 and state["declined"] == 3
    assert state["cooled"] == 3
    assert seen[:6] == [(True, 0), (True, 0), (False, 0), (False, 0),
                        (False, 16), (False, 15)]


def test_route_ok_gate(monkeypatch):
    """capnp output over line, NUL, syslen framing or none, with or
    without a capnp_extra; not RFC5424 output; only rfc5424 input has the
    fused route; FLOWGGER_DEVICE_ENCODE=0 keeps the tier (and the fused
    route) off."""
    enc = CapnpEncoder(Config.from_string(""))
    extra = CapnpEncoder(Config.from_string('[output.capnp_extra]\na = "b"\n'))
    assert DC.route_ok(enc, LineMerger()) and DC.route_ok(enc, None)
    assert DC.route_ok(extra, SyslenMerger())
    assert not DC.route_ok(RFC5424Encoder(), LineMerger())
    assert FR.route_for("rfc5424", enc, None).name == "rfc5424_capnp"
    assert FR.route_for("rfc3164", enc, None) is None
    assert FR.out_key(enc) == "capnp"
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    assert not DC.route_ok(enc, LineMerger())
    assert FR.route_for("rfc5424", enc, None) is None
