"""The split device tier for RFC5424 output (O5 and O5/3164) on the CPU,
against the JAX package: the plain versions (``device_rfc5424_out.
encode_rows`` / ``encode_rows_3164``, probe and assemble as the fetch
driver composes them) against the reference's ``_encode_kernel`` /
``_encode_kernel_3164`` (``elide=True``) on every row's tier bit and
probe channels (``fac8``, ``sev8``, ``pri1``, ``hostl16``) and every
tier row's length and bytes; each leg's ``fetch_encode`` against the
reference's over a sequence of batches that is taken, declines and
cools down (bytes, errors and the hysteresis state after every batch);
and the gate of ``route_ok``.

Both sides read the same decode channels (the port's plain decodes,
which ``test_torch_rfc5424.py`` and ``test_torch_rfc3164.py`` hold equal
to the reference's).  The reference's encodes run eagerly
(``jax.disable_jit``); in the ``fetch_encode`` comparisons its driver
runs on the plain encode, which the first tests hold equal to the
reference's, so those comparisons are of the two drivers.  Batches of
[256, 256].  Exact on every bit and byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.encoders.rfc5424 import RFC5424Encoder as RRFC5424Encoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import device_rfc5424_out as RDO

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, scalar_expectation)
from flowgger_tpu_torch.encoders import LTSVEncoder, RFC5424Encoder
from flowgger_tpu_torch.mergers import LineMerger, SyslenMerger
from flowgger_tpu_torch.tpu import device_rfc5424_out as DO
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc3164 as R3
from flowgger_tpu_torch.tpu import rfc5424 as R5

jax.config.update("jax_platforms", "cpu")

L = 256
YEAR = 2026
HEAD = "<13>1 2015-08-05T15:53:45Z h a p m"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edge_lines():
    tier, _ = make_tier_corpus(160, seed=211)
    mixed, _ = make_corpus(60, seed=212)
    odd = [f'{HEAD} [a b="1"][c][d e="2" f="3"][g h="4"][i j="5"] five',
           f'{HEAD} [a b="1" c="2" d="3" e="4" f="5" g="6" h="7"] seven',
           f'{HEAD} [x k="a\\"b"] escaped value',
           "<191>1 2015-08-05T15:53:45.002Z h a p m - pri 191",
           "<0>1 2015-08-05T15:53:45Z h a p m - pri 0",
           "<13>1 2015-08-05T15:53:45Z - - - - -",
           f'{HEAD} [a][b c="d"][e] empty blocks',
           f"{HEAD} - " + "w" * 218, f"{HEAD} - ", f"{HEAD} -"]
    return tier[:100] + mixed + [o.encode() for o in odd] + tier[100:]


def _edge_lines_3164():
    tier, _ = make_rfc3164_tier_corpus(160, seed=213)
    mixed, _ = make_rfc3164_corpus(60, seed=214)
    odd = [b"Oct 11 22:14:15 nopri su: message without a PRI",
           b"<0>Oct 11 22:14:15 h x", b"<191>Oct  1 02:03:04 h y",
           b"<34>Oct 11 22:14:15 h " + b"z" * 230, b"<34>Oct 11 22:14:15 h"]
    return tier[:100] + mixed + odd + tier[100:]


def _jax(dec):
    return {k: jnp.asarray(v.numpy()) for k, v in dec.items()}


def _check_plain(leg, lines, suffix):
    batch, lens, _, _, _, n = pack.pack_lines_2d(lines, L)
    assert batch.shape[0] == 256
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    if leg == "rfc5424":
        dec = R5.decode_rfc5424(bt, lt)
        rk, pk = RDO._encode_kernel, DO.encode_rows
        rkw = {"max_sd": 4}
    else:
        dec = R3.decode_rfc3164(bt, lt, YEAR)
        rk, pk = RDO._encode_kernel_3164, DO.encode_rows_3164
        rkw = {}
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    ts_text = jnp.zeros((256, 32), jnp.uint8)
    ts_len = jnp.zeros(256, jnp.int32)
    with jax.disable_jit():
        probe = rk(jb, jl, _jax(dec), ts_text, ts_len, suffix=suffix,
                   assemble=False, elide=True, **rkw)
        acc, r_len, r_tier = rk(jb, jl, _jax(dec), ts_text, ts_len,
                                suffix=suffix, assemble=True, elide=True,
                                **rkw)
    probe = {k: np.asarray(v) for k, v in probe.items()}
    acc, r_len, r_tier = np.asarray(acc), np.asarray(r_len), np.asarray(r_tier)

    res = pk(bt, lt, dec, suffix=suffix, assemble=False, n=n)
    base, base_len, small8 = (r.numpy() for r in res[:3])
    OW = DO.out_width(L, suffix)
    p_tier = base & (base_len <= OW)
    assert (p_tier[:n] == probe["tier"][:n]).all() and not p_tier[n:].any()
    assert (r_tier[:n] == probe["tier"][:n]).all()
    assert n // 3 < p_tier.sum() < n - 10
    names = ("fac8", "sev8", "pri1")[:small8.shape[0]]
    for i, k in enumerate(names):
        assert probe[k].dtype == np.uint8
        assert (small8[i][:n] == probe[k][:n]).all(), k
    if leg == "rfc3164":
        assert probe["hostl16"].dtype == np.uint16
        assert res[3].dtype == torch.uint16
        assert (res[3].numpy()[:n] == probe["hostl16"][:n]).all()
    t = np.flatnonzero(p_tier)
    assert (base_len[t] == r_len[t]).all()
    rows, a_len, a_tier = pk(bt, lt, dec, suffix=suffix)
    rows = rows.numpy()
    assert (a_tier.numpy()[:n] == p_tier[:n]).all()
    assert rows.shape == acc.shape
    for i in t:
        assert rows[i, :r_len[i]].tobytes() == acc[i, :r_len[i]].tobytes(), i


@pytest.mark.parametrize("suffix", [b"\n", b"\0", b""],
                         ids=["line", "nul", "noop"])
def test_plain_encode_matches_reference(suffix):
    """O5's plain version against the reference's _encode_kernel with
    elide=True; the bank, the stamp's render, the head rebuild and the
    ladder constants are the reference's."""
    _check_plain("rfc5424", _edge_lines(), suffix)
    assert DO._bank(suffix) == RDO._bank(suffix)
    for v in (1672740000.002, 1438790025.0, -1.5, 253402300799.999):
        assert DO._render_rfc3339(v) == RDO._render_rfc3339(v)
    pri = np.array([0, 13, 191, 99, 100])
    txt = np.zeros((5, 32), np.uint8)
    tl = np.full(5, 3)
    txt[:, :3] = np.frombuffer(b"abc", np.uint8)
    for has in (None, np.array([1, 0, 1, 0, 1], bool)):
        got, want = DO._head_rows(pri, has, txt, tl), RDO._head_rows(
            pri, has, txt, tl)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert (DO.FALLBACK_FRAC, DO.DECLINE_LIMIT, DO.COOLDOWN) == (
        RDO.FALLBACK_FRAC, RDO.DECLINE_LIMIT, RDO.COOLDOWN)


@pytest.mark.parametrize("suffix", [b"\n", b"\0"], ids=["line", "nul"])
def test_plain_encode_3164_matches_reference(suffix):
    """O5/3164's plain version against the reference's
    _encode_kernel_3164 with elide=True, pri1 and hostl16 included."""
    _check_plain("rfc3164", _edge_lines_3164(), suffix)


def _plain_kernel(batch, lens, dec, ts_text, ts_len, *, suffix, max_sd=4,
                  assemble=True, elide=False):
    """The reference's _encode_kernel contract from O5's plain version."""
    return _plain_any(DO.encode_rows, batch, lens, dec, suffix, assemble,
                      elide, ("fac8", "sev8"))


def _plain_kernel_3164(batch, lens, dec, ts_text, ts_len, *, suffix,
                       assemble=True, elide=False):
    """The reference's _encode_kernel_3164 contract from O5/3164's plain
    version."""
    return _plain_any(DO.encode_rows_3164, batch, lens, dec, suffix,
                      assemble, elide, ("fac8", "sev8", "pri1"))


def _plain_any(fn, batch, lens, dec, suffix, assemble, elide, names):
    assert elide
    tdec = {k: torch.from_numpy(np.array(v)) for k, v in dec.items()}
    bt = torch.from_numpy(np.array(batch))
    lt = torch.from_numpy(np.array(lens))
    if not assemble:
        res = fn(bt, lt, tdec, suffix=suffix, assemble=False)
        OW = DO.out_width(bt.shape[1], suffix)
        out = {"tier": jnp.asarray((res[0] & (res[1] <= OW)).numpy())}
        for i, k in enumerate(names):
            out[k] = jnp.asarray(res[2][i].numpy())
        if len(res) > 3:
            out["hostl16"] = jnp.asarray(res[3].numpy())
        return out
    rows, out_len, tier = fn(bt, lt, tdec, suffix=suffix)
    return (jnp.asarray(rows.numpy()), jnp.asarray(out_len.numpy()),
            jnp.asarray(tier.numpy()))


@pytest.mark.parametrize("leg", ["rfc5424", "rfc3164"])
def test_handler_matches_reference_batch_for_batch(monkeypatch, leg):
    """Each leg's fetch_encode against the reference's, batch for batch
    over taken, declined and cooled batches (syslen framing for rfc5424,
    line for rfc3164): the same BlockResult bytes, errors and oracle
    rows, the scalar path's bytes, and the same hysteresis state after
    every batch."""
    monkeypatch.setattr(RDO, "_encode_kernel", _plain_kernel)
    monkeypatch.setattr(RDO, "_encode_kernel_3164", _plain_kernel_3164)
    monkeypatch.setenv("FLOWGGER_COMPILE_TIMEOUT_MS", "0")
    if leg == "rfc5424":
        tier, _ = make_tier_corpus(240, seed=224)
        mixed, _ = make_corpus(240, seed=221)
        merger, rmerger = SyslenMerger(), RSyslenMerger()
    else:
        tier, _ = make_rfc3164_tier_corpus(240, seed=222)
        mixed, _ = make_rfc3164_corpus(240, seed=223)
        merger, rmerger = LineMerger(), RLineMerger()
    batches = [tier, tier] + [mixed] * 4 + [tier] * 2
    enc = RFC5424Encoder(Config.from_string(""))
    renc = RRFC5424Encoder(RConfig.from_string(""))
    state, rstate = {}, {}
    seen = []
    for lines in batches:
        packed = pack.pack_lines_2d(lines, L)
        bt, lt = torch.from_numpy(packed[0]), torch.from_numpy(packed[1])
        jb, jl = jnp.asarray(packed[0]), jnp.asarray(packed[1])
        if leg == "rfc5424":
            handle = R5.decode_rfc5424_submit(bt, lt)
            jdec = _jax(R5.decode_rfc5424(bt, lt))
            rhandle = (jdec, packed[0], packed[1], 4, "sum", jb, jl)
            got, _ = DO.fetch_encode(handle, packed, enc, merger, state)
            want, _ = RDO.fetch_encode(rhandle, packed, renc, rmerger,
                                       rstate)
        else:
            dec = R3.decode_rfc3164(bt, lt, YEAR)
            handle = (dec, bt, lt)
            rhandle = (_jax(dec), jb, jl)
            got, _ = DO.fetch_encode_3164(handle, packed, enc, merger, state)
            want, _ = RDO.fetch_encode_3164(rhandle, packed, renc, rmerger,
                                            rstate)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.block.data == want.block.data
            if want.block.prefix_lens is not None:
                assert np.array_equal(got.block.prefix_lens,
                                      want.block.prefix_lens)
            assert got.errors == want.errors
            assert got.fallback_rows == want.fallback_rows
            if leg == "rfc5424":
                exp, _ = scalar_expectation(b"\n".join(lines),
                                            merger=merger, output="rfc5424")
                assert got.block.data == exp
        for k in ("declines", "cooldown"):
            assert state.get(k, 0) == rstate.get(k, 0), k
        seen.append((got is not None, state.get("cooldown", 0)))
    assert state["taken"] == 2 and state["declined"] == 3
    assert state["cooled"] == 3
    assert seen[:6] == [(True, 0), (True, 0), (False, 0), (False, 0),
                        (False, 16), (False, 15)]


def test_route_ok_gate(monkeypatch):
    """RFC5424 output over line, NUL, syslen framing or none; not LTSV
    output; both inputs have their fused route; FLOWGGER_DEVICE_ENCODE=0
    keeps the tier (and the fused routes) off."""
    enc = RFC5424Encoder(Config.from_string(""))
    assert DO.route_ok(enc, LineMerger()) and DO.route_ok(enc, None)
    assert not DO.route_ok(LTSVEncoder(Config.from_string("")), LineMerger())
    assert FR.route_for("rfc5424", enc, LineMerger()).name == \
        "rfc5424_rfc5424"
    assert FR.route_for("rfc3164", enc, None).name == "rfc3164_rfc5424"
    assert FR.route_for("ltsv", enc, LineMerger()) is None
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    assert not DO.route_ok(enc, LineMerger())
    assert FR.route_for("rfc5424", enc, LineMerger()) is None
