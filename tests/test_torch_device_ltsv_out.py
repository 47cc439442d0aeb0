"""The split device tier for LTSV output (OL) on the CPU, against the JAX
package: OL's plain version (``device_ltsv_out.encode_rows``, probe and
assemble as the fetch driver composes them) against the reference's
``device_ltsv_out._encode_kernel(..., elide=True)`` on every row's tier
bit and gaps and every tier row's length and bytes; the tier's
``fetch_encode`` against the reference's over a sequence of batches that
is taken, declines and cools down (bytes, errors and the hysteresis
state after every batch); and the gate of ``route_ok``.

Both sides read the same rfc5424 decode channels (the port's plain
decode, which ``test_torch_rfc5424.py`` holds equal to the reference's).
The reference's encode runs eagerly (``jax.disable_jit``); in the
``fetch_encode`` comparison its driver runs on the plain encode, which
the first test holds equal to the reference's, so that comparison is of
the two drivers.  Batches of [256, 256].  Exact on every bit and byte.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.encoders.ltsv import LTSVEncoder as RLTSVEncoder
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import device_ltsv_out as RDO

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_corpus, make_ltsv_out_tier_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder, LTSVEncoder
from flowgger_tpu_torch.mergers import LineMerger, SyslenMerger
from flowgger_tpu_torch.tpu import device_ltsv_out as DO
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as R5

jax.config.update("jax_platforms", "cpu")

L = 256
EXTRAS = (("_zone:a", "eu\tw1"), ("relay", "r1"))
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
    tier, _ = make_ltsv_out_tier_corpus(160, seed=111)
    mixed, _ = make_corpus(60, seed=112)
    odd = [f'{HEAD} [x k:y="v"] colon in a name',
           f"{HEAD} - tab\tin the message",
           f'{HEAD} [x k="a\\"b"] escaped value',
           f"<165>1 2015-08-05T15:53:45Z h a p m - facility 20",
           f"<7>1 2015-08-05T15:53:45Z h a p m - facility 0",
           f"{HEAD} - " + "w" * 218, f"{HEAD} - " + "v" * 190,
           f"{HEAD} - ", f"{HEAD} -", "<13>1 2015-08-05T15:53:45Z - - - - -",
           f'{HEAD} [a b="1" c="2"][d e="3"] m']
    return tier[:100] + mixed + [o.encode() for o in odd] + tier[100:]


def _dec(batch, lens):
    return R5.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens))


@pytest.mark.parametrize("suffix,extras", [(b"\n", ()), (b"\0", EXTRAS)],
                         ids=["line", "nul_extras"])
def test_plain_encode_matches_reference(suffix, extras):
    """OL's plain version against the reference's _encode_kernel with
    elide=True: the tier mask and gaps of every row and the length and
    bytes of every tier row; the bank, the render of the stamp and the
    ladder constants are the reference's."""
    lines = _edge_lines()
    batch, lens, _, _, _, n = pack.pack_lines_2d(lines, L)
    assert batch.shape[0] == 256
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = _dec(batch, lens)
    jdec = {k: jnp.asarray(v.numpy()) for k, v in dec.items()}
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    ts_text = jnp.zeros((256, 32), jnp.uint8)
    ts_len = jnp.zeros(256, jnp.int32)
    with jax.disable_jit():
        probe = RDO._encode_kernel(jb, jl, jdec, ts_text, ts_len,
                                   suffix=suffix, extras=extras,
                                   assemble=False, elide=True)
        acc, r_len, r_tier = RDO._encode_kernel(
            jb, jl, jdec, ts_text, ts_len, suffix=suffix, extras=extras,
            assemble=True, elide=True)
    probe = {k: np.asarray(v) for k, v in probe.items()}
    acc, r_len, r_tier = np.asarray(acc), np.asarray(r_len), np.asarray(r_tier)

    kw = {"suffix": suffix, "extras": extras}
    base, base_len, gaps = DO.encode_rows(bt, lt, dec, assemble=False, n=n,
                                          **kw)
    OW = DO.out_width(L, suffix, extras)
    p_tier = base.numpy() & (base_len.numpy() <= OW)
    assert (p_tier[:n] == probe["tier"][:n]).all() and not p_tier[n:].any()
    assert (r_tier[:n] == probe["tier"][:n]).all()
    assert n // 3 < p_tier.sum() < n - 20
    t = np.flatnonzero(p_tier)
    assert probe["gap0"].dtype == np.uint16
    assert (gaps.numpy()[0][t] == probe["gap0"][t]).all()
    assert (gaps.numpy()[1][t] == probe["gap1"][t]).all()
    assert (base_len.numpy()[t] == r_len[t]).all()
    rows, a_len, a_tier = DO.encode_rows(bt, lt, dec, **kw)
    rows = rows.numpy()
    assert (a_tier.numpy()[:n] == p_tier[:n]).all()
    assert rows.shape == acc.shape
    for i in t:
        assert rows[i, :r_len[i]].tobytes() == acc[i, :r_len[i]].tobytes(), i
    # a row the width test alone takes out (its message twice is longer
    # than the output width)
    assert (base.numpy() & ~p_tier).any()
    assert DO._bank(suffix, extras) == RDO._bank(suffix, extras)
    assert DO._render_display(1438790025.5) == \
        RDO._render_display(1438790025.5)
    assert (DO.FALLBACK_FRAC, DO.DECLINE_LIMIT, DO.COOLDOWN) == (
        RDO.FALLBACK_FRAC, RDO.DECLINE_LIMIT, RDO.COOLDOWN)


def _plain_kernel(batch, lens, dec, ts_text, ts_len, *, suffix, extras=(),
                  assemble=True, elide=False):
    """The reference's _encode_kernel contract from OL's plain version."""
    assert elide
    tdec = {k: torch.from_numpy(np.array(v)) for k, v in dec.items()}
    bt = torch.from_numpy(np.array(batch))
    lt = torch.from_numpy(np.array(lens))
    if not assemble:
        base, base_len, gaps = DO.encode_rows(bt, lt, tdec, suffix=suffix,
                                              extras=extras, assemble=False)
        OW = DO.out_width(bt.shape[1], suffix, extras)
        tier = base & (base_len <= OW)
        g = gaps.numpy().astype(np.uint16)
        return {"tier": jnp.asarray(tier.numpy()), "gap0": jnp.asarray(g[0]),
                "gap1": jnp.asarray(g[1])}
    rows, out_len, tier = DO.encode_rows(bt, lt, tdec, suffix=suffix,
                                         extras=extras)
    return (jnp.asarray(rows.numpy()), jnp.asarray(out_len.numpy()),
            jnp.asarray(tier.numpy()))


@pytest.mark.parametrize("extras", [(), EXTRAS], ids=["plain", "extras"])
def test_handler_matches_reference_batch_for_batch(monkeypatch, extras):
    """The split tier's fetch_encode against the reference's, batch for
    batch over taken, declined and cooled batches (syslen framing): the
    same BlockResult bytes, errors and oracle rows, the scalar path's
    bytes, and the same hysteresis state after every batch."""
    monkeypatch.setattr(RDO, "_encode_kernel", _plain_kernel)
    monkeypatch.setenv("FLOWGGER_COMPILE_TIMEOUT_MS", "0")
    tier, _ = make_ltsv_out_tier_corpus(240, seed=120)
    mixed, _ = make_corpus(240, seed=114)
    batches = [tier, tier] + [mixed] * 4 + [tier] * 2
    toml = "".join(f'[output.ltsv_extra]\n"{k}" = "{v}"\n'.replace(
        "\t", "\\t") for k, v in extras[:1]) + "".join(
        f'"{k}" = "{v}"\n' for k, v in extras[1:])
    enc = LTSVEncoder(Config.from_string(toml))
    renc = RLTSVEncoder(RConfig.from_string(toml))
    assert enc.extra == list(extras)
    state, rstate = {}, {}
    seen = []
    for lines in batches:
        packed = pack.pack_lines_2d(lines, L)
        bt, lt = torch.from_numpy(packed[0]), torch.from_numpy(packed[1])
        handle = R5.decode_rfc5424_submit(bt, lt)
        jb, jl = jnp.asarray(packed[0]), jnp.asarray(packed[1])
        jdec = {k: jnp.asarray(v.numpy())
                for k, v in _dec(packed[0], packed[1]).items()}
        rhandle = (jdec, packed[0], packed[1], 4, "sum", jb, jl)
        got, _ = DO.fetch_encode(handle, packed, enc, SyslenMerger(), state)
        want, _ = RDO.fetch_encode(rhandle, packed, renc, RSyslenMerger(),
                                   rstate)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.block.data == want.block.data
            assert np.array_equal(got.block.prefix_lens,
                                  want.block.prefix_lens)
            assert got.errors == want.errors
            assert got.fallback_rows == want.fallback_rows
            exp, _ = scalar_expectation(b"\n".join(lines),
                                        config=Config.from_string(toml),
                                        merger=SyslenMerger(),
                                        output="ltsv")
            assert got.block.data == exp
        for k in ("declines", "cooldown"):
            assert state.get(k, 0) == rstate.get(k, 0), k
        seen.append((got is not None, state.get("cooldown", 0)))
    assert state["taken"] == 2 and state["declined"] == 3
    assert state["cooled"] == 3
    assert seen[:6] == [(True, 0), (True, 0), (False, 0), (False, 0),
                        (False, 16), (False, 15)]


def test_route_ok_gate(monkeypatch):
    """LTSV output over line, NUL, syslen framing or none; not GELF
    output; FLOWGGER_DEVICE_ENCODE=0 keeps the tier (and the fused route)
    off."""
    enc = LTSVEncoder(Config.from_string(""))
    assert DO.route_ok(enc, LineMerger()) and DO.route_ok(enc, None)
    assert not DO.route_ok(GelfEncoder(Config.from_string("")), LineMerger())
    assert FR.route_for("rfc5424", enc, LineMerger()).name == "rfc5424_ltsv"
    assert FR.route_for("rfc3164", enc, LineMerger()) is None
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    assert not DO.route_ok(enc, LineMerger())
    assert FR.route_for("rfc5424", enc, LineMerger()) is None
