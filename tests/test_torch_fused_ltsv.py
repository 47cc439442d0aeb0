"""The fused ltsv → GELF route (FL) on the CPU, against the JAX package:
its plain version (``fused_routes._FusedRows`` on a CPU batch: L1's plain
decode narrowed to ``DEMAND["ltsv_gelf"]``, then EL's plain encode at 6
pairs) against the reference's ``_fused_ltsv_gelf`` — the probe's tier
bits and narrowed timestamp channels, the small fetch's channel dict
(the reference's ``_ltsv_small_fetch``), the assemble's bytes — and the
carried selection ``carried_plain`` for ``ltsv_gelf`` against the rows'
parts; and the route end to end through a handler, against the scalar
path.

The reference's fused program is jitted once a phase at one shape,
[256, 256].  Exact on every bit and byte.
"""

import contextlib
import io
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.tpu import fused_routes as RFR

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_ltsv_corpus, make_ltsv_tier_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import NulMerger
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_ltsv as DL
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import ltsv as L1
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

L = 256
SUFFIX = b"\0"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    tier, _ = make_ltsv_tier_corpus(180, seed=101)
    mixed, _ = make_ltsv_corpus(40, seed=102)
    lines = tier[:120] + mixed + tier[120:] + [
        b"time:-1.5\thost:h", b"time:1\thost:h\tbell:x\x07y",
        b"time:2015-08-05T15:53:45+09:30\thost:h\tmessage:m",
        b"time:1438790025.123456\thost:h\tlevel:2"]
    return pack.pack_lines_2d(lines, L)


@pytest.fixture(scope="module")
def probed():
    """The reference's fused probe and the port's plain one on the same
    batch, with the timestamp text the fetch driver makes from the port's."""
    batch, lens, _, _, _, n = _batch()
    N = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    rows = FR._FusedRows(FR.ROUTES["ltsv"], bt, lt, SUFFIX, (), None)
    base, base_len = rows.probe(n)
    small, _ = rows.small_channels(n)
    txt, tl = DC._ts_text_block_np({k: v.copy() for k, v in small.items()},
                                   DL.ts_vals_ltsv)
    ts_text = np.zeros((N, DC.TS_W), np.uint8)
    ts_len = np.zeros(N, np.int32)
    ts_text[:n], ts_len[:n] = txt, tl
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    kw = dict(suffix=SUFFIX, impl="lax", extras=(),
              demand=RFR.DEMAND["ltsv_gelf"])
    ref = RFR._fused_ltsv_gelf(jb, jl, jnp.asarray(ts_text),
                               jnp.asarray(ts_len), assemble=False, **kw)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return {"batch": batch, "lens": lens, "n": n, "rows": rows,
            "base": base.numpy(), "base_len": base_len.numpy(),
            "small": small, "ts_text": ts_text, "ts_len": ts_len,
            "ref": ref, "jax": (jb, jl, kw)}


def test_fused_probe_matches_reference(probed):
    """The plain FL probe's tier (at the rows' stamp widths) and the
    narrowed channels the reference's probe returns."""
    p, ref, n = probed, probed["ref"], probed["n"]
    OW = DL.out_width(L, SUFFIX)
    tier = p["base"] & (p["base_len"] + p["ts_len"] <= OW)
    assert (tier[:n] == ref["tier"][:n]).all() and not tier[n:].any()
    assert n // 2 < tier.sum() < n
    dec = L1.decode_ltsv(torch.from_numpy(p["batch"]),
                         torch.from_numpy(p["lens"]))
    assert (dec["ok"].numpy() == ref["ok"]).all()
    assert (dec["ts_kind"].numpy() == ref["ts_kind8"]).all()
    assert ((dec["ts_meta"].numpy() & 255) == ref["ts_frac8"]).all()
    assert (dec["off"].numpy() // 60 == ref["off_min16"]).all()
    for k in ("days", "sod", "nanos", "ts_hi", "ts_lo"):
        assert (dec[k].numpy() == ref[k]).all(), k


def test_small_fetch_matches_reference(probed):
    """The probe's small channels hand ts_vals_ltsv the channel dict the
    reference's _ltsv_small_fetch rebuilds (off = off_min * 60, frac =
    meta & 255, the kinds the batch lacks as zeros), on the real rows."""
    n = probed["n"]
    want = RFR._ltsv_small_fetch(probed["ref"], np.asarray)
    got = probed["small"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert (got[k] == v[:n]).all(), k
    okh = got["ok"]
    assert (DL.ts_vals_ltsv(got, okh) == DL.ts_vals_ltsv(
        {k: v[:n] for k, v in want.items()}, okh)).all()


def test_fused_assemble_matches_reference(probed):
    """The plain FL assemble (from the probe's kept decode) writes the
    reference's bytes for every tier row."""
    p, n = probed, probed["n"]
    jb, jl, kw = p["jax"]
    acc, r_len, r_tier = (np.asarray(v) for v in RFR._fused_ltsv_gelf(
        jb, jl, jnp.asarray(p["ts_text"]), jnp.asarray(p["ts_len"]),
        assemble=True, **kw))
    keep = r_tier & (np.arange(r_tier.size) < n)
    length = p["base_len"] + p["ts_len"]
    assert (length[keep] == r_len[keep]).all()
    gated = np.where(keep, length, 0)
    row_off = np.where(keep, np.cumsum(gated) - gated, -1)
    flat = p["rows"].assemble(torch.from_numpy(p["ts_text"]),
                              torch.from_numpy(p["ts_len"]),
                              torch.from_numpy(row_off), int(gated.sum()),
                              n).numpy()
    want = b"".join(acc[i, :r_len[i]].tobytes() for i in np.flatnonzero(keep))
    assert flat.tobytes() == want and keep.sum() > n // 2


def test_carried_plain_ltsv(probed):
    """carried_plain for ltsv_gelf: per tier row the pair count, the host
    and message spans, whether a message is present, the level and the
    six sorted pairs' spans, in escaped coordinates (a raw offset plus the
    JSON escapes before it); the pairs are the non-special parts in name
    order, zeros past the count."""
    p, n = probed, probed["n"]
    bt, lt = torch.from_numpy(p["batch"]), torch.from_numpy(p["lens"])
    dec = {k: v.numpy() for k, v in L1.decode_ltsv(bt, lt).items()}
    cp = FR.carried_plain({k: torch.from_numpy(v) for k, v in dec.items()},
                          "ltsv_gelf", bt, lt).numpy()
    cols = FR.carried_columns("ltsv_gelf")
    assert cp.shape == (256, 31) and len(cols) == 31
    at = {c: i for i, c in enumerate(cols)}
    tier_rows = np.flatnonzero(p["base"][:n])
    for r in tier_rows:
        raw = p["batch"][r, :p["lens"][r]].tobytes()

        def esc(a):
            return a + sum(c in b'"\\\x08\t\n\x0c\r' for c in raw[:max(a, 0)])

        row = cp[r]
        for key, chan in (("host_s", "host_start"), ("host_e", "host_end"),
                          ("msg_s", "msg_start"), ("msg_e", "msg_end")):
            assert row[at[(key, None)]] == esc(int(dec[chan][r])), key
        assert row[at[("has_msg", None)]] == int(dec["msg_pos"][r] >= 0)
        assert row[at[("level", None)]] == dec["level_val"][r]
        np_ = int(dec["n_parts"][r])
        specials = {int(dec[k][r]) for k in ("time_pos", "host_pos",
                                              "msg_pos", "level_pos")}
        pairs = sorted((raw[s:c], s, c, e) for s, c, e in zip(
            dec["part_start"][r][:np_].tolist(),
            dec["colon_pos"][r][:np_].tolist(),
            dec["part_end"][r][:np_].tolist()) if s not in specials)
        assert row[at[("pair_count", None)]] == len(pairs)
        for q in range(6):
            got = [row[at[(k, q)]] for k in ("ns", "ne", "vs", "ve")]
            want = ([esc(pairs[q][1]), esc(pairs[q][2]),
                     esc(pairs[q][2] + 1), esc(pairs[q][3])]
                    if q < len(pairs) else [0, 0, 0, 0])
            assert got == want, (r, q)
    assert tier_rows.size > n // 2


def test_fused_route_end_to_end():
    """A handler's batches through FL on the CPU: the tier mix is taken
    by the fused route, the sourced mix declines it (and the split tier)
    and cools down; every byte, error and notice is the scalar path's."""
    config = Config.from_string("[input]\ntpu_encode_economics = false\n")
    for make, taken in ((make_ltsv_tier_corpus, True),
                        (make_ltsv_corpus, False)):
        tx = queue.Queue()
        h = BatchHandler(tx, GelfEncoder(config), config, NulMerger(),
                         torch.device("cpu"), start_timer=False, fmt="ltsv")
        lines, _ = make(4 * 1024, seed=103)
        datas = [b"\n".join(lines[i:i + 1024]) + b"\n"
                 for i in range(0, len(lines), 1024)]
        said, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(said), \
                contextlib.redirect_stderr(err):
            for d in datas:
                h._dispatch(pack.pack_region_2d(d, 512))
        got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
        notices = []
        exp, errs = scalar_expectation(b"".join(datas), fmt="ltsv",
                                       notices=notices)
        assert got == exp and sorted(err.getvalue().splitlines()) == \
            sorted(errs)
        assert said.getvalue().splitlines() == notices
        fused = h.route_state["fused:ltsv_gelf"]
        if taken:
            assert fused.get("taken") == 4 and "ltsv" not in h.route_state
        else:
            # three declines start a cooldown of 16; the handler counts it
            # down at the fourth batch's dispatch
            assert (fused.get("declined"), fused.get("cooled"),
                    fused.get("cooldown")) == (3, 1, 15)
