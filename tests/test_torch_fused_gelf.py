"""The fused gelf→GELF route (FG) on the CPU against the JAX package: its
plain version (the flat decode narrowed to its DEMAND set, then EG's
plain encode, the probe's decode kept for the assemble) against the
reference's ``fused_routes._fused_gelf_gelf`` run eagerly under
``jax.disable_jit()`` — the probe's tier bits, stamp channels and ``ok``,
the carried selection, then the assembled bytes — and the route through
the batch handler's ladder: it takes every batch of the tier mix with
the split path's and the scalar path's bytes, and declines and cools on
the sourced mix, whose batches the split path and the host tier take.
Every comparison is exact."""

import io
import queue
import time
from contextlib import redirect_stderr

import jax
import numpy as np
import pytest
import torch

from flowgger_tpu.tpu import device_common as JDC
from flowgger_tpu.tpu import fused_routes as JFR
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_gelf_corpus, make_gelf_tier_corpus,
                                       mask_wall_stamps, scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import NulMerger
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_gelf_gelf as EG
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import gelf as TG
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler

L = 256
N = 128
SUFFIX = b"\0"
ROUTE = "gelf_gelf"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    raw = make_gelf_tier_corpus(80, seed=21)[0]
    raw += make_gelf_corpus(N - len(raw), seed=22)[0]
    batch, lens, *_ = pack.pack_lines_2d(raw, L)
    return batch[:N], lens[:N]


BATCH, LENS = _batch()
BT, LT = torch.from_numpy(BATCH), torch.from_numpy(LENS)


def test_demand_and_routes_match_the_reference():
    """The fused route's DEMAND set is the reference's, and the route is
    registered under the gelf input; its carried row is EG's selection."""
    assert FR.DEMAND[ROUTE] == JFR.DEMAND[ROUTE]
    assert FR.ROUTES["gelf"].name == ROUTE
    assert len(FR.carried_columns(ROUTE)) == 49


def test_fused_gelf_matches_reference():
    """The plain probe against the reference's fused probe: the tier at
    the phase-1 width, the decode's ok and the stamp channels on the tier
    rows; the carried selection is the split encode's; then the plain
    assemble from the probe's kept decode against the reference's fused
    assemble, every tier row's bytes."""
    cfg = Config.from_string("")
    route = FR.ROUTES["gelf"]
    handle = FR.submit(route, (BATCH, LENS))
    kern, kw = route.make_kernel(handle, GelfEncoder(cfg), NulMerger())
    assert kw["ts_vals_fn"] is EG.ts_vals_gelf
    base, base_len = kern.probe(N)
    small, nbytes = kern.small_channels(N)
    assert nbytes == 12 * N
    with jax.disable_jit():
        jp = JFR._fused_gelf_gelf(BATCH, LENS, np.zeros((N, 0), np.uint8),
                                  np.full(N, JDC.TS_W, np.int32),
                                  suffix=SUFFIX, assemble=False,
                                  demand=JFR.DEMAND[ROUTE])
    tier1 = (base & (base_len + DC.TS_W <= kern.OW)).numpy()
    assert np.array_equal(np.asarray(jp["tier"]), tier1)
    assert 40 < tier1.sum() < N
    assert not (tier1 & ~np.asarray(jp["ok"])).any()
    for k in EG.TS_KEYS:
        assert np.array_equal(small[k][tier1], np.asarray(jp[k])[tier1]), k
    dec = TG.decode_gelf(BT, LT)
    carried = FR.carried_plain(dec, ROUTE, BT, LT)
    s = EG.analyze(BT, LT, dec)
    on = base.numpy()
    assert (carried[:, 0].numpy()[on] == s["pc"].numpy()[on]).all()

    txt, tl = DC._ts_text_block_np(small, EG.ts_vals_gelf)
    ts_text, ts_len = torch.from_numpy(txt), torch.from_numpy(tl)
    length = base_len.to(torch.int64) + ts_len
    tier = base & (length <= kern.OW)
    gated = torch.where(tier, length, 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    flat = kern.assemble(ts_text, ts_len, row_off, int(gated.sum()), N)
    with jax.disable_jit():
        jrows, jlen, jtier = JFR._fused_gelf_gelf(
            BATCH, LENS, txt, tl, suffix=SUFFIX, assemble=True,
            demand=JFR.DEMAND[ROUTE])
    jrows, jlen = np.asarray(jrows), np.asarray(jlen)
    assert np.array_equal(np.asarray(jtier), tier.numpy())
    want = b"".join(bytes(jrows[r, :jlen[r]])
                    for r in np.flatnonzero(tier.numpy()))
    assert bytes(flat.numpy()) == want


def _run(lines, fuse):
    cfg = Config.from_string(f'[input]\ntpu_encode_economics = false\n'
                             f'tpu_batch_size = 64\n'
                             f'tpu_fuse = "{fuse}"\n')
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, NulMerger(),
                           torch.device("cpu"), start_timer=False,
                           fmt="gelf")
    err = io.StringIO()
    with redirect_stderr(err):
        for i in range(0, len(lines), 64):
            handler._dispatch(pack.pack_lines_2d(lines[i:i + 64], L))
    out = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    return out, err.getvalue().splitlines(), handler.route_state


def test_fused_route_through_the_ladder():
    """tpu_fuse = auto: FG takes every batch of the tier mix with the
    split path's (tpu_fuse = off: EG takes them) and the scalar path's
    bytes; on the sourced mix FG declines three batches and cools, the
    split tier likewise, and the host tier writes the same bytes."""
    t0 = time.time() - 1.0
    tier = make_gelf_tier_corpus(256, seed=23)[0]
    auto, errs, state = _run(tier, "auto")
    off, errs_off, state_off = _run(tier, "off")
    exp, exp_errs = scalar_expectation(b"\n".join(tier) + b"\n", fmt="gelf")
    assert auto == off and mask_wall_stamps(auto, t0) == mask_wall_stamps(
        exp, t0)
    assert errs == errs_off == exp_errs
    assert state[f"fused:{ROUTE}"]["taken"] == 4 and "gelf" not in state
    assert state_off["gelf"]["taken"] == 4

    sourced = make_gelf_corpus(448, seed=24)[0]
    auto, errs, state = _run(sourced, "auto")
    exp, exp_errs = scalar_expectation(b"\n".join(sourced) + b"\n",
                                       fmt="gelf")
    assert mask_wall_stamps(auto, t0) == mask_wall_stamps(exp, t0)
    assert errs == exp_errs
    fused = state[f"fused:{ROUTE}"]
    assert fused["declined"] == 3 and fused["cooled"] == 4
    assert state["gelf"]["declined"] == 3 and state["gelf"]["cooled"] == 4
