"""The fused rfc5424 → LTSV route (FO/ltsv) on the CPU, against the JAX
package: its plain version (``fused_routes._FusedRows`` on a CPU batch:
K1's plain decode narrowed to ``DEMAND["rfc5424_ltsv"]``, then OL's plain
encode) against the reference's ``_fused_rfc5424_ltsv`` — the probe's
tier bits, gaps and the ok / stamp channels, and the assemble's bytes —
and the carried channels ``carried_plain`` for ``rfc5424_ltsv``; and the
route end to end through a handler with ``tpu_fuse`` auto, on and off,
against the scalar path.

The reference's fused program runs eagerly (``jax.disable_jit``) at one
shape, [256, 256].  Exact on every bit and byte.
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
from flowgger_tpu_torch.corpus import (make_corpus, make_ltsv_out_tier_corpus,
                                       make_rfc3164_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.encoders import LTSVEncoder
from flowgger_tpu_torch.mergers import LineMerger
from flowgger_tpu_torch.tpu import device_ltsv_out as DO
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as R5
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

L = 256
SUFFIX = b"\n"
EXTRAS = (("_zone:a", "eu\tw1"),)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fused():
    """The reference's fused probe and assemble and the port's plain
    route on one batch (the assemble keeps the reference's tier rows)."""
    tier, _ = make_ltsv_out_tier_corpus(190, seed=121)
    mixed, _ = make_corpus(50, seed=122)
    lines = tier[:120] + mixed + tier[120:] + [
        b'<13>1 2015-08-05T15:53:45Z h a p m [x k:y="v"] colon',
        b"<165>1 2015-08-05T15:53:45Z h a p m - tab\tx"]
    batch, lens, _, _, _, n = pack.pack_lines_2d(lines, L)
    N = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    rows = FR._FusedRows(FR.ROUTES["rfc5424_ltsv"], bt, lt, SUFFIX, EXTRAS,
                         None)
    base, base_len = rows.probe(n)
    small, _ = rows.small_channels(n)
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    ts_text = jnp.zeros((N, 32), jnp.uint8)
    ts_len = jnp.zeros(N, jnp.int32)
    kw = dict(max_sd=4, suffix=SUFFIX, extras=EXTRAS,
              demand=RFR.DEMAND["rfc5424_ltsv"])
    with jax.disable_jit():
        ref = RFR._fused_rfc5424_ltsv(jb, jl, ts_text, ts_len,
                                      assemble=False, **kw)
        acc, r_len, r_tier = RFR._fused_rfc5424_ltsv(jb, jl, ts_text, ts_len,
                                                     assemble=True, **kw)
    return {"batch": batch, "lens": lens, "n": n, "rows": rows,
            "base": base.numpy(), "base_len": base_len.numpy(),
            "small": small, "ref": {k: np.asarray(v) for k, v in ref.items()},
            "acc": np.asarray(acc), "r_len": np.asarray(r_len),
            "r_tier": np.asarray(r_tier)}


def test_fused_probe_matches_reference(fused):
    """The plain probe's tier (the width test at OL's output width), its
    gaps and its ok / stamp channels against the reference probe's; the
    route's DEMAND is the reference's."""
    p, ref, n = fused, fused["ref"], fused["n"]
    OW = DO.out_width(L, SUFFIX, EXTRAS)
    tier = p["base"] & (p["base_len"] <= OW)
    assert (tier[:n] == ref["tier"][:n]).all() and not tier[n:].any()
    assert n // 2 < tier.sum() < n
    t = np.flatnonzero(tier)
    for k in ("gap0", "gap1", "ok", "days", "sod", "off", "nanos"):
        got = p["small"][k]
        want = ref[k][:n]
        sel = t if k.startswith("gap") else np.arange(n)
        assert (got[sel] == want[sel]).all(), k
    assert FR.DEMAND["rfc5424_ltsv"] == RFR.DEMAND["rfc5424_ltsv"]
    assert FR.ROUTES["rfc5424_ltsv"].name == RFR.ROUTES["rfc5424_ltsv"].name


def test_fused_assemble_matches_reference(fused):
    """The plain assemble (from the probe's kept decode) writes the
    reference's bytes for every tier row."""
    p, n = fused, fused["n"]
    keep = p["r_tier"] & (np.arange(p["r_tier"].size) < n)
    assert (p["base_len"][keep] == p["r_len"][keep]).all()
    gated = np.where(keep, p["base_len"], 0)
    row_off = np.where(keep, np.cumsum(gated) - gated, -1)
    N = p["batch"].shape[0]
    flat = p["rows"].assemble(torch.zeros((N, 32), dtype=torch.uint8),
                              torch.zeros(N, dtype=torch.int32),
                              torch.from_numpy(row_off), int(gated.sum()),
                              n).numpy()
    want = b"".join(p["acc"][i, :p["r_len"][i]].tobytes()
                    for i in np.flatnonzero(keep))
    assert flat.tobytes() == want and keep.sum() > n // 2


def test_carried_plain_rfc5424_ltsv(fused):
    """carried_plain for rfc5424_ltsv: K1's channels that OL's assemble
    reads, in K1's packed order, 38 a row."""
    bt = torch.from_numpy(fused["batch"])
    lt = torch.from_numpy(fused["lens"])
    dec = R5.decode_rfc5424(bt, lt)
    cp = FR.carried_plain(dec, "rfc5424_ltsv").numpy()
    cols = FR.carried_columns("rfc5424_ltsv")
    assert cp.shape == (256, 38) and len(cols) == 38
    for j, (k, s) in enumerate(cols):
        want = dec[k] if s is None else dec[k][:, s]
        assert (cp[:, j] == want.to(torch.int32).numpy()).all(), (k, s)
    assert {k for k, _ in cols} == FR._LTSV_OUT_CARRY


def _run(fuse, lines, fmt="rfc5424"):
    config = Config.from_string(f'[input]\ntpu_encode_economics = false\n'
                                f'tpu_fuse = "{fuse}"\n')
    tx = queue.Queue()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        h = BatchHandler(tx, LTSVEncoder(config), config, LineMerger(),
                         torch.device("cpu"), start_timer=False, fmt=fmt)
        datas = [b"\n".join(lines[i:i + 1024]) + b"\n"
                 for i in range(0, len(lines), 1024)]
        for d in datas:
            h._dispatch(pack.pack_region_2d(d, 512))
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(b"".join(datas), merger=LineMerger(),
                                   fmt=fmt, output="ltsv")
    return h, got, err.getvalue().splitlines(), exp, errs


@pytest.mark.parametrize("fuse", ["auto", "on", "off"])
def test_fused_route_end_to_end(fuse):
    """A handler's tier batches into LTSV: with tpu_fuse auto or on the
    fused route takes every batch, with off the split tier OL does; every
    byte and error is the scalar path's."""
    lines, _ = make_ltsv_out_tier_corpus(3 * 1024, seed=123)
    h, got, err, exp, errs = _run(fuse, lines)
    assert got == exp and err == errs
    fused = h.route_state.get("fused:rfc5424_ltsv", {})
    split = h.route_state.get("rfc5424", {})
    if fuse == "off":
        assert split.get("taken") == 3 and not fused
    else:
        assert fused.get("taken") == 3 and not split


def test_fuse_on_without_a_route_says_so():
    """tpu_fuse = "on" for an (input, output) pair with no fused route
    (rfc3164 into LTSV) prints the reference's notice and runs the split
    path, the scalar path's bytes."""
    lines, _ = make_rfc3164_corpus(600, seed=124)
    h, got, err, exp, errs = _run("on", lines, fmt="rfc3164")
    assert err[0] == (
        'flowgger-tpu: input.tpu_fuse = "on" but this config cannot fuse '
        "format 'rfc3164' (no registered fused program for the route, "
        "template mining on, or a sharded mesh owns the format); using the "
        "split decode/encode path")
    assert got == exp and sorted(err[1:]) == sorted(errs)
