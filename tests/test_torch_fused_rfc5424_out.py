"""The fused → RFC5424 routes (FO/r5: rfc5424 and rfc3164 input) on the
CPU, against the JAX package: their plain versions (``fused_routes.
_FusedRows`` on a CPU batch: the format's plain decode narrowed to its
``DEMAND``, then O5's or O5/3164's plain encode) against the reference's
``_fused_rfc5424_rfc5424`` and ``_fused_rfc3164_rfc5424`` — the probe's
tier bits, its small channels (``fac8``, ``sev8``, ``pri1``,
``hostl16``) and the ok / stamp channels, and the assemble's bytes — and
the carried channels ``carried_plain``; and both routes end to end
through a handler with ``tpu_fuse`` auto, on and off, against the scalar
path.

The reference's fused programs run eagerly (``jax.disable_jit``) at one
shape, [256, 256].  Exact on every bit and byte."""

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
from flowgger_tpu_torch.corpus import (make_corpus, make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, scalar_expectation)
from flowgger_tpu_torch.encoders import RFC5424Encoder
from flowgger_tpu_torch.mergers import LineMerger, SyslenMerger
from flowgger_tpu_torch.tpu import device_rfc5424_out as DO
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc3164 as R3
from flowgger_tpu_torch.tpu import rfc5424 as R5
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

L = 256
SUFFIX = b"\n"
YEAR = 2026


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(fmt):
    if fmt == "rfc5424":
        tier, _ = make_tier_corpus(190, seed=231)
        mixed, _ = make_corpus(50, seed=232)
        return tier[:120] + mixed + tier[120:] + [
            b'<13>1 2015-08-05T15:53:45Z h a p m [a b="1"][c][d e="2"] x',
            b'<191>1 2015-08-05T15:53:45Z h a p m [x k="a\\"b"] esc']
    tier, _ = make_rfc3164_tier_corpus(190, seed=233)
    mixed, _ = make_rfc3164_corpus(50, seed=234)
    return tier[:120] + mixed + tier[120:] + [
        b"Oct 11 22:14:15 nopri su: no PRI", b"<191>Oct  1 02:03:04 h y"]


@pytest.fixture(scope="module", params=["rfc5424", "rfc3164"])
def fused(request):
    """The reference's fused probe and assemble and the port's plain
    route on one batch of the leg ``request.param`` (the assemble keeps
    the reference's tier rows)."""
    fmt = request.param
    name = f"{fmt}_rfc5424"
    batch, lens, _, _, _, n = pack.pack_lines_2d(_lines(fmt), L)
    N = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    rows = FR._FusedRows(FR.ROUTES[name], bt, lt, SUFFIX, (),
                         YEAR if fmt == "rfc3164" else None)
    base, base_len = rows.probe(n)
    small, _ = rows.small_channels(n)
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    ts_text = jnp.zeros((N, 32), jnp.uint8)
    ts_len = jnp.zeros(N, jnp.int32)
    kw = dict(suffix=SUFFIX, demand=RFR.DEMAND[name])
    with jax.disable_jit():
        if fmt == "rfc5424":
            def run(assemble):
                return RFR._fused_rfc5424_rfc5424(
                    jb, jl, ts_text, ts_len, max_sd=4, assemble=assemble,
                    **kw)
        else:
            def run(assemble):
                return RFR._fused_rfc3164_rfc5424(
                    jb, jl, jnp.int32(YEAR), ts_text, ts_len,
                    assemble=assemble, **kw)
        ref = run(False)
        acc, r_len, r_tier = run(True)
    return {"fmt": fmt, "name": name, "batch": batch, "lens": lens, "n": n,
            "rows": rows, "base": base.numpy(),
            "base_len": base_len.numpy(), "small": small,
            "ref": {k: np.asarray(v) for k, v in ref.items()},
            "acc": np.asarray(acc), "r_len": np.asarray(r_len),
            "r_tier": np.asarray(r_tier)}


def test_fused_probe_matches_reference(fused):
    """The plain probe's tier (the width test at O5's output width), its
    small channels and its ok / stamp channels against the reference
    probe's; the route's DEMAND is the reference's."""
    p, ref, n = fused, fused["ref"], fused["n"]
    OW = DO.out_width(L, SUFFIX)
    tier = p["base"] & (p["base_len"] <= OW)
    assert (tier[:n] == ref["tier"][:n]).all() and not tier[n:].any()
    assert n // 2 < tier.sum() < n
    keys = ["fac8", "sev8", "ok", "days", "sod", "off", "nanos"]
    if p["fmt"] == "rfc3164":
        keys += ["pri1", "hostl16"]
    for k in keys:
        got = p["small"][k]
        assert got.dtype == ref[k].dtype or k in ("ok", "days", "sod",
                                                  "off", "nanos"), k
        assert (got == ref[k][:n]).all(), k
    name = p["name"]
    assert FR.DEMAND[name] == RFR.DEMAND[name]
    assert FR.ROUTES[name].name == RFR.ROUTES[name].name
    assert FR.ROUTES[name].out == RFR.ROUTES[name].out == "rfc5424"


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


def test_carried_plain(fused):
    """carried_plain of the route: the decode's channels that the leg's
    assemble reads, in the decode's packed order (50 a row for rfc5424,
    3 for rfc3164)."""
    bt = torch.from_numpy(fused["batch"])
    lt = torch.from_numpy(fused["lens"])
    name = fused["name"]
    dec = (R5.decode_rfc5424(bt, lt) if fused["fmt"] == "rfc5424"
           else R3.decode_rfc3164(bt, lt, YEAR))
    cp = FR.carried_plain(dec, name).numpy()
    cols = FR.carried_columns(name)
    width = 50 if fused["fmt"] == "rfc5424" else 3
    assert cp.shape == (256, width) and len(cols) == width
    for j, (k, s) in enumerate(cols):
        want = dec[k] if s is None else dec[k][:, s]
        assert (cp[:, j] == want.to(torch.int32).numpy()).all(), (k, s)
    assert {k for k, _ in cols} == FR._OUT_CARRY[name]


def _run(fuse, lines, fmt, merger):
    config = Config.from_string(f'[input]\ntpu_encode_economics = false\n'
                                f'tpu_fuse = "{fuse}"\n')
    tx = queue.Queue()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        h = BatchHandler(tx, RFC5424Encoder(config), config, merger,
                         torch.device("cpu"), start_timer=False, fmt=fmt)
        datas = [b"\n".join(lines[i:i + 1024]) + b"\n"
                 for i in range(0, len(lines), 1024)]
        for d in datas:
            h._dispatch(pack.pack_region_2d(d, 512))
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(b"".join(datas), merger=merger, fmt=fmt,
                                   output="rfc5424")
    return h, got, err.getvalue().splitlines(), exp, errs


@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164"])
@pytest.mark.parametrize("fuse", ["auto", "on", "off"])
def test_fused_route_end_to_end(fuse, fmt):
    """A handler's tier batches into RFC5424: with tpu_fuse auto or on the
    fused route takes every batch, with off the split tier (O5 or
    O5/3164) does; every byte and error is the scalar path's."""
    if fmt == "rfc5424":
        lines, _ = make_tier_corpus(3 * 1024, seed=235)
        merger = SyslenMerger()
    else:
        lines, _ = make_rfc3164_tier_corpus(3 * 1024, seed=236)
        merger = LineMerger()
    h, got, err, exp, errs = _run(fuse, lines, fmt, merger)
    assert got == exp and sorted(err) == sorted(errs)
    fused = h.route_state.get(f"fused:{fmt}_rfc5424", {})
    split = h.route_state.get(fmt, {})
    if fuse == "off":
        assert split.get("taken") == 3 and not fused
    else:
        assert fused.get("taken") == 3 and not split
