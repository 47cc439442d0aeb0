"""The fused rfc5424 → capnp route (FO/capnp) on the CPU, against the JAX
package: its plain version (``fused_routes._FusedRows`` on a CPU batch:
the plain decode narrowed to its ``DEMAND``, then OC's plain encode)
against the reference's ``_fused_rfc5424_capnp`` — the probe's tier bits,
``fac8`` / ``sev8`` and the ok / stamp channels, and the assemble's
bytes, with and without a ``capnp_extra`` — and the carried channels
``carried_plain``; and the route end to end through a handler with
``tpu_fuse`` auto, on and off, against the scalar path.

The reference's fused program runs eagerly (``jax.disable_jit``) at one
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
from flowgger_tpu_torch.corpus import (make_corpus, make_tier_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.encoders import CapnpEncoder
from flowgger_tpu_torch.mergers import NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import device_capnp as DC
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc5424 as R5
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

L = 256
NAME = "rfc5424_capnp"
EXTRAS = (("env", "prod"), ("dc", "eu-west-1"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines():
    tier, _ = make_tier_corpus(190, seed=241)
    mixed, _ = make_corpus(50, seed=242)
    return tier[:120] + mixed + tier[120:] + [
        b'<13>1 2015-08-05T15:53:45Z h a p m [a b="1"][c d="e"] x',
        b'<191>1 2015-08-05T15:53:45Z h a p m [x k="a\\"b"] esc',
        b"<13>1 2015-08-05T15:53:45Z - - - - -"]


@pytest.fixture(scope="module", params=[(b"", ()), (b"\0", EXTRAS)],
                ids=["noop", "nul_extra"])
def fused(request):
    """The reference's fused probe and assemble and the port's plain
    route on one batch (the assemble keeps the reference's tier rows)."""
    suffix, extras = request.param
    batch, lens, _, _, _, n = pack.pack_lines_2d(_lines(), L)
    N = batch.shape[0]
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    rows = FR._FusedRows(FR.ROUTES[NAME], bt, lt, suffix, extras, None)
    base, base_len = rows.probe(n)
    small, _ = rows.small_channels(n)
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    ts_text = jnp.zeros((N, 32), jnp.uint8)
    ts_len = jnp.zeros(N, jnp.int32)
    with jax.disable_jit():
        def run(assemble):
            return RFR._fused_rfc5424_capnp(
                jb, jl, ts_text, ts_len, max_sd=4, suffix=suffix,
                extras=extras, assemble=assemble, demand=RFR.DEMAND[NAME])

        ref = run(False)
        acc, r_len, r_tier = run(True)
    return {"batch": batch, "lens": lens, "n": n, "suffix": suffix,
            "extras": extras, "rows": rows, "base": base.numpy(),
            "base_len": base_len.numpy(), "small": small,
            "ref": {k: np.asarray(v) for k, v in ref.items()},
            "acc": np.asarray(acc), "r_len": np.asarray(r_len),
            "r_tier": np.asarray(r_tier)}


def test_fused_probe_matches_reference(fused):
    """The plain probe's tier (the width test at OC's output width), fac8
    / sev8 and its ok / stamp channels against the reference probe's; the
    route's DEMAND and registration are the reference's."""
    p, ref, n = fused, fused["ref"], fused["n"]
    OW = DC.out_width(L, p["suffix"], p["extras"])
    tier = p["base"] & (p["base_len"] <= OW)
    assert (tier[:n] == ref["tier"][:n]).all() and not tier[n:].any()
    assert n // 2 < tier.sum() < n
    for k in ("fac8", "sev8", "ok", "days", "sod", "off", "nanos"):
        got = p["small"][k]
        assert got.dtype == ref[k].dtype or k not in ("fac8", "sev8"), k
        assert (got == ref[k][:n]).all(), k
    assert FR.DEMAND[NAME] == RFR.DEMAND[NAME]
    assert FR.ROUTES[NAME].name == RFR.ROUTES[NAME].name
    assert FR.ROUTES[NAME].out == RFR.ROUTES[NAME].out == "capnp"


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
    """carried_plain of the route: the decode's channels OC's assemble
    reads, in the decode's packed order, sd[0]'s id only (45 a row)."""
    bt = torch.from_numpy(fused["batch"])
    lt = torch.from_numpy(fused["lens"])
    dec = R5.decode_rfc5424(bt, lt)
    cp = FR.carried_plain(dec, NAME).numpy()
    cols = FR.carried_columns(NAME)
    assert cp.shape == (256, 45) and len(cols) == 45
    for j, (k, s) in enumerate(cols):
        want = dec[k] if s is None else dec[k][:, s]
        assert (cp[:, j] == want.to(torch.int32).numpy()).all(), (k, s)
    assert {k for k, _ in cols} == FR._OUT_CARRY[NAME]
    assert all(s in (None, 0) for k, s in cols if k.startswith("sid"))


@pytest.mark.parametrize("fuse", ["auto", "on", "off"])
def test_fused_route_end_to_end(fuse):
    """A handler's tier batches into capnp (syslen framing, a capnp_extra
    with fuse on): with tpu_fuse auto or on the fused route takes every
    batch, with off the split tier (OC) does; every byte and error is
    the scalar path's."""
    lines, _ = make_tier_corpus(3 * 1024, seed=243)
    text = f'[input]\ntpu_encode_economics = false\ntpu_fuse = "{fuse}"\n' + (
        '[output.capnp_extra]\nenv = "prod"\n' if fuse == "on" else "")
    config = Config.from_string(text)
    merger = SyslenMerger() if fuse != "off" else NulMerger()
    tx = queue.Queue()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        h = BatchHandler(tx, CapnpEncoder(config), config, merger,
                         torch.device("cpu"), start_timer=False,
                         fmt="rfc5424")
        datas = [b"\n".join(lines[i:i + 1024]) + b"\n"
                 for i in range(0, len(lines), 1024)]
        for d in datas:
            h._dispatch(pack.pack_region_2d(d, 512))
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(b"".join(datas), merger=merger,
                                   output="capnp", config=config)
    assert got == exp and sorted(err.getvalue().splitlines()) == sorted(errs)
    fused = h.route_state.get(f"fused:{NAME}", {})
    split = h.route_state.get("rfc5424", {})
    if fuse == "off":
        assert split.get("taken") == 3 and not fused
    else:
        assert fused.get("taken") == 3 and not split


class _OnCard(torch.Tensor):
    """A CPU tensor that reports lying on the card."""

    @property
    def is_cuda(self):
        return True


# each fused route, its kernels' wrapper in ``kernels``, whether the
# wrapper takes the input format first, its corpus and its encoder
_CARD_ROUTES = {
    "rfc5424_gelf": ("fused_gelf_cuda", True, "make_tier_corpus", "gelf"),
    "rfc5424_ltsv": ("fused_ltsv_out_cuda", False,
                     "make_ltsv_out_tier_corpus", "ltsv"),
    "rfc5424_rfc5424": ("fused_rfc5424_out_cuda", True, "make_tier_corpus",
                        "rfc5424"),
    "rfc3164_rfc5424": ("fused_rfc5424_out_cuda", True,
                        "make_rfc3164_tier_corpus", "rfc5424"),
    "rfc5424_capnp": ("fused_capnp_out_cuda", False, "make_tier_corpus",
                      "capnp"),
}


@pytest.mark.parametrize("name", sorted(_CARD_ROUTES))
def test_card_branch_takes_the_legs_wrapper(monkeypatch, name):
    """A fused batch on the card goes through its output leg's kernels
    wrapper for the probe and the assemble (the wrapper stood in for by
    the route's plain version on the same rows, with the carried
    channels of ``carried_plain``), and the driver's block is the CPU
    route's byte for byte."""
    from flowgger_tpu_torch import corpus, encoders
    from flowgger_tpu_torch.tpu import kernels

    wrapper, takes_fmt, maker, out = _CARD_ROUTES[name]
    route, = [r for r in FR.ROUTES.values() if r.name == name]
    assert FR.split_tier(route.fmt, route.out).__name__.endswith(
        {"gelf": "device_gelf", "ltsv": "device_ltsv_out",
         "rfc5424": "device_rfc5424_out", "capnp": "device_capnp"}[out])
    lines, _ = getattr(corpus, maker)(200, 252)
    packed = pack.pack_lines_2d(lines, 512)
    n = packed[5]
    bt, lt = torch.from_numpy(packed[0]), torch.from_numpy(packed[1])
    enc = {"gelf": encoders.GelfEncoder, "ltsv": encoders.LTSVEncoder,
           "rfc5424": encoders.RFC5424Encoder,
           "capnp": CapnpEncoder}[out](Config.from_string(""))
    calls = []
    plain = {}

    def stand_in(*args, **kw):
        if takes_fmt:
            assert args[0] == route.fmt
            args = args[1:]
        batch, lens, m = args[:3]
        assert batch.is_cuda and m == n and lens.dtype == torch.int32
        if "row_off" not in kw:
            calls.append("probe")
            rows = plain["rows"] = FR._FusedRows(
                route, bt, lt, b"\0", (), kw.get("year"))
            base, base_len = rows.probe(m)
            return (base, base_len, rows.small,
                    FR.carried_plain(rows.dec, name), *rows.extra)
        calls.append("assemble")
        rows = plain["rows"]
        assert kw["tier"] is not None and kw["OW"] == rows.OW
        assert ("ts_text" in kw) == (out == "gelf")
        return rows.assemble(kw.get("ts_text"), kw.get("ts_len"),
                             kw["row_off"], kw["total"], m)

    monkeypatch.setattr(kernels, wrapper, stand_in)

    def run(batch):
        handle = FR.submit(route, (batch, lt) + tuple(packed[2:]))
        res, _ = FR.fetch_encode(handle, packed, enc, NulMerger())
        return res

    card = run(bt.as_subclass(_OnCard))
    assert calls == ["probe", "assemble"]
    want = run(bt)
    assert card is not None and want is not None
    assert bytes(card.block.data) == bytes(want.block.data)
    assert np.array_equal(card.block.bounds, want.block.bounds)
    assert card.errors == want.errors
