"""The port's fused decode→encode route tier (tpu/fused_routes.py) and
its dispatch in the batch handler, on the CPU, against the JAX package:

- the fused routes' plain probe and assemble (the format's plain decode
  narrowed to ``DEMAND``, then the split tier's plain encode) against
  the reference's ``_fused_rfc5424_gelf`` and ``_fused_rfc3164_gelf``
  (run under ``jax.disable_jit()``, as the reference's own differential
  tests run them): the tier at the TS_W width and the ok and timestamp
  channels of every row, and every tier row's bytes;
- the route table: ``DEMAND``, the ladder constants, ``route_for`` and
  ``cooldown_state``;
- ``input.tpu_fuse``: the reference's errors, and its ``"on"`` notice
  word for word (both CLIs' stderr equal);
- fused, split (``tpu_fuse = "off"``) and scalar bytes equal on small
  rfc5424 and rfc3164 tier mixes and mixes, through the handler and
  through the entry point;
- the decline/cooldown sequence of the fused and split states over a
  run of declining and then engaging batches, written from the
  reference's rules (``batch.py:1336-1346``: a cooling fused route counts
  down at submit and the split path takes the batch;
  ``device_common.py:876``: three declines in a row start a cooldown of
  sixteen batches), with the two states never sharing a count.

Exact on every channel and byte.
"""

import contextlib
import io
import os
import queue
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.tpu import fused_routes as RF

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import (make_corpus, make_line,
                                       make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import fused_routes as FR
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
L = 256
YEAR = 2024


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _handler(fmt, fuse=None, batch_size=100000, merger=None):
    text = ("[input]\ntpu_encode_economics = false\n"
            "tpu_batch_size = %d\n" % batch_size)
    if fuse is not None:
        text += f'tpu_fuse = "{fuse}"\n'
    cfg = Config.from_string(text)
    tx = queue.Queue()
    h = BatchHandler(tx, GelfEncoder(cfg), cfg, merger or NulMerger(),
                     torch.device("cpu"), start_timer=False, fmt=fmt)
    return h, tx


def _feed(h, tx, lines):
    """One batch through the handler: its bytes and stderr lines."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        for ln in lines:
            h.handle_bytes(ln)
        h.flush()
    data = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    return data, err.getvalue().splitlines()


# ---------------------------------------------------------------------------
# the fused programs against the reference's
# ---------------------------------------------------------------------------

def _ref_fused(fmt, batch, lens, suffix, ts_text, ts_len, assemble):
    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    kw = {"suffix": suffix, "impl": "lax", "assemble": assemble,
          "extras": (), "demand": RF.DEMAND[f"{fmt}_gelf"]}
    with jax.disable_jit():
        if fmt == "rfc3164":
            return RF._fused_rfc3164_gelf(jb, jl, jnp.int32(YEAR),
                                          jnp.asarray(ts_text),
                                          jnp.asarray(ts_len), **kw)
        return RF._fused_rfc5424_gelf(jb, jl, jnp.asarray(ts_text),
                                      jnp.asarray(ts_len), max_sd=4, **kw)


@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164"])
def test_fused_probe_matches_reference(fmt):
    """The probe (at the TS_W width, as the reference's driver probes)
    gives the reference's tier and its ok and timestamp channels; the
    assemble at the rows' stamp text gives its tier, lengths and bytes."""
    if fmt == "rfc5424":
        tier, _ = make_tier_corpus(120, seed=71)
        mixed, _ = make_corpus(60, seed=72)
    else:
        tier, _ = make_rfc3164_tier_corpus(120, seed=71)
        mixed, _ = make_rfc3164_corpus(60, seed=72)
    lines = [ln[:L] for ln in tier + mixed]
    batch, lens, _, _, _, n = pack.pack_lines_2d(lines, L)
    assert batch.shape == (256, L)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    suffix = b"\0"
    kern = FR._FusedRows(FR.ROUTES[fmt], bt, lt, suffix, (), YEAR)
    base, base_len = kern.probe(n)
    small, _ = kern.small_channels(n)

    N = batch.shape[0]
    ref = _ref_fused(fmt, batch, lens, suffix,
                     np.zeros((N, 0), np.uint8),
                     np.full(N, DC.TS_W, np.int32), False)
    tier1 = (base & (base_len + DC.TS_W <= kern.OW)).numpy()
    assert (tier1[:n] == np.asarray(ref["tier"])[:n]).all()
    assert 0 < tier1[:n].sum() < n
    for k in ("ok", "days", "sod", "off", "nanos"):
        assert (small[k] == np.asarray(ref[k])[:n]).all(), k

    txt, tl = DC.ts_text_block(small)
    ts_text = np.zeros((N, DC.TS_W), np.uint8)
    ts_len = np.zeros(N, np.int32)
    ts_text[:n], ts_len[:n] = txt, tl
    acc, r_len, r_tier = (np.asarray(a) for a in _ref_fused(
        fmt, batch, lens, suffix, ts_text, ts_len, True))
    p_len = base_len.numpy() + ts_len
    p_tier = base.numpy() & (p_len <= kern.OW)
    assert (p_tier[:n] == r_tier[:n]).all()
    rows = np.flatnonzero(p_tier)
    gated = np.where(p_tier, p_len, 0)
    row_off = torch.from_numpy(np.where(p_tier, np.cumsum(gated) - gated,
                                        -1))
    flat = kern.assemble(torch.from_numpy(ts_text), torch.from_numpy(ts_len),
                         row_off, int(gated.sum()), n).numpy()
    for i in rows:
        o = int(row_off[i])
        assert (flat[o:o + p_len[i]].tobytes()
                == acc[i, :r_len[i]].tobytes()), i


def test_route_table_matches_reference(monkeypatch):
    for name in ("rfc5424_gelf", "rfc3164_gelf"):
        assert FR.DEMAND[name] == RF.DEMAND[name]
    assert (FR.FALLBACK_FRAC, FR.DECLINE_LIMIT, FR.COOLDOWN) == (
        RF.FALLBACK_FRAC, RF.DECLINE_LIMIT, RF.COOLDOWN)
    enc = GelfEncoder(Config.from_string(""))
    for fmt, name in (("rfc5424", "rfc5424_gelf"),
                      ("rfc3164", "rfc3164_gelf")):
        route = FR.route_for(fmt, enc, LineMerger())
        assert route.name == name and route.fmt == fmt
        state = {}
        assert FR.cooldown_state(state, route) is state[f"fused:{name}"]
    assert FR.route_for("jsonl", enc, LineMerger()) is None
    dyn = GelfEncoder(Config.from_string('[output.gelf_extra]\n_x = "1"\n'))
    assert FR.route_for("rfc5424", dyn, LineMerger()) is None
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    assert FR.route_for("rfc5424", enc, LineMerger()) is None


# ---------------------------------------------------------------------------
# input.tpu_fuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,message", [
    ('"sometimes"', "input.tpu_fuse must be auto, on or off"),
    ("3", "input.tpu_fuse must be a string")])
def test_tpu_fuse_validation(value, message):
    """Both packages' batch handlers refuse the value with the same
    ConfigError text (the reference's supervisor then restarts its input
    thread; the port has no supervisor yet and exits)."""
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.config import ConfigError as RConfigError
    from flowgger_tpu.decoders.rfc5424 import RFC5424Decoder as RDecoder
    from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
    from flowgger_tpu.tpu.batch import BatchHandler as RBatchHandler

    text = f"[input]\ntpu_encode_economics = false\ntpu_fuse = {value}\n"
    cfg = Config.from_string(text)
    with pytest.raises(ConfigError) as exc:
        BatchHandler(queue.Queue(), GelfEncoder(cfg), cfg, NulMerger(),
                     torch.device("cpu"), start_timer=False)
    rcfg = RConfig.from_string(text)
    with pytest.raises(RConfigError) as rexc:
        RBatchHandler(queue.Queue(), RDecoder(), RGelfEncoder(rcfg), rcfg,
                      start_timer=False)
    assert str(exc.value) == str(rexc.value) == message
    for fuse in ("auto", "on", "off"):
        _handler("rfc5424", fuse)


def _run(pkg, cfg, data, env_extra):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT),
               FLOWGGER_DEVICE_ENCODE="0", **env_extra)
    extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=300)


def test_on_notice_matches_the_reference_cli(tmp_path):
    """``tpu_fuse = "on"`` on a config that cannot fuse (jsonl_tpu) prints
    the reference's notice word for word: both CLIs' stdout and stderr
    equal."""
    data = b'{"timestamp":1438790025.42,"host":"web1","message":"hi"}\n'
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "jsonl_tpu"\n'
            'tpu_fuse = "on"\n'
            '[output]\ntype = "stdout"\nformat = "gelf"\n'
            'framing = "line"\n')
        proc = _run(pkg, cfg, data, {})
        outs[pkg] = (proc.returncode, proc.stdout,
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port == ref and port[0] == 0 and port[1]
    assert port[2] == [
        'flowgger-tpu: input.tpu_fuse = "on" but this config '
        "cannot fuse format 'jsonl' (no registered fused program "
        "for the route, template mining on, or a sharded mesh owns "
        "the format); using the split decode/encode path"]


# ---------------------------------------------------------------------------
# the ladder: fused, split and scalar bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,tier_mix", [
    ("rfc5424", True), ("rfc5424", False), ("rfc3164", True),
    ("rfc3164", False)], ids=["rfc5424_tier", "rfc5424_mix", "rfc3164_tier",
                              "rfc3164_mix"])
def test_fused_split_scalar_bytes_equal(fmt, tier_mix):
    """Four batches through a handler with the fused route on ("auto")
    and off: the same bytes and stderr lines, equal to the scalar path's;
    on the tier mixes the fused route takes every batch and the split
    tier sees none (or, off, takes every batch)."""
    if fmt == "rfc5424":
        make = make_tier_corpus if tier_mix else make_corpus
    else:
        make = make_rfc3164_tier_corpus if tier_mix else make_rfc3164_corpus
    lines, _ = make(4 * 120, seed=73)
    got = {}
    for fuse in ("auto", "off"):
        h, tx = _handler(fmt, fuse)
        outs, errs = [], []
        for b in range(4):
            o, e = _feed(h, tx, lines[b * 120:(b + 1) * 120])
            outs.append(o)
            errs += e
        got[fuse] = (b"".join(outs), errs, h.route_state)
    exp, exp_err = scalar_expectation(b"\n".join(lines) + b"\n", fmt=fmt)
    assert got["auto"][0] == got["off"][0] == exp
    assert got["auto"][1] == got["off"][1]
    assert sorted(got["auto"][1]) == sorted(exp_err)
    fused = got["auto"][2].get(f"fused:{fmt}_gelf", {})
    if tier_mix:
        assert fused.get("taken") == 4 and fmt not in got["auto"][2]
        assert got["off"][2][fmt]["taken"] == 4
        assert "fused:" + fmt + "_gelf" not in got["off"][2]
    else:
        assert fused.get("declined", 0) >= 1 and not fused.get("taken")


def test_entry_point_engages_the_fused_route(tmp_path, monkeypatch, capsys):
    """stdin → rfc3164_tpu → GELF through ``pipeline.start`` on the CPU:
    the fused route takes the tier mix's batches, the bytes are the
    scalar path's."""
    lines, _ = make_rfc3164_tier_corpus(900, seed=74)
    data = b"\n".join(lines) + b"\n"
    out = tmp_path / "out.gelf"
    cfg = tmp_path / "cfg.toml"
    cfg.write_text(
        '[input]\ntpu_encode_economics = false\n'
        'type = "stdin"\nformat = "rfc3164_tpu"\n'
        'tpu_batch_size = 256\ntpu_flush_ms = 600000\n'
        '[output]\ntype = "file"\nformat = "gelf"\nframing = "line"\n'
        f'file_path = "{out}"\n')
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    pipe = pipeline.start(str(cfg), device="cpu")
    exp, errs = scalar_expectation(data, merger=LineMerger(), fmt="rfc3164")
    assert out.read_bytes() == exp
    assert sorted(capsys.readouterr().err.splitlines()) == sorted(errs)
    state = pipe._handler.route_state
    fused = state["fused:rfc3164_gelf"]
    assert fused["taken"] >= 2 and not fused.get("declined")
    assert "rfc3164" not in state
    assert fused["fetch_bytes"] < fused["emit_bytes"]


# ---------------------------------------------------------------------------
# the decline / cooldown sequence
# ---------------------------------------------------------------------------

_KEYS = ("taken", "declined", "cooled", "wide")


def _states(h, fmt):
    return ({k: h.route_state.get(f"fused:{fmt}_gelf", {}).get(k, 0)
             for k in _KEYS},
            {k: h.route_state.get(fmt, {}).get(k, 0) for k in _KEYS})


def _steps(h, tx, fmt, batches):
    """Each batch's move on the fused and on the split state."""
    seq = []
    for lines in batches:
        f0, s0 = _states(h, fmt)
        _feed(h, tx, lines)
        f1, s1 = _states(h, fmt)
        seq.append(([k for k in _KEYS if f1[k] != f0[k]],
                    [k for k in _KEYS if s1[k] != s0[k]]))
    return seq


def test_decline_cooldown_sequence_rfc3164():
    """Three declining batches, then sixteen, then engaging ones.  The
    fused route declines three times (the split tier, probing the same
    batches after it, declines three times on its own count), then cools
    down for sixteen batches at submit while the split tier cools down in
    the same batches, then both are back: the fused route takes the next
    engaging batch and the split tier never sees it."""
    rng = np.random.default_rng(75)
    good, kinds = make_rfc3164_tier_corpus(40 * 26, seed=76)
    good = [ln for ln, k in zip(good, kinds) if k == "fast"]
    bad = [b"Oct 17 01:02:03 Gateway m %d" % i for i in range(40)]
    batches = []
    for i in range(24):
        rows = good[40 * i:40 * i + 36]
        if i < 19:
            rows = rows + bad[:4]              # 10 % outside the tiers
        batches.append([rows[j] for j in rng.permutation(len(rows))])
    h, tx = _handler("rfc3164")
    seq = _steps(h, tx, "rfc3164", batches)
    want = ([(["declined"], ["declined"])] * 3
            + [(["cooled"], ["cooled"])] * 16
            + [(["taken"], [])] * 5)
    assert seq == want
    assert h.route_state["fused:rfc3164_gelf"]["cooldown"] == 0


def test_decline_cooldown_states_never_share_a_count():
    """rfc5424 batches with 7-16-pair rows: the fused route (6 pairs, no
    wide probe) declines and cools down, while the split tier takes the
    same batches through its 16-pair wide probe — one state's declines
    never move the other's."""
    rng = np.random.default_rng(77)
    batches = []
    for i in range(6):
        rows = [make_line(rng, "tier") for _ in range(30)]
        rows += [make_line(rng, "rescue") for _ in range(10)]
        batches.append(rows)
    h, tx = _handler("rfc5424", merger=LineMerger())
    seq = _steps(h, tx, "rfc5424", batches)
    assert seq == ([(["declined"], ["taken", "wide"])] * 3
                   + [(["cooled"], ["taken", "wide"])] * 3)
    assert h.route_state["fused:rfc5424_gelf"]["cooldown"] == 13
    assert h.route_state["rfc5424"].get("cooldown", 0) == 0
