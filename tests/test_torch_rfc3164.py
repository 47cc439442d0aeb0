"""The port's RFC3164 (BSD syslog) input on the CPU, against the JAX
package: the BSD date parse and the scalar decoder (the oracle), the
plain decode (D3's plain version) on every channel for a fixed year,
the host block encoder and the split device tier's plain encode (E3's,
``elide=True``) byte for byte, the config gates, and ``python -m
flowgger_tpu_torch`` against ``python -m flowgger_tpu`` on one config
and input.

Every jitted reference call shares one batch shape ([256, 256]) and few
static arguments, so the reference compiles little; the decode runs
eagerly (it is plain jnp).  Exact on every channel and byte.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders.rfc3164 import RFC3164Decoder as RDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import device_rfc3164 as RD3
from flowgger_tpu.tpu import encode_rfc3164_gelf_block as RB3
from flowgger_tpu.tpu import rfc3164 as RR3
from flowgger_tpu.utils import timeparse as RTP

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import (make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.decoders import DecodeError
from flowgger_tpu_torch.decoders.rfc3164 import RFC3164Decoder
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_rfc3164 as D3
from flowgger_tpu_torch.tpu import encode_rfc3164_gelf_block as B3
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc3164 as R3
from flowgger_tpu_torch.utils import timeparse as TP

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
L = 256
YEAR = 2024
EXTRAS = (("a-first", "x"), ("kind", "h"), ("level2", "y"), ("zzz", "last"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# every branch of the decode: the day layouts A, B and C, Feb 29 in a
# leap year (and Feb 30), the timezone-lookalike guard (capitalised and
# digit-bearing single tokens, the two lowercase aliases, a near miss,
# a dotted host), PRI forms, whitespace runs, escapes, control bytes,
# non-ASCII, the custom "host: date: msg" layout, short and empty rows
HAND = [
    b"<34>Oct 11 22:14:15 mymachine su: 'su root' failed for lonvick",
    b"<13>Oct  7 01:02:03 host.example.com app[42]: layout C",
    b"<13>Oct 7 01:02:03 10.0.0.1 app: layout B",
    b"Oct 17 01:02:03 nopri tag: no pri",
    b"<13>Feb 29 01:02:03 leap x: feb 29",
    b"<13>Feb 30 01:02:03 bad x: feb 30",
    b"<13>Mar  3 01:02:03 Gateway x: tz lookalike",
    b"<13>Mar  3 01:02:03 localtime x: alias",
    b"<13>Mar  3 01:02:03 posixrules x: alias",
    b"<13>Mar  3 01:02:03 posixrule x: not an alias",
    b"<13>Mar  3 01:02:03 EST5EDT x: digits in a zone",
    b"<13>Mar  3 01:02:03 UTC x: a real zone",
    b"<13>Mar  3 01:02:03 Web.A x: a dot",
    b"<999>Jan  1 00:00:00 a b",
    b"<1a>Jan  1 00:00:00 a b",
    b"<>Jan  1 00:00:00 a b",
    b"<12",
    b"<5>",
    b"Jan  1 00:00:00 a  b",
    b"Jan  1 00:00:00 a b ",
    b" Jan  1 00:00:00 a b",
    b"Jan  1 00:00:00 a\tb",
    b"Jan  1 0:00:00 a b",
    b"Jan 31 23:59:5",
    b"2023 Jan 31 23:59:59 yearhost m",
    b"myhost: Jan 31 23:59:59: custom layout",
    b'<7>Dec 31 23:59:59 h x: "quoted" and \\ back\\slash',
    b"<7>Dec 31 23:59:59 h x: bell\x07here",
    b"<7>Dec 31 23:59:59 h x: caf\xc3\xa9",
    b"<7>Dec 31 23:59:59 h",
    b"<7>Dec 31 23:59:59 h ",
    b"",
    b"J",
]


def _lines():
    rng = np.random.default_rng(61)
    alpha = list(b"<>0123456789 :JanFebOctDcv.aZ\t-/")
    rand = [bytes(rng.choice(alpha, int(rng.integers(0, 40))))
            for _ in range(40)]
    tier, _ = make_rfc3164_tier_corpus(90, seed=62)
    mixed, _ = make_rfc3164_corpus(90, seed=63)
    return HAND + rand + tier + mixed


def _packed(lines=None):
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(
        _lines() if lines is None else lines, L)
    assert batch.shape == (256, L)
    return batch, lens, chunk, starts, orig, n


def _ref_decode(batch, lens, year=YEAR):
    return {k: np.asarray(v) for k, v in RR3.decode_rfc3164(
        jnp.asarray(batch), jnp.asarray(lens), year).items()}


def test_timeparse_matches_reference():
    toks = [["Oct", "11", "22:14:15"], ["Feb", "29", "01:02:03", "UTC"],
            ["Mar", "10", "02:30:00", "America/New_York"],
            ["Nov", "3", "01:30:00", "America/New_York"],
            ["2023", "Jan", "31", "23:59:59", "Europe/Paris"],
            ["Jan", "1", "0:00:00"], ["Foo", "1", "00:00:00"],
            ["Jan", "31", "23:59:5"], ["Jan", "1", "00:00:00", "Nowhere"]]
    for t in toks:
        for has_year in (False, True):
            try:
                want = RTP.parse_rfc3164_ts(t, has_year)
            except ValueError:
                with pytest.raises(ValueError):
                    TP.parse_rfc3164_ts(t, has_year)
                continue
            assert TP.parse_rfc3164_ts(t, has_year) == want
    assert TP.current_year_utc() == RTP.current_year_utc()
    for zone in ("UTC", "Europe/Paris", "Nowhere", "localtime"):
        assert (TP._tz_offset_nanos(zone, 2024, 7, 1, 12, 0, 0)
                == RTP._tz_offset_nanos(zone, 2024, 7, 1, 12, 0, 0))


def test_scalar_decoder_matches_reference():
    """The oracle: the same record or the same error and stderr line for
    every row."""
    mine, ref = RFC3164Decoder(), RDecoder()
    for raw in _lines():
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            continue
        out = []
        for dec in (mine, ref):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                try:
                    r = dec.decode(line)
                    out.append((r.ts, r.hostname, r.facility, r.severity,
                                r.msg, r.full_msg, err.getvalue()))
                except Exception as e:  # noqa: BLE001 - both packages' DecodeError
                    out.append((type(e).__name__, str(e), err.getvalue()))
        assert out[0] == out[1], line


@pytest.mark.parametrize("year", [2024, 2025])
def test_plain_decode_matches_jax(year):
    """D3's plain version against the reference's decode_rfc3164 on every
    channel of every row (padding rows included), in a leap and a
    non-leap year."""
    batch, lens, *_ = _packed()
    got = R3.decode_rfc3164(torch.from_numpy(batch), torch.from_numpy(lens),
                            year)
    ref = _ref_decode(batch, lens, year)
    assert set(got) == set(ref) == set(R3.KEYS)
    for k, v in ref.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and (g == v).all(), k
    assert 0.2 < ref["ok"].mean() < 0.9
    leap = HAND.index(b"<13>Feb 29 01:02:03 leap x: feb 29")
    assert bool(ref["ok"][leap]) == (year % 4 == 0)
    # the layouts: A, C and B rows on the fast path, the tz guard off it
    # but for the near miss and the dotted host
    assert list(ref["ok"][:4]) == [True] * 4
    assert list(ref["ok"][6:10]) == [False, False, False, True]
    assert not ref["ok"][10:12].any() and ref["ok"][12]


def test_fetch_unpacks_the_kernel_layout():
    """decode_rfc3164_fetch of the kernel's packed [12, N] layout gives
    the plain version's channels and dtypes."""
    batch, lens, *_ = _packed()
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    plain = R3.decode_rfc3164(bt, lt, YEAR)
    packed = torch.stack([plain[k].to(torch.int32) for k in R3.KEYS])
    got = R3.decode_rfc3164_fetch((packed, bt, lt))
    for k, v in plain.items():
        assert got[k].dtype == v.numpy().dtype and (got[k] == v.numpy()).all()


_MERGERS = {"nul": (NulMerger(), RNulMerger()),
            "line": (LineMerger(), RLineMerger()),
            "syslen": (SyslenMerger(), RSyslenMerger()),
            "none": (None, None)}


@pytest.mark.parametrize("merger", list(_MERGERS))
@pytest.mark.parametrize("extras", [(), EXTRAS], ids=["plain", "extras"])
def test_block_encoder_matches_reference(merger, extras):
    """encode_rfc3164_gelf_block over the same channels equals the
    reference's block encoder (bytes, errors, oracle rows) and the
    scalar path."""
    batch, lens, chunk, starts, orig, n = _packed()
    ref_dec = _ref_decode(batch, lens, TP.current_year_utc())
    toml = ("[output.gelf_extra]\n"
            + "".join(f'{k} = "{v}"\n' for k, v in extras)) if extras else ""
    enc = GelfEncoder(Config.from_string(toml))
    renc = RGelfEncoder(RConfig.from_string(toml))
    m, rm = _MERGERS[merger]
    got = B3.encode_rfc3164_gelf_block(chunk, starts, orig, ref_dec, n, L,
                                       enc, m)
    want = RB3.encode_rfc3164_gelf_block(chunk, starts, orig, ref_dec, n, L,
                                         renc, rm)
    assert got.block.data == want.block.data
    assert got.errors == want.errors
    assert got.fallback_rows == want.fallback_rows > 10
    # NUL framing keeps each row as packed (a CR included)
    exp, _ = scalar_expectation(b"\0".join(_lines()) + b"\0", "nul",
                                config=Config.from_string(toml), merger=m,
                                fmt="rfc3164")
    assert got.block.data == exp
    assert B3.gelf_extra_consts_3164(list(extras)) == \
        RB3.gelf_extra_consts_3164(list(extras))


@pytest.mark.parametrize("suffix,extras", [(b"\0", ()), (b"\n", EXTRAS)],
                         ids=["nul", "syslen_extras"])
def test_device_encode_matches_reference(suffix, extras):
    """E3's plain version (probe and assemble, composed as the driver
    composes them) against the reference's device_rfc3164._encode_kernel
    with elide=True: the tier mask of every row and the length and bytes
    of every tier row; the constant bank is the reference's."""
    batch, lens, _, _, _, n = _packed()
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = R3.decode_rfc3164(bt, lt, YEAR)
    small = {k: dec[k][:n].numpy() for k in ("ok", "days", "sod", "off",
                                             "nanos")}
    txt, tl = DC.ts_text_block(small)
    ts_text = np.zeros((256, DC.TS_W), np.uint8)
    ts_len = np.zeros(256, np.int32)
    ts_text[:n], ts_len[:n] = txt, tl

    jb, jl = jnp.asarray(batch), jnp.asarray(lens)
    rdec = RR3.decode_rfc3164_jit(jb, jl, jnp.int32(YEAR))
    acc, r_len, r_tier = RD3._encode_kernel(
        jb, jl, dict(rdec), jnp.asarray(ts_text), jnp.asarray(ts_len),
        suffix=suffix, impl="lax", assemble=True, extras=extras, elide=True)
    acc, r_len, r_tier = (np.asarray(acc), np.asarray(r_len),
                          np.asarray(r_tier))

    kw = {"suffix": suffix, "extras": extras}
    base, base_len = D3.encode_rows(bt, lt, dec, assemble=False, n=n, **kw)
    OW = D3.out_width(L, suffix, extras)
    p_len = base_len.numpy() + ts_len
    p_tier = base.numpy() & (p_len <= OW)
    rows, a_len, a_tier = D3.encode_rows(
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
    bank, offs, parts = D3._bank(suffix, extras)
    rbank, roffs, rparts = RD3._bank(suffix, extras)
    assert (bank, offs, parts) == (rbank, roffs, rparts)
    assert D3.elide_spec(suffix, extras) == RD3.elide_spec(suffix, extras)
    assert (D3.FALLBACK_FRAC, D3.DECLINE_LIMIT, D3.COOLDOWN) == (
        RD3.FALLBACK_FRAC, RD3.DECLINE_LIMIT, RD3.COOLDOWN)


def test_route_ok_and_config_gates(monkeypatch):
    """rfc3164_tpu runs into GELF, with gelf_extra keys this layout
    places and with keys it cannot (``level``: the Record path, as in the
    reference, test_cli_rfc3164_level_extra_matches_jax_package); capnp
    into kafka without brokers raises the reference's ConfigError (the
    Kafka sink runs since the sinks slice)."""
    enc = GelfEncoder(Config.from_string(""))
    assert D3.route_ok(enc, LineMerger()) and D3.route_ok(enc, None)
    for extra in ('zone = "eu"\n', 'level = "9"\n'):
        pipeline.Pipeline(Config.from_string(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "rfc3164_tpu"\n'
            '[output]\ntype = "stdout"\n[output.gelf_extra]\n' + extra),
            device="cpu")
    assert not D3.route_ok(GelfEncoder(Config.from_string(
        '[output.gelf_extra]\nlevel = "9"\n')), LineMerger())
    with pytest.raises(ConfigError,
                       match="output.kafka_brokers is required"):
        pipeline.Pipeline(Config.from_string(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "rfc3164_tpu"\n'
            '[output]\ntype = "kafka"\nformat = "capnp"\n'),
            device="cpu")
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    assert not D3.route_ok(enc, LineMerger())


def _run(pkg, cfg, data, env_extra):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT),
               **env_extra)
    extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=300)


@pytest.mark.parametrize("framing,out_type", [("nul", "stdout")])
def test_cli_rfc3164_matches_jax_package(tmp_path, framing, out_type):
    """One rfc3164_tpu config and input through both CLIs: stdout (or the
    file) and stderr equal.  The port runs its whole ladder (the fused
    route, the split tier, the host tier, on the CPU their plain
    versions); the reference its host tier (its device compiles on the
    CPU are not what this holds)."""
    lines, _ = make_rfc3164_corpus(800, seed=64)
    sep = b"\0" if framing == "nul" else b"\n"
    data = sep.join(lines) + sep + b"<13>Oct 17 10:11:12 tail partial"
    assert len(data) > 1 << 16
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "rfc3164_tpu"\n'
            f'framing = "{framing}"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 256\n'
            + ('tpu_fuse = "off"\n' if pkg == "flowgger_tpu" else "")
            + f'[output]\ntype = "{out_type}"\nformat = "gelf"\n'
            f'file_path = "{out}"\nframing = "line"\n')
        env = ({"FLOWGGER_DEVICE_ENCODE": "0"} if pkg == "flowgger_tpu"
               else {})
        proc = _run(pkg, cfg, data, env)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        body = out.read_bytes() if out_type == "file" else proc.stdout
        outs[pkg] = (body, proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[0] == ref[0] and len(port[0]) > 1000
    assert port[1] == ref[1] and port[1]
    exp, _ = scalar_expectation(data, framing, merger=LineMerger(),
                                fmt="rfc3164")
    banner, body = port[0].split(b"\n", 1)
    assert banner.startswith(b"Flowgger") and body == exp


def test_cli_rfc3164_level_extra_matches_jax_package(tmp_path):
    """rfc3164_tpu with a gelf_extra ``level`` (a fixed GELF field this
    layout cannot place) takes the Record path in both packages: the
    same output bytes and stderr through both CLIs (the start-up notice
    first, then the decoder's own lines and the error lines), exit code
    0, and the scalar path's bytes."""
    lines, _ = make_rfc3164_corpus(500, seed=65)
    data = b"\n".join(lines) + b"\n<13>Oct 17 10:11:12 tail partial"
    extra = '[output.gelf_extra]\nlevel = "3"\nzone = "eu"\n'
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "rfc3164_tpu"\n'
            'framing = "line"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 256\n'
            '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\nframing = "nul"\n' + extra)
        env = ({"FLOWGGER_DEVICE_ENCODE": "0"} if pkg == "flowgger_tpu"
               else {})
        proc = _run(pkg, cfg, data, env)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (out.read_bytes(), proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port == ref and b'"level":"3"' in port[0]
    assert port[1][0] == (
        "flowgger-tpu: columnar block route disabled for format 'rfc3164' "
        "(output.gelf_extra keys need dynamic placement (leading '_' or a "
        "fixed-key overwrite)); throughput falls to the per-record path "
        "(~30x slower)")
    exp, _ = scalar_expectation(data, merger=NulMerger(), fmt="rfc3164",
                                config=Config.from_string(extra))
    assert port[0] == exp


def test_tier_corpus_stays_under_the_decline_threshold():
    """One batch of the rfc3164 tier mix (layout C): the fast rows are
    in the tier and the rows outside it stay near their 3 % share."""
    lines, kinds = make_rfc3164_tier_corpus(2048, seed=20261016)
    assert all(b">Oct  7 " in ln[:13] for ln, k in zip(lines, kinds)
               if k == "fast")
    batch, lens, _, _, orig, n = pack.pack_lines_2d(lines, 512)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    dec = R3.decode_rfc3164(bt, lt, YEAR)
    base, base_len = D3.encode_rows(bt, lt, dec, suffix=b"\0",
                                    assemble=False, n=n)
    tier = base & (base_len + DC.TS_W <= D3.out_width(512, b"\0"))
    cand = tier.numpy()[:n] & (orig[:n] <= 512)
    kinds = np.asarray(kinds)
    assert cand[kinds == "fast"].all()
    assert 0.02 < 1 - cand.mean() < 0.04 < D3.FALLBACK_FRAC


def test_scalar_expectation_keeps_the_decoder_lines():
    """The rfc3164 decoder's own stderr line comes before the error line
    of a row both layouts reject."""
    data = b"<13>Oct 17 01:02:03 h x: ok\njust some words\n"
    out, errs = scalar_expectation(data, fmt="rfc3164")
    assert out and errs == [
        "Unable to parse the rfc3164 input: 'just some words'",
        "Malformed RFC3164 event: Invalid timestamp or hostname: "
        "[just some words]"]
    with pytest.raises(DecodeError):
        with contextlib.redirect_stderr(io.StringIO()):
            RFC3164Decoder().decode("just some words")
