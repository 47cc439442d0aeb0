"""The port's auto-detect input (``auto_tpu``) on the CPU, against the JAX
package.

- ``classify`` against the reference's on the classifier's edge rows
  (``corpus.AUTO_EDGE``), seeded rows over the bytes its decision table
  reads and the auto mix, with and without ``auto_extra_formats =
  ["jsonl"]``; and the plain version of AC (``classify_plain``) against
  the reference's jitted ``classify_device`` on the same rows packed at
  n ∈ {100, 512, 2048} rows and L ∈ {16, 19, 64, 512} bytes.
- ``classify_packed`` against the reference's on batches of fewer and of
  more than 512 rows (the reference's host rule and its device rule),
  and at 16 bytes wide, rows past the width included, with and without
  the jsonl leg; and on a batch that lies on the card it calls AC's
  wrapper at any row count and width (the wrapper stood in for by the
  plain version).
- ``decode_auto_packed`` (the Record path of a mixed batch) against the
  reference's, Record by Record; ``encode_auto_gelf_blocks`` against the
  reference's, batch for batch: block bytes and bounds, errors, ``emit``,
  ``error_rows``, and each leg's decline state (``route_state[format]``)
  through taken batches and one leg's declines, with the reference's
  device tiers compiling inline (its watchdog off).
- ``python -m flowgger_tpu_torch --device cpu`` against ``python -m
  flowgger_tpu`` on ``auto_tpu`` over line, NUL and syslen framing: the
  output bytes, stdout, stderr and exit code (stderr: the rfc3164
  decoder's own lines and the rest each in order, since the reference
  prints the first on its fetcher thread; syslen as a multiset, the
  reference prints its end-of-stream line early).
- The dns leg (``auto_extra_formats = ["dns"]``): ``classify`` and
  ``classify_packed`` against the reference's (its host rule under 512
  rows, its device rule with the numpy ``_extras_adjust`` overlay at and
  past 512) on batches with the dns mix and its classifier edges
  (``corpus.AUTO_DNS_EDGE``: BOM'd, ``{``- and ``<``-first dns-shaped
  rows, heads with a dot at an edge); ``encode_auto_gelf_blocks`` into
  GELF and LTSV against the reference's (host tiers); and both CLIs into
  GELF with the jsonl and dns legs (into LTSV:
  ``test_torch_ltsv_out_cli.py``).
"""

import contextlib
import io
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders.ltsv import LTSVDecoder as RLTSVDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.encoders.ltsv import LTSVEncoder as RLTSVEncoder
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import autodetect as RA

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import (AUTO_DNS_EDGE, AUTO_EDGE,
                                       make_auto_corpus, make_dns_corpus,
                                       make_gelf_tier_corpus,
                                       make_jsonl_corpus,
                                       make_ltsv_tier_corpus,
                                       make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, mask_wall_stamps,
                                       scalar_expectation, syslen_stream)
from flowgger_tpu_torch.decoders.ltsv import LTSVDecoder
from flowgger_tpu_torch.encoders import GelfEncoder, LTSVEncoder
from flowgger_tpu_torch.mergers import LineMerger, SyslenMerger
from flowgger_tpu_torch.tpu import autodetect as A
from flowgger_tpu_torch.tpu import pack

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
L = 256
T0 = time.time() - 1.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers (on a
    loaded box a pool of one thread a core runs the plain versions
    several times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fuzz_rows(n: int, seed: int):
    """Rows over the bytes the decision table reads."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"<>{}1 0129a\t:\xef\xbb\xbfx", np.uint8)
    return [alphabet[rng.integers(0, alphabet.size,
                                  int(rng.integers(0, 30)))].tobytes()
            for _ in range(n)]


def _rows(n: int, seed: int):
    rows = list(AUTO_EDGE) + _fuzz_rows(n // 3, seed)
    rows += make_auto_corpus(n, seed)[0] + make_jsonl_corpus(20, seed)[0]
    return rows[:n]


def test_classify_matches_reference():
    rows = _rows(1500, 11)
    for extras in ((), ("jsonl",)):
        got = [A.classify(r, extras) for r in rows]
        assert got == [RA.classify(r, extras) for r in rows]
        assert set(got) == ({0, 1, 2, 4} if extras else {0, 1, 2, 3})


@pytest.mark.parametrize("n", [100, 512, 2048])
@pytest.mark.parametrize("width", [16, 19, 64, 512])
def test_plain_classifier_matches_classify_device(n, width):
    rows = _rows(n, n + width)
    batch, lens, _, _, _, m = pack.pack_lines_2d(rows, width)
    want = np.asarray(RA._classify_device_jit(jnp.asarray(batch[:m]),
                                              jnp.asarray(lens[:m])))
    got = A.classify_plain(torch.from_numpy(batch[:m]),
                           torch.from_numpy(lens[:m]))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [300, 700])
@pytest.mark.parametrize("extras", [(), ("jsonl",)], ids=["four", "jsonl"])
def test_classify_packed_matches_reference(n, extras):
    rows = _rows(n, 5 * n)
    packed = pack.pack_lines_2d(rows, 64)
    assert (packed[4] > 64).any()
    want = RA.classify_packed(packed, extras=extras)
    got = A.classify_packed(packed, extras)
    assert got.dtype == np.int8 and np.array_equal(got, want)
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    assert np.array_equal(A.classify_packed(tp, extras), want)


@pytest.mark.parametrize("n", [100, 700])
@pytest.mark.parametrize("extras", [(), ("jsonl",)], ids=["four", "jsonl"])
def test_classify_packed_narrow_matches_reference(n, extras):
    """At a width under 19 bytes the reference classifies every row from
    its raw bytes; the port takes the plain version, then the raw bytes
    of the rows the width cut."""
    rows = _rows(n, 7 * n)
    packed = pack.pack_lines_2d(rows, 16)
    assert (packed[4] > 16).any() and (packed[4] <= 16).any()
    want = RA.classify_packed(packed, extras=extras)
    assert np.array_equal(A.classify_packed(packed, extras), want)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports lying on the card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("n,width", [(5, 16), (300, 64), (700, 19)])
def test_classify_packed_sends_a_card_batch_to_ac(monkeypatch, n, width):
    """A batch on the card is classified by AC's wrapper whatever its row
    count and width: no small batch goes to the host."""
    from flowgger_tpu_torch.tpu import kernels

    calls = []

    def wrapper(batch, lens, m, dns=False):
        assert lens.dtype == torch.int32 and not dns
        calls.append((tuple(batch.shape), m))
        return A.classify_plain(batch.as_subclass(torch.Tensor)[:m],
                                lens[:m])

    monkeypatch.setattr(kernels, "classify_auto_cuda", wrapper)
    rows = _rows(n, 3 * n + width)
    packed = pack.pack_lines_2d(rows, width)
    m = packed[5]
    card = (torch.from_numpy(packed[0]).as_subclass(_OnCard),
            torch.from_numpy(packed[1])) + packed[2:]
    got = A.classify_packed(card, ("jsonl",))
    assert calls == [(packed[0].shape, m)]
    assert np.array_equal(got, RA.classify_packed(packed, extras=("jsonl",)))


def _rec(r):
    if r is None:
        return None
    sd = None if r.sd is None else [
        (b.sd_id, [(n, v.kind, v.value) for n, v in b.pairs]) for b in r.sd]
    return (0.0 if r.ts >= T0 else r.ts, r.hostname, r.facility, r.severity,
            r.appname, r.procid, r.msgid, r.msg, r.full_msg, sd)


@pytest.mark.parametrize("extras", [(), ("jsonl",)], ids=["four", "jsonl"])
def test_decode_auto_packed_matches_reference(extras):
    rows = make_auto_corpus(500, 21)[0] + make_jsonl_corpus(40, 22)[0]
    packed = pack.pack_lines_2d(rows, L)
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    toml = '[input.ltsv_schema]\nstatus = "u64"\nreqtime = "f64"\n'
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(said), \
            contextlib.redirect_stderr(io.StringIO()):
        got = A.decode_auto_packed(tp, LTSVDecoder(Config.from_string(toml)),
                                   extras)
    with contextlib.redirect_stdout(rsaid), \
            contextlib.redirect_stderr(io.StringIO()):
        want = RA.decode_auto_packed(
            packed, L, RLTSVDecoder(RConfig.from_string(toml)), extras)
    assert [(_rec(r.record), r.error, r.line) for r in got] == \
        [(_rec(r.record), r.error, r.line) for r in want]
    assert said.getvalue() == rsaid.getvalue()
    assert sum(r.record is not None for r in got) > 400


def _clean(make, n, seed, kind):
    """Rows of one tier mix's tier kind short enough for OW at L = 256."""
    lines, kinds = make(4 * n, seed)
    return [ln for ln, k in zip(lines, kinds)
            if k == kind and len(ln) <= 140][:n]


def _block_batches():
    """Mixed batches: every leg's tier rows (each leg taken), then three
    with a quarter of the rfc3164 leg malformed (that leg declines three
    times and cools; the others are taken), then the cooled leg's
    window."""
    legs = [iter(_clean(make_tier_corpus, 400, 31, "tier")),
            iter(_clean(make_rfc3164_tier_corpus, 400, 32, "fast")),
            iter(_clean(make_ltsv_tier_corpus, 400, 33, "tier")),
            iter(_clean(make_gelf_tier_corpus, 400, 34, "tier"))]
    bad, kinds = make_rfc3164_corpus(6000, 35)
    bad = iter([ln for ln, k in zip(bad, kinds) if k == "malformed"])
    out = []
    for b in range(6):
        rows = []
        for i in range(40):
            rows.extend(next(leg) for leg in legs)
            if 1 <= b <= 3 and i % 4 == 0:
                rows.append(next(bad))
        out.append(rows)
    return out


_STATE = ("declines", "cooldown", "wide_cooldown")


def test_encode_auto_gelf_blocks_matches_reference(monkeypatch, capsys):
    # the reference's device tiers compile inline (no watchdog decline)
    monkeypatch.setenv("FLOWGGER_COMPILE_TIMEOUT_MS", "0")
    enc = GelfEncoder(Config.from_string(""))
    renc = RGelfEncoder(RConfig.from_string(""))
    dec = LTSVDecoder(Config.from_string(""))
    rdec = RLTSVDecoder(RConfig.from_string(""))
    state, rstate = {}, {}
    taken, n_errors = [], []
    for rows in _block_batches():
        packed = pack.pack_lines_2d(rows, L)
        tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
            + packed[2:]
        before = {k: dict(v) for k, v in state.items()}
        capsys.readouterr()
        got = A.encode_auto_gelf_blocks(tp, enc, SyslenMerger(), dec, state)
        said = capsys.readouterr()
        want = RA.encode_auto_gelf_blocks(packed, renc, RSyslenMerger(), rdec,
                                          rstate)
        rsaid = capsys.readouterr()
        assert got.block.data == want.block.data
        assert np.array_equal(got.block.bounds, want.block.bounds)
        assert np.array_equal(got.block.prefix_lens, want.block.prefix_lens)
        assert got.errors == want.errors
        assert np.array_equal(got.emit, want.emit)
        assert got.error_rows == want.error_rows
        assert got.fallback_rows == want.fallback_rows
        assert (said.out, said.err) == (rsaid.out, rsaid.err)
        for fmt in ("rfc5424", "rfc3164", "ltsv", "gelf"):
            assert {k: state[fmt].get(k, 0) for k in _STATE} == \
                {k: rstate[fmt].get(k, 0) for k in _STATE}, fmt
        n_errors.append(len(got.errors))
        taken.append(tuple(state[f].get("taken", 0)
                           - before.get(f, {}).get("taken", 0)
                           for f in ("rfc5424", "rfc3164", "ltsv", "gelf")))
    # every leg takes the clean batches; the rfc3164 leg declines three
    # times, then its cooldown keeps it off the tier
    assert taken == [(1, 1, 1, 1)] + [(1, 0, 1, 1)] * 5
    assert state["rfc3164"]["declined"] == 3
    assert state["rfc3164"]["cooled"] == 2
    assert n_errors[0] == 0 and min(n_errors[1:4]) > 0


def test_dns_leg_raises():
    """The extra legs' validation: the dns leg is accepted (a pipeline
    builds with it), an unknown format or a non-list raises, as in the
    reference."""
    pipeline.Pipeline(Config.from_string(
        '[input]\ntpu_encode_economics = false\n'
        'type = "stdin"\nformat = "auto_tpu"\n'
        'auto_extra_formats = ["dns"]\n[output]\ntype = "stdout"\n'),
        device="cpu")
    assert A.auto_extra_formats(Config.from_string(
        '[input]\nauto_extra_formats = ["dns", "jsonl"]\n')) == \
        RA.auto_extra_formats(RConfig.from_string(
            '[input]\nauto_extra_formats = ["dns", "jsonl"]\n')) == \
        ("jsonl", "dns")
    with pytest.raises(ConfigError, match="must be a list"):
        A.auto_extra_formats(Config.from_string(
            '[input]\nauto_extra_formats = "dns"\n'))
    with pytest.raises(ConfigError, match="unknown format"):
        A.auto_extra_formats(Config.from_string(
            '[input]\nauto_extra_formats = ["capnp"]\n'))
    assert A.auto_extra_formats(Config.from_string(
        '[input]\nauto_extra_formats = ["jsonl"]\n')) == ("jsonl",)


def _dns_rows(n: int, seed: int):
    rows = list(AUTO_DNS_EDGE) + list(AUTO_EDGE)
    rows += [b"\xef\xbb\xbf" + r for r in make_dns_corpus(10, seed)[0]]
    rows += [b"{" + r for r in make_dns_corpus(10, seed + 1)[0]]
    rows += make_auto_corpus(n, seed, dns=True)[0] + _fuzz_rows(n // 4,
                                                                 seed)
    return rows[:n]


DNS_EXTRAS = [("dns",), ("jsonl", "dns")]


def test_classify_dns_matches_reference():
    rows = _dns_rows(1500, 12)
    for extras in DNS_EXTRAS:
        got = [A.classify(r, extras) for r in rows]
        assert got == [RA.classify(r, extras) for r in rows]
        assert 5 in got


@pytest.mark.parametrize("n", [300, 700])
@pytest.mark.parametrize("extras", DNS_EXTRAS, ids=["dns", "jsonl_dns"])
@pytest.mark.parametrize("width", [64, 512])
def test_classify_packed_dns_matches_reference(n, extras, width):
    """The dns overlay computed by the classifier (AC's plain version)
    against the reference's classify_packed: its host rule below 512
    rows, its device rule and numpy overlay at and past 512; rows past
    the width from their raw bytes in both."""
    rows = _dns_rows(n, 3 * n + width)
    packed = pack.pack_lines_2d(rows, width)
    want = RA.classify_packed(packed, extras=extras)
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    got = A.classify_packed(tp, extras)
    assert np.array_equal(got, want) and (got == 5).sum() > 10


@pytest.mark.parametrize("output", ["gelf", "ltsv"])
def test_encode_auto_blocks_dns_matches_reference(monkeypatch, output):
    """A mixed batch with the dns leg into GELF and LTSV (host tiers on
    both sides): the block bytes, bounds, errors, emit and error rows of
    the reference's."""
    monkeypatch.setenv("FLOWGGER_DEVICE_ENCODE", "0")
    rows = _dns_rows(700, 13)
    packed = pack.pack_lines_2d(rows, L)
    tp = (torch.from_numpy(packed[0]), torch.from_numpy(packed[1])) \
        + packed[2:]
    cfg, rcfg = Config.from_string(""), RConfig.from_string("")
    enc, renc = ((LTSVEncoder(cfg), RLTSVEncoder(rcfg)) if output == "ltsv"
                 else (GelfEncoder(cfg), RGelfEncoder(rcfg)))
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(said), \
            contextlib.redirect_stderr(io.StringIO()):
        got = A.encode_auto_gelf_blocks(tp, enc, SyslenMerger(),
                                        LTSVDecoder(cfg), {}, ("dns",))
    with contextlib.redirect_stdout(rsaid), \
            contextlib.redirect_stderr(io.StringIO()):
        want = RA.encode_auto_gelf_blocks(packed, renc, RSyslenMerger(),
                                          RLTSVDecoder(rcfg), {},
                                          extras=("dns",))
    assert (mask_wall_stamps(got.block.data, T0)
            == mask_wall_stamps(want.block.data, T0))
    assert np.array_equal(got.block.bounds, want.block.bounds)
    assert got.errors == want.errors and got.error_rows == want.error_rows
    assert np.array_equal(got.emit, want.emit)
    assert said.getvalue() == rsaid.getvalue()


def _split(lines):
    """The rfc3164 decoder's own lines and the rest, each in order."""
    own = "Unable to parse the rfc3164 input: "
    return ([x for x in lines if x.startswith(own)],
            [x for x in lines if not x.startswith(own)])


def _run(pkg, cfg, data):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    if pkg == "flowgger_tpu":
        env["FLOWGGER_DEVICE_ENCODE"] = "0"
    extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=600)


@pytest.mark.parametrize("framing", ["line", "nul", "syslen", "line_dns"])
def test_cli_auto_matches_jax_package(tmp_path, framing):
    """One auto_tpu config through both CLIs: the port runs its whole
    ladder (on the CPU the plain versions of AC, the decodes and the
    split tiers, the host tier, the oracle), the reference its host tier
    (its device compiles on the CPU are not what this holds).  The NUL
    run adds the jsonl leg (``auto_extra_formats = ["jsonl"]``) and
    JSON-lines rows; line_dns the jsonl and dns legs, their rows and the
    dns classifier's edges."""
    lines = make_auto_corpus(600, seed=71)[0] \
        + make_auto_corpus(500, seed=72, tier=True)[0]
    extras = ""
    if framing == "nul":
        lines += make_jsonl_corpus(150, seed=73)[0]
        extras = 'auto_extra_formats = ["jsonl"]\n'
    if framing == "line_dns":
        framing = "line"
        lines = (make_auto_corpus(500, seed=74, dns=True)[0]
                 + make_jsonl_corpus(100, seed=75)[0])
        extras = 'auto_extra_formats = ["jsonl", "dns"]\n'

    if framing == "syslen":
        data = syslen_stream(lines)
    else:
        sep = b"\0" if framing == "nul" else b"\n"
        data = sep.join(lines) + sep + b"time:1\thost:tail\tpartial:1"
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "auto_tpu"\n'
            f'framing = "{framing}"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 512\n' + extras
            + '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\nframing = "line"\n')
        proc = _run(pkg, cfg, data)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (mask_wall_stamps(out.read_bytes(), T0), proc.stdout,
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[0] == ref[0] and len(port[0]) > 100000
    assert port[1] == ref[1] and b"Missing value" in port[1]
    if framing == "syslen":
        assert sorted(port[2]) == sorted(ref[2]) and port[2]
    else:
        # the reference prints the rfc3164 decoder's own lines as a
        # batch's legs encode, on its fetcher thread, while the batch
        # before prints its error lines: each kind is in order, the two
        # interleave as the threads run
        assert _split(port[2]) == _split(ref[2]) and port[2]
    exp, errs = scalar_expectation(data, framing, merger=LineMerger(),
                                   fmt="auto",
                                   config=Config.from_string(
                                       "[input]\n" + extras))
    assert port[0] == mask_wall_stamps(exp, T0)
    assert sorted(port[2]) == sorted(errs)
