"""The port's GELF input on the CPU against the JAX package: the scalar
decoder, the flat structural index (K5's plain version at ``nested = 0``)
at 8, 16 and 24 fields channel for channel, the decode fetch with its
24-field rescue, the host block encoder under every merger, the configs
the slice refuses, one CLI pair end to end and one on the Record path
(a gelf_extra).  Every comparison is
exact; GELF rows without a timestamp are stamped with the wall clock in
both packages, so those stamps are masked (``corpus.mask_wall_stamps``).
One batch geometry ([64, 256]) keeps the JAX side at a few compiled
programs."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as JConfig
from flowgger_tpu.decoders import DecodeError as JDecodeError
from flowgger_tpu.decoders.gelf import GelfDecoder as JGelfDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as JGelfEncoder
from flowgger_tpu.mergers import LineMerger as JLineMerger
from flowgger_tpu.mergers import NulMerger as JNulMerger
from flowgger_tpu.mergers import SyslenMerger as JSyslenMerger
from flowgger_tpu.tpu import encode_gelf_gelf_block as JB
from flowgger_tpu.tpu import gelf as JG
from flowgger_tpu.tpu import jsonidx as JI
from flowgger_tpu.tpu import materialize_gelf as JM
from flowgger_tpu.tpu import rfc5424 as JR
from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import (make_gelf_corpus, make_gelf_tier_corpus,
                                       mask_wall_stamps, scalar_expectation)
from flowgger_tpu_torch.decoders import DecodeError, GelfDecoder
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import gelf as TG
from flowgger_tpu_torch.tpu import jsonidx as TI
from flowgger_tpu_torch.tpu import materialize_gelf as TM
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.encode_gelf_gelf_block import (
    encode_gelf_gelf_block)

ROOT = Path(__file__).resolve().parent.parent
L = 256
N = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(n):
    return ",".join(f'"k{i:02d}":{i}' for i in range(n))


# the reference's GELF edge rows: specials of every type, the level and
# version screens, numbers the tier must leave to the oracle, escapes,
# nested values, field budgets (8, 16, 24 and past), backslash runs on
# both sides of the escape cap, whitespace past the lookaround window,
# non-ASCII and broken JSON
EDGE_LINES = [
    '{"version":"1.1","host":"h","short_message":"m","timestamp":1.5,'
    '"level":3,"_a":"x","b":2,"c":true,"d":null,"e":false}',
    '{"host":"h","timestamp":1}',
    '{"host":"","timestamp":0,"version":"1.0"}',
    '{"host":"h","timestamp":-12.25,"level":0}',
    '{"host":"h","timestamp":"1"}',
    '{"host":1,"timestamp":1}',
    '{"host":"h","timestamp":1,"level":8}',
    '{"host":"h","timestamp":1,"level":-1}',
    '{"host":"h","timestamp":1,"level":1.0}',
    '{"host":"h","timestamp":1,"version":"2.0"}',
    '{"host":"h","timestamp":1,"version":1.1}',
    '{"host":"h","timestamp":1,"short_message":3}',
    '{"host":"h","timestamp":1,"full_message":"a\\nb"}',
    '{"host":"h","timestamp":01}',
    '{"host":"h","timestamp":1.}',
    '{"host":"h","timestamp":-0}',
    '{"host":"h","timestamp":1e3}',
    '{"host":"h","timestamp":1234567890123456.7}',
    '{"host":"h","timestamp":9007199254740993}',
    '{"host":"h","timestamp":1,"n":12345678901234567890}',
    '{"host":"h","timestamp":1,"n":-9223372036854775809}',
    '{"host":"h","timestamp":1,"f":1.25,"g":-0}',
    '{"host":"h","timestamp":1,"_x":1,"x":2}',
    '{"host":"h","timestamp":1,"abcdefghij":1,"abcdefghik":2}',
    '{"host":"h","timestamp":1,"abcdefgh":1,"abcdefghi":2}',
    '{"host":"h","host":"i","timestamp":1}',
    '{"host":"h","timestamp":1,"k":"v","k":"w"}',
    '{"host":"h","timestamp":1,"o":{"a":1}}',
    '{"host":"h","timestamp":1,"a":[1,2]}',
    '{"host":"h","timestamp":1,"s":"caf\\u00e9"}',
    '{"host":"h","timestamp":1,"s":"café"}',
    '{"ho\\u0073t":"h","timestamp":1}',
    '{"host":"h"}',
    '{"timestamp":1}',
    '{ "host" : "h" , "timestamp" : 2 }',
    '{"host":"h",         "timestamp":1}',
    '{"host":"h","timestamp":1}}',
    '{"host":"h","timestamp":1',
    "[1,2]",
    "not json",
    "",
    '{"host":"h","timestamp":1,' + _keys(7) + "}",
    '{"host":"h","timestamp":1,' + _keys(14) + "}",
    '{"host":"h","timestamp":1,' + _keys(22) + "}",
    '{"host":"h","timestamp":1,' + _keys(23) + "}",
] + [
    '{"host":"h","timestamp":1,"s":"' + "\\" * n + 'q"}' for n in (16, 17)
] + [
    '{"host":"h","timestamp":1,"s":"' + "\\" * n + '"}' for n in (14, 16)
]


def _raw():
    raw = [ln.encode() for ln in EDGE_LINES]
    raw += make_gelf_tier_corpus(6, seed=3)[0]
    raw += make_gelf_corpus(N - len(raw), seed=4)[0]
    assert len(raw) == N
    return raw


RAW = _raw()
BATCH, LENS, CHUNK, STARTS, ORIG, NREAL = pack.pack_lines_2d(RAW, L)
BATCH, LENS = BATCH[:N], LENS[:N]
# rows without a 16-backslash run: the JAX package's XLA tier caps
# backslash runs in its parity ladder (its Pallas tier and the port use
# the exact NFA machine), so channels other than ok and n_fields may
# differ on the rest
EXACT = np.array([b"\\" * JR.ESC_RUN_CAP not in r for r in RAW])


def _assert_matches_parity_tier(ref, got, exact):
    assert not exact.all()
    assert set(got) == set(ref)
    for k, v in ref.items():
        a, b = np.asarray(v), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in ("ok", "n_fields"):
            assert np.array_equal(a, b), k
        assert np.array_equal(a[exact], b[exact]), (
            k, np.argwhere(a[exact] != b[exact])[:4].tolist())


def test_shared_constants_match_jax():
    """The value classes, field budgets and error text the port copies."""
    assert (TI.VT_STRING, TI.VT_NUMBER, TI.VT_TRUE, TI.VT_FALSE,
            TI.VT_NULL) == (JG.VT_STRING, JG.VT_NUMBER, JG.VT_TRUE,
                            JG.VT_FALSE, JG.VT_NULL)
    assert TI.WS_WINDOW == JI.WS_WINDOW
    assert (TG.DEFAULT_MAX_FIELDS, TG.RESCUE_MAX_FIELDS) == (
        JG.DEFAULT_MAX_FIELDS, JG.RESCUE_MAX_FIELDS)
    assert TM._PARSE_ERR == JM._PARSE_ERR


def _records_equal(a, b):
    return (a.ts, a.hostname, a.severity, a.msg, a.full_msg) == (
        b.ts, b.hostname, b.severity, b.msg, b.full_msg) \
        and [(p.sd_id, [(n, repr(v)) for n, v in p.pairs])
             for p in (a.sd or [])] == [
            (p.sd_id, [(n, repr(v)) for n, v in p.pairs]) for p in (b.sd or [])]


def test_decoder_matches_jax_decoder():
    """The port's scalar oracle decodes every line as the JAX package's
    does: the record (the stamp of a row without a timestamp apart) or
    the error message; the scalar oracle row carries the same."""
    for raw in RAW:
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            continue
        try:
            want = ("rec", JGelfDecoder().decode(line))
        except JDecodeError as e:
            want = ("err", str(e))
        try:
            got = ("rec", GelfDecoder().decode(line))
        except DecodeError as e:
            got = ("err", str(e))
        assert got[0] == want[0], line
        if got[0] == "err":
            assert got[1] == want[1], line
            assert TM._scalar_gelf(line).error == got[1]
            continue
        if '"timestamp"' not in line:
            got[1].ts = want[1].ts = 0.0
        assert _records_equal(got[1], want[1]), line


_JDEC = {}


def _jax_decode(F):
    """The JAX package's decode_gelf at F fields, one compile a width."""
    if F not in _JDEC:
        _JDEC[F] = {k: np.asarray(v) for k, v in
                    JG.decode_gelf_jit(BATCH, LENS, max_fields=F).items()}
    return _JDEC[F]


@pytest.mark.parametrize("F", [8, 16, 24])
def test_decode_gelf_matches_jax(F):
    """The flat structural index at 8, 16 (the device tier's wide probe)
    and 24 fields (the rescue) against the JAX package's ``decode_gelf``:
    ok and n_fields on every row, every channel on every row without a
    16-backslash run."""
    got = TG.decode_gelf(torch.from_numpy(BATCH), torch.from_numpy(LENS), F)
    _assert_matches_parity_tier(_jax_decode(F),
                                {k: v.numpy() for k, v in got.items()},
                                EXACT)
    ok = got["ok"].numpy()
    assert ok.any() and not ok.all()
    if F == 8:
        nf = got["n_fields"].numpy()
        assert (~ok & (nf > 8) & (nf <= 24)).any()


def test_flat_index_equals_the_nested_one_where_both_accept():
    """The two modes of the plain index agree on a row with no brackets;
    the flat mode flags any bracket outside a string."""
    bt, lt = torch.from_numpy(BATCH), torch.from_numpy(LENS)
    flat = TI.structural_index(bt, lt, 8, nested=0)
    nested = TI.structural_index(bt, lt, 8, nested=4)
    brackets = np.array([b"[" in r or b"]" in r for r in RAW])
    both = flat["ok"].numpy() & nested["ok"].numpy()
    assert both.any() and not (flat["ok"].numpy() & brackets).any()
    for k in flat:
        assert np.array_equal(flat[k].numpy()[both], nested[k].numpy()[both])


def test_fetch_with_rescue_matches_jax():
    """decode_gelf_fetch re-dispatches the 9-24-key rows at 24 fields and
    widens the field channels, exactly as the JAX package does."""
    ref = JG.decode_gelf_fetch(JG.decode_gelf_submit(BATCH, LENS))
    got = TG.decode_gelf_fetch(TG.decode_gelf_submit(
        torch.from_numpy(BATCH), torch.from_numpy(LENS)))
    assert got["key_start"].shape == (N, TG.RESCUE_MAX_FIELDS)
    _assert_matches_parity_tier(ref, got, EXACT)
    assert (got["ok"] & (got["n_fields"] > TG.DEFAULT_MAX_FIELDS)).any()


MERGERS = [(NulMerger(), JNulMerger()), (LineMerger(), JLineMerger()),
           (SyslenMerger(), JSyslenMerger()), (None, None)]


@pytest.mark.parametrize("merger,jmerger", MERGERS,
                         ids=["nul", "line", "syslen", "none"])
def test_gelf_gelf_block_matches_reference(merger, jmerger):
    """encode_gelf_gelf_block over the port's fetch equals the JAX
    package's block encoder over its own fetch, byte for byte, and (for
    the merger the scalar path frames with) the scalar decoder +
    GelfEncoder row for row: errors in order, oracle rows counted, the
    wall-clock stamps of rows without a timestamp masked."""
    lines = [r for r in RAW if b"\\" * 16 not in r]
    if isinstance(merger, SyslenMerger):
        # a masked stamp would leave its row's length prefix apart
        lines = [r for r in lines if b'"timestamp"' in r
                 or not r.startswith(b"{")]
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(lines, L)
    t0 = time.time() - 1.0
    host = TG.decode_gelf_fetch(TG.decode_gelf_submit(
        torch.from_numpy(batch), torch.from_numpy(lens)))
    res = encode_gelf_gelf_block(chunk, starts, orig, host, n, L,
                                 GelfEncoder(Config.from_string("")), merger)
    jhost = JG.decode_gelf_fetch(JG.decode_gelf_submit(batch, lens))
    jres = JB.encode_gelf_gelf_block(chunk, starts, orig, jhost, n, L,
                                     JGelfEncoder(JConfig.from_string("")),
                                     jmerger)
    assert (mask_wall_stamps(res.block.data, t0)
            == mask_wall_stamps(jres.block.data, t0))
    assert res.errors == jres.errors
    assert res.fallback_rows == jres.fallback_rows
    assert 0 < res.fallback_rows < n
    if merger is not None:
        exp, errs = scalar_expectation(b"\n".join(lines) + b"\n",
                                       merger=merger, fmt="gelf")
        assert (mask_wall_stamps(res.block.data, t0)
                == mask_wall_stamps(exp, t0))
        assert [f"{e}: [{ln.strip()}]" if e != "__utf8__"
                else "Invalid UTF-8 input" for e, ln in res.errors] == errs
    extra = GelfEncoder(Config.from_string('[output.gelf_extra]\nx = "y"\n'))
    assert encode_gelf_gelf_block(chunk, starts, orig, host, n, L, extra,
                                  merger) is None


@pytest.mark.parametrize("text,words", [
    ('[input]\ntpu_encode_economics = false\n'
     'type = "stdin"\nformat = "gelf_tpu"\n[output]\n'
     'type = "kafka"\nformat = "capnp"\n',
     ("output.kafka_brokers is required",)),
], ids=["capnp_output"])
def test_gelf_configs_the_slice_refuses(text, words):
    """gelf_tpu into capnp over kafka (the reference's default for capnp)
    without brokers raises the reference's ConfigError (the Kafka sink
    runs since the sinks slice: test_torch_sinks.py).  (A gelf_extra,
    which takes the reference's Record path, runs:
    test_cli_gelf_extra_matches_jax_package; LTSV output runs:
    test_torch_ltsv_out_cli.py; RFC5424 output:
    test_torch_rfc5424_out_cli.py; capnp into a file or stdout:
    test_torch_capnp_out_more_cli.py.)"""
    with pytest.raises(ConfigError) as exc:
        pipeline.Pipeline(Config.from_string(text), device="cpu")
    for w in words:
        assert w in str(exc.value)


def _run(pkg, cfg, data):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               FLOWGGER_DEVICE_ENCODE="0", PYTHONPATH=str(ROOT))
    extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=600)


def test_cli_gelf_matches_jax_package(tmp_path):
    """One gelf_tpu → GELF configuration through both CLIs, line framing:
    the same output bytes and stderr lines.  The port runs its whole
    ladder (on the CPU the plain versions of FG, EG and the flat index,
    the host tier, the oracle), the reference its host tier; rows
    without a timestamp are stamped with the wall clock on both sides
    and masked."""
    lines = (make_gelf_tier_corpus(150, seed=41)[0]
             + make_gelf_corpus(250, seed=42)[0]
             + [r for r in RAW if b"\n" not in r])
    data = b"\n".join(lines) + b'\n{"host":"tail","timestamp":1'
    outs = {}
    t0 = time.time() - 1.0
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "gelf_tpu"\n'
            'framing = "line"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 128\n'
            + ('tpu_fuse = "off"\n' if pkg == "flowgger_tpu" else "")
            + '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\n')
        proc = _run(pkg, cfg, data)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (mask_wall_stamps(out.read_bytes(), t0),
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[0] == ref[0] and b'"timestamp":0,' in port[0]
    assert port[1] == ref[1] and port[1]


def test_cli_gelf_extra_matches_jax_package(tmp_path):
    """gelf_tpu with a gelf_extra takes the Record path in both packages
    (the block encoder and the device tiers decline any extra): the same
    output bytes, stdout and stderr (the start-up notice first) through
    both CLIs, exit code 0."""
    lines = make_gelf_corpus(300, seed=44)[0] + [
        r for r in RAW if b"\n" not in r]
    data = b"\n".join(lines) + b'\n{"host":"tail","timestamp":1'
    outs = {}
    t0 = time.time() - 1.0
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "gelf_tpu"\n'
            'framing = "line"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 128\n'
            '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\n[output.gelf_extra]\nx = "y"\n'
            'short_message = "over"\n')
        proc = _run(pkg, cfg, data)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (mask_wall_stamps(out.read_bytes(), t0), proc.stdout,
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port == ref
    assert b'"short_message":"over"' in port[0] and b'"x":"y"' in port[0]
    assert port[2][0] == (
        "flowgger-tpu: columnar block route disabled for format 'gelf' "
        "(output.gelf_extra is set); throughput falls to the per-record "
        "path (~30x slower)")
