"""The port's LTSV input on the CPU, against the JAX package: the Apache
date parse and the scalar decoder (the oracle) with its schema and
suffix tables from the same TOML, the plain decode (L1's plain version)
on every channel, the host block encoder byte for byte (untyped and with
a typed schema of at most 8 keys), the config gates (every schema and
``gelf_extra`` config runs; the block encoders of both packages decline
the same batches), and ``python -m flowgger_tpu_torch`` against
``python -m flowgger_tpu`` on ltsv configs across line, NUL and syslen
framing, ``tpu_fuse`` auto and off, a static ``gelf_extra`` and a typed
schema, and on the four configs that take the Record path (a 10-key
typed schema, a suffix for a schema type, ``gelf_extra`` keys this
layout cannot place): the same bytes, stderr lines and stdout notices.

Every jitted reference call shares one batch shape ([256, 256]); the
decode compiles once.  Exact on every channel and byte.
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
from flowgger_tpu.config import ConfigError as RConfigError
from flowgger_tpu.decoders.ltsv import LTSVDecoder as RDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import encode_ltsv_gelf_block as RBL
from flowgger_tpu.tpu import ltsv as RL
from flowgger_tpu.utils import timeparse as RTP

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import (LTSV_SCHEMA_10, make_ltsv_corpus,
                                       make_ltsv_tier_corpus,
                                       scalar_expectation, syslen_stream)
from flowgger_tpu_torch.decoders.ltsv import LTSVDecoder
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import encode_ltsv_gelf_block as BL
from flowgger_tpu_torch.tpu import ltsv as L1
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.utils import timeparse as TP

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
L = 256
EXTRAS = (("a-first", "x"), ("kind", "h"), ("level2", "y"), ("zzz", "last"))
SCHEMA = ('[input.ltsv_schema]\nstatus = "u64"\nsize = "i64"\n'
          'reqtime = "f64"\ncache = "string"\nok = "bool"\n')


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the reference tests' rows (tests/test_decoder_ltsv.py and the block
# route's), and the edges of the device decode: both stamp forms, the
# Apache one bracketed and not, signs and digit counts, bad dates and
# offsets, level forms, missing, repeated and colon-less parts, more than
# 24 parts, typed values canonical and not, escapes, control bytes,
# non-ASCII and empty rows
HAND = [
    "time:[10/Oct/2000:13:55:36.3 -0700]\tdone:true\tscore:-1\tmean:0.42\t"
    "counter:42\tlevel:3\thost:testhostname\tname1:value1\t"
    "name 2: value 2\tn3:v3\tmessage:this is a test",
    "time:1438790025.99\thost:h\tname1:value1",
    "time:[2015-08-05T15:53:45.637824Z]\thost:h\tn:v",
    "time:[5/Aug/2015:15:53:45.637824 -0000]\thost:h\tn:v",
    "time:1.5\thost:h\tcounter_u64:42",
    "host:h\tx:1", "time:1.5\tx:1", "time:1.5\thost:h\tlevel:9",
    "time:1.5\thost:h\tlevel:abc", "time:bogus\thost:h",
    "time:1.5\thost:h\tdone:yes", "time:1.5\thost:h\tcounter:-1",
    "time:1.5\thost:h\tscore:1.5", "time:1.5\thost:h\tmean:xyz",
    "host:web1\ttime:2015-08-05T15:53:45Z\tmessage:hello ltsv",
    "host:web2\ttime:1438790025.42\tzeta:z\talpha:a\tmessage:sorted",
    "host:w\ttime:1438790025\tlevel:3\tuser:bob\tmessage:lvl",
    "host:w\ttime:2015-08-05T15:53:45.25Z",
    'host:w\ttime:1438790025\tk:v with "quote"\tmessage:esc',
    "host:w\ttime:1438790025\tnovalue\tmessage:notice",
    "host:w\ttime:1438790025\tdup:a\tdup:b\tmessage:dups",
    "host:w\ttime:1438790025\tmessage:unicodé",
    "plain not ltsv at all",
    "time:-1438790025.42\thost:web", "time:+12345678901234567.5\thost:x",
    "time:9007199254740993\thost:x", "time:1e9\thost:x", "time:inf\thost:x",
    "time:1_0\thost:x", "time: 1\thost:x",
    "host:a\thost:b\ttime:1",
    "time:1\thost:h\t" + "\t".join(f"k{i}:v" for i in range(30)),
    "time:1.2.3\thost:h", "time:.5\thost:h", "time:5.\thost:h",
    "time:\thost:h", "time:[]\thost:h",
    "level:12345678901234\ttime:1\thost:h", "level:007\ttime:1\thost:h",
    "level:+3\ttime:1\thost:h", "level:\ttime:1\thost:h",
    "time:2016-02-29T23:59:59.123456789-11:45\thost:h",
    "time:2015-13-05T15:53:45Z\thost:h", "time:2015-08-05T15:53:45.Z\thost:h",
    "time:2015-08-05t15:53:45z\thost:h",
    "time:2015-08-05T15:53:45+24:00\thost:h",
    "time:2015-08-05T15:53:45.1234567891Z\thost:h",
    "a:b:c\tx::\t:y\ttime:1\thost:h\t", "", "\t\t\t",
    "time:1\thost:h\tstatus:200\tsize:-12\treqtime:0.5\tok:true",
    "time:1\thost:h\tstatus:0200\tsize:-0\treqtime:0.50\tok:True",
    "time:1\thost:h\tstatus:18446744073709551616\treqtime:1e300",
    "time:1\thost:h\tbell:x\x07y\tmessage:tab\\tesc \\\\",
    "time:1\thost:\tmessage:",
]


def _lines():
    rng = np.random.default_rng(81)
    alpha = list(b"timehostmessagelevel:\t0123456789.-+TZ[]/ ")
    rand = [rng.choice(alpha, int(rng.integers(0, 80)))
            .astype(np.uint8).tobytes() for _ in range(40)]
    tier, _ = make_ltsv_tier_corpus(60, seed=82)
    mixed, _ = make_ltsv_corpus(100, seed=83)
    return [h.encode() for h in HAND] + rand + tier + mixed


def _packed(lines=None):
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(
        _lines() if lines is None else lines, L)
    assert batch.shape == (256, L)
    return batch, lens, chunk, starts, orig, n


def _ref_decode(batch, lens):
    return {k: np.asarray(v) for k, v in RL.decode_ltsv_jit(
        jnp.asarray(batch), jnp.asarray(lens)).items()}


_CONFIGS = [
    "",
    '[input]\n' + SCHEMA,
    '[input.ltsv_schema]\ncounter = "u64"\nscore = "i64"\n'
    '[input.ltsv_suffixes]\nu64 = "_u64"\nI64 = "_i64"\nF64 = "_f64"\n'
    'Bool = "_bool"\n',
    '[input.ltsv_schema]\nx = "u128"\n',
    '[input.ltsv_suffixes]\nstring = "_s"\n',
    '[input.ltsv_suffixes]\nu32 = "_s"\n',
    '[input.ltsv_schema]\nx = 3\n',
    '[input.ltsv_suffixes]\nu64 = 3\n',
    '[input]\nltsv_schema = "x"\n',
]


def test_timeparse_matches_reference():
    for s in ("10/Oct/2000:13:55:36 -0700", "10/Oct/2000:13:55:36.3 -0700",
              "5/Aug/2015:15:53:45.637824 -0000", "29/Feb/2016:00:00:00 +1400",
              "29/Feb/2015:00:00:00 +0000", "1/Foo/2000:00:00:00 +0000",
              "1/Jan/2000:00:00:00 0000", "1/Jan/2000:24:00:00 +0000",
              "1/Jan/2000:00:00:00.1234567891 +0000", "1/Jan/2000 +0000",
              "x", ""):
        try:
            want = RTP.parse_english_time(s)
        except ValueError:
            with pytest.raises(ValueError):
                TP.parse_english_time(s)
            continue
        assert TP.parse_english_time(s) == want


@pytest.mark.parametrize("toml", range(len(_CONFIGS)))
def test_scalar_decoder_matches_reference(toml):
    """The oracle with the same TOML: the same schema and suffix tables
    (or the same ConfigError), then the same record, error and stdout
    notice for every row."""
    text = _CONFIGS[toml]
    try:
        ref = RDecoder(RConfig.from_string(text))
    except RConfigError as e:
        with pytest.raises(ConfigError) as exc:
            LTSVDecoder(Config.from_string(text))
        assert str(exc.value) == str(e)
        return
    mine = LTSVDecoder(Config.from_string(text))
    assert (mine.schema, mine.suffixes) == (ref.schema, ref.suffixes)
    for raw in _lines():
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            continue
        out = []
        for dec in (mine, ref):
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                try:
                    r = dec.decode(line)
                    pairs = [(k, v.kind, v.value) for k, v in
                             (r.sd[0].pairs if r.sd else [])]
                    out.append((r.ts, r.hostname, r.severity, r.msg,
                                r.full_msg, pairs, said.getvalue()))
                except Exception as e:  # noqa: BLE001 - either DecodeError
                    out.append((type(e).__name__, str(e), said.getvalue()))
        assert out[0] == out[1], line


def test_plain_decode_matches_jax():
    """L1's plain version against the reference's decode_ltsv_jit on
    every channel of every row (padding rows included)."""
    batch, lens, *_ = _packed()
    got = L1.decode_ltsv(torch.from_numpy(batch), torch.from_numpy(lens))
    ref = _ref_decode(batch, lens)
    assert set(got) == set(ref)
    for k, v in ref.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert (g == v).all(), k
    assert 0.2 < ref["ok"].mean() < 0.9
    assert {0, 1, 2} <= set(ref["ts_kind"].tolist())
    # padding rows: the plain version's n gives the reference's values
    n = 200
    cut = L1.decode_ltsv(torch.from_numpy(batch), torch.from_numpy(lens), n=n)
    empty = _ref_decode(np.zeros((256, L), np.uint8), np.zeros(256, np.int32))
    for k, v in cut.items():
        assert (v.numpy()[n:] == empty[k][n:]).all(), k


def test_fetch_unpacks_the_kernel_layout():
    """decode_ltsv_fetch of the kernel's packed [94, N] layout gives the
    plain version's channels and dtypes."""
    batch, lens, *_ = _packed()
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    plain = L1.decode_ltsv(bt, lt)
    rows = [plain[k].to(torch.int32) for k in L1.KEYS_1D]
    rows += [plain[k].t() for k in L1.KEYS_PART]
    packed = torch.cat([torch.stack(rows[:len(L1.KEYS_1D)])]
                       + rows[len(L1.KEYS_1D):])
    assert packed.shape == (L1.n_channels(), 256)
    got = L1.decode_ltsv_fetch((packed, bt, lt))
    for k, v in plain.items():
        assert got[k].dtype == v.numpy().dtype and (got[k] == v.numpy()).all()


_MERGERS = {"nul": (NulMerger(), RNulMerger()),
            "line": (LineMerger(), RLineMerger()),
            "syslen": (SyslenMerger(), RSyslenMerger()),
            "none": (None, None)}


@pytest.mark.parametrize("merger", list(_MERGERS))
@pytest.mark.parametrize("cfg", ["plain", "extras", "schema"])
def test_block_encoder_matches_reference(merger, cfg):
    """encode_ltsv_gelf_block over the same channels equals the
    reference's block encoder (bytes, errors, oracle rows, stdout
    notices) and the scalar path, untyped, with static extras and with a
    typed schema of at most 8 keys."""
    batch, lens, chunk, starts, orig, n = _packed()
    ref_dec = _ref_decode(batch, lens)
    toml = {"plain": "", "schema": "[input]\n" + SCHEMA,
            "extras": "[output.gelf_extra]\n" + "".join(
                f'{k} = "{v}"\n' for k, v in EXTRAS)}[cfg]
    config = Config.from_string(toml)
    enc, renc = GelfEncoder(config), RGelfEncoder(RConfig.from_string(toml))
    dec, rdec = LTSVDecoder(config), RDecoder(RConfig.from_string(toml))
    m, rm = _MERGERS[merger]
    said, rsaid = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(said):
        got = BL.encode_ltsv_gelf_block(chunk, starts, orig, ref_dec, n, L,
                                        enc, m, dec)
    with contextlib.redirect_stdout(rsaid):
        want = RBL.encode_ltsv_gelf_block(chunk, starts, orig, ref_dec, n, L,
                                          renc, rm, rdec)
    assert got.block.data == want.block.data
    assert got.errors == want.errors
    assert got.fallback_rows == want.fallback_rows > 10
    assert said.getvalue() == rsaid.getvalue() and said.getvalue()
    notices = []
    exp, _ = scalar_expectation(b"\0".join(_lines()) + b"\0", "nul",
                                config=config, merger=m, fmt="ltsv",
                                notices=notices)
    assert got.block.data == exp
    assert notices == said.getvalue().splitlines()
    assert BL.gelf_extra_consts_ltsv(list(EXTRAS)) == \
        RBL.gelf_extra_consts_ltsv(list(EXTRAS))


# the configs of the Record path: batch by batch (the block encoder
# declines: "batch") or for the whole run (the block route can never
# engage, a start-up notice: "run")
RECORD_PATH = {
    "schema10": (LTSV_SCHEMA_10, "batch"),
    "suffix": ('[input.ltsv_schema]\nstatus = "u64"\n[input.ltsv_suffixes]\n'
               'u64 = "_n"\n', "batch"),
    "dyn_extra": ('[output.gelf_extra]\n_dyn = "x"\n', "run"),
    "host_extra": ('[output.gelf_extra]\nhost = "x"\n', "run"),
}


@pytest.mark.parametrize("toml,record_path", [
    ('[input.ltsv_schema]\n' + "".join(f'k{i} = "u64"\n' for i in range(9)),
     "batch"),
    RECORD_PATH["suffix"],
    ('[input.ltsv_schema]\nstatus = "u64"\n[input.ltsv_suffixes]\n'
     'i64 = "_n"\n', None),
    ('[input.ltsv_schema]\n' + "".join(f'k{i} = "u64"\n' for i in range(8)),
     None),
    RECORD_PATH["dyn_extra"],
    RECORD_PATH["host_extra"],
])
def test_config_gates(toml, record_path):
    """ltsv_tpu runs every schema and gelf_extra config.  Two take the
    Record path batch by batch, as the reference's do: its block encoder
    and the port's both decline the batch (more than 8 schema keys; a
    suffix for a type the schema uses); gelf_extra keys this layout
    cannot place keep the block route off for the whole run (neither
    package's block encoder takes them).  The CLI pairs of the four:
    test_cli_ltsv_record_path_matches_jax_package."""
    text = ('[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "ltsv_tpu"\n'
            '[output]\ntype = "stdout"\n' + toml)
    config = Config.from_string(text)
    pipeline.Pipeline(config, device="cpu")
    batch, lens, chunk, starts, orig, n = _packed()
    host = L1.decode_ltsv_fetch(L1.decode_ltsv_submit(
        torch.from_numpy(batch), torch.from_numpy(lens), n))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        got = BL.encode_ltsv_gelf_block(
            chunk, starts, orig, host, n, L, GelfEncoder(config),
            NulMerger(), LTSVDecoder(config))
        want = RBL.encode_ltsv_gelf_block(
            chunk, starts, orig, _ref_decode(batch, lens), n, L,
            RGelfEncoder(RConfig.from_string(text)), RNulMerger(),
            RDecoder(RConfig.from_string(text)))
    assert (got is None) == (want is None) == (record_path is not None)
    if got is not None:
        assert got.block.data == want.block.data


def _run(pkg, cfg, data, env_extra):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT),
               **env_extra)
    extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=300)


@pytest.mark.parametrize("framing,fuse,toml", [
    ("line", "auto", '[output.gelf_extra]\nzone = "eu"\n'),
    ("nul", "off", "[input]\n" + SCHEMA),
    ("syslen", "auto", ""),
], ids=["line_extra", "nul_off_schema", "syslen"])
def test_cli_ltsv_matches_jax_package(tmp_path, framing, fuse, toml):
    """One ltsv_tpu config and input through both CLIs: the file, stdout
    (the decoder's "Missing value" notices) and stderr equal.  The port
    runs its whole ladder (on the CPU the plain versions of FL, EL and
    L1, the host tier, the oracle); the reference its host tier (its
    device compiles on the CPU are not what this holds).  With syslen
    the reference prints its end-of-stream line before its per-record
    errors, so stderr is compared as a multiset there."""
    lines, _ = make_ltsv_corpus(500, seed=84)
    tier, _ = make_ltsv_tier_corpus(300, seed=85)
    lines = tier[:150] + lines + tier[150:]
    if framing == "syslen":
        data = syslen_stream(lines)
    else:
        sep = b"\0" if framing == "nul" else b"\n"
        data = sep.join(lines) + sep + b"time:1\thost:tail\tpartial:1"
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        # the [input.*] tables after the input keys, [output.*] last
        in_tables = toml.replace("[input]\n", "") \
            if toml.startswith("[input]") else ""
        out_tables = toml if toml.startswith("[output") else ""
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "ltsv_tpu"\n'
            f'framing = "{framing}"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 256\n'
            + f'tpu_fuse = "{"off" if pkg == "flowgger_tpu" else fuse}"\n'
            + in_tables
            + '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\nframing = "line"\n' + out_tables)
        env = ({"FLOWGGER_DEVICE_ENCODE": "0"} if pkg == "flowgger_tpu"
               else {})
        proc = _run(pkg, cfg, data, env)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (out.read_bytes(), proc.stdout,
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[0] == ref[0] and len(port[0]) > 1000
    assert port[1] == ref[1] and b"Missing value" in port[1]
    if framing == "syslen":
        assert sorted(port[2]) == sorted(ref[2]) and port[2]
    else:
        assert port[2] == ref[2] and port[2]
    config = Config.from_string(toml)
    exp, errs = scalar_expectation(data, framing, config=config,
                                   merger=LineMerger(), fmt="ltsv")
    assert port[0] == exp and sorted(port[2]) == sorted(errs)


def test_tier_corpus_stays_under_the_decline_threshold():
    """One batch of the ltsv tier mix: the tier rows are in EL's 6-pair
    tier and the rows outside it stay near their 3 % share; the sourced
    mix is mostly outside it (8-14 pairs, Apache stamps)."""
    from flowgger_tpu_torch.tpu import device_common as DC
    from flowgger_tpu_torch.tpu import device_ltsv as DL

    for make, lo, hi in ((make_ltsv_tier_corpus, 0.02, 0.04),
                         (make_ltsv_corpus, 0.9, 1.0)):
        lines, kinds = make(1024, seed=20261016)
        batch, lens, _, _, orig, n = pack.pack_lines_2d(lines, 512)
        bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
        dec = L1.decode_ltsv(bt, lt)
        base, base_len = DL.encode_rows(bt, lt, dec, suffix=b"\0",
                                        assemble=False, n=n)
        tier = base & (base_len + DC.TS_W <= DL.out_width(512, b"\0"))
        cand = tier.numpy()[:n] & (orig[:n] <= 512)
        assert lo <= 1 - cand.mean() <= hi
        if make is make_ltsv_tier_corpus:
            assert cand[np.asarray(kinds) == "tier"].all()
            assert 1 - cand.mean() < DL.FALLBACK_FRAC


@pytest.mark.parametrize("name", list(RECORD_PATH))
def test_cli_ltsv_record_path_matches_jax_package(tmp_path, name):
    """The ltsv configs of the Record path through both CLIs, NUL
    framing: the file, stdout (the decoder's notices) and stderr (the
    start-up notice where the block route can never engage) equal, exit
    code 0, and the bytes the scalar path's."""
    toml, record_path = RECORD_PATH[name]
    lines, _ = make_ltsv_corpus(300, seed=86)
    lines += [b"k0:1\tk1:x\tk8:-3\tstatus:7\thost:h\ttime:1",
              b"k0:18446744073709551616\tstatus:-1\ttime:2",
              b"status:12\tk3:0\tmessage:typed\thost:h2\ttime:3"]
    data = b"\0".join(lines) + b"\0" + b"time:1\thost:tail\tpartial:1"
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        in_tables = toml if toml.startswith("[input") else ""
        out_tables = toml if toml.startswith("[output") else ""
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "ltsv_tpu"\n'
            'framing = "nul"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 256\n' + in_tables
            + '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\nframing = "line"\n' + out_tables)
        env = ({"FLOWGGER_DEVICE_ENCODE": "0"} if pkg == "flowgger_tpu"
               else {})
        proc = _run(pkg, cfg, data, env)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (out.read_bytes(), proc.stdout,
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port == ref and len(port[0]) > 1000
    assert b"Missing value" in port[1]
    notice = ("flowgger-tpu: columnar block route disabled for format "
              "'ltsv' (output.gelf_extra keys need dynamic placement "
              "(leading '_' or a fixed-key overwrite)); throughput falls "
              "to the per-record path (~30x slower)")
    assert (port[2][0] == notice) == (record_path == "run")
    exp, errs = scalar_expectation(data, "nul", config=Config.from_string(
        toml), merger=LineMerger(), fmt="ltsv")
    assert port[0] == exp
    assert [x for x in port[2] if x != notice] == errs
