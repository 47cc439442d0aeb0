"""The port's Record path on the CPU, against the JAX package.

- Each materializer (``materialize``, ``materialize_rfc3164``,
  ``materialize_ltsv`` with a typed 10-key schema and a suffix,
  ``materialize_gelf``, ``materialize_jsonl``) against the reference's on
  the same decode channels, Record by Record (every field, SD values
  with their kinds, errors and lines exactly; a GELF row without a
  timestamp is stamped with the wall clock on both sides and compared
  apart), and the ltsv decoder's "Missing value" notices in order.
- ``batch._decode_packed`` for the five formats against the reference's
  on seeded batches: each side decodes with its own kernel (the port's
  plain versions here, the reference's jnp programs).
- ``encode_gelf.encode_rfc5424_gelf`` against the reference's, byte for
  byte, with and without ``gelf_extra`` keys of dynamic placement.
- The handler on the Record-path configs (the start-up notice, every
  batch through the Record path) against the scalar path.
- ``python -m flowgger_tpu_torch --device cpu`` against ``python -m
  flowgger_tpu`` on the auto_tpu configs that take the Record path
  (``auto_extra_formats = ["jsonl"]`` with a ``gelf_extra``, a dynamic
  ``gelf_extra``, a typed ``ltsv_schema``): output bytes, stdout, stderr
  and exit code.

Every JAX call shares one batch shape ([256, 256]) per format.
"""

import contextlib
import io
import os
import queue
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.decoders.ltsv import LTSVDecoder as RLTSVDecoder
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.tpu import batch as RB
from flowgger_tpu.tpu import encode_gelf as REG
from flowgger_tpu.tpu import materialize as RM
from flowgger_tpu.tpu import materialize_gelf as RMG
from flowgger_tpu.tpu import materialize_jsonl as RMJ
from flowgger_tpu.tpu import materialize_ltsv as RML
from flowgger_tpu.tpu import materialize_rfc3164 as RM3
from flowgger_tpu.tpu import pack as RP

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (LTSV_SCHEMA_10, make_auto_corpus,
                                       make_corpus, make_gelf_corpus,
                                       make_jsonl_corpus, make_ltsv_corpus,
                                       make_rfc3164_corpus, mask_wall_stamps,
                                       scalar_expectation)
from flowgger_tpu_torch.decoders.ltsv import LTSVDecoder
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.outputs import stream_bytes
from flowgger_tpu_torch.tpu import batch as B
from flowgger_tpu_torch.tpu import encode_gelf as EG
from flowgger_tpu_torch.tpu import gelf as TG
from flowgger_tpu_torch.tpu import jsonl as TJ
from flowgger_tpu_torch.tpu import ltsv as TL
from flowgger_tpu_torch.tpu import materialize as M
from flowgger_tpu_torch.tpu import materialize_gelf as MG
from flowgger_tpu_torch.tpu import materialize_jsonl as MJ
from flowgger_tpu_torch.tpu import materialize_ltsv as ML
from flowgger_tpu_torch.tpu import materialize_rfc3164 as M3
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu import rfc3164 as T3
from flowgger_tpu_torch.tpu import rfc5424 as T5
from flowgger_tpu_torch.tpu.batch import BatchHandler

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
L = 256
ROWS = 200
SUFFIX = '[input.ltsv_suffixes]\nu64 = "_n"\nf64 = "_f"\n'
EXTRA_DYN = '[output.gelf_extra]\n_env = "prod"\nhost = "relay"\n'
# t0: rows stamped with the wall clock from here on compare as 0
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


def _lines(fmt: str, seed: int = 0):
    make = {"rfc5424": make_corpus, "rfc3164": make_rfc3164_corpus,
            "ltsv": make_ltsv_corpus, "gelf": make_gelf_corpus,
            "jsonl": make_jsonl_corpus}[fmt]
    # the odd rows every format meets: empty, invalid UTF-8, free text
    return make(ROWS, seed=90 + seed)[0] + [b"", b"\xff\xfe bad",
                                            b"just some words"]


def _packed(lines):
    """The same packed batch for both sides (numpy) and the port's torch
    form of it."""
    packed = pack.pack_lines_2d(lines, L)
    b, ln = packed[0], packed[1]
    return packed, (torch.from_numpy(b), torch.from_numpy(ln)) + packed[2:]


def _rec(r):
    """A Record as plain values: every field, the SD elements with each
    value's kind; a wall-clock stamp (a GELF row without a timestamp)
    reads 0."""
    if r is None:
        return None
    sd = None if r.sd is None else [
        (b.sd_id, [(n, v.kind, v.value) for n, v in b.pairs]) for b in r.sd]
    return (0.0 if r.ts >= T0 else r.ts, r.hostname, r.facility, r.severity,
            r.appname, r.procid, r.msgid, r.msg, r.full_msg, sd)


def _results(results):
    return [(_rec(r.record), r.error, r.line) for r in results]


def _captured(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        res = fn(*args)
    return res, out.getvalue()


def _ltsv_decoders(text):
    return LTSVDecoder(Config.from_string(text)), \
        RLTSVDecoder(RConfig.from_string(text))


@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164", "ltsv", "gelf",
                                 "jsonl"])
def test_materializers_match_reference(fmt):
    """Each materializer on the port's decode channels of one batch,
    against the reference's materializer on the same channels."""
    lines = _lines(fmt)
    packed, tp = _packed(lines)
    _, lens, chunk, starts, orig, n = packed
    if fmt == "rfc5424":
        host = T5.decode_rfc5424_host(tp[0], tp[1])
        got = M.materialize(chunk, starts, lens, orig, host, n, L)
        want = RM.materialize(chunk, starts, lens, orig, host, n, L)
    elif fmt == "rfc3164":
        host = T3.decode_rfc3164_fetch(T3.decode_rfc3164_submit(tp[0], tp[1]))
        got = M3.materialize_rfc3164(chunk, starts, orig, host, n, L)
        want = RM3.materialize_rfc3164(chunk, starts, orig, host, n, L)
    elif fmt == "ltsv":
        dec, rdec = _ltsv_decoders(LTSV_SCHEMA_10 + SUFFIX)
        host = TL.decode_ltsv_fetch(TL.decode_ltsv_submit(tp[0], tp[1], n))
        got, said = _captured(ML.materialize_ltsv, chunk, starts, orig, host,
                              n, L, dec)
        want, rsaid = _captured(RML.materialize_ltsv, chunk, starts, orig,
                                host, n, L, rdec)
        assert said == rsaid and "Missing value" in said
    elif fmt == "gelf":
        host = TG.decode_gelf_fetch(TG.decode_gelf_submit(tp[0], tp[1]))
        got = MG.materialize_gelf(chunk, starts, orig, host, n, L)
        want = RMG.materialize_gelf(chunk, starts, orig, host, n, L)
    else:
        host = TJ.decode_jsonl_host(tp[0], tp[1])
        got = MJ.materialize_jsonl(chunk, starts, orig, host, n, L)
        want = RMJ.materialize_jsonl(chunk, starts, orig, host, n, L)
    assert _results(got) == _results(want)
    assert any(r.record is not None for r in got)
    assert any(r.error is not None for r in got)


@pytest.mark.parametrize("fmt", ["rfc5424", "rfc3164", "ltsv", "gelf",
                                 "jsonl"])
def test_decode_packed_matches_reference(fmt):
    """The Record path of one batch: the port's decode (plain version) and
    materializer against the reference's ``_decode_packed`` (its jnp
    decode and materializer), Record by Record."""
    lines = _lines(fmt, seed=1)
    packed, tp = _packed(lines)
    if fmt == "ltsv":
        dec, rdec = _ltsv_decoders(LTSV_SCHEMA_10)
        got, said = _captured(B._decode_packed, fmt, tp, dec)
        want, rsaid = _captured(RB._decode_packed, fmt, packed, rdec)
        assert said == rsaid
    else:
        got, _ = _captured(B._decode_packed, fmt, tp)
        want, _ = _captured(RB._decode_packed, fmt, packed)
    assert len(got) == packed[5]
    assert _results(got) == _results(want)


@pytest.mark.parametrize("extra", ["", EXTRA_DYN,
                                   '[output.gelf_extra]\nzone = "eu"\n'],
                         ids=["none", "dynamic", "static"])
def test_encode_rfc5424_gelf_matches_reference(extra):
    """The per-row span encode, byte for byte and error for error, on the
    same channels."""
    lines = _lines("rfc5424", seed=2)
    packed, tp = _packed(lines)
    _, _, chunk, starts, orig, n = packed
    host = T5.decode_rfc5424_host(tp[0], tp[1])
    got = EG.encode_rfc5424_gelf(chunk, starts, orig, host, n, L,
                                 GelfEncoder(Config.from_string(extra)))
    want = REG.encode_rfc5424_gelf(chunk, starts, orig, host, n, L,
                                   RGelfEncoder(RConfig.from_string(extra)))
    assert [(r.encoded, r.error, r.line) for r in got] == \
        [(r.encoded, r.error, r.line) for r in want]
    if extra == EXTRA_DYN:
        assert b'"_env":"prod"' in got[0].encoded + got[1].encoded


# name -> (format, config, output merger); the gelf and auto runs keep
# off syslen framing (a wall-clock stamp's length reaches the prefix)
RECORD_CONFIGS = {
    "rfc5424_dyn": ("rfc5424", EXTRA_DYN, SyslenMerger),
    "rfc3164_level": ("rfc3164", '[output.gelf_extra]\nlevel = "3"\n',
                      NulMerger),
    "ltsv_schema10": ("ltsv", LTSV_SCHEMA_10, LineMerger),
    "ltsv_suffix": ("ltsv", '[input.ltsv_schema]\nstatus = "u64"\n' + SUFFIX,
                    SyslenMerger),
    "gelf_extra": ("gelf", '[output.gelf_extra]\nx = "y"\n', NulMerger),
    "jsonl_extra": ("jsonl", '[output.gelf_extra]\nx = "y"\n', SyslenMerger),
    "auto_env": ("auto", '[output.gelf_extra]\n_env = "prod"\n', LineMerger),
    "auto_schema": ("auto", LTSV_SCHEMA_10, NulMerger),
}
NOTICE = ("flowgger-tpu: columnar block route disabled for format '{fmt}' "
          "({why}); throughput falls to the per-record path (~30x slower)")


@pytest.mark.parametrize("name", list(RECORD_CONFIGS))
def test_handler_record_path_matches_scalar_path(name, capsys):
    """The port's handler on each Record-path config, over three batches
    and an end-of-stream record: the reference's start-up notice (or
    none, where the block encoder declines each batch after the fact),
    then the scalar path's bytes, stderr and stdout."""
    fmt, toml, merger_cls = RECORD_CONFIGS[name]
    if fmt == "auto":
        lines = make_auto_corpus(500, seed=93)[0]
    else:
        lines = _lines(fmt, seed=3) + _lines(fmt, seed=4)
    cfg = Config.from_string(f"[input]\ntpu_encode_economics = false\n"
                             f"tpu_max_line_len = {L}\n"
                             "tpu_batch_size = 150\n" + toml)
    merger = merger_cls()
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, merger,
                           torch.device("cpu"), start_timer=False, fmt=fmt)
    notice = capsys.readouterr().err.splitlines()
    for ln in lines[:-1]:
        handler.handle_bytes(ln)
    handler.flush()
    handler.handle_bytes(lines[-1])
    handler.flush()
    got = b"".join(stream_bytes(tx.get_nowait(), merger)
                   for _ in range(tx.qsize()))
    cap = capsys.readouterr()
    notices = []
    exp, errs = scalar_expectation(b"\n".join(lines) + b"\n", config=cfg,
                                   merger=merger, fmt=fmt, notices=notices)
    assert mask_wall_stamps(got, T0) == mask_wall_stamps(exp, T0)
    assert len(got) > 10000
    if fmt in ("rfc3164", "auto"):
        # the rfc3164 decoder prints its own line for a row both of its
        # layouts reject, as the batch decodes: before the batch's error
        # lines, each kind in order
        def split(ln):
            own = "Unable to parse the rfc3164 input: "
            return ([x for x in ln if x.startswith(own)],
                    [x for x in ln if not x.startswith(own)])
        assert split(cap.err.splitlines()) == split(errs)
    else:
        assert cap.err.splitlines() == errs
    assert cap.out.splitlines() == notices
    why = {"rfc5424": "output.gelf_extra keys need dynamic placement "
                      "(leading '_' or a fixed-key overwrite)",
           "rfc3164": "output.gelf_extra keys need dynamic placement "
                      "(leading '_' or a fixed-key overwrite)",
           "gelf": "output.gelf_extra is set",
           "jsonl": "output.gelf_extra is set",
           "auto": ("output.gelf_extra is set" if "extra" in toml
                    else "input.ltsv_schema is set")}.get(fmt)
    assert notice == ([NOTICE.format(fmt=fmt, why=why)] if why else [])


def _run(pkg, cfg, data):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               FLOWGGER_DEVICE_ENCODE="0", PYTHONPATH=str(ROOT))
    extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=600)


@pytest.mark.parametrize("toml", [
    '[input]\nauto_extra_formats = ["jsonl"]\n'
    '[output.gelf_extra]\nzone = "eu"\n',
    '[output.gelf_extra]\n_env = "prod"\nhost = "relay"\n',
    "[input]\n" + LTSV_SCHEMA_10,
], ids=["jsonl_extras", "dynamic_extra", "typed_schema"])
def test_cli_auto_record_path_matches_jax_package(tmp_path, toml):
    """One auto_tpu config that takes the Record path through both CLIs,
    line framing: the file, stdout and stderr equal (the start-up notice
    included), exit code 0."""
    lines = make_auto_corpus(700, seed=94)[0] \
        + make_jsonl_corpus(60, seed=95)[0]
    data = b"\n".join(lines) + b"\n<13>1 2015-08-05T15:53:45Z h a p m - tail"
    outs = {}
    in_tables = toml.replace("[input]\n", "") \
        if toml.startswith("[input]") else ""
    out_tables = toml[toml.index("[output"):] if "[output" in toml else ""
    in_tables = in_tables.split("[output")[0]
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "auto_tpu"\n'
            'framing = "line"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 256\n' + in_tables
            + '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\nframing = "line"\n' + out_tables)
        proc = _run(pkg, cfg, data)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (mask_wall_stamps(out.read_bytes(), T0), proc.stdout,
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[0] == ref[0] and len(port[0]) > 10000
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[2][0].startswith("flowgger-tpu: columnar block route "
                                 "disabled for format 'auto'")
