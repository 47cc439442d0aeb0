"""The port end to end on the CPU: ``python -m flowgger_tpu_torch
cfg.toml --device cpu`` against ``python -m flowgger_tpu cfg.toml`` on
one config file and one input (output bytes and stderr error lines), the
batch handler against the scalar oracle across chunk and flush
boundaries, the slice's config surface, and the import rule (no JAX, no
flowgger_tpu)."""

import io
import os
import queue
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flowgger_tpu_torch import pipeline
from flowgger_tpu_torch.config import Config, ConfigError
from flowgger_tpu_torch.corpus import (make_corpus, make_jsonl_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.splitters import LineSplitter, NulSplitter
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler
from flowgger_tpu_torch.tpu.encode_gelf_block import encode_rfc5424_gelf_block
from flowgger_tpu_torch.tpu.rfc5424 import decode_rfc5424_host


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


ROOT = Path(__file__).resolve().parent.parent
TAIL = b"<13>1 2015-08-05T15:53:45Z h a p m - partial frame at EOF"


def _input(framing, n_lines=600, seed=21):
    """The mixed corpus plus a partial frame at EOF (600 lines are
    ~100 KiB, so stdin's 64 KiB reads cut records across chunks)."""
    lines, _ = make_corpus(n_lines, seed)
    sep = b"\0" if framing == "nul" else b"\n"
    return sep.join(lines) + sep + TAIL


def _run(pkg, cfg, data, extra=()):
    # one intra-op thread in the child too (see _one_thread)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               FLOWGGER_DEVICE_ENCODE="0", PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", pkg, str(cfg), *extra],
                          input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=300)


@pytest.mark.parametrize("framing,out_type,out_framing", [
    ("line", "file", None), ("nul", "stdout", "line")])
def test_cli_matches_jax_package(tmp_path, framing, out_type, out_framing):
    data = _input(framing)
    assert len(data) > 1 << 16
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "rfc5424_tpu"\n'
            f'framing = "{framing}"\ntpu_flush_ms = 600000\n'
            'tpu_fuse = "off"\n'
            f'[output]\ntype = "{out_type}"\nformat = "gelf"\n'
            f'file_path = "{out}"\n'
            + (f'framing = "{out_framing}"\n' if out_framing else ""))
        extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
        proc = _run(pkg, cfg, data, extra)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        body = out.read_bytes() if out_type == "file" else proc.stdout
        outs[pkg] = (body, proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    merger = LineMerger() if out_framing == "line" else NulMerger()
    exp, errs = scalar_expectation(data, framing, merger=merger)
    if out_type == "file":
        assert port[0] == exp
    assert port[1] == errs and errs


@pytest.mark.parametrize("merger", [NulMerger(), LineMerger(),
                                    SyslenMerger(), None],
                         ids=["nul", "line", "syslen", "none"])
def test_block_encoder_matches_scalar_oracle(merger):
    """encode_rfc5424_gelf_block over the port's decode channels equals
    the scalar decoder + GelfEncoder + merger row for row, with the
    oracle rows spliced in input order and errors in order."""
    lines, _ = make_corpus(700, seed=4)
    packed = pack.pack_lines_2d(lines, 512)
    batch, lens, chunk, starts, orig_lens, n = packed
    host = decode_rfc5424_host(torch.from_numpy(batch), torch.from_numpy(lens))
    enc = GelfEncoder(Config.from_string(""))
    res = encode_rfc5424_gelf_block(chunk, starts, orig_lens, host, n, 512,
                                    enc, merger)
    exp, errs = scalar_expectation(b"\n".join(lines) + b"\n", merger=merger)
    assert res.block.data == exp
    got_errs = [f"{e}: [{ln.strip()}]" for e, ln in res.errors]
    assert got_errs == errs
    assert res.fallback_rows > 0 and len(res.block) == int(res.emit.sum())


class _Chunks:
    """A stream whose reads return at most ``size`` bytes."""

    def __init__(self, data, size):
        self.buf = io.BytesIO(data)
        self.size = size

    def read(self, n):
        return self.buf.read(min(n, self.size))


@pytest.mark.parametrize("framing,chunk", [("line", 97), ("nul", 4093),
                                           ("line", 1 << 16)])
def test_batch_handler_across_chunk_and_flush_boundaries(capsys, framing,
                                                         chunk):
    """Small reads split records across chunks and a small batch size
    forces flushes mid-stream, so the session carry crosses both."""
    data = _input(framing, n_lines=400, seed=8)
    cfg = Config.from_string("[input]\ntpu_encode_economics = false\n"
                             "tpu_batch_size = 64\n")
    tx = queue.Queue()
    handler = BatchHandler(tx, GelfEncoder(cfg), cfg, NulMerger(),
                           torch.device("cpu"), start_timer=False)
    splitter = NulSplitter() if framing == "nul" else LineSplitter()
    splitter.run(_Chunks(data, chunk), handler)
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(data, framing)
    assert got == exp
    assert capsys.readouterr().err.splitlines() == errs


def test_gelf_extra_static_keys_honored(tmp_path, monkeypatch, capsys):
    cfg_path = tmp_path / "cfg.toml"
    out = tmp_path / "out.gelf"
    cfg_path.write_text(
        '[input]\ntpu_encode_economics = false\n'
        'type = "stdin"\nformat = "rfc5424_tpu"\n'
        '[output]\ntype = "file"\nformat = "gelf"\n'
        f'file_path = "{out}"\n[output.gelf_extra]\nx-origin = "port"\n'
        'zzz = "last"\n')
    data = _input("line", n_lines=300, seed=2)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    pipeline.start(str(cfg_path), device="cpu")
    exp, errs = scalar_expectation(data, config=Config.from_path(
        str(cfg_path)))
    assert out.read_bytes() == exp and b'"x-origin":"port"' in exp
    assert capsys.readouterr().err.splitlines() == errs


# (config, the key the reference's error names or None where the
# reference runs it, the case's id).  The transports and the scalar and
# capnp inputs run since the port's network-input slice, and the redis
# input and the kafka, tls and rotating-file sinks since the sinks slice
# (test_torch_sinks.py, test_torch_sinks_cli.py): these configs raised
# "later slice" until then, and now must do what the reference's do —
# raise its ConfigError for the key left out (output.kafka_brokers: a
# config without output.type runs into Kafka; output.connect), or run.
# Each keeps its test id, so the ids no longer name what they check: the
# comment above each says what it does
BAD_CONFIGS = [
    # checks input.type = "redis" with a *_tpu format (into the default
    # Kafka output, which needs its brokers)
    ('[input]\ntype = "redis"\nformat = "rfc5424_tpu"\n',
     "output.kafka_brokers", "input.type"),
    # checks input.type = "redis" with a scalar format
    ('[input]\ntype = "redis"\nformat = "ltsv"\n', "output.kafka_brokers",
     "input.format0"),
    # checks output.type = "tls"
    ('[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\n[output]\n'
     'type = "tls"\n', "output.connect", "input.format1"),
    # checks output.type = "syslog-tls"
    ('[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\n[output]\n'
     'type = "syslog-tls"\n', "output.connect", "input.framing"),
    # checks output.type = "kafka" behind a tcp input of a scalar format
    ('[input]\ntype = "tcp"\nformat = "ltsv"\n[output]\n'
     'type = "kafka"\n', "output.kafka_brokers", "input.format2"),
    ('[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\n[output]\n'
     'type = "kafka"\n', "output.kafka_brokers", "output.type"),
    # the rotating file: runs
    ('[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\n[output]\n'
     'type = "file"\nfile_path = "x"\nfile_rotation_size = 10\n',
     None, "file_rotation_size"),
]


@pytest.mark.parametrize("text,key", [c[:2] for c in BAD_CONFIGS],
                         ids=[c[2] for c in BAD_CONFIGS])
def test_later_slice_configs_raise(text, key):
    """The port builds each config as the JAX package does: the same
    ConfigError words, or a pipeline."""
    from flowgger_tpu.config import Config as JConfig
    from flowgger_tpu.config import ConfigError as JConfigError
    from flowgger_tpu.pipeline import Pipeline as JPipeline

    if key is None:
        JPipeline(JConfig.from_string(text))
        pipe = pipeline.Pipeline(Config.from_string(text), device="cpu")
        assert pipe.output.rotation_size == 10
        return
    with pytest.raises(JConfigError) as ref:
        JPipeline(JConfig.from_string(text))
    with pytest.raises(ConfigError) as exc:
        pipeline.Pipeline(Config.from_string(text), device="cpu")
    assert str(exc.value) == str(ref.value)
    assert key in str(exc.value), (key, str(exc.value))


# the serving layers' keys (config, what the port must do): "ref" —
# raise the JAX package's own ConfigError words; "later" — raise a
# ConfigError naming the slice that ports the key, where the reference
# runs the config; "never" — the device_decode fault site, refused for
# good; "runs" — build, as the reference does (the value: the queue
# class and policy the port builds, or the stderr notice it prints)
_STDIN_TPU = '[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\n'
_STDIN_SCALAR = '[input]\ntype = "stdin"\nformat = "rfc5424"\n'
SERVING_CONFIGS = [
    (_STDIN_TPU + 'queue_policy = "bogus"\n', "ref", "queue_policy_bogus"),
    (_STDIN_TPU + "queue_policy = 3\n", "ref", "queue_policy_type"),
    (_STDIN_TPU + 'queue_policy = "drop_newest"\n',
     ("runs", "PolicyQueue", "drop_newest"), "queue_policy_drop_newest"),
    (_STDIN_SCALAR + 'queue_policy = "drop_oldest"\n',
     ("runs", "PolicyQueue", "drop_oldest"), "queue_policy_scalar"),
    (_STDIN_SCALAR + '[durability]\nmode = "require"\n', "ref",
     "durability_require_scalar"),
    (_STDIN_SCALAR + '[durability]\nmode = "spill"\n',
     ("runs", 'durability.mode = "spill" requires a *_tpu input format '
      "(got 'rfc5424'); the spill tier is disabled"),
     "durability_spill_scalar"),
    (_STDIN_TPU + '[durability]\nmode = "bogus"\n', "ref",
     "durability_bogus_tpu"),
    (_STDIN_TPU + '[durability]\nmode = "spill"\n', "later",
     "durability_spill_tpu"),
    (_STDIN_TPU + '[durability]\nmode = "require"\n', "later",
     "durability_require_tpu"),
    (_STDIN_TPU + '[tenants.a]\npeers = ["10.0.0.0/8"]\nweight = 0\n',
     "ref", "tenants_weight"),
    (_STDIN_TPU + '[tenant]\ndefault_queue_policy = "x"\n[tenants.a]\n',
     "ref", "tenant_default_policy"),
    (_STDIN_TPU + '[tenants.a]\npeers = ["10.0.0.0/8"]\n',
     ("runs", "WeightedFairQueue", None), "tenants_fair_queue"),
    (_STDIN_TPU + '[faults]\nsink_write = "once:1"\n', "later",
     "faults_sink_write"),
    (_STDIN_TPU + '[faults]\nspill_io = "every:2"\n', "later",
     "faults_spill_io"),
    (_STDIN_TPU + '[faults]\ndevice_decode = "every:2"\n', "never",
     "faults_device_decode"),
    (_STDIN_TPU + '[faults]\nqueue_pressure = "sometimes"\n', "ref",
     "faults_bad_spec"),
    (_STDIN_TPU + '[control]\ninterval_ms = 1000\n', "later", "control"),
    (_STDIN_TPU + "tpu_fleet = true\n", "later", "fleet"),
    (_STDIN_TPU + "tpu_fleet_port = 8733\n", "later", "fleet_port"),
    (_STDIN_TPU + "[metrics]\ninterval = 10\n", "later", "metrics"),
    (_STDIN_TPU + "[slo.lat]\nobjective = 0.99\n", "later", "slo"),
    (_STDIN_TPU + "[supervisor]\nmax_restarts = 3\n", "later",
     "supervisor"),
]


@pytest.mark.parametrize("text,expect", [c[:2] for c in SERVING_CONFIGS],
                         ids=[c[2] for c in SERVING_CONFIGS])
def test_serving_configs_match_reference(capsys, text, expect):
    """The serving layers' keys no longer run silently: the port raises
    the reference's words where it refuses, names the later slice where
    the port cannot run the key yet, and builds what the reference
    builds where it runs (C1 of the roadmap's faults)."""
    from flowgger_tpu.config import Config as JConfig
    from flowgger_tpu.pipeline import Pipeline as JPipeline
    from flowgger_tpu.utils import faultinject as JFI
    from flowgger_tpu_torch.utils import faultinject as FI

    text += '[output]\ntype = "stdout"\n'
    try:
        if expect == "ref":
            with pytest.raises(Exception) as ref:
                JPipeline(JConfig.from_string(text))
            with pytest.raises(Exception) as exc:
                pipeline.Pipeline(Config.from_string(text), device="cpu")
            assert type(exc.value).__name__ == type(ref.value).__name__
            assert str(exc.value) == str(ref.value)
            return
        if expect == "later":
            with pytest.raises(ConfigError, match="later slice") as exc:
                pipeline.Pipeline(Config.from_string(text), device="cpu")
            assert "ROADMAP A8." in str(exc.value)
            return
        if expect == "never":
            # a kernel failure ends the port's run: nothing to inject
            with pytest.raises(ConfigError, match="is not ported: a device "
                               "or kernel failure ends the port's run"):
                pipeline.Pipeline(Config.from_string(text), device="cpu")
            JPipeline(JConfig.from_string(text))
            return
        capsys.readouterr()
        pipe = pipeline.Pipeline(Config.from_string(text), device="cpu")
        port_err = capsys.readouterr().err
        ref = JPipeline(JConfig.from_string(text))
        ref_err = capsys.readouterr().err
        if len(expect) == 2:
            assert port_err == ref_err == expect[1] + "\n"
            return
        assert type(pipe.tx).__name__ == type(ref.tx).__name__ == expect[1]
        if expect[2] is not None:
            assert pipe.tx.policy == ref.tx.policy == expect[2]
    finally:
        FI.reset()
        JFI.reset()


@pytest.mark.parametrize("text,words", [
    ('[input]\ntype = "carrier-pigeon"\n', "Invalid input type: "
     "carrier-pigeon"),
    ('[input]\ntype = "stdin"\nformat = "avro"\n',
     "Unknown input format: avro"),
    ('[input]\ntype = "stdin"\nformat = "bogus_tpu"\n',
     "Unknown input format: bogus_tpu"),
    ('[input]\ntype = "stdin"\n[output]\ntype = "pigeon"\n',
     "Invalid output type: pigeon"),
])
def test_unknown_input_type_and_format_raise_reference_words(text, words):
    """An input type, input format or output type that no factory has
    raises the reference's own ConfigError words (the JAX package's
    Pipeline, whose factories run in the same order)."""
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.config import ConfigError as RConfigError
    from flowgger_tpu.pipeline import Pipeline as RPipeline

    with pytest.raises(ConfigError) as exc:
        pipeline.Pipeline(Config.from_string(text), device="cpu")
    with pytest.raises(RConfigError) as rexc:
        RPipeline(RConfig.from_string(text))
    assert str(exc.value) == str(rexc.value) == words


@pytest.mark.parametrize("name", ["avro", "gelf_tpu", ""])
def test_unknown_output_format_raises_reference_words(name):
    """An output.format no encoder has raises the reference's own
    ConfigError words (the JAX package's get_encoder)."""
    from flowgger_tpu.config import Config as RConfig
    from flowgger_tpu.config import ConfigError as RConfigError
    from flowgger_tpu.pipeline import get_encoder

    text = ('[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\nformat = "rfc5424_tpu"\n[output]\n'
            f'type = "stdout"\nformat = "{name}"\n')
    with pytest.raises(ConfigError) as exc:
        pipeline.Pipeline(Config.from_string(text), device="cpu")
    with pytest.raises(RConfigError) as rexc:
        get_encoder(name, RConfig.from_string(text))
    assert str(exc.value) == str(rexc.value) == \
        f"Unknown output format: {name}"


# configs that take the Record path in both packages (they raised
# ConfigError before the port had one): rfc5424 with gelf_extra keys that
# need dynamic placement (the per-row span encode), jsonl with any
# gelf_extra
RECORD_PATH = {
    "rfc5424_dyn": ("rfc5424_tpu", "line", '_dyn = "x"\nhost = "relay"\n',
                    "output.gelf_extra keys need dynamic placement (leading "
                    "'_' or a fixed-key overwrite)"),
    "jsonl_extra": ("jsonl_tpu", "nul", 'x = "y"\n',
                    "output.gelf_extra is set"),
}


@pytest.mark.parametrize("name", list(RECORD_PATH))
def test_cli_record_path_matches_jax_package(tmp_path, name):
    """A gelf_extra config of the Record path through both CLIs: the same
    output bytes and stderr (the start-up notice first), exit code 0,
    and the bytes the scalar path's."""
    fmt, framing, extra, why = RECORD_PATH[name]
    if fmt == "jsonl_tpu":
        lines, _ = make_jsonl_corpus(500, seed=23)
        data = b"\0".join(lines) + b'\0{"timestamp":1,"host":"tail"'
    else:
        data = _input(framing, n_lines=500, seed=24)
    outs = {}
    for pkg in ("flowgger_tpu_torch", "flowgger_tpu"):
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            f'[input]\ntpu_encode_economics = false\n'
            f'type = "stdin"\nformat = "{fmt}"\n'
            f'framing = "{framing}"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 256\n'
            '[output]\ntype = "file"\nformat = "gelf"\n'
            f'file_path = "{out}"\nframing = "line"\n'
            '[output.gelf_extra]\n' + extra)
        extra_args = ("--device", "cpu") if pkg == "flowgger_tpu_torch" \
            else ()
        proc = _run(pkg, cfg, data, extra_args)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[pkg] = (out.read_bytes(), proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port == ref and len(port[0]) > 10000
    notice = (f"flowgger-tpu: columnar block route disabled for format "
              f"'{fmt[:-4]}' ({why}); throughput falls to the per-record "
              "path (~30x slower)")
    assert port[1][0] == notice
    exp, errs = scalar_expectation(
        data, framing, config=Config.from_string("[output.gelf_extra]\n"
                                                 + extra),
        merger=LineMerger(), fmt=fmt[:-4])
    assert port[0] == exp and port[1][1:] == errs


def test_cuda_is_the_default_and_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pipeline.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.resolve_device(None)
    cfg = tmp_path / "cfg.toml"
    cfg.write_text('[input]\ntpu_encode_economics = false\n'
                   'type = "stdin"\nformat = "rfc5424_tpu"\n'
                   '[output]\ntype = "stdout"\n')
    from flowgger_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(cfg)])


# modules of the LTSV output and the dns input, among those the walk
# must reach
_NEW_MODULES = ("encoders.ltsv", "decoders.dns", "tpu.dns",
                "tpu.materialize_dns", "tpu.encode_dns_block",
                "tpu.encode_ltsv_block", "tpu.device_ltsv_out",
                "encoders.rfc5424", "encoders.rfc3164",
                "encoders.passthrough", "tpu.encode_rfc5424_block",
                "tpu.encode_passthrough_block",
                "tpu.encode_rfc3164_3164_block", "tpu.device_rfc5424_out",
                "capnp_wire", "encoders.capnp", "tpu.encode_capnp_block",
                "tpu.device_capnp", "tpu.overlap", "inputs.tcp_input",
                "inputs.tls_input", "inputs.udp_input", "inputs.file_input",
                "utils.recvmmsg", "utils.inotify", "utils.retry",
                "utils.resp", "utils.rotating_file", "utils.snappy",
                "utils.kafka_wire", "inputs.redis_input",
                "outputs.tls_output", "outputs.kafka_output",
                "utils.bounded_queue", "utils.faultinject", "tpu.breaker",
                "tenancy", "tenancy.registry", "tenancy.admission",
                "tenancy.fairqueue", "tenancy.templates",
                "tpu.encode_passthrough")


def test_import_rule():
    """Every module of the port imports without JAX and without any
    module of the JAX package (the walk reaches the LTSV output's, the
    dns input's, the syslog outputs', the capnp output's and the overlap
    executor's modules, the transports' and their utilities, the redis
    input's and the sinks' too), and so does ``chip_smoke.py``."""
    code = (
        "import pkgutil, sys\n"
        "import flowgger_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flowgger_tpu' or m.startswith('flowgger_tpu.')]\n"
        f"new = ['flowgger_tpu_torch.' + m for m in {_NEW_MODULES!r}]\n"
        "missing = [m for m in new if m not in names]\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
