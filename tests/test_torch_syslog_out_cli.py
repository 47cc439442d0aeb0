"""``python -m flowgger_tpu_torch --device cpu`` against ``python -m
flowgger_tpu`` into the other syslog-text outputs and JSON:

- ``output.format = "passthrough"`` from rfc5424_tpu and rfc3164_tpu,
  with and without ``output.syslog_prepend_timestamp`` (set, both take
  the Record path and say so at start-up; the wall-clock prefix is
  masked);
- ``output.format = "rfc3164"`` from rfc3164_tpu (the block route) and
  rfc5424_tpu (the Record path, with its start-up notice);
- ``output.format = "json"`` (GELF) from rfc5424_tpu on ``output.type =
  "stdout"`` (the inferred ``noop`` framing: the block route with an
  empty suffix) and on ``"debug"`` (the inferred ``line`` framing).

Stdout, stderr, the output file where there is one, and the exit code
are the same."""

import re

import pytest
import torch

from flowgger_tpu_torch.corpus import (make_corpus, make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus)
from torch_cli import PACKAGES, run

NOTICE = "flowgger-tpu: columnar block route disabled for format "
PREPEND = "[year]-[month]-[day]T[hour]:[minute]:[second]Z "
_WALL = re.compile(rb"(^|[\n\0])\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ ")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (torch_cli)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _r5():
    return make_tier_corpus(200, 71)[0] + make_corpus(200, 72)[0]


def _r3():
    return (make_rfc3164_tier_corpus(200, 73)[0]
            + make_rfc3164_corpus(200, 74)[0])


# name: (input.format, lines, [output] keys, the start-up notice's reason
# or None)
CONFIGS = {
    "rfc5424_passthrough": ("rfc5424_tpu", _r5,
                            'type = "file"\nformat = "passthrough"\n'
                            'framing = "line"\n', None),
    "rfc5424_passthrough_prepend": (
        "rfc5424_tpu", _r5,
        'type = "file"\nformat = "passthrough"\nframing = "nul"\n'
        f'syslog_prepend_timestamp = "{PREPEND}"\n',
        "output.syslog_prepend_timestamp is set"),
    "rfc3164_passthrough": ("rfc3164_tpu", _r3,
                            'type = "file"\nformat = "passthrough"\n'
                            'framing = "syslen"\n', None),
    "rfc3164_passthrough_prepend": (
        "rfc3164_tpu", _r3,
        'type = "file"\nformat = "passthrough"\nframing = "line"\n'
        f'syslog_prepend_timestamp = "{PREPEND}"\n',
        "output.syslog_prepend_timestamp is set"),
    "rfc3164_rfc3164": ("rfc3164_tpu", _r3,
                        'type = "file"\nformat = "rfc3164"\n'
                        'framing = "line"\n', None),
    "rfc5424_rfc3164": ("rfc5424_tpu", _r5,
                        'type = "file"\nformat = "rfc3164"\n'
                        'framing = "line"\n',
                        "output.format RFC3164Encoder has no columnar "
                        "encoder for input format 'rfc5424'"),
    "json_stdout": ("rfc5424_tpu", _r5,
                    'type = "stdout"\nformat = "json"\n', None),
    "json_debug": ("rfc5424_tpu", _r5,
                   'type = "debug"\nformat = "json"\n', None),
}


def _mask(data: bytes, prepend: bool) -> bytes:
    return _WALL.sub(rb"\1<wall> ", data) if prepend else data


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_syslog_output_matches_jax_package(tmp_path, name):
    fmt, make, out_keys, reason = CONFIGS[name]
    data = b"\n".join(make()) + b"\n"
    prepend = "syslog_prepend_timestamp" in out_keys
    outs = {}
    for pkg in PACKAGES:
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        keys = out_keys + (f'file_path = "{out}"\n'
                           if 'type = "file"' in out_keys else "")
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\ntpu_flush_ms = 600000\n'
            'tpu_batch_size = 256\n'
            f'tpu_fuse = "{"off" if pkg == "flowgger_tpu" else "auto"}"\n'
            f'format = "{fmt}"\nframing = "line"\n[output]\n' + keys)
        proc = run(pkg, cfg, data)
        assert proc.returncode == 0, (pkg, proc.stderr.decode()[-2000:])
        body = out.read_bytes() if out.exists() else b""
        outs[pkg] = (_mask(body, prepend), _mask(proc.stdout, prepend),
                     proc.stderr.decode().splitlines())
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port == ref
    assert len(port[0]) + len(port[1]) > 10000
    if prepend:
        assert port[0].count(b"<wall> ") > 300
    notice = [ln for ln in port[2] if ln.startswith(NOTICE)]
    if reason is None:
        assert notice == []
    else:
        assert notice == [f"{NOTICE}'{fmt[:-4]}' ({reason}); throughput "
                          "falls to the per-record path (~30x slower)"]
    if name == "json_stdout":
        # the noop merger: GELF records back to back, no separator
        assert b"}\n" not in port[1] and b"}{" in port[1]
    if name == "json_debug":
        assert port[1].count(b"}\n") > 300
