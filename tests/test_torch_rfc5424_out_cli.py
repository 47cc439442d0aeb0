"""``python -m flowgger_tpu_torch --device cpu`` against ``python -m
flowgger_tpu`` into ``output.format = "rfc5424"``, for every input the
port reads: rfc5424_tpu (the split tier O5's mix and the line mix),
rfc3164_tpu, gelf_tpu, ltsv_tpu (with and without a typed
``ltsv_schema``, which takes the Record path and says so at start-up in
both), jsonl_tpu (the Record path, with its start-up notice) and auto_tpu
(with and without ``auto_extra_formats = ["jsonl"]``, which keeps auto
off RFC5424 and says so), over line and syslen output framing.  The
output bytes, stdout, stderr and exit code are the same.

The reference prints the rfc3164 decoder's own "Unable to parse" lines
of an auto batch on its fetcher thread, so for auto those and the other
stderr lines are compared each in order on their own.  GELF and jsonl
rows without a timestamp take the wall clock in both packages: the
mixes here leave them out."""

import pytest
import torch

from flowgger_tpu_torch.corpus import (LTSV_SCHEMA_10, make_auto_corpus,
                                       make_corpus, make_gelf_corpus,
                                       make_gelf_tier_corpus,
                                       make_jsonl_corpus, make_ltsv_corpus,
                                       make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus)
from torch_cli import cli_pair

NOTICE = "flowgger-tpu: columnar block route disabled for format "


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (torch_cli)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _auto(seed):
    lines, kinds = make_auto_corpus(500, seed)
    return [ln for ln, k in zip(lines, kinds) if k != "gelf:no_ts"]


def _gelf(seed):
    lines, kinds = make_gelf_corpus(300, seed)
    return make_gelf_tier_corpus(200, seed + 1)[0] + [
        ln for ln, k in zip(lines, kinds) if k != "no_ts"]


def _jsonl(seed):
    lines, kinds = make_jsonl_corpus(400, seed)
    return [ln for ln, k in zip(lines, kinds) if "no_ts" not in k]


# name: (input.format, input framing, extra [input] keys or tables,
# lines, the start-up notice's reason or None)
CONFIGS = {
    "rfc5424": ("rfc5424_tpu", "line", "",
                lambda: (make_tier_corpus(300, 61)[0]
                         + make_corpus(200, 62)[0]), None),
    "rfc3164": ("rfc3164_tpu", "line", "",
                lambda: (make_rfc3164_tier_corpus(200, 63)[0]
                         + make_rfc3164_corpus(200, 64)[0]), None),
    "gelf": ("gelf_tpu", "line", "", lambda: _gelf(65), None),
    "ltsv": ("ltsv_tpu", "nul", "", lambda: make_ltsv_corpus(400, 66)[0],
             None),
    "ltsv_schema": ("ltsv_tpu", "nul", LTSV_SCHEMA_10,
                    lambda: make_ltsv_corpus(300, 67)[0],
                    "input.ltsv_schema is set"),
    "jsonl": ("jsonl_tpu", "nul", "", lambda: _jsonl(68),
              "output.format RFC5424Encoder has no columnar encoder for "
              "input format 'jsonl'"),
    "auto": ("auto_tpu", "line", "", lambda: _auto(69), None),
    "auto_extra": ("auto_tpu", "line", 'auto_extra_formats = ["jsonl"]\n',
                   lambda: _auto(70),
                   "input.auto_extra_formats is set (the jsonl/dns legs "
                   "block-encode GELF/LTSV only)"),
}


def _split(lines):
    own = [ln for ln in lines if ln.startswith("Unable to parse")]
    return own, [ln for ln in lines if not ln.startswith("Unable to parse")]


def check_cli_pair(tmp_path, name, framing):
    """Both CLIs over config ``name`` of :data:`CONFIGS` into RFC5424
    with output ``framing``; an auto stream is one batch (the reference
    compiles each leg's decode once a sub-batch shape)."""
    fmt, in_framing, more, make, reason = CONFIGS[name]
    sep = b"\0" if in_framing == "nul" else b"\n"
    data = sep.join(make()) + sep
    in_keys = f'format = "{fmt}"\nframing = "{in_framing}"\n'
    in_tables = more if more.startswith("[") else ""
    in_keys += "" if in_tables else more
    outs = cli_pair(tmp_path, data, in_keys,
                    f'format = "rfc5424"\nframing = "{framing}"\n',
                    in_tables=in_tables,
                    batch_size=1024 if fmt == "auto_tpu" else 256)
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[:2] == ref[:2] and len(port[0]) > 10000
    if fmt == "auto_tpu":
        assert _split(port[2]) == _split(ref[2])
    else:
        assert port[2] == ref[2]
    notice = [ln for ln in port[2] if ln.startswith(NOTICE)]
    if reason is None:
        assert notice == []
    else:
        assert notice == [f"{NOTICE}'{fmt[:-4]}' ({reason}); throughput "
                          "falls to the per-record path (~30x slower)"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_rfc5424_output_matches_jax_package(tmp_path, name):
    check_cli_pair(tmp_path, name, "line")
