"""``python -m flowgger_tpu_torch --device cpu`` against ``python -m
flowgger_tpu`` into ``output.format = "ltsv"``, with and without an
``[output.ltsv_extra]`` (this file: without; ``test_torch_ltsv_out_
extra_cli.py``: with), for every input the port reads: rfc5424_tpu,
rfc3164_tpu, ltsv_tpu (with and without a typed ``ltsv_schema``, which
takes the Record path and says so at start-up in both), gelf_tpu,
jsonl_tpu, dns_tpu and auto_tpu (with and without
``auto_extra_formats = ["dns"]``).  The output bytes, stdout (the ltsv
decoder's notices), stderr and exit code are the same.

The reference prints the rfc3164 decoder's own "Unable to parse" lines
of an auto batch on its fetcher thread, so for auto those and the other
stderr lines are compared each in order on their own (as
``test_torch_autodetect.py`` does).  GELF rows without a timestamp take
the wall clock in both packages: the auto mixes here leave them out."""

import pytest
import torch

from flowgger_tpu_torch.corpus import (LTSV_SCHEMA_10, make_auto_corpus,
                                       make_corpus, make_dns_corpus,
                                       make_gelf_corpus,
                                       make_gelf_tier_corpus,
                                       make_jsonl_corpus, make_ltsv_corpus,
                                       make_ltsv_out_tier_corpus,
                                       make_rfc3164_corpus)
from torch_cli import cli_pair

EXTRA = '[output.ltsv_extra]\n"_zone:a" = "eu\\tw1"\nrelay = "r1"\n'


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (torch_cli)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _auto(seed, dns):
    lines, kinds = make_auto_corpus(500, seed, dns=dns)
    return [ln for ln, k in zip(lines, kinds) if k != "gelf:no_ts"]


def _gelf(seed):
    lines, kinds = make_gelf_corpus(300, seed)
    return make_gelf_tier_corpus(200, seed + 1)[0] + [
        ln for ln, k in zip(lines, kinds) if k != "no_ts"]


# name: (input.format, framing, extra [input] keys and tables, lines)
CONFIGS = {
    "rfc5424": ("rfc5424_tpu", "line", "",
                lambda: (make_ltsv_out_tier_corpus(200, 81)[0]
                         + make_corpus(300, 82)[0])),
    "rfc3164": ("rfc3164_tpu", "line", "",
                lambda: make_rfc3164_corpus(400, 83)[0]),
    "ltsv": ("ltsv_tpu", "nul", "", lambda: make_ltsv_corpus(400, 84)[0]),
    "ltsv_schema": ("ltsv_tpu", "nul", LTSV_SCHEMA_10,
                    lambda: make_ltsv_corpus(300, 85)[0]),
    "gelf": ("gelf_tpu", "line", "", lambda: _gelf(86)),
    "jsonl": ("jsonl_tpu", "nul", "", lambda: make_jsonl_corpus(400, 87)[0]),
    "dns": ("dns_tpu", "line", "", lambda: make_dns_corpus(500, 88)[0]),
    "auto": ("auto_tpu", "line", "", lambda: _auto(89, False)),
    "auto_dns": ("auto_tpu", "line", 'auto_extra_formats = ["dns"]\n',
                 lambda: _auto(90, True)),
}


def _split(lines):
    own = [ln for ln in lines if ln.startswith("Unable to parse")]
    return own, [ln for ln in lines if not ln.startswith("Unable to parse")]


def check_cli_pair(tmp_path, name, extra):
    """Both CLIs over config ``name`` of :data:`CONFIGS` into LTSV; an
    auto stream is one batch (the reference compiles each leg's decode
    once a sub-batch shape)."""
    fmt, framing, more, make = CONFIGS[name]
    sep = b"\0" if framing == "nul" else b"\n"
    data = sep.join(make()) + sep
    in_keys = f'format = "{fmt}"\nframing = "{framing}"\n'
    in_tables = more if more.startswith("[") else ""
    in_keys += "" if in_tables else more
    outs = cli_pair(tmp_path, data, in_keys,
                    'format = "ltsv"\nframing = "line"\n',
                    in_tables=in_tables, out_tables=EXTRA if extra else "",
                    batch_size=1024 if fmt == "auto_tpu" else 256)
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[:2] == ref[:2] and len(port[0]) > 10000
    if fmt == "auto_tpu":
        assert _split(port[2]) == _split(ref[2])
    else:
        assert port[2] == ref[2]
    if name == "ltsv_schema":
        assert port[2][0].startswith(
            "flowgger-tpu: columnar block route disabled for format 'ltsv' "
            "(input.ltsv_schema is set)")
    if extra:
        assert b"zone_a:eu w1\trelay:r1\t" in port[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_ltsv_output_matches_jax_package(tmp_path, name):
    check_cli_pair(tmp_path, name, extra=False)
