"""``python -m flowgger_tpu_torch --device cpu`` against ``python -m
flowgger_tpu`` into ``output.format = "capnp"`` from ltsv_tpu (with and
without a typed ``ltsv_schema``, which takes the Record path and says so
at start-up in both), gelf_tpu, jsonl_tpu and dns_tpu (the Record path,
with its start-up notice) and auto_tpu (with and without
``auto_extra_formats = ["jsonl"]``, which keeps auto off capnp and says
so): the same output bytes (wall-clock stamps masked), stdout, stderr
and exit code, as ``test_torch_capnp_out_cli.py`` compares them."""

import pytest
import torch

from flowgger_tpu_torch.corpus import (LTSV_SCHEMA_10, make_auto_corpus,
                                       make_dns_corpus, make_gelf_corpus,
                                       make_gelf_tier_corpus,
                                       make_jsonl_corpus, make_ltsv_corpus)
from test_torch_capnp_out_cli import check_cli_pair


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (torch_cli)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_columnar(fmt):
    return (f"output.format CapnpEncoder has no columnar encoder for input "
            f"format '{fmt}'")


# as test_torch_capnp_out_cli.CONFIGS; the gelf, jsonl and auto mixes keep
# their rows without a timestamp (masked)
CONFIGS = {
    "ltsv": ("ltsv_tpu", "nul", "", lambda: make_ltsv_corpus(400, 171)[0],
             None, "", "auto", None),
    "ltsv_schema": ("ltsv_tpu", "nul", LTSV_SCHEMA_10,
                    lambda: make_ltsv_corpus(300, 172)[0], "line", "",
                    "auto", "input.ltsv_schema is set"),
    "gelf": ("gelf_tpu", "line", "",
             lambda: (make_gelf_tier_corpus(200, 173)[0]
                      + make_gelf_corpus(300, 174)[0]), None, "", "auto",
             None),
    "jsonl": ("jsonl_tpu", "nul", "", lambda: make_jsonl_corpus(400, 175)[0],
              "syslen", "", "auto", _no_columnar("jsonl")),
    "dns": ("dns_tpu", "line", "", lambda: make_dns_corpus(400, 176)[0],
            None, "", "auto", _no_columnar("dns")),
    "auto": ("auto_tpu", "line", "", lambda: make_auto_corpus(500, 177)[0],
             "line", "", "auto", None),
    "auto_extra": ("auto_tpu", "line", 'auto_extra_formats = ["jsonl"]\n',
                   lambda: make_auto_corpus(500, 178)[0], None, "", "auto",
                   "input.auto_extra_formats is set (the jsonl/dns legs "
                   "block-encode GELF/LTSV only)"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_capnp_output_more_matches_jax_package(tmp_path, name):
    check_cli_pair(tmp_path, CONFIGS, name)
