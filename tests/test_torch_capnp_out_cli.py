"""``python -m flowgger_tpu_torch --device cpu`` against ``python -m
flowgger_tpu`` into ``output.format = "capnp"`` from rfc5424_tpu (the line
mix, the tier mix with the fused route and with ``tpu_fuse = "off"``, a
``capnp_extra``) and rfc3164_tpu, over the inferred noop framing and
explicit line, NUL and syslen output framing: the same output bytes,
stdout, stderr and exit code.  The other inputs' pairs are in
``test_torch_capnp_out_more_cli.py``, a file of its own so that
``--dist loadfile`` runs the two beside each other.

GELF and jsonl rows without a timestamp take the wall clock in both
packages: their stamps are masked (``corpus.mask_capnp_stamps``, which
steps message by message through the segment tables).  The reference
prints the rfc3164 decoder's own "Unable to parse" lines of an auto
batch on its fetcher thread, so for auto those and the other stderr
lines are compared each in order on their own."""

import time

import pytest
import torch

from flowgger_tpu_torch.corpus import (make_corpus, make_rfc3164_corpus,
                                       make_rfc3164_tier_corpus,
                                       make_tier_corpus, mask_capnp_stamps)
from torch_cli import cli_pair

NOTICE = "flowgger-tpu: columnar block route disabled for format "
EXTRA = '[output.capnp_extra]\nenv = "prod"\ndc = "eu-west-1"\n'


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (torch_cli)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rfc5424():
    return make_tier_corpus(300, 161)[0] + make_corpus(200, 162)[0]


# name: (input.format, input framing, extra [input] keys or tables,
# lines, output framing (None: inferred, noop), [output] tables, the
# port's tpu_fuse, the start-up notice's reason or None)
CONFIGS = {
    "rfc5424": ("rfc5424_tpu", "line", "", _rfc5424, None, "", "auto",
                None),
    "rfc5424_tier_off": ("rfc5424_tpu", "line", "",
                         lambda: make_tier_corpus(600, 163)[0], "line", "",
                         "off", None),
    "rfc5424_extra": ("rfc5424_tpu", "nul", "", _rfc5424, "nul", EXTRA,
                      "auto", None),
    "rfc5424_syslen": ("rfc5424_tpu", "line", "", _rfc5424, "syslen", "",
                       "auto", None),
    "rfc3164": ("rfc3164_tpu", "line", "",
                lambda: (make_rfc3164_tier_corpus(200, 164)[0]
                         + make_rfc3164_corpus(200, 165)[0]), None, "",
                "auto", None),
}


def _split(lines):
    own = [ln for ln in lines if ln.startswith("Unable to parse")]
    return own, [ln for ln in lines if not ln.startswith("Unable to parse")]


def check_cli_pair(tmp_path, configs, name):
    """Both CLIs over config ``name`` of ``configs`` into capnp; an auto
    stream is one batch (the reference compiles each leg's decode once a
    sub-batch shape)."""
    fmt, in_framing, more, make, framing, out_tables, fuse, reason = \
        configs[name]
    sep = b"\0" if in_framing == "nul" else b"\n"
    data = sep.join(make()) + sep
    in_keys = f'format = "{fmt}"\nframing = "{in_framing}"\n'
    in_tables = more if more.startswith("[") else ""
    in_keys += "" if in_tables else more
    out_keys = 'format = "capnp"\n' + (
        f'framing = "{framing}"\n' if framing else "")
    since = time.time() - 1.0
    outs = cli_pair(tmp_path, data, in_keys, out_keys, in_tables=in_tables,
                    out_tables=out_tables, fuse=fuse,
                    batch_size=1024 if fmt == "auto_tpu" else 256)
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port[1] == ref[1] and len(port[0]) > 10000
    assert (mask_capnp_stamps(port[0], since, framing or "noop")
            == mask_capnp_stamps(ref[0], since, framing or "noop"))
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
def test_cli_capnp_output_matches_jax_package(tmp_path, name):
    check_cli_pair(tmp_path, CONFIGS, name)
