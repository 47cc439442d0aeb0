"""The configs of ``test_torch_rfc5424_out_cli.py`` into
``output.format = "rfc5424"`` with syslen output framing: ``python -m
flowgger_tpu_torch --device cpu`` against ``python -m flowgger_tpu``,
the same output bytes (each row's octet count computed over the elided
and spliced row), stdout, stderr and exit code.  A file of its own, so
that ``--dist loadfile`` runs it beside the line-framed pairs."""

import pytest
import torch

from test_torch_rfc5424_out_cli import CONFIGS, check_cli_pair


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (torch_cli)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_rfc5424_syslen_output_matches_jax_package(tmp_path, name):
    check_cli_pair(tmp_path, name, "syslen")
