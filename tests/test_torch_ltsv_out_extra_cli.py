"""``python -m flowgger_tpu_torch --device cpu`` against ``python -m
flowgger_tpu`` into ``output.format = "ltsv"`` with an
``[output.ltsv_extra]`` whose key holds a ':' and a leading '_' and whose
value holds a tab, for every input the port reads (the configs and the
comparison of ``test_torch_ltsv_out_cli.py``, which runs them without
the extra; a file of its own so that the two spread over test
workers)."""

import pytest
import torch

from test_torch_ltsv_out_cli import CONFIGS, check_cli_pair


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in the CLI children (torch_cli)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_ltsv_extra_matches_jax_package(tmp_path, name):
    check_cli_pair(tmp_path, name, extra=True)
