"""K5, the JSON structural-index kernel source (csrc/structural_index.cu)
in its nested mode (the JSON-lines decode; its flat mode:
tests/test_torch_gelf_kernel_source.py), compiled for the CPU with g++ through the host emulation in
tests/cuda_host, against the plain PyTorch version it replaces (the
emulation and what it checks: tests/test_torch_kernel_sources.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgger_tpu_torch.corpus import make_jsonl_corpus
from flowgger_tpu_torch.tpu import jsonidx as JI
from flowgger_tpu_torch.tpu import pack

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_host"))
import build as host_build  # noqa: E402
import hostlibs  # noqa: E402


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


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if not host_build.gxx_available():
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    return hostlibs.load(("structural_index",),
                         tmp_path_factory.mktemp("cuda_host"))


def _json_lines():
    from test_torch_jsonl import EDGE_LINES

    return ([ln.encode() for ln in EDGE_LINES]
            + make_jsonl_corpus(300, seed=19)[0])


def _index_check(libs, lines, L, max_fields):
    batch, lens, *_ = pack.pack_lines_2d(lines, L)
    out = np.full((JI.n_channels(max_fields), batch.shape[0]), -7, np.int32)
    fn = getattr(libs["structural_index"], f"fg_structural_index_f{max_fields}")
    assert fn(_ptr(batch), _ptr(lens), _ptr(out), batch.shape[0], L, 4,
              None) == 0
    got = JI.unpack_channels(torch.from_numpy(out), max_fields)
    ref = JI.structural_index(torch.from_numpy(batch), torch.from_numpy(lens),
                              max_fields, nested=4)
    assert ref["ok"].any() and not ref["ok"].all()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("L", [512, 96])
@pytest.mark.parametrize("max_fields", [8, 24])
def test_structural_index_kernel_source_matches_plain(libs, L, max_fields):
    """Every channel on every row — padding, rejected and over-long rows
    included — equals the plain structural index."""
    _index_check(libs, _json_lines(), L, max_fields)


def _keys(n):
    return ",".join(f'"k{j}":{j}' for j in range(n))


# structures (the text after the shifting first field) whose running
# state the warp scans carry across 32-position chunks: backslash runs
# before a quote (16 or more flag the row), outside-string whitespace
# runs of 8 and 9 (9 flags it), previous / next significant bytes 1-9
# positions away (the window holds 8), literal words, depth changes and
# nested closes, and more keys than either field budget
JSON_FEATURES = (
    ['"s":"' + "\\" * r + ('"' if r % 2 == 0 else 'x"') + ',"t":1'
     for r in (15, 16, 17, 31, 32, 33, 40)]
    + ['"k":' + " " * w + '1,"t":2' for w in (8, 9)]
    + ['"k":1' + " " * w + ',"t":2' for w in (8, 9)]
    + ['"k":' + " " * w + '"v"' for w in range(9)]
    + ['"k"' + " " * w + ':"v"' for w in range(9)]
    + ['"k":"v"' + " " * w + ',"t":1' for w in range(9)]
    + ['"k":[1' + " " * w + '],"t":1' for w in range(9)]
    + ['"k":' + v + ',"t":1' for v in ("true", "false", "null", "truex",
                                       "fals", "nul", "-12.5e3")]
    + ['"k":' + v for v in ("true", "false", "null")]
    + ['"k":{"a":[1,{"b":2}],"c":{}},"t":[]',
       '"k":[[[[[1]]]]]',
       '"k":[[[[1]]]]',
       '"k":{"a":1}x,"t":1',
       '"k":{"a":"}"}]',
       '"k":[1,2}',
       _keys(9), _keys(24), _keys(25)])


def _json_boundary_lines(L):
    """Each feature starting at positions 24-40 (a padding string value
    grows one byte at a time), and ending at the row's last bytes: rows
    of L - 3 to L bytes and over-long rows clipped inside the feature."""
    out, head = [], '{"p":"'
    for feat in JSON_FEATURES:
        for start in range(24, 41):
            pad = start - len(head) - 2
            out.append(head + "a" * pad + '",' + feat + "}")
        tail = '",' + feat + "}"
        for total in (L - 3, L - 2, L - 1, L, L + 1, L + 3):
            pad = total - len(head) - len(tail)
            if pad >= 0:
                out.append(head + "a" * pad + tail)
    out += ['{"p":' + " " * 9 + "1}", '{"p":1}' + " " * 8, "{" + " " * 40,
            '{"p":"' + "\\" * 40 + '"}']
    # a row cut inside a literal word after eight rows that hold the word
    # whole: the kernel reuses a warp's staging slot from block to block,
    # and bytes past a row's length must read as 0, not as the last row's
    out += [""] * (-len(out) % 8)
    for word in ("true", "false", "null"):
        out += ['{"p":1,"k":' + word + "}"] * 8 + ['{"p":1,"k":' + word[:-1]] * 8
    return [ln.encode() for ln in out]


@pytest.mark.parametrize("L", [512, 96, 100])
@pytest.mark.parametrize("max_fields", [8, 24])
def test_structural_index_kernel_source_chunk_boundaries(libs, L, max_fields):
    """The warp-per-row scans carry state across 32-position chunks: every
    channel of every boundary row equals the plain structural index, at
    a row width that is a multiple of 16 bytes (vector staging) and at
    one that is not (byte staging)."""
    _index_check(libs, _json_boundary_lines(L), L, max_fields)
