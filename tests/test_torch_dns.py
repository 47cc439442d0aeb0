"""The port's dns input (``dns_tpu``) on the CPU, against the JAX package.

- DN's plain version (``dns.decode_dns``) against the reference's
  ``decode_dns`` (jitted at one shape a width), channel for channel on
  every row — the dns mix with every edge kind (``corpus.DNS_EDGE_KINDS``)
  and rows at the channel contract's corners: fewer and more than five
  tabs, empty fields, a latency past the row, rows cut by the width —
  and the padding contract (rows at and past ``n`` decode as empty rows).
- ``materialize_dns`` against the reference's, row for row (each Record
  encoded by both packages' GELF and LTSV encoders).
- ``encode_dns_gelf_block`` and ``encode_dns_ltsv_block`` against the
  reference's on the same batch × line / NUL / syslen mergers (the LTSV
  one with an ``ltsv_extra``): block bytes, errors and oracle rows, and
  the scalar path's bytes.
- A handler (``BatchHandler``, fmt "dns") over the mix: the scalar
  path's bytes and stderr, into GELF and LTSV.
- ``python -m flowgger_tpu_torch --device cpu`` against ``python -m
  flowgger_tpu`` on ``dns_tpu`` into GELF (with and without a
  ``gelf_extra``, which takes the Record path) and into LTSV: output
  bytes, stdout, stderr and exit code.
"""

import contextlib
import io
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.config import Config as RConfig
from flowgger_tpu.encoders.gelf import GelfEncoder as RGelfEncoder
from flowgger_tpu.encoders.ltsv import LTSVEncoder as RLTSVEncoder
from flowgger_tpu.mergers import LineMerger as RLineMerger
from flowgger_tpu.mergers import NulMerger as RNulMerger
from flowgger_tpu.mergers import SyslenMerger as RSyslenMerger
from flowgger_tpu.tpu import dns as RD
from flowgger_tpu.tpu import encode_dns_block as REB
from flowgger_tpu.tpu import materialize_dns as RMD

from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (DNS_EDGE_KINDS, make_dns_corpus,
                                       make_dns_tier_corpus,
                                       scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder, LTSVEncoder
from flowgger_tpu_torch.mergers import LineMerger, NulMerger, SyslenMerger
from flowgger_tpu_torch.tpu import dns as D
from flowgger_tpu_torch.tpu import encode_dns_block as EB
from flowgger_tpu_torch.tpu import materialize_dns as MD
from flowgger_tpu_torch.tpu import pack
from flowgger_tpu_torch.tpu.batch import BatchHandler
from torch_cli import cli_pair

jax.config.update("jax_platforms", "cpu")

EXTRA = '[output.ltsv_extra]\n"_zone:a" = "eu\\tw1"\nrelay = "r1"\n'
CORNERS = [
    b"", b"\t", b"\t\t\t\t\t", b"\t\t\t\t\t\t", b"1\t2\t3\t4\t5",
    b"1\tc\tq\tA\tR\t", b"1\tc\tq\tA\tR\t7\t8", b"1.\tc\tq\tA\tR\t7",
    b".1\tc\tq\tA\tR\t7", b"1.2.3\tc\tq\tA\tR\t7", b"1\t\tq\tA\tR\t7",
    b"1\tc\t\tA\tR\t7", b"1\tc\tq\t\t\t7", b"1\tc\tq\tA\tR\t" + b"9" * 19,
    b"1\tc\tq\tA\tR\t" + b"9" * 20, b"1\tc\tq\tA\tR\t0", b"1\tc\tq\tA\tR\t07",
    b"1\tc\tq\tA\tR\t7x", b"1\tc\tq\tA\tR\t-7", b"+1\tc\tq\tA\tR\t7",
    b"1760000000.123456\t10.0.0.1\t" + b"n" * 300 + b"\tA\tNOERROR\t12",
    b"1\tc\tq\xc3\xa9\tA\tR\t7", b"1\tc\tq\"\tA\tR\t7",
    b"1\tc\tq\\\tA\tR\t7", b"1\tc\tq\x01\tA\tR\t7",
]


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


def _lines(n=600, seed=61):
    lines, kinds = make_dns_corpus(n, seed)
    assert set(DNS_EDGE_KINDS) <= set(kinds)
    return CORNERS + lines


def _ref_channels(batch, lens):
    out = RD.decode_dns_jit(jnp.asarray(batch), jnp.asarray(lens))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("width", [256, 64])
def test_plain_decode_matches_reference(width):
    lines = _lines()
    batch, lens, _, _, orig, n = pack.pack_lines_2d(lines, width)
    assert (orig[:n] > width).any()
    want = _ref_channels(batch, lens)
    got = D.decode_dns(torch.from_numpy(batch), torch.from_numpy(lens))
    assert set(got) == set(want) == set(D.KEYS)
    for k in D.KEYS:
        g = got[k].numpy()
        assert g.dtype == want[k].dtype, k
        assert np.array_equal(g, want[k]), k
    assert 0 < want["ok"].sum() < n
    # the padding contract: rows at and past n decode as empty rows,
    # whatever bytes they hold
    junk = batch.copy()
    junk[n:] = 9
    lens_j = lens.copy()
    lens_j[n:] = width
    pad = D.decode_dns(torch.from_numpy(junk), torch.from_numpy(lens_j), n=n)
    empty = _ref_channels(np.zeros((1, width), np.uint8),
                          np.zeros(1, np.int32))
    for k in D.KEYS:
        assert np.array_equal(pad[k].numpy()[:n], want[k][:n]), k
        assert (pad[k].numpy()[n:] == empty[k][0]).all(), k


def _records(results, encoders):
    return [(r.error, r.line,
             None if r.record is None else
             tuple(e.encode(r.record) for e in encoders))
            for r in results]


def test_materialize_dns_matches_reference():
    lines = _lines(600, 62)
    packed = pack.pack_lines_2d(lines, 128)
    batch, lens, chunk, starts, orig, n = packed
    host = D.decode_dns_fetch(D.decode_dns_submit(
        torch.from_numpy(batch), torch.from_numpy(lens), n))
    got = MD.materialize_dns(chunk, starts, orig, host, n, 128)
    want = RMD.materialize_dns(chunk, starts, orig,
                               _ref_channels(batch, lens), n, 128)
    cfg, rcfg = Config.from_string(EXTRA), RConfig.from_string(EXTRA)
    assert _records(got, (GelfEncoder(cfg), LTSVEncoder(cfg))) == \
        _records(want, (RGelfEncoder(rcfg), RLTSVEncoder(rcfg)))
    assert sum(r.record is None for r in got) > 10


MERGERS = [(LineMerger, RLineMerger), (NulMerger, RNulMerger),
           (SyslenMerger, RSyslenMerger)]


@pytest.mark.parametrize("merger", MERGERS, ids=["line", "nul", "syslen"])
@pytest.mark.parametrize("output", ["gelf", "ltsv"])
def test_dns_block_matches_reference(merger, output):
    lines = _lines(600, 63)
    packed = pack.pack_lines_2d(lines, 256)
    batch, lens, chunk, starts, orig, n = packed
    host = D.decode_dns_fetch(D.decode_dns_submit(
        torch.from_numpy(batch), torch.from_numpy(lens), n))
    toml = EXTRA if output == "ltsv" else ""
    cfg, rcfg = Config.from_string(toml), RConfig.from_string(toml)
    if output == "ltsv":
        enc, renc = LTSVEncoder(cfg), RLTSVEncoder(rcfg)
        fn, rfn = EB.encode_dns_ltsv_block, REB.encode_dns_ltsv_block
    else:
        enc, renc = GelfEncoder(cfg), RGelfEncoder(rcfg)
        fn, rfn = EB.encode_dns_gelf_block, REB.encode_dns_gelf_block
    m, rm = merger[0](), merger[1]()
    got = fn(chunk, starts, orig, host, n, 256, enc, m)
    want = rfn(chunk, starts, orig, _ref_channels(batch, lens), n, 256, renc,
               rm)
    assert got.block.data == want.block.data
    assert np.array_equal(got.block.bounds, want.block.bounds)
    assert got.errors == want.errors
    assert got.fallback_rows == want.fallback_rows
    assert 10 < got.fallback_rows < n // 2
    exp, errs = scalar_expectation(b"\n".join(lines) + b"\n", config=cfg,
                                   merger=m, fmt="dns", output=output)
    assert got.block.data == exp
    assert [f"{e}: [{ln.strip()}]" for e, ln in got.errors] == errs
    # a gelf_extra keeps the GELF block encoder off (the Record path)
    if output == "gelf":
        extra = GelfEncoder(Config.from_string(
            '[output.gelf_extra]\nx = "y"\n'))
        assert fn(chunk, starts, orig, host, n, 256, extra, m) is None


@pytest.mark.parametrize("output", ["gelf", "ltsv"])
def test_handler_matches_scalar_path(output):
    """The dns handler over two batches and a tail, into either output:
    the scalar path's bytes and stderr lines, in order."""
    lines = _lines(700, 64)
    data = b"\n".join(lines) + b"\n1\tc\tq\tA\tR\t5"
    config = Config.from_string("[input]\ntpu_encode_economics = false\n"
                                "tpu_batch_size = 256\n")
    enc = (LTSVEncoder if output == "ltsv" else GelfEncoder)(config)
    tx = queue.Queue()
    h = BatchHandler(tx, enc, config, LineMerger(), torch.device("cpu"),
                     start_timer=False, fmt="dns")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        sess = h.open_raw("line")
        for i in range(0, len(data), 7000):
            sess.push(data[i:i + 7000])
        sess.finish()
        h.flush()
    got = b"".join(tx.get_nowait().data for _ in range(tx.qsize()))
    exp, errs = scalar_expectation(data, config=config, merger=LineMerger(),
                                   fmt="dns", output=output)
    assert got == exp and err.getvalue().splitlines() == errs
    assert len(errs) > 20


@pytest.mark.parametrize("output,tables", [
    ("gelf", ""), ("gelf", '[output.gelf_extra]\nx-origin = "port"\n'),
    ("ltsv", "")], ids=["gelf", "gelf_extra", "ltsv"])
def test_cli_dns_matches_jax_package(tmp_path, output, tables):
    """One dns_tpu config through both CLIs: the same output bytes,
    stdout and stderr; a gelf_extra prints the start-up notice and runs
    the Record path in both."""
    lines = make_dns_tier_corpus(200, 65)[0] + _lines(600, 66)
    data = b"\n".join(lines) + b"\n1\tc\tq\tA\tR\t5"
    outs = cli_pair(tmp_path, data, 'format = "dns_tpu"\n',
                    f'format = "{output}"\nframing = "line"\n',
                    out_tables=tables)
    port, ref = outs["flowgger_tpu_torch"], outs["flowgger_tpu"]
    assert port == ref and len(port[0]) > 10000
    if tables:
        assert port[2][0].startswith(
            "flowgger-tpu: columnar block route disabled for format 'dns' "
            "(output.gelf_extra is set)")
