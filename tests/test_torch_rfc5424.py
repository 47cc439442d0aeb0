"""The port's plain RFC5424 decode (flowgger_tpu_torch.tpu.rfc5424)
against the JAX package's ``decode_rfc5424_jit`` and its submit/fetch
rescue, on the CPU.

Rule (the one chip_smoke.py applies to the CUDA kernel): ``ok`` equal on
every row, ``pair_count`` equal wherever it exceeds the 6-pair budget,
and every channel equal — dtype included — on the rows that are ``ok``.
All batches share one [256, 512] geometry so the JAX side compiles once
per pair width.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgger_tpu.tpu import pack as jpack
from flowgger_tpu.tpu import rfc5424 as R
from flowgger_tpu_torch.corpus import make_corpus
from flowgger_tpu_torch.tpu import rfc5424 as T

from test_tpu_rfc5424 import CORPUS

ROWS, L = 256, 512


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


def _fuzz_lines(seed):
    rng = random.Random(seed)
    alphabet = list(' <>[]"\\=-:.TZ0123456789abchmp\t\u00e9')
    base = ('<13>1 2015-08-05T15:53:45.637824Z host app 1 2 '
            '[id k="v" k2="v2"] msg body')
    lines = []
    for _ in range(200):
        chars = list(base)
        for _ in range(rng.randint(1, 6)):
            op = rng.random()
            pos = rng.randrange(len(chars))
            if op < 0.4:
                chars[pos] = rng.choice(alphabet)
            elif op < 0.7:
                chars.insert(pos, rng.choice(alphabet))
            else:
                del chars[pos]
        lines.append("".join(chars).encode())
    for _ in range(56):
        lines.append("".join(rng.choice(alphabet)
                             for _ in range(rng.randint(0, 40))).encode())
    return lines


def _pairs_lines():
    out = []
    for npairs in range(0, 24):
        pairs = " ".join(f'k{i:02d}="v{i}"' for i in range(npairs))
        out.append(f"<13>1 2015-08-05T15:53:45Z h a p m [id {pairs}] m".encode())
        half = npairs // 2
        a = " ".join(f'a{i}="{i}"' for i in range(half))
        b = " ".join(f'b{i}="{i}"' for i in range(npairs - half))
        out.append(f"<13>1 2015-08-05T15:53:45Z h a p m [x@1 {a}][y@2 {b}] m"
                   .encode())
    for nsd in range(1, 8):
        sd = "".join(f'[s{i} k="{i}"]' for i in range(nsd))
        out.append(f"<13>1 2015-08-05T15:53:45Z h a p m {sd} m".encode())
    return out


def _escape_lines():
    out = []
    for run in range(0, 34):
        out.append(('<13>1 2015-08-05T15:53:45Z h a p m [id k="a'
                    + "\\" * run + '" x="y"] m').encode())
        out.append(('<13>1 2015-08-05T15:53:45Z h a p m [id k="a'
                    + "\\" * run + '\\"t" x="y"] m').encode())
    return out


CASES = {
    "corpus": lambda: [ln.encode() for ln in CORPUS],
    "mixed": lambda: make_corpus(ROWS, seed=11)[0],
    "fuzz": lambda: _fuzz_lines(1234),
    "pairs": _pairs_lines,
    "escapes": _escape_lines,
}


def _batch(lines):
    """[256, 512] batch; rows past the lines are zero-length padding."""
    assert len(lines) <= ROWS
    batch, lens, *_ = jpack.pack_lines_2d(lines, L)
    assert batch.shape == (ROWS, L)
    return batch, lens


def assert_rule(ref, got, max_pairs=R.DEFAULT_MAX_PAIRS):
    assert set(ref) == set(got)
    ok = np.asarray(ref["ok"])
    assert np.array_equal(ok, got["ok"]), "ok differs"
    pc = np.asarray(ref["pair_count"])
    over = pc > max_pairs
    assert np.array_equal(pc[over], np.asarray(got["pair_count"])[over])
    for k, v in ref.items():
        a, b = np.asarray(v), np.asarray(got[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.array_equal(a[ok], b[ok]), k


@pytest.fixture(scope="module")
def batches():
    return {name: _batch(fn()) for name, fn in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_pairs", [R.DEFAULT_MAX_PAIRS,
                                       R.RESCUE_MAX_PAIRS])
def test_plain_decode_matches_jax(batches, case, max_pairs):
    batch, lens = batches[case]
    ref = R.decode_rfc5424_jit(jnp.asarray(batch), jnp.asarray(lens),
                               max_sd=R.DEFAULT_MAX_SD, max_pairs=max_pairs,
                               extract_impl="sum")
    got = T.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens),
                           max_pairs=max_pairs)
    assert_rule(ref, {k: v.numpy() for k, v in got.items()}, max_pairs)


@pytest.mark.parametrize("case", ["pairs", "mixed", "corpus"])
def test_fetch_rescue_matches_jax(batches, case):
    """Submit + fetch, including the 16-pair re-decode of 7-16-pair rows
    and the widened pair channels it returns."""
    batch, lens = batches[case]
    ref = R.decode_rfc5424_host(batch, lens)
    got = T.decode_rfc5424_host(torch.from_numpy(batch),
                                torch.from_numpy(lens))
    assert_rule(ref, got)
    if case == "pairs":
        pc = got["pair_count"]
        rescued = (pc > T.DEFAULT_MAX_PAIRS) & (pc <= T.RESCUE_MAX_PAIRS)
        assert rescued.any() and got["ok"][rescued].any()
        assert got["name_start"].shape[1] == T.RESCUE_MAX_PAIRS


def test_padding_and_overflow_rows_flagged(batches):
    batch, lens = batches["pairs"]
    n = len(_pairs_lines())
    got = T.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens))
    assert not got["ok"][n:].any(), "padding rows must decode ok=False"
    pc = got["pair_count"].numpy()
    assert not got["ok"].numpy()[pc > T.DEFAULT_MAX_PAIRS].any()
    # more than max_sd SD elements: never ok
    assert not got["ok"][n - 3:n].any()


def test_escape_cap_rows_fall_back(batches):
    batch, lens = batches["escapes"]
    got = T.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens))
    ok = got["ok"].numpy()
    # run r feeds the quote of k="a\...\" — ok only below the cap
    for run in range(0, 34):
        row = 2 * run
        if run >= T.ESC_RUN_CAP:
            assert not ok[row], run
    assert ok[:2 * (T.ESC_RUN_CAP - 2)].any()


def test_fused_frame_decode_matches_jax():
    """The chained framing → decode entry over one raw CRLF line region
    (the plain versions on the CPU) against the JAX package's host pack
    of the same region and its decode, at the module's [256, 512]
    geometry."""
    from flowgger_tpu_torch.tpu.kernels import fused_frame_decode_rfc5424

    lines = make_corpus(200, seed=23)[0]
    blob = b"".join(ln + b"\r\n" for ln in lines)
    region = torch.zeros(1 << 17, dtype=torch.uint8)
    region[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    spans, got = fused_frame_decode_rfc5424(region, len(blob), sep=10,
                                            strip_cr=True, ncap=ROWS,
                                            max_len=L)
    assert int(spans["n"]) == len(lines) and not bool(spans["overflow"])
    assert int(spans["consumed"]) == len(blob)
    batch, lens, _, starts, orig_lens, n = jpack.pack_region_2d(
        blob, L, sep=10, strip_cr=True)
    assert batch.shape == (ROWS, L) and n == len(lines)
    assert np.array_equal(spans["starts"][:n].numpy(), starts[:n])
    assert np.array_equal(spans["lens"][:n].numpy(), orig_lens)
    ref = R.decode_rfc5424_jit(jnp.asarray(batch), jnp.asarray(lens),
                               max_sd=R.DEFAULT_MAX_SD,
                               max_pairs=R.DEFAULT_MAX_PAIRS,
                               extract_impl="sum")
    assert_rule(ref, {k: v.numpy() for k, v in got.items()})


def test_unpack_channels_layout():
    """The kernel's channel-major packing round-trips through
    unpack_channels into the plain version's dict."""
    batch, lens = _batch(_pairs_lines())
    ref = T.decode_rfc5424(torch.from_numpy(batch), torch.from_numpy(lens))
    rows = []
    for k in T._KEYS_1D:
        rows.append(ref[k].to(torch.int32)[None, :])
    for k in T._KEYS_SD + T._KEYS_PAIR:
        rows.append(ref[k].to(torch.int32).t())
    packed = torch.cat(rows)
    assert packed.shape[0] == T.n_channels(T.DEFAULT_MAX_SD,
                                           T.DEFAULT_MAX_PAIRS)
    back = T.unpack_channels(packed, T.DEFAULT_MAX_SD, T.DEFAULT_MAX_PAIRS)
    for k, v in ref.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_plain_decode_matches_pallas_interpret():
    """The Pallas kernel in interpret mode on a small batch (about 20 s
    of interpreter time on the CPU)."""
    good = (b'<165>1 2023-10-11T22:14:15.003Z host app 123 ID47 '
            b'[ex@32473 k="v"] hello')
    msgs = [good, b'<34>1 2024-01-01T00:00:00Z h a p m - msg',
            b'garbage line', good.replace(b"165", b"999"),
            b'<1>1 2024-06-30T23:59:60Z - - - - -',
            b'<13>1 2025-02-28T12:00:00.123456+05:30 h a - - '
            b'[a@1 x="1"][b@2 y="2"] m']
    bat = np.zeros((12, 128), np.uint8)
    lens = np.zeros(12, np.int32)
    for i in range(12):
        r = msgs[i % len(msgs)][:128]
        bat[i, :len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    ref = R.decode_rfc5424_pallas(bat, lens, block_rows=12, interpret=True)
    got = T.decode_rfc5424(torch.from_numpy(bat), torch.from_numpy(lens))
    ok = np.asarray(ref["ok"])
    assert np.array_equal(ok, got["ok"].numpy())
    for k, v in ref.items():
        # the Pallas tier returns every integer channel as int32
        assert np.array_equal(np.asarray(v)[ok],
                              got[k].numpy().astype(np.asarray(v).dtype)[ok]), k
