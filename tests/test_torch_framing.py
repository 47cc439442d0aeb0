"""The port's plain framing stages (flowgger_tpu_torch.tpu.framing)
against the JAX package: the Pallas span and gather kernels in interpret
mode, the jnp tier (``frame_sep_spans_jit`` / ``frame_gather_jit``), and
the host splitter — on line and NUL regions with CRLF endings, empty
records, a trailing partial record and span-count overflow.  Every
output element is compared.  One region size and one span capacity keep
the JAX side at a few compiled shapes."""

import numpy as np
import pytest
import torch

from flowgger_tpu.tpu import framing as jframing
from flowgger_tpu.tpu import pack as jpack
from flowgger_tpu.tpu import pallas_kernels as PK
from flowgger_tpu_torch.tpu import framing as F
from flowgger_tpu_torch.tpu import pack as tpack

B, NCAP, MAX_LEN = 4096, 64, 48


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


SPAN_KEYS = ("starts", "lens", "n", "consumed", "overflow")


def _region(seed, sep, crlf, n_recs, tail=b""):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_recs):
        k = int(rng.integers(0, 60)) if i % 7 else 0   # some empty records
        recs.append(bytes(rng.integers(32, 127, k).astype(np.uint8)))
    end = (b"\r" if crlf else b"") + bytes([sep])
    blob = b"".join(r + end for r in recs) + tail
    assert len(blob) <= B
    reg = np.zeros(B, np.uint8)
    reg[:len(blob)] = np.frombuffer(blob, np.uint8)
    return reg, len(blob), blob


# (name, sep, strip_cr, crlf, n_recs, tail)
REGIONS = [
    ("line", 10, True, False, 40, b""),
    ("line-crlf", 10, True, True, 40, b""),
    ("line-partial", 10, True, True, 30, b"partial tail"),
    ("line-overflow", 10, True, False, 100, b""),
    ("line-empty", 10, True, False, 0, b"no separator at all"),
    ("nul", 0, False, False, 50, b""),
    ("nul-cr-kept", 0, False, True, 20, b"x"),
    ("nul-overflow", 0, False, False, 90, b"\r"),
]


@pytest.mark.parametrize("name,sep,strip_cr,crlf,n_recs,tail", REGIONS,
                         ids=[r[0] for r in REGIONS])
def test_sep_spans_match_jax(name, sep, strip_cr, crlf, n_recs, tail):
    reg, rlen, blob = _region(len(name), sep, crlf, n_recs, tail)
    got = F.frame_sep_spans(torch.from_numpy(reg), rlen, sep=sep,
                            strip_cr=strip_cr, ncap=NCAP)
    jit = jframing.frame_sep_spans_jit(reg, rlen, sep=sep,
                                       strip_cr=strip_cr, ncap=NCAP)
    pal = PK.frame_sep_spans_pallas(reg, np.int32(rlen), sep=sep,
                                    strip_cr=strip_cr, ncap=NCAP,
                                    interpret=True)
    for ref in (jit, pal):
        for k in SPAN_KEYS:
            a, b = np.asarray(ref[k]), got[k].numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, k)
    assert bool(got["overflow"]) == ("overflow" in name)
    if not bool(got["overflow"]):
        # the host splitter agrees record for record
        starts, lens, n, _carry = jpack.split_chunk(blob, strip_cr=strip_cr) \
            if sep == 10 else jpack._split_np(blob, strip_cr, sep)
        assert int(got["n"]) == n
        assert np.array_equal(got["starts"][:n].numpy(), starts)
        assert np.array_equal(got["lens"][:n].numpy(), lens)


@pytest.mark.parametrize("name", ["line-crlf", "line-partial", "nul"])
def test_gather_matches_jax(name):
    spec = {r[0]: r for r in REGIONS}[name]
    _, sep, strip_cr, crlf, n_recs, tail = spec
    reg, rlen, _ = _region(len(name), sep, crlf, n_recs, tail)
    spans = F.frame_sep_spans(torch.from_numpy(reg), rlen, sep=sep,
                              strip_cr=strip_cr, ncap=NCAP)
    starts, lens = spans["starts"], spans["lens"]
    got_b, got_l = F.frame_gather(torch.from_numpy(reg), starts, lens,
                                  MAX_LEN)
    s_np, l_np = starts.numpy(), lens.numpy()
    jb, jl = jframing.frame_gather_jit(reg, s_np, l_np, max_len=MAX_LEN)
    pb, pl = PK.frame_gather_pallas(reg, s_np, l_np, max_len=MAX_LEN,
                                    interpret=True)
    for ref_b, ref_l in ((jb, jl), (pb, pl)):
        assert np.array_equal(np.asarray(ref_b), got_b.numpy())
        assert np.array_equal(np.asarray(ref_l), got_l.numpy())
        assert got_b.dtype == torch.uint8 and got_l.dtype == torch.int32


@pytest.mark.parametrize("framing,sep", [("line", b"\n"), ("nul", b"\0")])
def test_device_frame_region_matches_host_pack(framing, sep):
    """The packed tuple of the port's device framing (plain versions on
    the CPU) equals the JAX package's host pack of the same region."""
    rng = np.random.default_rng(5)
    recs = [bytes(rng.integers(32, 127, int(rng.integers(0, 90)))
                  .astype(np.uint8)) + (b"\r" if i % 3 == 0 else b"")
            for i in range(300)]
    framed = b"".join(r + sep for r in recs)
    packed, consumed, err = F.device_frame_region(
        framed, framing, MAX_LEN, n_records=framed.count(sep),
        device=torch.device("cpu"))
    ref = jpack.pack_region_2d(framed, MAX_LEN, sep=sep[0],
                               strip_cr=framing == "line")
    assert consumed == len(framed) and err is False
    assert np.array_equal(packed[0].numpy(), ref[0])
    assert np.array_equal(packed[1].numpy(), ref[1])
    assert packed[2] == ref[2]
    assert np.array_equal(packed[3], ref[3])
    assert np.array_equal(packed[4], ref[4])
    assert packed[5] == ref[5]
    # and the port's own host pack (the span-overflow re-frame) too
    host = tpack.pack_region_2d(framed, MAX_LEN, sep=sep[0],
                                strip_cr=framing == "line")
    for a, b in zip(host[:2], ref[:2]):
        assert np.array_equal(a, b)
    assert np.array_equal(host[3], ref[3]) and np.array_equal(host[4], ref[4])


def test_span_overflow_declines():
    """More records than the caller's count sized the spans for (256
    slots for 300 records) is a decline, never a truncated answer."""
    with pytest.raises(F.FramingDeclined):
        F.device_frame_region(b"x\n" * 300, "line", MAX_LEN, n_records=10,
                              device=torch.device("cpu"))
