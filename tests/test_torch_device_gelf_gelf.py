"""The split gelf→GELF device tier (EG) on the CPU against the JAX
package: the plain version of its encode at 8 and 16 fields against the
reference's ``device_gelf_gelf._encode_kernel`` (run eagerly under
``jax.disable_jit()``: compiling it costs more than running it once) —
the probe's tier bits and timestamp channels, then the assembled bytes
of every tier row — and the tier through the port's fetch driver, taking
a batch of the tier mix and declining one of the sourced mix, byte for
byte against the scalar path.  Every comparison is exact."""

import json
import time

import jax
import numpy as np
import pytest
import torch

from flowgger_tpu.tpu import device_common as JDC
from flowgger_tpu.tpu import device_gelf_gelf as JEG
from flowgger_tpu.tpu import gelf as JG
from flowgger_tpu_torch.config import Config
from flowgger_tpu_torch.corpus import (make_gelf_corpus, make_gelf_tier_corpus,
                                       mask_wall_stamps, scalar_expectation)
from flowgger_tpu_torch.encoders import GelfEncoder
from flowgger_tpu_torch.mergers import NulMerger
from flowgger_tpu_torch.tpu import device_common as DC
from flowgger_tpu_torch.tpu import device_gelf_gelf as EG
from flowgger_tpu_torch.tpu import gelf as TG
from flowgger_tpu_torch.tpu import pack

L = 256
N = 128
SUFFIX = b"\0"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# rows aimed at the tier's screens: canonical and non-canonical numbers
# as pairs and stamps, 15-17-digit stamps around 2**53, signed stamps,
# specials of every type, repeats, '_' prefixes and the 8-byte sort key,
# empty host and values, level and version literals
EDGE = [
    b'{"host":"h","timestamp":1,"_a":true,"_b":false,"_c":null,"d":"","_":1}',
    b'{"host":"","timestamp":0,"version":"1.0","level":0,"zz":-12,"_zz":1}',
    b'{"host":"x","timestamp":123456789012345.6,"level":7}',
    b'{"host":"x","timestamp":1234567890123456.7}',
    b'{"host":"x","timestamp":9007199254740992}',
    b'{"host":"x","timestamp":9007199254740993}',
    b'{"host":"x","timestamp":-1760000000.25,"short_message":""}',
    b'{"host":"x","timestamp":01.5}', b'{"host":"x","timestamp":1.}',
    b'{"host":"x","timestamp":-0}', b'{"host":"x","timestamp":0.0}',
    b'{"host":"x","timestamp":1e5}', b'{"host":"x","timestamp":"1"}',
    b'{"host":"x","timestamp":1,"k":123456789012345678}',
    b'{"host":"x","timestamp":1,"k":1234567890123456789}',
    b'{"host":"x","timestamp":1,"k":-0,"j":00}',
    b'{"host":"x","timestamp":1,"k":1.5}',
    b'{"host":"x","timestamp":1,"_abcdefghij":1,"abcdefghik":2}',
    b'{"host":"x","timestamp":1,"abcdefgh":1,"abcdefghi":2}',
    b'{"host":"x","timestamp":1,"_k":1,"k":2}',
    b'{"host":"x","host":"y","timestamp":1}',
    b'{"host":"x","timestamp":1,"level":8}',
    b'{"host":"x","timestamp":1,"level":"1"}',
    b'{"host":"x","timestamp":1,"version":"1.2"}',
    b'{"host":"x","timestamp":1,"version":"1.1","full_message":"f"}',
    b'{"host":"x","timestamp":1,"full_message":"a\\nb"}',
    b'{"host":"x","timestamp":1,"s":"caf\xc3\xa9"}',
    b'{"host":"x","timestamp":1,"s":"tab\there"}',
    b'{"host":"x","timestamp":1,' + b",".join(b'"k%02d":%d' % (i, i)
                                           for i in range(14)) + b"}",
    b'{"timestamp":1,"short_message":"no host"}',
]


def _batch():
    raw = list(EDGE) + make_gelf_tier_corpus(60, seed=7)[0]
    raw += make_gelf_corpus(N - len(raw), seed=8)[0]
    batch, lens, *_ = pack.pack_lines_2d(raw, L)
    return raw, batch[:N], lens[:N]


RAW, BATCH, LENS = _batch()
BT, LT = torch.from_numpy(BATCH), torch.from_numpy(LENS)


def _decodes(F):
    """The port's and the reference's decode at F fields, held equal
    here on every channel of every row (no row has a 16-backslash
    run), so both encodes read the same channels."""
    got = TG.decode_gelf(BT, LT, F)
    ref = {k: np.asarray(v) for k, v in
           JG.decode_gelf_jit(BATCH, LENS, max_fields=F).items()}
    for k, v in ref.items():
        assert np.array_equal(v, got[k].numpy()), k
    return got, ref


@pytest.mark.parametrize("F", [8, 16])
def test_plain_encode_matches_reference(F):
    """The probe: the tier bit (at the phase-1 width TS_W) on every row
    and the ts_hi / ts_lo / ts_meta parse on every row (the plain
    version's unmasked channels) and on the tier rows (its probe's);
    then the assembled bytes and length of every tier row at the rows'
    own stamp text — all equal to the reference's encode."""
    got, ref = _decodes(F)
    with jax.disable_jit():
        jp = JEG._encode_kernel(BATCH, LENS, ref,
                                np.zeros((N, 0), np.uint8),
                                np.full(N, JDC.TS_W, np.int32),
                                suffix=SUFFIX, assemble=False, elide=True)
    s = EG.analyze(BT, LT, got)
    for k in EG.TS_KEYS:
        assert np.array_equal(np.asarray(jp[k]), s[k].numpy()), k
    base, base_len, small = EG.encode_rows(BT, LT, got, suffix=SUFFIX,
                                           assemble=False, n=N)
    OW = EG.out_width(L, SUFFIX)
    tier1 = (base & (base_len + DC.TS_W <= OW)).numpy()
    assert np.array_equal(np.asarray(jp["tier"]), tier1)
    assert 40 < tier1.sum() < N
    for i, k in enumerate(EG.TS_KEYS):
        assert np.array_equal(small[i].numpy()[tier1],
                              np.asarray(jp[k])[tier1])
        assert not small[i].numpy()[~base.numpy()].any()

    h = small.numpy()
    txt, tl = DC._ts_text_block_np({"ok": np.ones(N, bool), "ts_hi": h[0],
                                    "ts_lo": h[1], "ts_meta": h[2]},
                                   EG.ts_vals_gelf)
    with jax.disable_jit():
        jrows, jlen, jtier = JEG._encode_kernel(
            BATCH, LENS, ref, txt, tl, suffix=SUFFIX, assemble=True,
            elide=True)
    rows, out_len, tier = EG.encode_rows(BT, LT, got, torch.from_numpy(txt),
                                         torch.from_numpy(tl), suffix=SUFFIX)
    jtier, jrows, jlen = (np.asarray(jtier), np.asarray(jrows),
                          np.asarray(jlen))
    assert np.array_equal(jtier, tier.numpy())
    for r in np.flatnonzero(jtier):
        assert jlen[r] == out_len[r]
        assert bytes(jrows[r, :jlen[r]]) == bytes(rows[r, :out_len[r]])


def test_ts_vals_match_the_reference_combine():
    """The host combine of the split-integer parse (numpy float64) equals
    the reference's on every tier row's channels, and the float() of the
    stamp span the host tier formats."""
    got, _ = _decodes(8)
    base, _, small = EG.encode_rows(BT, LT, got, suffix=SUFFIX,
                                    assemble=False, n=N)
    h = {k: small[i].numpy() for i, k in enumerate(EG.TS_KEYS)}
    vals = EG.ts_vals_gelf(h, None)
    assert np.array_equal(vals, JEG.ts_vals_gelf(h, None))
    on = base.numpy()
    assert on.any()
    for r in np.flatnonzero(on):
        stamp = json.loads(RAW[r])["timestamp"]
        assert vals[r] == float(stamp), RAW[r]


def _handler_run(lines, state):
    """One batch through the tier's fetch driver (the port's, on its
    plain version): (result, route state)."""
    batch, lens, chunk, starts, orig, n = pack.pack_lines_2d(lines, L)
    packed = (batch, lens, chunk, starts, orig, n)
    handle = TG.decode_gelf_submit(torch.from_numpy(batch),
                                   torch.from_numpy(lens))
    res, _ = EG.fetch_encode(handle, packed,
                             GelfEncoder(Config.from_string("")), NulMerger(),
                             state)
    return res


def test_fetch_encode_takes_the_tier_mix_and_declines_the_sourced_one():
    """The tier takes a batch of the tier mix with the scalar path's
    bytes and errors, fetching fewer bytes than it emits; a batch of the
    sourced mix (9-15 fields, floats, escaped full messages) declines at
    8 fields and at 16 (the wide probe), and the caller's host tier
    runs."""
    lines = make_gelf_tier_corpus(200, seed=9)[0]
    state = {}
    t0 = time.time() - 1.0
    res = _handler_run(lines, state)
    assert res is not None and state["taken"] == 1
    exp, errs = scalar_expectation(b"\n".join(lines) + b"\n", fmt="gelf")
    assert mask_wall_stamps(res.block.data, t0) == mask_wall_stamps(exp, t0)
    assert [f"{e}: [{ln.strip()}]" for e, ln in res.errors] == errs
    assert state["fetch_bytes"] < state["emit_bytes"]

    state = {}
    assert _handler_run(make_gelf_corpus(200, seed=10)[0], state) is None
    assert state["declined"] == 1 and state["wide_cooldown"] == EG.COOLDOWN
