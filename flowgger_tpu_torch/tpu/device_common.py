"""Shared machinery of the device encode tier: JSON escaping, the SD
pair sort, segment assembly (plain PyTorch versions), the host halves
(timestamp text, constant splice) and the fetch driver with its tier
gating and decline hysteresis.

A trimmed copy of the JAX package's ``tpu/device_common.py``: the
definitions and the driver's decisions are the reference's, so a batch
takes or declines the device tier exactly as it does there.  What the
port leaves out: the compile watchdog and AOT wrappers (the CUDA kernel
builds once, before the first batch, and a failed build raises), the
metrics registry (the driver counts in the caller's ``route_state``
dict) and the on-device row compaction, a TPU workaround: the port's
assemble kernel writes each tier row straight to its byte offset in one
flat buffer, so the host fetches exactly the tier rows' bytes.

The plain versions keep the reference's formulation where it is cheap
in PyTorch (escape map, 8-byte sort keys, sorting network) and use a
gather where the reference rotates rows (segment assembly); on the rows
of the tier they give the same bytes, and the tier mask and lengths on
every row.
"""

from __future__ import annotations

import os
import threading
import time
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from .assemble import concat_segments, exclusive_cumsum
from .materialize import compute_ts
from .rfc5424 import _wrap32

TS_W = 32          # timestamp text slot width (longest json_f64 ≈ 25)
E_CAP = 56         # max JSON escapes per row on the device tier


def _out_width(L: int, src_width: int = 0) -> int:
    """Static output width: a power of two covering the concatenated
    source row (``src_width`` = escaped line + constant bank + ts text)
    and typical GELF output for lines of width L.  It bounds a tier
    row's length (``out_len <= OW``)."""
    w = 512
    while w < 2 * L or w < src_width:
        w *= 2
    return w


def escape_stage(batch: torch.Tensor, lens: torch.Tensor,
                 assemble: bool = True) -> dict:
    """JSON-escape classification and (when assembling) the escaped row.

    Returns ``esc_row`` ([N, L+E_CAP] u8, or None), ``ne_total`` ([N]
    escapes per row), ``bad_ctl`` ([N, L] control bytes that need a
    6-byte ``\\u00XX`` escape — off the tier) and ``dmap(a)``, the
    escaped offset of raw offset ``a`` (``a`` plus the escapes before
    it)."""
    N, L = batch.shape
    i64 = torch.int64
    bb = batch.to(i64)
    iota = torch.arange(L, dtype=i64, device=batch.device).expand(N, L)
    valid = iota < lens.to(i64)[:, None]
    two_ctl = (bb == 8) | (bb == 9) | (bb == 10) | (bb == 12) | (bb == 13)
    esc = ((bb == 34) | (bb == 92) | two_ctl) & valid
    bad_ctl = (bb < 32) & ~two_ctl & valid
    esc_i = esc.to(i64)
    ne_incl = torch.cumsum(esc_i, dim=1)
    ne_excl = ne_incl - esc_i
    ne_total = ne_incl[:, -1]
    # escapes before each raw offset 0..L
    ecnt = torch.cat([torch.zeros((N, 1), dtype=i64, device=batch.device),
                      ne_incl], dim=1)

    esc_row = None
    if assemble:
        mapped = bb
        for code, ch in ((8, "b"), (9, "t"), (10, "n"), (12, "f"),
                         (13, "r")):
            mapped = torch.where(bb == code, ord(ch), mapped)
        mapped = torch.where(valid, mapped, 0)
        EW = L + E_CAP
        rows = torch.arange(N, device=batch.device)[:, None].expand(N, L)
        # each byte lands after the escapes before it (its own backslash
        # first); both placements are strictly increasing along a row, so
        # the two scatters never collide within themselves
        main = torch.zeros((N, EW), dtype=i64, device=batch.device)
        pref = torch.zeros((N, EW), dtype=i64, device=batch.device)
        main[rows, iota + torch.clamp(ne_incl, max=E_CAP)] = mapped
        pref[rows, iota + torch.clamp(ne_excl, max=E_CAP)] = \
            torch.where(esc, 92, 0)
        esc_row = (main | pref).to(torch.uint8)

    def dmap(a: torch.Tensor) -> torch.Tensor:
        a = a.to(i64)
        return a + ecnt.gather(1, a.clamp(0, L)[:, None])[:, 0]

    return {"esc_row": esc_row, "ne_total": ne_total, "bad_ctl": bad_ctl,
            "dmap": dmap}


def assemble_rows(segs, esc_row: torch.Tensor, bank: bytes,
                  ts_text: torch.Tensor, OW: int):
    """The [N, OW] output rows from the per-row segment table.

    ``segs`` is a list of ``(src0 [N], seglen [N])`` in destination
    order; sources index the concatenated row ``escaped line ∥ constant
    bank ∥ timestamp text``.  Each output byte finds its segment by a
    search over the segment ends and gathers its source byte.  Returns
    (rows, out_len)."""
    seg_src = torch.stack([s for s, _ in segs], dim=1)
    seg_len = torch.stack([ln for _, ln in segs], dim=1)
    ends = torch.cumsum(seg_len, dim=1)
    seg_dst = ends - seg_len
    out_len = ends[:, -1]
    N = esc_row.shape[0]
    const_row = torch.tensor(list(bank), dtype=torch.uint8,
                             device=esc_row.device)
    src2 = torch.cat([esc_row, const_row.expand(N, len(bank)),
                      ts_text.to(torch.uint8)], dim=1)
    W2 = src2.shape[1]
    if W2 > OW:
        raise ValueError(f"source row {W2} exceeds OW {OW}")
    o = torch.arange(OW, dtype=torch.int64,
                     device=esc_row.device).expand(N, OW).contiguous()
    k = torch.searchsorted(ends.contiguous(), o, right=True).clamp(
        max=seg_len.shape[1] - 1)
    src = seg_src.gather(1, k) + (o - seg_dst.gather(1, k))
    byte = src2.gather(1, src.clamp(0, W2 - 1))
    keep = (o < out_len[:, None]) & (src >= 0) & (src < W2)
    return torch.where(keep, byte, torch.zeros_like(byte)), out_len


def splice_elided_rows(body: np.ndarray, row_off: np.ndarray,
                       ts_lens: np.ndarray, head: bytes, ts_label: bytes,
                       tail: bytes):
    """Rebuild full output rows from constant-elided device rows: the
    head constant leads, the timestamp label goes before the row's last
    ``ts_lens[i]`` bytes (its timestamp text), the tail (with the
    framing suffix) trails.  One segment gather, 5 segments a row.
    Returns (full body, full row_off)."""
    R = row_off.size - 1
    lens = np.diff(row_off).astype(np.int64)
    deco = np.frombuffer(head + ts_label + tail, dtype=np.uint8)
    src = np.concatenate([np.asarray(body, dtype=np.uint8), deco])
    B = int(np.asarray(body).size)
    h, lb, tl = len(head), len(ts_label), len(tail)
    ts = np.asarray(ts_lens, dtype=np.int64)
    pre = lens - ts  # variable bytes before the timestamp text
    seg_src = np.stack([
        np.full(R, B, dtype=np.int64),
        row_off[:-1].astype(np.int64),
        np.full(R, B + h, dtype=np.int64),
        row_off[:-1].astype(np.int64) + pre,
        np.full(R, B + h + lb, dtype=np.int64),
    ], axis=1).ravel()
    seg_len = np.stack([
        np.full(R, h, dtype=np.int64), pre,
        np.full(R, lb, dtype=np.int64), ts,
        np.full(R, tl, dtype=np.int64),
    ], axis=1).ravel()
    out = concat_segments(src, seg_src, seg_len)
    return out, exclusive_cumsum(lens + h + lb + tl)


def splice_rows(body: np.ndarray, row_off: np.ndarray,
                ins_src: np.ndarray, ins_at: np.ndarray,
                ins_a: np.ndarray, ins_l: np.ndarray):
    """Generic per-row insertion splice for constant/computed elision.

    Every row gets K insertions: insertion k of row r takes
    ``ins_l[r, k]`` bytes from ``ins_src`` at offset ``ins_a[r, k]`` and
    lands at body-relative offset ``ins_at[r, k]`` (offsets ascending
    per row, measured in the elided body's coordinates).  One segment
    gather (2K+1 segments/row, native concat when available) rebuilds
    the full rows.  :func:`splice_elided_rows` is the fixed
    head/ts-label/tail specialization; the → LTSV tier uses this one
    because its elided constants sit at row-dependent offsets (mid-row
    gaps).  Returns (full body, full row_off)."""

    R = row_off.size - 1
    K = ins_at.shape[1]
    lens = np.diff(row_off).astype(np.int64)
    B = int(np.asarray(body).size)
    src = np.concatenate([np.asarray(body, dtype=np.uint8),
                          np.asarray(ins_src, dtype=np.uint8)])
    seg_src = np.empty((R, 2 * K + 1), dtype=np.int64)
    seg_len = np.empty((R, 2 * K + 1), dtype=np.int64)
    r0 = row_off[:-1].astype(np.int64)
    prev = np.zeros(R, dtype=np.int64)
    for k in range(K):
        at = np.minimum(np.asarray(ins_at[:, k], dtype=np.int64), lens)
        seg_src[:, 2 * k] = r0 + prev
        seg_len[:, 2 * k] = np.maximum(at - prev, 0)
        seg_src[:, 2 * k + 1] = B + np.asarray(ins_a[:, k], dtype=np.int64)
        seg_len[:, 2 * k + 1] = np.asarray(ins_l[:, k], dtype=np.int64)
        prev = np.maximum(at, prev)
    seg_src[:, 2 * K] = r0 + prev
    seg_len[:, 2 * K] = lens - prev
    out = concat_segments(src, seg_src.ravel(), seg_len.ravel())
    new_lens = lens + np.asarray(ins_l, dtype=np.int64).sum(axis=1)
    return out, exclusive_cumsum(new_lens)


def _ts_vals(small: Dict[str, np.ndarray]) -> np.ndarray:
    okh = small["ok"].astype(bool)
    return compute_ts({k: np.where(okh, small[k], 0)
                       for k in ("days", "sod", "off", "nanos")})


def ts_text_block(small: Dict[str, np.ndarray], ts_vals_fn=None,
                  render=None):
    """Per-row timestamp text ([R, TS_W] u8) and lengths ([R] int32):
    ``json_f64`` of each row's f64 stamp, formatted by the native host
    tier (``fg_format_f64_json``).  Rows whose ``ok`` is False get the
    text of 0.0 (a placeholder the tier never emits).
    ``ts_vals_fn(small, ok_mask) -> float64 array`` overrides the
    days/sod/off/nanos combine for a format whose tier carries other
    timestamp channels (the ltsv float spans: ``device_ltsv.
    ts_vals_ltsv``).  ``render(val) -> bytes`` overrides the json_f64
    notation for an output whose stamp text is not serde_json's (the →
    LTSV routes' Rust ``Display`` form), once per distinct stamp, as the
    reference does (device_common.py:686-726; a text longer than TS_W
    raises here, where the reference clips it)."""
    from .. import native

    vals = (_ts_vals(small) if ts_vals_fn is None
            else ts_vals_fn(small, small["ok"].astype(bool)))
    if render is not None:
        return _render_unique(vals, render)
    txt, lens = native.format_f64_json_native(vals, TS_W)
    # fetch_encode_driver's one-probe lengths rest on this bound; the
    # formatter gives a text longer than TS_W length 0
    if lens.size and int(lens.min()) == 0:
        raise AssertionError("a timestamp text exceeds TS_W")
    return txt, lens


def _ts_text_block_np(small: Dict[str, np.ndarray], ts_vals_fn=None):
    """The plain version of :func:`ts_text_block`: ``json_f64`` once
    per distinct stamp."""
    from ..utils.rustfmt import json_f64

    vals = (_ts_vals(small) if ts_vals_fn is None
            else ts_vals_fn(small, small["ok"].astype(bool)))
    return _render_unique(vals,
                          lambda v: json_f64(v).encode("ascii"))


def _render_unique(vals: np.ndarray, render):
    """``render`` once per distinct value: ([R, TS_W] u8, [R] int32)."""
    uniq, inv = np.unique(vals, return_inverse=True)
    txt = np.zeros((uniq.size, TS_W), dtype=np.uint8)
    ulen = np.zeros(uniq.size, dtype=np.int32)
    for u, val in enumerate(uniq):
        s = render(float(val))
        if len(s) > TS_W:
            raise AssertionError(f"timestamp text {s!r} exceeds TS_W")
        txt[u, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        ulen[u] = len(s)
    return txt[inv], ulen[inv]


def build_bank(parts: Dict[str, bytes], suffix: bytes):
    """Concatenate a device encoder's segment constants into one bank
    (the framing suffix rides the tail constant); returns
    (bank_bytes, {name: offset})."""
    offs, bank = {}, b""
    for k, v in parts.items():
        if k == "tail":
            v = v + suffix
        offs[k] = len(bank)
        bank += v
    return bank, offs


_AMBIG_LEN = 8     # name-key bytes captured for sorting
_BIG = 0x7FFFFFFF  # sort key for absent pairs (names are ASCII < 0x7f)

# optimal 12-comparator sorting network for 6 elements
_NET6 = ((0, 5), (1, 3), (2, 4), (1, 2), (3, 4), (0, 3), (2, 5),
         (0, 1), (2, 3), (4, 5), (1, 2), (3, 4))


@lru_cache(maxsize=None)
def _sort_network(n: int):
    """Comparator list sorting ``n`` elements: the 12-comparator network
    at 6, Batcher's odd-even mergesort at any other width (63
    comparators at 16)."""
    if n == 6:
        return _NET6
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            j = k % p
            while j <= n - 1 - k:
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2):
                        pairs.append((i + j, i + j + k))
                j += 2 * k
            k //= 2
        p *= 2
    return tuple(pairs)


def sort_pairs_by_key8(bb: torch.Tensor, cols: dict, max_pairs: int,
                       slot_valid=None):
    """Sort per-pair span columns by their names' first 8 bytes
    (serde_json's BTreeMap order) with a sorting network, and flag rows
    whose order the 8-byte prefix cannot decide.

    ``cols`` carries lists ``ns_raw``/``ne_raw`` (raw name spans, for the
    keys), the payload lists that ride the swaps and ``_pair_count``;
    this adds the ``hi``/``lo`` (signed int32 words of the name's bytes
    0-3 and 4-7) and ``nlen`` key lists, sorts everything in place and
    returns the ambig mask: equal 8-byte prefixes are orderable only
    when exactly one name is ≤ 8 bytes; equal-length or both-longer
    names (duplicates included, dict last-wins) leave the tier.

    Slots are normally compacted (the valid pairs first, gated by
    ``_pair_count``); ``slot_valid`` (a list of [N] bool, one a slot)
    marks the valid slots in place instead: the others key to _BIG and
    the sort itself moves them to the tail (``device_gelf_gelf`` feeds
    its fields in raw order so)."""
    N, L = bb.shape
    i64 = torch.int64
    pair_count = cols.pop("_pair_count")
    cols["hi"], cols["lo"], cols["nlen"] = [], [], []
    k8 = torch.arange(8, dtype=i64, device=bb.device)
    for p in range(max_pairs):
        ns_r = cols["ns_raw"][p].to(i64)
        ne_r = cols["ne_raw"][p].to(i64)
        pv = (p < pair_count) if slot_valid is None else slot_valid[p]
        pos = ns_r[:, None] + k8
        inn = (pos >= 0) & (pos < L) & (pos < ne_r[:, None])
        z = torch.where(inn, bb.gather(1, pos.clamp(0, L - 1)), 0)
        hi = _wrap32((z[:, 0] << 24) + (z[:, 1] << 16) + (z[:, 2] << 8)
                     + z[:, 3])
        lo = _wrap32((z[:, 4] << 24) + (z[:, 5] << 16) + (z[:, 6] << 8)
                     + z[:, 7])
        cols["hi"].append(torch.where(pv, hi, _BIG))
        cols["lo"].append(torch.where(pv, lo, _BIG))
        cols["nlen"].append(torch.where(pv, ne_r - ns_r, _BIG))

    payload = [k for k in cols if k not in ("hi", "lo", "nlen")]
    for i, j in _sort_network(max_pairs):
        ah, bh = cols["hi"][i], cols["hi"][j]
        al, bl = cols["lo"][i], cols["lo"][j]
        an, bn = cols["nlen"][i], cols["nlen"][j]
        swap = (bh < ah) | ((bh == ah) & ((bl < al)
                            | ((bl == al) & (bn < an))))
        for key in ("hi", "lo", "nlen", *payload):
            a, b = cols[key][i], cols[key][j]
            cols[key][i] = torch.where(swap, b, a)
            cols[key][j] = torch.where(swap, a, b)

    ambig = torch.zeros((N,), dtype=torch.bool, device=bb.device)
    for p in range(max_pairs - 1):
        keq = ((cols["hi"][p] == cols["hi"][p + 1])
               & (cols["lo"][p] == cols["lo"][p + 1])
               & (cols["hi"][p] != _BIG))
        la, lb = cols["nlen"][p], cols["nlen"][p + 1]
        ambig |= keq & ((la == lb) | ((la > _AMBIG_LEN)
                                      & (lb > _AMBIG_LEN)))
    return ambig


def gelf_route_ok(encoder, merger, extras_placeable) -> bool:
    """The device GELF tier applies to GELF output over line, NUL or
    syslen framing (or none), with ``gelf_extra`` keys that have static
    placement; ``FLOWGGER_DEVICE_ENCODE=0`` turns it off."""
    from ..encoders.gelf import GelfEncoder
    from ..mergers import LineMerger, NulMerger, SyslenMerger

    if os.environ.get("FLOWGGER_DEVICE_ENCODE", "1") == "0":
        return False
    if type(encoder) is not GelfEncoder:
        return False
    if encoder.extra and not extras_placeable(encoder.extra):
        return False
    return merger is None or type(merger) in (LineMerger, NulMerger,
                                              SyslenMerger)


def encode_route_ok(encoder, merger, enc_cls) -> bool:
    """The gate of the non-GELF device encode tiers (→ LTSV): the exact
    encoder type over line, NUL or syslen framing (or none), under the
    same ``FLOWGGER_DEVICE_ENCODE`` switch as the GELF tiers.  Their
    extras always place statically (``ltsv_extra`` renders to one
    constant blob), so there is no placement check."""
    from ..mergers import LineMerger, NulMerger, SyslenMerger

    if os.environ.get("FLOWGGER_DEVICE_ENCODE", "1") == "0":
        return False
    if type(encoder) is not enc_cls:
        return False
    return merger is None or type(merger) in (LineMerger, NulMerger,
                                              SyslenMerger)


# lanes share a handler's route_state (as the reference's lanes share
# its _device_route_state): one lock keeps the counts whole
_COUNT_LOCK = threading.Lock()


def _count(route_state, key: str, v: int = 1) -> None:
    if route_state is not None:
        with _COUNT_LOCK:
            route_state[key] = route_state.get(key, 0) + v


def fetch_encode_driver(kern, packed, encoder, merger, route_state,
                        suffix: bytes, syslen: bool, scalar_fn,
                        fallback_frac: float, decline_limit: int,
                        cooldown: int, wide=None, elide=None,
                        timings: Optional[dict] = None, ts_vals_fn=None,
                        ts_render=None):
    """The device tier's fetch flow (the reference's decisions, in its
    order):

    1. cooldown: a batch in a cooldown window goes to the host tier;
    2. phase 1: one probe of the real rows gives each row's tier bit
       before the width test and its length without the timestamp text
       (``base``, ``base_len``); the phase-1 tier is the width test at
       the pessimistic TS_W timestamp width, ``base & (base_len + TS_W
       <= OW)``, and only that bit crosses, so a stream that keeps
       declining never pays the timestamp text;
    3. when more than ``fallback_frac`` of the rows fall outside it, the
       wide probe (``wide()``: the batch decoded again at 16 pairs) if
       the format has one and is not cooling it down; then the decline,
       which after ``decline_limit`` in a row starts a cooldown of
       ``cooldown`` batches;
    4. the timestamp text of the phase-1 candidates, uploaded;
    5. each row's length, ``base_len + ts_len``.  The reference probes
       again with the real text widths and intersects with phase 1;
       since a text is at most TS_W bytes (``ts_text_block``) and the
       length grows with it, that intersection is phase 1 itself, so
       the tier rows are the phase-1 candidates and no second probe
       runs;
    6. the tier rows' elided bytes, assembled at their offsets (an
       exclusive scan of the gated lengths, on the device) in one flat
       buffer, fetched whole, the elided constants spliced back on the
       host;
    7. the syslen prefix, then the other rows through the scalar oracle
       (``finish_block``).

    ``kern`` is an object with ``probe(n) -> (base, base_len)`` and
    ``assemble(ts_text, ts_len, row_off, total, n) -> flat`` on the
    batch's device, ``N`` rows, the output width ``OW`` and
    ``small_channels() -> (dict, nbytes)`` (the ``ok`` and timestamp
    channels on the host: the reference driver's ``ts_keys``, which the
    row object knows; ``ts_vals_fn`` combines them when they are not the
    calendar four, and ``ts_render`` formats them when the output's
    stamp text is not json_f64, as :func:`ts_text_block` says).  A row
    object whose ``ts_in_row`` is False (the → LTSV tier) leaves the
    timestamp text out of its device rows altogether: its ``base_len``
    is the row's whole device length, the width test is ``base_len <=
    OW`` and the host splices the text back (``elide`` is then a
    callable that owns the whole splice: ``elide(body, row_off, small,
    ts_text, ts_len, ridx) -> (body, row_off)``, the reference's
    callable form).  Counts go to
    ``route_state``: ``taken``, ``declined``, ``cooled``, ``wide``,
    ``tier_rows``, ``fetch_bytes`` and ``emit_bytes`` beside the
    reference's hysteresis keys; ``timings`` (optional) collects the
    host-clock seconds of ``probe``, ``ts_text``, ``assemble_fetch`` and
    ``splice``.

    Returns (BlockResult | None, fetch_seconds); None = the caller runs
    the host tier."""
    from .block_common import apply_syslen_prefix, finish_block

    batch, lens, chunk, starts, orig_lens, n_real = packed
    n = int(n_real)
    N = kern.N

    if route_state is not None and route_state.get("cooldown", 0) > 0:
        route_state["cooldown"] -= 1
        _count(route_state, "cooled")
        return None, 0.0

    t_fetch = 0.0
    fetched = [0]
    clock = [time.perf_counter()]

    def _fetch(t: torch.Tensor) -> np.ndarray:
        nonlocal t_fetch
        t0 = time.perf_counter()
        h = t.cpu().numpy()
        t_fetch += time.perf_counter() - t0
        fetched[0] += h.nbytes
        return h

    def _stage(name: str) -> None:
        now = time.perf_counter()
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + now - clock[0]
        clock[0] = now

    ts_in_row = getattr(kern, "ts_in_row", True)

    def phase1(probed) -> np.ndarray:
        base, base_len = probed
        ts_w = TS_W if ts_in_row else 0
        return _fetch(base[:n] & (base_len[:n] + ts_w <= kern.OW))

    probed = kern.probe(n)
    tier1_np = phase1(probed)

    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    max_len = batch.shape[1]
    cand1 = tier1_np & (lens64 <= max_len)

    # pair-budget escalation: when the base width declines, probe the
    # batch decoded at 16 pairs before giving it to the host tier; a
    # failed wide probe cools the wide attempt down on its own
    if n and wide is not None and (1.0 - cand1.mean()) > fallback_frac:
        wide_cd = 0 if route_state is None else \
            route_state.get("wide_cooldown", 0)
        if wide_cd > 0:
            route_state["wide_cooldown"] = wide_cd - 1
        else:
            kern_w = wide()
            probed_w = kern_w.probe(n)
            cand1w = phase1(probed_w) & (lens64 <= max_len)
            if (1.0 - cand1w.mean()) <= fallback_frac:
                _count(route_state, "wide")
                kern, probed, cand1 = kern_w, probed_w, cand1w
            elif route_state is not None:
                route_state["wide_cooldown"] = cooldown

    if n and (1.0 - cand1.mean()) > fallback_frac:
        _count(route_state, "declined")
        _count(route_state, "fetch_bytes", fetched[0])
        if route_state is not None:
            route_state["declines"] = route_state.get("declines", 0) + 1
            if route_state["declines"] >= decline_limit:
                route_state["cooldown"] = cooldown
                route_state["declines"] = 0
        _stage("probe")
        return None, t_fetch
    if route_state is not None:
        route_state["declines"] = 0
    _stage("probe")

    small, nbytes = kern.small_channels(n)
    fetched[0] += nbytes
    # only phase-1 candidates get timestamp text; the others carry a
    # placeholder and stay off the tier
    small["ok"] = small["ok"].astype(bool) & cand1
    ts_np, ts_len_np = ts_text_block(small, ts_vals_fn, ts_render)
    ts_text = torch.zeros((N, TS_W), dtype=torch.uint8)
    ts_len = torch.zeros(N, dtype=torch.int32)
    ts_text[:n] = torch.from_numpy(ts_np)
    ts_len[:n] = torch.from_numpy(ts_len_np)
    ts_text = ts_text.to(kern.device)
    ts_len = ts_len.to(kern.device)
    _stage("ts_text")

    len_d = probed[1] + ts_len if ts_in_row else probed[1]
    # lengths are bounded by OW: they cross as u16
    len_np = _fetch(len_d[:n].to(torch.int32 if kern.OW > 0xFFFF
                                 else torch.uint16)).astype(np.int64)
    ridx = np.flatnonzero(cand1)
    total = int(len_np[ridx].sum())
    if ridx.size:
        cand_full = torch.zeros(N, dtype=torch.bool)
        cand_full[:n] = torch.from_numpy(cand1)
        gate = cand_full.to(kern.device)
        gated = torch.where(gate, len_d.to(torch.int64), 0)
        row_off = torch.where(gate, torch.cumsum(gated, 0) - gated, -1)
        body = _fetch(kern.assemble(ts_text, ts_len, row_off, total, n))
        row_off_h = exclusive_cumsum(len_np[ridx])
    else:
        body = np.zeros(0, dtype=np.uint8)
        row_off_h = np.zeros(1, dtype=np.int64)
    _stage("assemble_fetch")

    if callable(elide) and ridx.size:
        # a row-object splice: the → LTSV tier's constants and stamp sit
        # mid-row, at offsets its probe reported
        body, row_off_h = elide(body, row_off_h, small, ts_np,
                                ts_len_np.astype(np.int64), ridx)
    elif elide is not None and ridx.size:
        # the head / timestamp-label / tail constants the kernel left
        # out of the transfer, restored byte for byte
        body, row_off_h = splice_elided_rows(
            body, row_off_h, ts_len_np.astype(np.int64)[ridx], *elide)
    prefix_lens_tier = None
    if syslen and ridx.size:
        final_buf, row_off_h, prefix_lens_tier = apply_syslen_prefix(
            body, row_off_h, np.diff(row_off_h))
    else:
        final_buf = body.tobytes()
    _stage("splice")

    _count(route_state, "taken")
    _count(route_state, "tier_rows", int(ridx.size))
    _count(route_state, "fetch_bytes", fetched[0])
    _count(route_state, "emit_bytes", len(final_buf))
    res = finish_block(chunk, starts64, lens64, n, cand1, ridx, final_buf,
                       row_off_h, prefix_lens_tier, suffix, syslen, merger,
                       encoder, scalar_fn=scalar_fn)
    _stage("oracle")
    return res, t_fetch
