"""Columnar DNS block encoders: the fixed-grammar field spans
(tpu/dns.py) become framed GELF or LTSV bytes per batch.

The grammar is fixed, so both layouts are a constant segment skeleton
with six span/scratch holes — no per-row branching at all:

GELF (sorted keys — the three ``_``-pairs sort before every special)::

    {"_latency_us":L,"_qtype":"Q","_rcode":"R","host":"C",
     "short_message":"N","timestamp":T,"version":"1.1"}

LTSV (pair order = Record construction order, prefix stripped)::

    latency_us:L\tqtype:Q\trcode:R\t<extras>host:C\ttime:T\tmessage:N

The timestamp re-formats per row through the dedup scratch (json_f64 /
display_f64); the latency re-emits verbatim when canonical (no leading
zero).  Rows needing escaping — control bytes beyond the five tabs,
quotes/backslashes (GELF), non-ASCII — or a non-canonical latency take
the scalar oracle, keeping bytes identical to DNSDecoder→encoder in
every case.

A copy of the JAX package's ``tpu/encode_dns_block.py`` (``dns_screen``
:57, ``_assemble_fixed`` :97, ``encode_dns_gelf_block`` :143,
``encode_dns_ltsv_block`` :206).
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# these routes must stay byte-identical to, and the differential
# tests that enforce it
SCALAR_ORACLE = "flowgger_tpu_torch.decoders.dns:DNSDecoder"
DIFF_TEST = "tests/test_torch_dns.py::test_dns_block_matches_reference"

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from ..utils.rustfmt import json_f64
from .assemble import (
    build_source,
    concat_segments,
    count_in_spans,
    exclusive_cumsum,
)
from .block_common import (
    BlockResult,
    apply_syslen_prefix,
    finish_block,
    merger_suffix,
    span_f64_scratch,
)
from .materialize_dns import _scalar_dns


def dns_screen(chunk_bytes, starts, orig_lens, out, n_real: int,
               max_len: int, gelf_strings: bool):
    """Shared route screen: kernel-ok rows whose bytes re-emit
    verbatim.  ``gelf_strings`` additionally bans quotes/backslashes
    (JSON string escaping); both routes ban non-ASCII and any control
    byte other than the five separator tabs."""
    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    chunk_pad = np.concatenate(
        [chunk_arr, np.zeros(max_len + 2, dtype=np.uint8)])

    cand = ok & (lens64 <= max_len) & ~has_high
    # control bytes other than tab would need escaping in either output
    ctl_cum = np.cumsum((chunk_arr < 0x20) & (chunk_arr != 9))
    row_end = starts64 + lens64
    cand &= count_in_spans(ctl_cum, starts64, row_end) == 0
    if gelf_strings:
        esc_cum = np.cumsum((chunk_arr == ord('"'))
                            | (chunk_arr == ord("\\")))
        cand &= count_in_spans(esc_cum, starts64, row_end) == 0

    # latency must be canonical to re-emit verbatim ("007" parses to 7)
    lat_a = starts64 + np.asarray(out["lat_start"])[:n]
    lat_b = starts64 + np.asarray(out["lat_end"])[:n]
    cand &= (chunk_pad[lat_a] != ord("0")) | (lat_b - lat_a == 1)

    def span(key):
        a = starts64 + np.asarray(out[key + "_start"])[:n]
        b = starts64 + np.asarray(out[key + "_end"])[:n]
        return a, b

    return dict(n=n, starts64=starts64, lens64=lens64, cand=cand,
                chunk_arr=chunk_arr, span=span,
                lat_a=lat_a, lat_b=lat_b)


def _assemble_fixed(chunk_bytes, s, cols_fn, fmt_fn, suffix, syslen,
                    merger, encoder):
    """Shared fixed-skeleton assembly: ``cols_fn(ridx, consts_offsets,
    cbase, ts_off, ts_len)`` returns the per-row (src, len) column
    grid."""
    n, starts64, lens64, cand = (s["n"], s["starts64"], s["lens64"],
                                 s["cand"])
    chunk_arr = s["chunk_arr"]
    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None
    if R:
        tsa, tsb = s["span"]("ts")
        scratch, ts_off, ts_len = span_f64_scratch(
            chunk_bytes, tsa[ridx], tsb[ridx], fmt_fn)
        consts, offs, cbase, src = cols_fn.build(scratch, chunk_arr)
        cols = cols_fn(ridx, offs, cbase, ts_off, ts_len)
        FIXED = len(cols)
        fd = (np.arange(R, dtype=np.int64) * FIXED)[:, None] \
            + np.arange(FIXED, dtype=np.int64)[None, :]
        seg_src = np.empty(R * FIXED, dtype=np.int64)
        seg_len = np.empty(R * FIXED, dtype=np.int64)
        fsrc = np.empty((R, FIXED), dtype=np.int64)
        flen = np.empty((R, FIXED), dtype=np.int64)
        for k, (s_, ln) in enumerate(cols):
            fsrc[:, k] = s_
            flen[:, k] = ln
        seg_src[fd] = fsrc
        seg_len[fd] = flen
        dst0 = exclusive_cumsum(seg_len)
        body = concat_segments(src, seg_src, seg_len, dst0)
        rstart = np.arange(R, dtype=np.int64) * FIXED
        row_off = np.concatenate([dst0[rstart], dst0[-1:]])
        tier_lens = np.diff(row_off)
        if syslen:
            final_buf, row_off, prefix_lens_tier = apply_syslen_prefix(
                body, row_off, tier_lens)
        else:
            final_buf = body.tobytes()
    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder, scalar_fn=_scalar_dns)


def encode_dns_gelf_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    spec = merger_suffix(merger)
    if spec is None or encoder.extra:
        return None
    suffix, syslen = spec
    s = dns_screen(chunk_bytes, starts, orig_lens, out, n_real, max_len,
                   gelf_strings=True)

    class Cols:
        @staticmethod
        def build(scratch, chunk_arr):
            consts, offs = build_source(
                b'{"_latency_us":', b',"_qtype":"', b'","_rcode":"',
                b'","host":"', b'","short_message":"', b'","timestamp":',
                b',"version":"1.1"}' + suffix, scratch)
            cbase = int(chunk_arr.size)
            return consts, offs, cbase, np.concatenate(
                [chunk_arr, consts])

        def __call__(self, ridx, offs, cbase, ts_off, ts_len):
            (o_lat, o_qt, o_rc, o_host, o_short, o_ts, o_tail,
             o_scratch) = offs

            def sp(key):
                a, b = s["span"](key)
                return a[ridx], (b - a)[ridx]

            lat_a, lat_l = s["lat_a"][ridx], (s["lat_b"]
                                              - s["lat_a"])[ridx]
            qt_a, qt_l = sp("qtype")
            rc_a, rc_l = sp("rcode")
            cl_a, cl_l = sp("client")
            qn_a, qn_l = sp("qname")
            return (
                (cbase + o_lat, len(b'{"_latency_us":')),
                (lat_a, lat_l),
                (cbase + o_qt, len(b',"_qtype":"')),
                (qt_a, qt_l),
                (cbase + o_rc, len(b'","_rcode":"')),
                (rc_a, rc_l),
                (cbase + o_host, len(b'","host":"')),
                (cl_a, cl_l),
                (cbase + o_short, len(b'","short_message":"')),
                (qn_a, qn_l),
                (cbase + o_ts, len(b'","timestamp":')),
                (cbase + o_scratch + ts_off, ts_len),
                (cbase + o_tail, len(b',"version":"1.1"}')
                 + len(suffix)),
            )

    return _assemble_fixed(chunk_bytes, s, Cols(), json_f64, suffix,
                           syslen, merger, encoder)


def encode_dns_ltsv_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    from ..utils.rustfmt import display_f64
    from .block_common import ltsv_extra_blob

    spec = merger_suffix(merger)
    if spec is None:
        return None
    suffix, syslen = spec
    s = dns_screen(chunk_bytes, starts, orig_lens, out, n_real, max_len,
                   gelf_strings=False)
    extra_blob = ltsv_extra_blob(encoder.extra)

    class Cols:
        @staticmethod
        def build(scratch, chunk_arr):
            consts, offs = build_source(
                b"latency_us:", b"\tqtype:", b"\trcode:",
                b"\t" + extra_blob + b"host:", b"\ttime:",
                b"\tmessage:", suffix, scratch)
            cbase = int(chunk_arr.size)
            return consts, offs, cbase, np.concatenate(
                [chunk_arr, consts])

        def __call__(self, ridx, offs, cbase, ts_off, ts_len):
            (o_lat, o_qt, o_rc, o_host, o_time, o_msg, o_sfx,
             o_scratch) = offs

            def sp(key):
                a, b = s["span"](key)
                return a[ridx], (b - a)[ridx]

            lat_a, lat_l = s["lat_a"][ridx], (s["lat_b"]
                                              - s["lat_a"])[ridx]
            qt_a, qt_l = sp("qtype")
            rc_a, rc_l = sp("rcode")
            cl_a, cl_l = sp("client")
            qn_a, qn_l = sp("qname")
            return (
                (cbase + o_lat, len(b"latency_us:")),
                (lat_a, lat_l),
                (cbase + o_qt, len(b"\tqtype:")),
                (qt_a, qt_l),
                (cbase + o_rc, len(b"\trcode:")),
                (rc_a, rc_l),
                (cbase + o_host, len(b"\t" + extra_blob + b"host:")),
                (cl_a, cl_l),
                (cbase + o_time, len(b"\ttime:")),
                (cbase + o_scratch + ts_off, ts_len),
                (cbase + o_msg, len(b"\tmessage:")),
                (qn_a, qn_l),
                (cbase + o_sfx, len(suffix)),
            )

    return _assemble_fixed(chunk_bytes, s, Cols(), display_f64, suffix,
                           syslen, merger, encoder)
