r"""Columnar DNS query-log decoder (dnstap-style TSV): kernel DN.

Scalar spec: decoders/dns.py.  The grammar is fixed — exactly six
tab-separated fields, ``ts client qname qtype rcode latency_us`` — so the
decode is one tab-ordinal scan, the positions of the first five tabs,
and a span plus an elementwise validation a field:

- ``ts`` validates as ``digits[.digits]`` (no dot at either edge); the
  exact f64 value is parsed on the host (``float(span)``, once per
  distinct stamp);
- ``latency_us`` validates as 1..19 plain digits (19 digits always fit
  u64; longer-but-still-u64 values are oracle work);
- ``client`` / ``qname`` must be non-empty; ``qtype`` / ``rcode`` are
  free spans.

Channel contract (the JAX package's ``tpu/dns.py`` ``decode_dns`` :44, on
every row): ``ok`` and ``has_high`` (bool) and twelve int32 span
channels.  On a row with fewer than five tabs the missing tab positions
are ``L``, clipped to the row's length; on a row with more, the first five
are taken and ``ok`` is False; ``lat_start`` may exceed the length.

Two implementations of one contract: :func:`decode_dns`, the plain
PyTorch version (the CPU takes it, and the tests hold it against the
JAX function), and the hand-written CUDA kernel ``csrc/decode_dns.cu``
(``kernels.decode_dns_cuda``), which writes the channels as one int32
``[14, N]`` tensor in :data:`KEYS` order.  Rows at and past ``n`` are
padding: they get an empty row's channels and their bytes are not read.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .rfc5424 import _extract

N_FIELDS = 6
MAX_LAT_DIGITS = 19  # 19 decimal digits always fit u64

# channel rows of the kernel's packed [14, N] int32 output
KEYS = ("ok", "has_high", "ts_start", "ts_end", "client_start",
        "client_end", "qname_start", "qname_end", "qtype_start",
        "qtype_end", "rcode_start", "rcode_end", "lat_start", "lat_end")
_BOOL_KEYS = ("ok", "has_high")


def unpack_channels(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Channel dict from the kernel's ``[14, N]`` int32 output; the
    dtypes match :func:`decode_dns`."""
    return {k: packed[i].to(torch.bool if k in _BOOL_KEYS else torch.int32)
            for i, k in enumerate(KEYS)}


def decode_dns(batch: torch.Tensor, lens: torch.Tensor,
               n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Decode a packed ``[N, L]`` uint8 batch with plain tensor ops: the
    channels, dtypes and values of the JAX package's ``decode_dns`` on
    every row.  With ``n``, the rows at and past it decode as empty rows
    (length 0), whatever they hold."""
    N, L = batch.shape
    i64 = torch.int64
    lens = lens.to(i64)
    if n is not None:
        lens = torch.where(torch.arange(N, device=batch.device) < n, lens, 0)
    iota = torch.arange(L, dtype=i64, device=batch.device).expand(N, L)
    valid = iota < lens[:, None]
    bb = torch.where(valid, batch, torch.zeros_like(batch)).to(i64)
    is_digit = (bb >= 48) & (bb <= 57)
    is_dot = bb == ord(".")

    is_tab = (bb == 9) & valid
    tab_ord = torch.cumsum(is_tab.to(i64), dim=1)
    ok = tab_ord[:, -1] == N_FIELDS - 1

    # the five separator positions (L where missing), clipped to the row
    tab_pos = _extract(is_tab, tab_ord, iota, N_FIELDS - 1, L)
    tab_pos = torch.minimum(tab_pos.to(i64), lens[:, None])
    t0, t1, t2, t3, t4 = (tab_pos[:, k] for k in range(N_FIELDS - 1))

    # ---- ts: digits[.digits] in [0, t0) ---------------------------------
    in_ts = (iota < t0[:, None]) & valid
    dot_bad = is_dot & ((iota == 0) | (iota == (t0 - 1)[:, None]))
    ts_viol = in_ts & ((~is_digit & ~is_dot) | dot_bad)
    n_dots = (in_ts & is_dot).sum(dim=1)
    ts_ok = ~ts_viol.any(dim=1) & (n_dots <= 1) & (t0 >= 1)

    # ---- latency: 1..19 plain digits in [t4+1, len) ----------------------
    lat_start = t4 + 1
    in_lat = (iota >= lat_start[:, None]) & valid
    lat_len = lens - lat_start
    lat_ok = (~(in_lat & ~is_digit).any(dim=1)
              & (lat_len >= 1) & (lat_len <= MAX_LAT_DIGITS))

    ok = ok & ts_ok & lat_ok & (t1 > t0 + 1) & (t2 > t1 + 1)
    out = {
        "ok": ok,
        "has_high": ((bb >= 128) & valid).any(dim=1),
        "ts_start": torch.zeros_like(lens), "ts_end": t0,
        "client_start": t0 + 1, "client_end": t1,
        "qname_start": t1 + 1, "qname_end": t2,
        "qtype_start": t2 + 1, "qtype_end": t3,
        "rcode_start": t3 + 1, "rcode_end": t4,
        "lat_start": lat_start, "lat_end": lens,
    }
    return {k: v.to(torch.bool if k in _BOOL_KEYS else torch.int32)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# submit / fetch (kernel on CUDA tensors, plain version on CPU tensors)
# ---------------------------------------------------------------------------

def decode_dns_submit(batch: torch.Tensor, lens: torch.Tensor,
                      n: Optional[int] = None):
    """Launch the decode of one packed batch (asynchronous on a CUDA
    device); pair with :func:`decode_dns_fetch`.  Rows at and past ``n``
    (default: none) are padding."""
    lens = lens.to(torch.int32)
    if batch.is_cuda:
        from .kernels import decode_dns_cuda

        out = decode_dns_cuda(batch, lens,
                              batch.shape[0] if n is None else n)
    else:
        out = decode_dns(batch, lens, n=n)
    return (out, batch, lens)


def decode_dns_fetch(handle) -> Dict[str, np.ndarray]:
    """Wait for a submitted decode and return host numpy channels."""
    out = handle[0]
    if isinstance(out, torch.Tensor):
        # one device-to-host copy of the packed channels
        out = unpack_channels(out.cpu())
    return {k: v.cpu().numpy() for k, v in out.items()}
