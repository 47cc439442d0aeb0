"""Mixed-format auto-detect dispatch: ``input.format = "auto_tpu"``.

A stream mixing RFC5424, RFC3164, LTSV and GELF records (one collector
that receives RFC5424 from rsyslog, BSD syslog from network gear, LTSV
from web servers and GELF from applications).  Each batch is partitioned
by a first-bytes signature, every class's rows are gathered into a
sub-batch on the batch's device and decoded by that format's kernel,
and the results go back into input order, so the output is what a
single-format run of each line would give.

Signature rules (``classify``):

- ``{``                      → GELF JSON
- ``<digits>1␣`` (opt. BOM)  → RFC5424 (version tag after the PRI)
- ``<``            otherwise → RFC3164
- TAB and ``:``  in the line → LTSV
- anything else              → RFC3164 (the lenient legacy decoder)

``input.auto_extra_formats`` opts extra legs in: ``"jsonl"`` re-routes
the ``{`` signature to the JSON-lines leg; ``"dns"`` adds, ahead of the
LTSV rule, lines with exactly five tabs whose first field is a unix
timestamp (``digits[.digits]``): the dnstap-TSV signature (tpu/dns.py).
With either, the legs block-encode GELF and LTSV only.

On a CUDA batch the classifier is the hand-written kernel AC
(``kernels.classify_auto_cuda``, ``csrc/classify_auto.cu``), at every
row count and width; a batch on the CPU takes :func:`classify_plain`,
the plain PyTorch version of the same function.  With the dns leg both
also compute the reference's dns overlay (``_extras_adjust`` :159-191)
over the row's unstripped bytes, on the batch's device: AC's ``dns``
flag, so the batch is never copied to the host for it.  (The reference
classifies batches of fewer than 512 rows, or narrower than 19 bytes,
with numpy on the host, where its auto batches are framed; the port's
lie on the card, and stay there.)  Rows longer than
``input.tpu_max_line_len`` are re-classified from their raw bytes
(their tab/colon signature may lie past the clip).

A trimmed copy of the JAX package's ``tpu/autodetect.py``:
``auto_extra_formats`` (:42), ``_dns_signature`` (:60), ``classify``
(:74), ``classify_device`` (:97) with the dns overlay of
``_extras_adjust`` (:159, here :func:`classify_plain` and AC; its jsonl
overlay stays on the host), ``classify_packed`` (:194), ``_class_table``
(:276), ``decode_auto_packed`` (:286) and ``encode_auto_gelf_blocks``
(:326), GELF and LTSV output.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, ConfigError
from ..decoders.ltsv import LTSVDecoder
from .materialize import LineResult

F_RFC5424, F_RFC3164, F_LTSV, F_GELF, F_JSONL, F_DNS = 0, 1, 2, 3, 4, 5

_EXTRA_FORMATS = ("jsonl", "dns")


def auto_extra_formats(config: Config) -> Tuple[str, ...]:
    """The validated ``input.auto_extra_formats`` list (empty tuple = the
    classic four-class table)."""
    v = config.lookup("input.auto_extra_formats")
    if v is None:
        return ()
    if (not isinstance(v, list)
            or any(not isinstance(x, str) for x in v)):
        raise ConfigError(
            "input.auto_extra_formats must be a list of strings")
    bad = sorted(set(v) - set(_EXTRA_FORMATS))
    if bad:
        raise ConfigError(
            f"input.auto_extra_formats: unknown format(s) {bad} "
            f"(expected a subset of {list(_EXTRA_FORMATS)})")
    return tuple(x for x in _EXTRA_FORMATS if x in v)


def _dns_signature(b: bytes) -> bool:
    """Exactly five tabs and a ``digits[.digits]`` first field — the
    dnstap-TSV shape (decoders/dns.py grammar)."""
    if b.count(b"\t") != 5:
        return False
    head = b.split(b"\t", 1)[0]
    if not head:
        return False
    whole, dot, frac = head.partition(b".")
    if not whole.isdigit():
        return False
    return not dot or frac.isdigit()


def classify(raw: bytes, extras: Tuple[str, ...] = ()) -> int:
    """The class code of one line, from its raw bytes."""
    b = raw
    if b.startswith(b"\xef\xbb\xbf"):
        b = b[3:]
    if b.startswith(b"{"):
        return F_JSONL if "jsonl" in extras else F_GELF
    if b.startswith(b"<"):
        gt = b.find(b">", 1, 6)
        if gt > 1 and b[gt + 1:gt + 3] == b"1 " and b[1:gt].isdigit():
            return F_RFC5424
        return F_RFC3164
    # the dns signature checks the RAW bytes (no BOM strip): a BOM'd first
    # field is not a clean unix timestamp, and the overlay reads the rows
    # unstripped, so the two classifiers agree on such rows
    if "dns" in extras and _dns_signature(raw):
        return F_DNS
    if b"\t" in b and b":" in b:
        return F_LTSV
    return F_RFC3164


def classify_plain(batch: torch.Tensor, lens: torch.Tensor,
                   dns: bool = False) -> torch.Tensor:
    """The plain version of AC (any device): the ``classify`` decision
    table over each row's valid bytes of a packed ``[N, L]`` batch, one
    int8 class code a row.  Bytes past a row's length, and past ``L``,
    read as 0.  With ``dns``, the reference's dns overlay
    (``_extras_adjust`` :170-191): a row with exactly five tabs whose
    head (the bytes before the first tab) is non-empty ``digits[.digits]``
    with no dot at either edge, whose base class is LTSV or RFC3164 and
    whose first byte (unstripped) is not ``<`` or ``{``, is dns."""
    N, L = batch.shape
    lens = lens.to(torch.int64)
    iota = torch.arange(L, device=batch.device)
    valid = iota[None, :] < lens[:, None]
    bb = torch.where(valid, batch, torch.zeros_like(batch))
    zero = torch.zeros(N, dtype=batch.dtype, device=batch.device)

    def col(x, j):
        return x[:, j] if j < L else zero

    bom = ((lens >= 3) & (col(bb, 0) == 0xEF) & (col(bb, 1) == 0xBB)
           & (col(bb, 2) == 0xBF))
    shifted = torch.zeros_like(bb)
    shifted[:, :max(L - 3, 0)] = bb[:, 3:]
    G = torch.where(bom[:, None], shifted, bb)

    g0 = col(G, 0)
    is_gelf = g0 == ord("{")
    is_lt = g0 == ord("<")
    gt = torch.zeros(N, dtype=torch.int64, device=batch.device)
    for j in (2, 3, 4, 5):
        gt = torch.where((gt == 0) & (col(G, j) == ord(">")),
                         torch.full_like(gt, j), gt)
    digits_ok = torch.ones_like(is_lt)
    for j in (1, 2, 3, 4):
        g = col(G, j)
        digits_ok &= (j >= gt) | ((g >= 48) & (g <= 57))
    v1 = torch.zeros_like(g0)
    v2 = torch.zeros_like(g0)
    for j in (2, 3, 4, 5):
        sel = gt == j
        v1 = torch.where(sel, col(G, j + 1), v1)
        v2 = torch.where(sel, col(G, j + 2), v2)
    is5424 = is_lt & (gt >= 2) & digits_ok & (v1 == ord("1")) & (v2 == 32)
    has_tab = (bb == 9).any(dim=1)
    has_col = (bb == 58).any(dim=1)

    cls = torch.full((N,), F_RFC3164, dtype=torch.int8, device=batch.device)
    cls = torch.where(has_tab & has_col, torch.full_like(cls, F_LTSV), cls)
    cls = torch.where(is_lt, torch.full_like(cls, F_RFC3164), cls)
    cls = torch.where(is5424, torch.full_like(cls, F_RFC5424), cls)
    cls = torch.where(is_gelf, torch.full_like(cls, F_GELF), cls)
    if dns:
        is_tab = bb == 9
        five = is_tab.sum(dim=1) == 5
        ft = torch.where(is_tab, iota[None, :], L).amin(dim=1)
        in_head = (iota[None, :] < ft[:, None]) & valid
        is_digit = (bb >= 48) & (bb <= 57)
        is_dot = bb == ord(".")
        junk = (in_head & ~is_digit & ~is_dot).any(dim=1)
        dots = (in_head & is_dot).sum(dim=1)
        dot_edge = (in_head & is_dot & ((iota[None, :] == 0)
                                        | (iota[None, :]
                                           == (ft - 1)[:, None]))).any(dim=1)
        b0 = col(bb, 0)
        on = (five & (ft >= 1) & ~junk & (dots <= 1) & ~dot_edge
              & ((cls == F_LTSV) | (cls == F_RFC3164))
              & (b0 != ord("<")) & (b0 != ord("{")))
        cls = torch.where(on, torch.full_like(cls, F_DNS), cls)
    return cls


def classify_rows(batch: torch.Tensor, lens: torch.Tensor,
                  n: int, dns: bool = False) -> torch.Tensor:
    """The class codes of the first ``n`` rows, int8 [n], on the batch's
    device: AC on a CUDA batch, the plain version on a CPU one; ``dns``
    adds the dns overlay."""
    if batch.is_cuda:
        from .kernels import classify_auto_cuda

        return classify_auto_cuda(batch, lens.to(torch.int32), n, dns=dns)
    return classify_plain(batch[:n], lens[:n], dns=dns)


def _extras_adjust(cls: np.ndarray, extras) -> None:
    """The opt-in jsonl leg over a class vector: the ``{`` signature
    re-labels to jsonl.  (The dns overlay is the classifier's own:
    :func:`classify_rows` with ``dns``.)"""
    if "jsonl" in extras:
        cls[cls == F_GELF] = F_JSONL


def _reclassify_over(cls, chunk, starts, orig_lens, n, L, extras) -> None:
    """Rows longer than the batch's width from their raw bytes."""
    over = np.flatnonzero(np.asarray(orig_lens)[:n] > L)
    for i in over.tolist():
        s = int(np.asarray(starts)[i])
        ln = int(np.asarray(orig_lens)[i])
        cls[i] = classify(chunk[s:s + ln], extras)


def classify_packed(packed, extras=()) -> np.ndarray:
    """First-bytes classification of a packed batch, ``classify``'s
    decision table with no per-line Python, on the batch's device at any
    row count and width: AC on a CUDA batch, its plain version on a CPU
    one.  Rows longer than the batch's width are re-classified from
    their raw bytes."""
    batch, lens, chunk, starts, orig_lens, n = packed
    if n == 0:
        return np.zeros(0, dtype=np.int8)
    if not isinstance(batch, torch.Tensor):
        batch, lens = torch.from_numpy(batch), torch.from_numpy(lens)
    cls = classify_rows(batch, lens, n,
                        dns="dns" in extras).cpu().numpy().copy()
    _extras_adjust(cls, extras)
    _reclassify_over(cls, chunk, starts, orig_lens, n, batch.shape[1], extras)
    return cls


def _class_table(extras: Tuple[str, ...]):
    table = [(F_RFC5424, "rfc5424"), (F_RFC3164, "rfc3164"),
             (F_LTSV, "ltsv"), (F_GELF, "gelf")]
    if "jsonl" in extras:
        table.append((F_JSONL, "jsonl"))
    if "dns" in extras:
        table.append((F_DNS, "dns"))
    return table


def decode_auto_packed(packed, ltsv_decoder: Optional[LTSVDecoder] = None,
                       extras: Tuple[str, ...] = ()) -> List[LineResult]:
    """The Record path of a mixed batch: classify, decode each class's
    row subset with its format's kernel and materializer, and put the
    results back into input order."""
    from . import pack as packmod
    from .batch import _decode_packed

    if ltsv_decoder is None:
        ltsv_decoder = LTSVDecoder(Config.from_string(""))
    n = packed[5]
    classes = classify_packed(packed, extras)
    results: List[LineResult] = [None] * n  # type: ignore
    for cls, fmt in _class_table(extras):
        idx = np.flatnonzero(classes == cls)
        if not idx.size:
            continue
        sub = packmod.subset_packed(packed, idx)
        res = _decode_packed(fmt, sub,
                             ltsv_decoder if fmt == "ltsv" else None)
        for i, r in zip(idx.tolist(), res):
            results[i] = r
    return results


def encode_auto_gelf_blocks(packed, encoder, merger, ltsv_decoder=None,
                            route_state=None, extras=()):
    """Block-encode a mixed batch into GELF, LTSV, RFC5424 or capnp:
    classify, submit every class's decode on its row subset, run each
    class's leg (its split device tier, then its host block encoder, each
    leg under its own decline and cooldown state in
    ``route_state[format]``), and merge the legs' buffers back into input
    order with one segment gather.
    Returns a BlockResult, or None when a leg cannot apply (a
    ``gelf_extra``, a typed ``ltsv_schema``, an unsupported merger): the
    caller then takes the Record path.  The handler runs it on a lane's
    fetcher thread, inside the lane's stream, so AC and every leg's
    kernels launch there; the route economics does not govern the legs."""
    from ..block import EncodedBlock
    from ..encoders import GelfEncoder, LTSVEncoder
    from .assemble import concat_segments, exclusive_cumsum
    from .batch import block_fetch_encode, block_submit
    from .block_common import BlockResult, merger_suffix
    from . import pack as packmod

    if ltsv_decoder is None:
        ltsv_decoder = LTSVDecoder(Config.from_string(""))
    spec = merger_suffix(merger)
    if spec is None or ltsv_decoder.schema:
        return None
    # gelf_extra needs static placement the gelf leg cannot provide;
    # ltsv_extra and capnp_extra render inside every leg
    if type(encoder) is GelfEncoder and encoder.extra:
        return None
    if extras and type(encoder) not in (GelfEncoder, LTSVEncoder):
        # the jsonl / dns legs block-encode GELF and LTSV only
        return None
    suffix, syslen = spec

    n = packed[5]
    classes = classify_packed(packed, extras)
    submitted = []
    for cls, fmt in _class_table(extras):
        idx = np.flatnonzero(classes == cls)
        if not idx.size:
            continue
        sub = packmod.subset_packed(packed, idx)
        submitted.append((idx, fmt, sub, block_submit(fmt, sub)))
    legs = []
    for idx, fmt, sub, handle in submitted:
        res, _ = block_fetch_encode(fmt, handle, sub, encoder, merger,
                                    ltsv_decoder, route_state)
        if res is None:
            return None
        legs.append((idx, res))

    emit = np.zeros(n, dtype=bool)
    row_len = np.zeros(n, dtype=np.int64)
    row_src = np.zeros(n, dtype=np.int64)   # leg ordinal
    row_boff = np.zeros(n, dtype=np.int64)  # offset inside the leg's buffer
    row_pfx = np.zeros(n, dtype=np.int64)
    buffers = []
    errors = []
    error_rows = []
    fallback_rows = 0
    for li, (idx, res) in enumerate(legs):
        b = res.block
        erows = idx[np.flatnonzero(res.emit)]
        emit[erows] = True
        row_len[erows] = np.diff(b.bounds)
        row_src[erows] = li
        row_boff[erows] = b.bounds[:-1]
        if b.prefix_lens is not None:
            row_pfx[erows] = b.prefix_lens
        buffers.append(np.frombuffer(b.data, dtype=np.uint8))
        for (err, line), r in zip(res.errors, res.error_rows):
            errors.append((err, line))
            error_rows.append(int(idx[r]))
        fallback_rows += res.fallback_rows

    bases = exclusive_cumsum(np.array([b.size for b in buffers],
                                      dtype=np.int64))[:-1] \
        if buffers else np.zeros(0, dtype=np.int64)
    src = np.concatenate(buffers) if buffers else np.zeros(0, dtype=np.uint8)
    rows = np.flatnonzero(emit)
    seg_src = bases[row_src[rows]] + row_boff[rows] if rows.size else \
        np.zeros(0, dtype=np.int64)
    seg_len = row_len[rows]
    data = concat_segments(src, seg_src, seg_len).tobytes() if rows.size \
        else b""
    bounds = exclusive_cumsum(seg_len)
    prefix_lens = row_pfx[rows] if syslen else None

    # errors in input order (each leg's list is in its subset's order)
    if errors:
        order = np.argsort(np.array(error_rows, dtype=np.int64),
                           kind="stable")
        errors = [errors[i] for i in order.tolist()]

    block = EncodedBlock(data, bounds, prefix_lens, len(suffix))
    return BlockResult(block, errors, fallback_rows, emit=emit,
                       error_rows=sorted(error_rows))
