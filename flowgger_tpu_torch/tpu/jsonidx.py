r"""JSON structural index (simdjson stage 1, arxiv 1902.08318): the plain
PyTorch version of the stage-1 classifier the JSON-lines decode runs.

Translated from the JAX package's ``jsonidx.structural_index`` with the
compiled-NFA string machine (``string_impl="nfa"``) and the bit-packed
``sum`` extractors (``extract_impl="sum"``), so every channel of every
row — rejected and padding rows included — equals the reference's:

- byte classification: whitespace / quote / backslash / structural
  planes straight off the [N, L] batch;
- the string/escape automaton (``NFA_TABLE``) resolved by composing
  packed transition functions with a log-shift ladder; its escape parity
  is exact at any backslash-run length, and the ``ESC_RUN_CAP`` plane
  still flags rows whose quote follows a run of 16 or more;
- bounded-window lookarounds (``WS_WINDOW`` each way) for the previous
  and next significant byte, which assign token roles;
- a structural depth channel (``nested`` levels below the top object);
- key/value spans through the packed-ordinal extractors shared with the
  RFC5424 decode (``rfc5424._extract`` / ``_extract_counts``), whose
  slot arithmetic carries on collision rows exactly as the reference's.

Anything structurally surprising flags the row ``ok=False``; the host
re-runs the scalar oracle on it.  The hand-written CUDA kernel
(``csrc/structural_index.cu``) evaluates the same definitions with one
warp per row, in one pass of warp scans; ``jsonl.decode_jsonl_submit``
launches it for a CUDA batch and takes this version only for a batch on
the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch

from .rfc5424 import (ESC_RUN_CAP, _extract, _extract_counts, _shift_left,
                      _shift_right)

WS_WINDOW = 8

# value token classes; VT_OBJECT/VT_ARRAY only appear with nested > 0
# (copies of the JAX package's constants; a test holds them equal)
VT_STRING, VT_NUMBER, VT_TRUE, VT_FALSE, VT_NULL = 0, 1, 2, 3, 4
VT_OBJECT, VT_ARRAY = 5, 6

# the string/escape automaton: four states (in-string, backslash-run
# parity) 0 = outside/even, 1 = outside/odd, 2 = inside/even,
# 3 = inside/odd; each byte class maps to a state->state function packed
# two bits per state into one integer
_S = 4
_SB = 2


def _nfa_pack(dsts) -> int:
    word = 0
    for s, d in enumerate(dsts):
        word |= d << (_SB * s)
    return word


NFA_OTHER = _nfa_pack((0, 0, 2, 2))    # bs-run parity resets
NFA_QUOTE = _nfa_pack((2, 0, 0, 2))    # real toggles; escaped stays
NFA_BS = _nfa_pack((1, 0, 3, 2))       # parity toggles
NFA_IDENT = _nfa_pack((0, 1, 2, 3))    # ladder fill / start-of-row
NFA_TABLE = (NFA_OTHER, NFA_QUOTE, NFA_BS)

# the kernel's packed output: the 1-D keys, then each per-field key as
# max_fields channel rows (csrc/structural_index.cu writes this layout)
KEYS_1D = ("ok", "n_fields")
KEYS_F = ("key_start", "key_end", "val_start", "val_end", "val_type",
          "key_esc", "val_esc")
_BOOL_KEYS = ("ok", "key_esc", "val_esc")


def n_channels(max_fields: int) -> int:
    return len(KEYS_1D) + len(KEYS_F) * max_fields


def unpack_channels(packed: torch.Tensor,
                    max_fields: int) -> Dict[str, torch.Tensor]:
    """Channel dict from the kernel's ``[C, N]`` int32 output; the
    dtypes match :func:`structural_index`."""
    out = {}
    for i, k in enumerate(KEYS_1D):
        out[k] = packed[i]
    i = len(KEYS_1D)
    for k in KEYS_F:
        out[k] = packed[i:i + max_fields].t().contiguous()
        i += max_fields
    return {k: (v != 0) if k in _BOOL_KEYS else v for k, v in out.items()}


def _nfa_compose(g, f):
    """h = g∘f over packed transition functions."""
    h = torch.zeros_like(f)
    for s in range(_S):
        fs = (f >> (_SB * s)) & (_S - 1)
        h = h | (((g >> (_SB * fs)) & (_S - 1)) << (_SB * s))
    return h


def _nfa_string_machine(quote, is_bs):
    """``(outside, escaped)``: the exclusive automaton state at each
    position (the state its byte is consumed in) projected to the
    outside-string and odd-backslash-parity predicates."""
    L = quote.shape[1]
    f = torch.where(quote, NFA_QUOTE,
                    torch.where(is_bs, NFA_BS, NFA_OTHER)).to(torch.int64)
    k = 1
    while k < L:
        f = _nfa_compose(f, _shift_right(f, k, NFA_IDENT))
        k <<= 1
    st = _shift_right(f, 1, NFA_IDENT) & (_S - 1)   # state from start 0
    return st < 2, (st & 1) == 1


def _esc_cap_plane(is_bs):
    """Positions whose preceding backslash run reached ESC_RUN_CAP."""
    a_k = _shift_right(is_bs, 1, False)
    for k in range(2, ESC_RUN_CAP + 1):
        a_k = a_k & _shift_right(is_bs, k, False)
    return a_k


def structural_index(batch: torch.Tensor, lens: torch.Tensor,
                     max_fields: int, nested: int = 0
                     ) -> Dict[str, torch.Tensor]:
    """Tokenize a packed ``[N, L]`` uint8 batch of one-JSON-object lines
    into per-key span channels — the JAX package's
    ``structural_index(..., extract_impl="sum", string_impl="nfa")``,
    channel for channel.  ``ok``/``key_esc``/``val_esc`` are bool, the
    rest int32; ``n_fields`` stays un-zeroed on not-ok rows (the rescue
    screen reads it)."""
    N, L = batch.shape
    dev = batch.device
    i64 = torch.int64
    lens = lens.to(i64)
    iota = torch.arange(L, dtype=i64, device=dev).expand(N, L)
    valid = iota < lens[:, None]
    bb = torch.where(valid, batch.to(i64), torch.zeros((), dtype=i64,
                                                        device=dev))

    def flag(x):
        return x.to(i64)

    is_ws = ((bb == 32) | (bb == 9) | (bb == 10) | (bb == 13)) & valid
    nonws = valid & ~is_ws

    # ---- escaped quotes & string state -----------------------------------
    is_bs = (bb == 92) & valid
    quote = (bb == ord('"')) & valid
    outside, escaped = _nfa_string_machine(quote, is_bs)
    real_q = quote & ~escaped
    cap_viol = (_esc_cap_plane(is_bs) & quote).any(dim=1)
    open_q = real_q & outside
    close_q = real_q & ~outside
    inside_str = ~outside & valid
    ok = ~cap_viol

    # ---- bounded-window lookarounds -------------------------------------
    # ptb/ntb: byte of the nearest non-ws position within WS_WINDOW
    # before/after each position (0 when none is in the window)
    pv = torch.where(nonws, (iota << 8) | bb, -1)
    ptb_w = torch.full_like(pv, -1)
    for k in range(1, WS_WINDOW + 1):
        ptb_w = torch.maximum(ptb_w, _shift_right(pv, k, -1))
    ptb = torch.where(ptb_w >= 0, ptb_w & 255, 0)
    big = 1 << 30
    nv = torch.where(nonws, (iota << 8) | bb, big)
    ntb_w = torch.full_like(nv, big)
    for k in range(1, WS_WINDOW + 1):
        ntb_w = torch.minimum(ntb_w, _shift_left(nv, k, big))
    ntb = torch.where(ntb_w < big, ntb_w & 255, 0)

    # an outside-string whitespace run longer than WS_WINDOW flags the row
    run = flag(is_ws & outside)
    rw_run = run.clone()
    for k in range(1, WS_WINDOW + 1):
        rw_run = rw_run + _shift_right(run, k, 0)
    viol = rw_run == WS_WINDOW + 1

    # ---- structure: braces, brackets, depth ------------------------------
    lb = (bb == ord("{")) & outside
    rb = (bb == ord("}")) & outside
    lsb = (bb == ord("[")) & outside
    rsb = (bb == ord("]")) & outside
    if nested:
        open_br = lb | lsb
        close_br = rb | rsb
        # inclusive depth: the top-level '{' sits at 1, a nested open at
        # >= 2, a top-level-value close back at 1, the final '}' at 0
        depth = torch.cumsum(flag(open_br), 1) - torch.cumsum(flag(close_br),
                                                              1)
        viol |= (depth < 0) & valid
        max_depth = torch.where(valid, depth, 0).max(dim=1).values
        ok &= max_depth <= 1 + nested
        top = depth == 1
        lb_top = lb & top
        rb_end = rb & (depth == 0)
        viol |= lsb & top
        nested_close = close_br & top & ~rb_end
        viol |= nested_close & (ntb != ord(",")) & (ntb != ord("}"))
        cont_start = open_br & (depth == 2)
        is_cont_val = cont_start & (ptb == ord(":"))
        viol |= cont_start & ~is_cont_val
    else:
        depth = None
        top = outside
        lb_top, rb_end = lb, rb
        viol |= lsb | rsb
        nested_close = torch.zeros_like(lb)
        is_cont_val = torch.zeros_like(lb)
    # the first significant byte must be the object open, the last its
    # close (position and is-it-the-brace tag packed in one reduction)
    wf = torch.where(nonws, 2 * iota + flag(~lb), 2 * L + 2).min(dim=1).values
    first_is_lb = (wf & 1) == 0
    wl = torch.where(nonws, 2 * iota + flag(rb), -1).max(dim=1).values
    last_is_rb = (wl & 1) == 1
    ok &= first_is_lb & last_is_rb & ((wf >> 1) < (wl >> 1))

    # ---- token roles (top level only) -------------------------------------
    if nested:
        top_open_q = open_q & top
        top_close_q = close_q & (depth == 1)
        viol |= open_q & ~top & (depth < 2)
    else:
        top_open_q = open_q
        top_close_q = close_q
    is_key_open = top_open_q & ((ptb == ord("{")) | (ptb == ord(",")))
    is_val_open = top_open_q & (ptb == ord(":"))
    viol |= top_open_q & ~is_key_open & ~is_val_open
    is_key_close = top_close_q & (ntb == ord(":"))
    is_val_close = top_close_q & ~is_key_close
    viol |= is_val_close & (ntb != ord(",")) & (ntb != ord("}"))

    colon_out = (bb == ord(":")) & top & valid
    comma_out = (bb == ord(",")) & top & valid
    viol |= comma_out & (ntb != ord('"'))

    key_ord = torch.cumsum(flag(is_key_open), 1)
    kc_ord = torch.cumsum(flag(is_key_close), 1)

    # row counts: each is at most L, so the reference's packed count
    # words never carry and these are plain sums
    def count(m):
        return flag(m).sum(dim=1)

    n_keys = count(is_key_open)
    if nested:
        ok &= count(lb | lsb) == count(rb | rsb)   # balanced brackets
    ok &= (count(real_q) & 1) == 0                 # every string closed
    ok &= (count(lb_top) == 1) & (count(rb_end) == 1)
    ok &= count(is_key_close) == n_keys
    ok &= n_keys <= max_fields
    ok &= count(colon_out) == n_keys
    ok &= count(comma_out) == torch.clamp(n_keys - 1, min=0)

    # ---- literal/number runs ----------------------------------------------
    structural = colon_out | comma_out | lb | rb | real_q
    if nested:
        structural = structural | lsb | rsb
        is_lit = nonws & outside & top & ~structural
    else:
        is_lit = nonws & outside & ~structural
    lit_start = is_lit & ~_shift_right(is_lit, 1, False)
    lit_end_m = is_lit & ~_shift_left(is_lit, 1, False)
    viol |= is_lit & (key_ord == 0)
    viol |= is_bs & outside
    ok &= ~viol.any(dim=1)

    is_lit_val = lit_start & (ptb == ord(":"))
    is_val_start = is_val_open | is_lit_val | is_cont_val
    # literal tokens match against the next four bytes as one word
    w4 = ((bb << 24) | (_shift_left(bb, 1, 0) << 16)
          | (_shift_left(bb, 2, 0) << 8) | _shift_left(bb, 3, 0))
    true_at = w4 == int.from_bytes(b"true", "big")
    null_at = w4 == int.from_bytes(b"null", "big")
    false_at = (w4 == int.from_bytes(b"fals", "big")) & \
        (_shift_left(bb, 4, 0) == ord("e"))
    is_num0 = ((bb >= 48) & (bb <= 57)) | (bb == ord("-"))
    zero = torch.zeros_like(bb)
    vclass = torch.where(
        is_val_open, 1 + VT_STRING,
        torch.where(true_at, 1 + VT_TRUE,
                    torch.where(false_at, 1 + VT_FALSE,
                                torch.where(null_at, 1 + VT_NULL,
                                            torch.where(is_num0,
                                                        1 + VT_NUMBER,
                                                        zero)))))
    if nested:
        vclass = torch.where(
            is_cont_val,
            torch.where(bb == ord("{"), 1 + VT_OBJECT, 1 + VT_ARRAY),
            vclass)

    # ---- per-key extraction (packed-sum words) ----------------------------
    F = max_fields
    key_open_pos = _extract(is_key_open, key_ord, iota, F, L)
    key_close_pos = _extract(is_key_close, kc_ord, iota, F, L)
    # value position and class share one extraction word per slot: the
    # class rides the bits above the position field
    pbits = max(10, int(L + 1).bit_length())
    vs_packed = _extract(is_val_start, key_ord, iota | (vclass << pbits), F,
                         L, slot_bits=pbits + 3)
    val_start_pos = vs_packed & ((1 << pbits) - 1)
    val_class1 = vs_packed >> pbits
    val_close_pos = _extract(is_val_close, key_ord, iota, F, L)
    lit_end_pos = _extract(lit_end_m, key_ord, iota, F, L)
    val_token_m = is_val_close | lit_start
    if nested:
        val_token_m = val_token_m | is_cont_val
    val_tokens = _extract_counts(val_token_m, key_ord, F)
    esc_count = _extract_counts(is_bs & inside_str, key_ord, F)

    field_valid = torch.arange(F, device=dev)[None, :] < n_keys[:, None]
    ok &= torch.where(field_valid, val_tokens == 1,
                      val_tokens == 0).all(dim=1)
    ok &= torch.where(field_valid, val_class1 >= 1, True).all(dim=1)
    val_type = torch.where(field_valid, val_class1 - 1, -1)
    ok &= torch.where(field_valid, (key_open_pos < key_close_pos)
                      & (key_close_pos < val_start_pos), True).all(dim=1)

    # string values end at their close quote, containers at the matching
    # close bracket, literals at the last run byte + 1
    is_string = val_type == VT_STRING
    if nested:
        cont_close_pos = _extract(nested_close, key_ord, iota, F, L)
        is_cont = (val_type == VT_OBJECT) | (val_type == VT_ARRAY)
        val_end = torch.where(is_string, val_close_pos,
                              torch.where(is_cont, cont_close_pos + 1,
                                          lit_end_pos + 1))
        ok &= torch.where(field_valid & is_cont,
                          cont_close_pos > val_start_pos, True).all(dim=1)
    else:
        val_end = torch.where(is_string, val_close_pos, lit_end_pos + 1)
    val_end = torch.minimum(val_end, lens[:, None])
    # literal token length must match exactly (rejects "truex")
    lit_len = torch.where(val_type == VT_TRUE, 4,
                          torch.where(val_type == VT_FALSE, 5,
                                      torch.where(val_type == VT_NULL, 4,
                                                  -1)))
    ok &= torch.where(field_valid & (lit_len > 0),
                      val_end - val_start_pos == lit_len, True).all(dim=1)
    ok &= torch.where(field_valid & is_string,
                      val_close_pos > val_start_pos, True).all(dim=1)

    esc_flag = (esc_count > 0) & field_valid
    i32 = torch.int32
    return {
        "ok": ok,
        "n_fields": n_keys.to(i32),
        "key_start": (key_open_pos + 1).to(i32),
        "key_end": key_close_pos.to(i32),
        "val_start": torch.where(is_string, val_start_pos + 1,
                                 val_start_pos).to(i32),
        "val_end": val_end.to(i32),
        "val_type": val_type.to(i32),
        "key_esc": esc_flag,
        "val_esc": esc_flag & is_string,
    }
