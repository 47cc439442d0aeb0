"""Seeded mixed corpora and their scalar-path expectation.

Used by ``chip_smoke.py`` and the differential tests to drive every
branch of the device paths:

- :func:`make_corpus` — RFC5424 lines: well-formed with 0-6 SD pairs,
  rows for the 16-pair rescue decode, rows beyond it and beyond four SD
  elements (scalar oracle), escaped quotes including backslash runs past
  the kernel's escape cap, malformed lines (stderr), over-length lines,
  CRLF endings and non-ASCII messages;
- :func:`make_tier_corpus` — RFC5424 lines the device encode tier takes
  (:data:`TIER_MIX`): ~97 % 0-6-pair rows, some with characters the
  JSON escape map carries, and ~3 % outside the tier;
- :func:`make_ltsv_out_tier_corpus` — RFC5424 lines the → LTSV device
  tier takes (:data:`LTSV_OUT_TIER_MIX`: the tier mix without tabs);
- :func:`make_jsonl_corpus` — JSON-lines rows (:data:`JSONL_MIX`), every
  one with a numeric ``timestamp``: flat objects, rows for the 24-field
  rescue and beyond it, nested containers within and past the depth cap,
  escaped strings with backslash runs up to 24, malformed rows,
  whitespace runs past the lookaround window, over-length, CRLF and
  non-ASCII rows;
- :func:`make_rfc3164_corpus` — one day's BSD-syslog stream
  (:data:`RFC3164_MIX`) in RFC 3164's §4.1 / §5.4 layout
  ``<PRI>Mmm dd hh:mm:ss host tag[pid]: msg``, and the rows of it the
  fast path leaves to the scalar oracle;
- :func:`make_rfc3164_tier_corpus` — BSD-syslog lines the device encode
  tier takes (:data:`RFC3164_TIER_MIX`), dated a single-digit day;
- :func:`make_ltsv_corpus` — LTSV access-log rows with ltsv.org's
  recommended labels (:data:`LTSV_MIX`): 8-14 pairs, ``time`` as RFC3339,
  a unix float or the bracketed Apache form, and the odd rows;
- :func:`make_ltsv_tier_corpus` — LTSV rows the device encode tiers take
  (:data:`LTSV_TIER_MIX`);
- :func:`make_gelf_corpus` — GELF 1.1 payloads (:data:`GELF_MIX`): the
  five specials, 3-9 additional fields, floats and escaped full
  messages, and the odd rows (no timestamp: :func:`mask_wall_stamps`);
- :func:`make_gelf_tier_corpus` — GELF payloads the device encode tiers
  take (:data:`GELF_TIER_MIX`);
- :func:`make_auto_corpus` — one collector's mixed stream for
  ``auto_tpu`` (:data:`AUTO_MIX`): the rfc5424, rfc3164, ltsv and gelf
  corpora interleaved ~40 / 30 / 15 / 15 %, plus the classifier's edge
  rows (:data:`AUTO_EDGE`); with ``tier=True`` from the four tier mixes;
- :func:`make_dns_corpus` — dnstap-style TSV query logs
  (:data:`DNS_MIX`), ``ts client qname qtype rcode latency_us``, with
  ~3 % edge rows (:data:`DNS_EDGE_KINDS`); :func:`make_dns_tier_corpus`
  the same stream without them;
- :func:`syslen_stream` — any line list as octet-counted frames
  (``<len> <line>`` back to back), the last frame cut short.

:func:`scalar_expectation` runs the port's scalar decoder and encoder
(GELF, json, LTSV, RFC5424, RFC3164 or passthrough) over the same bytes with the splitters' semantics — what
the batched path must reproduce byte for byte, stderr lines included
(for ``auto`` each line's class picks its decoder, as the classifier
does).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .config import Config
from .decoders import (DecodeError, DNSDecoder, GelfDecoder, JSONLDecoder,
                       LTSVDecoder, RFC3164Decoder, RFC5424Decoder)
from .encoders import (CapnpEncoder, EncodeError, GelfEncoder, LTSVEncoder,
                       PassthroughEncoder, RFC3164Encoder, RFC5424Encoder)
from .mergers import NulMerger

# (kind, share) — the line mix
MIX = (
    ("plain", 0.70), ("rescue", 0.08), ("over", 0.04), ("escape", 0.04),
    ("malformed", 0.05), ("long", 0.03), ("crlf", 0.03), ("high", 0.03),
)

_WORDS = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
          "theta", "iota", "kappa", "lambda", "mu", "request", "served",
          "GET", "/index.html", "200", "user=42", "timeout", "retry")
_VALUES = ("v", "a b", "x=y", "[8]", "path/to/x", "42", "", "tab\tsep",
           "semi;colon", "end]")
_VALUES_NO_TAB = tuple(v for v in _VALUES if "\t" not in v)
_MALFORMED = (
    "13>1 2015-08-05T15:53:45Z h a p m - no bracket",
    "<13>2 2015-08-05T15:53:45Z h a p m - version",
    "<999>1 2015-08-05T15:53:45Z h a p m - pri",
    "<>1 2015-08-05T15:53:45Z h a p m - empty pri",
    "<13>1 - h a p m - nil timestamp",
    "<13>1 2015-08-05T15:53:45Z h a p m x not dash",
    "<13>1 2015-08-05T15:53:45Z h a p",
    "<13>1 2016-12-31T23:59:60Z h a p m - leap second",
    "<13>1 2015-02-30T15:53:45Z h a p m - bad day",
    "<13>1 2015-08-05T15:53:45.0123456789Z h a p m - ten digits",
    '<13>1 2015-08-05T15:53:45Z h a p m [id k="v"]',
    '<13>1 2015-08-05T15:53:45Z h a p m [id  spaced = bogus',
    '<13>1 2015-08-05T15:53:45Z h a p m [id una="unterminated',
    "<13>1 2015-08-05T15:53:45Z h a p m [id] m",
    "",
)


def _ts(rng) -> str:
    frac = ("", f".{int(rng.integers(1, 999999999)):d}"[:int(rng.integers(2, 11))],
            ".5", ".637824")[int(rng.integers(0, 4))]
    off = ("Z", "z", "+02:00", "-07:30", "+00:00", "-11:45")[int(rng.integers(0, 6))]
    return (f"20{int(rng.integers(10, 38)):02d}-{int(rng.integers(1, 13)):02d}-"
            f"{int(rng.integers(1, 29)):02d}T{int(rng.integers(0, 24)):02d}:"
            f"{int(rng.integers(0, 60)):02d}:{int(rng.integers(0, 60)):02d}"
            f"{frac}{off}")


def _msg(rng, words: int) -> str:
    return " ".join(_WORDS[int(i)] for i in rng.integers(0, len(_WORDS), words))


def _sd(rng, n_elems: int, n_pairs: int, value_fn=None) -> str:
    """``n_elems`` SD elements carrying ``n_pairs`` pairs in total."""
    per = [0] * n_elems
    for i in range(n_pairs):
        per[int(rng.integers(0, n_elems))] += 1
    out = []
    k = 0
    for e in range(n_elems):
        pairs = []
        for _ in range(per[e]):
            v = value_fn(k) if value_fn else _VALUES[int(rng.integers(0, len(_VALUES)))]
            pairs.append(f'k{k:02d}="{v}"')
            k += 1
        body = " " + " ".join(pairs) if pairs else " "
        out.append(f"[id{e}@{int(rng.integers(1, 99999))}{body}]")
    return "".join(out)


def _head(rng) -> str:
    return (f"<{int(rng.integers(0, 192))}>1 {_ts(rng)} host-{int(rng.integers(0, 50))} "
            f"app{int(rng.integers(0, 9))} {int(rng.integers(1, 65535))} "
            f"ID{int(rng.integers(0, 99))}")


def make_line(rng, kind: str) -> bytes:
    if kind == "malformed":
        return _MALFORMED[int(rng.integers(0, len(_MALFORMED)))].encode()
    head = _head(rng)
    if kind == "plain":
        if rng.random() < 0.2:
            sd = "-"
        else:
            sd = _sd(rng, int(rng.integers(1, 5)), int(rng.integers(0, 7)))
        return f"{head} {sd} {_msg(rng, int(rng.integers(1, 12)))}".encode()
    if kind == "rescue":
        sd = _sd(rng, int(rng.integers(1, 5)), int(rng.integers(7, 17)),
                 lambda k: str(k))
        return f"{head} {sd} {_msg(rng, 3)}".encode()
    if kind == "over":
        if rng.random() < 0.5:
            sd = _sd(rng, 2, int(rng.integers(17, 24)), lambda k: str(k))
        else:
            sd = _sd(rng, int(rng.integers(5, 8)), 5, lambda k: "x")
        return f"{head} {sd} {_msg(rng, 2)}".encode()
    if kind == "escape":
        run = int(rng.choice([1, 2, 3, 14, 15, 16, 17, 24]))
        quote = "\\" * run + ('"' if run % 2 else '\\"')
        sd = f'[esc@1 q="a{quote}b" r="c\\]d"]'
        return f"{head} {sd} {_msg(rng, 2)}".encode()
    if kind == "long":
        sd = _sd(rng, 1, 2)
        return f"{head} {sd} {_msg(rng, 120)}".encode()
    if kind == "crlf":
        return f"{head} - {_msg(rng, 4)}\r".encode()
    if kind == "high":
        return f"{head} - {_msg(rng, 3)} ünïcødé ✓ 日本".encode()
    if kind in ("tier", "ltsv_tier"):
        # ltsv_tier: no tab anywhere (the → LTSV tier's value-escape
        # screen), so no "tab\tsep" SD value and no "col\tsep" word
        clean = kind == "ltsv_tier"
        vals = _VALUES_NO_TAB if clean else _VALUES
        sd = "-" if rng.random() < 0.2 else \
            _sd(rng, int(rng.integers(1, 5)), int(rng.integers(0, 7)),
                lambda k: vals[int(rng.integers(0, len(vals)))])
        words = _msg(rng, int(rng.integers(1, 12))).split(" ")
        if rng.random() < 0.2:
            # a character the JSON escape map must carry
            at = int(rng.integers(0, len(words) + 1))
            words.insert(at, ('say "hi"', "C:\\temp\\x", "col\tsep")[
                int(rng.integers(0, 2 if clean else 3))])
        return f"{head} {sd} {' '.join(words)}".encode()
    raise ValueError(kind)


def make_corpus(n_lines: int, seed: int) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` lines (without separators) and their kinds, drawn from
    :data:`MIX` with ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    kinds, shares = zip(*MIX)
    picks = rng.choice(len(kinds), size=n_lines, p=np.asarray(shares) / sum(shares))
    lines = [make_line(rng, kinds[int(k)]) for k in picks]
    return lines, [kinds[int(k)] for k in picks]


# (kind, share) — the mix the device encode tier takes: 0-6-pair rows
# with distinct SD names, a fifth of them with a quote, backslash or tab
# in the message, and ~3 % of rows outside the tier (malformed,
# non-ASCII, 7-16 pairs), under its 5 % decline threshold
TIER_MIX = (("tier", 0.97), ("malformed", 0.01), ("high", 0.01),
            ("rescue", 0.01))


def make_tier_corpus(n_lines: int, seed: int
                     ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` RFC5424 lines and their kinds, drawn from
    :data:`TIER_MIX` with ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    kinds, shares = zip(*TIER_MIX)
    picks = rng.choice(len(kinds), size=n_lines, p=np.asarray(shares) / sum(shares))
    lines = [make_line(rng, kinds[int(k)]) for k in picks]
    return lines, [kinds[int(k)] for k in picks]


# the → LTSV tier's mix (device_ltsv_out): TIER_MIX's shares with
# "ltsv_tier" rows, which carry no tab (an SD value or a message word
# with a tab needs the LTSV value escape and leaves that tier)
LTSV_OUT_TIER_MIX = (("ltsv_tier", 0.97), ("malformed", 0.01),
                     ("high", 0.01), ("rescue", 0.01))


def make_ltsv_out_tier_corpus(n_lines: int, seed: int
                              ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` RFC5424 lines the → LTSV device tier takes, drawn from
    :data:`LTSV_OUT_TIER_MIX` with ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    kinds, shares = zip(*LTSV_OUT_TIER_MIX)
    picks = rng.choice(len(kinds), size=n_lines,
                       p=np.asarray(shares) / sum(shares))
    lines = [make_line(rng, kinds[int(k)]) for k in picks]
    return lines, [kinds[int(k)] for k in picks]


# (kind, share) — the JSON-lines mix
JSONL_MIX = (
    ("flat", 0.60), ("wide", 0.10), ("over", 0.03), ("nested", 0.05),
    ("deep", 0.02), ("escape", 0.04), ("malformed", 0.05), ("ws", 0.02),
    ("long", 0.03), ("crlf", 0.03), ("high", 0.03),
)
_JSON_MALFORMED = (
    '{"timestamp":20,"host":"h",}',            # trailing comma
    '{"timestamp":21,"k":}',                   # missing value
    '{"timestamp":22,"k":01}',                 # leading zero
    '{"timestamp":23,"k":truex}',              # bad literal
    '{"timestamp":24,"k":[1,2}',               # mismatched brackets
    '{"timestamp":25 "k":1}',                  # missing comma
    '{"timestamp":26,"k":"unterminated}',
    '[1,2,3]',
    'not json at all',
    '',
    '{"timestamp":"a string","host":"h"}',
    '{"timestamp":27,"level":9}',
    '{"timestamp":28,"host":42}',
)


def _json_value(rng) -> str:
    r = int(rng.integers(0, 12))
    if r == 0:
        return str(int(rng.integers(-10**6, 10**6)))
    if r == 1:
        return ("true", "false", "null")[int(rng.integers(0, 3))]
    if r == 2:
        return f"{float(rng.integers(0, 10**6)) / 100:.2f}"
    return '"' + _msg(rng, int(rng.integers(0, 4))) + '"'


def _jts(rng) -> str:
    base = int(rng.integers(10**9, 2 * 10**9))
    return (str(base), f"{base}.{int(rng.integers(0, 1000)):03d}",
            f"{base}.5")[int(rng.integers(0, 3))]


def _json_obj(rng, n_other: int, msg: str = None, extra=()) -> str:
    """An object with timestamp/host/message/level, ``n_other`` more
    pairs and the ``extra`` pre-rendered pairs, in a shuffled key order
    with a little whitespace."""
    pairs = [f'"timestamp":{_jts(rng)}',
             f'"host":"host-{int(rng.integers(0, 50))}"',
             '"message":"' + (msg if msg is not None
                              else _msg(rng, int(rng.integers(1, 9)))) + '"',
             f'"level":{int(rng.integers(0, 8))}']
    pairs += [f'"f{k:02d}":{_json_value(rng)}' for k in range(n_other)]
    pairs += list(extra)
    order = rng.permutation(len(pairs))
    sep = (",", ", ", " , ")[int(rng.integers(0, 3))]
    return "{" + sep.join(pairs[int(i)] for i in order) + "}"


def make_jsonl_line(rng, kind: str) -> bytes:
    if kind == "malformed":
        return _JSON_MALFORMED[int(rng.integers(0, len(_JSON_MALFORMED)))
                               ].encode()
    if kind == "flat":
        return _json_obj(rng, int(rng.integers(1, 5))).encode()
    if kind == "wide":
        return _json_obj(rng, int(rng.integers(5, 21))).encode()
    if kind == "over":
        return _json_obj(rng, int(rng.integers(21, 30))).encode()
    if kind in ("nested", "deep"):
        depth = int(rng.integers(1, 5)) if kind == "nested" \
            else int(rng.integers(5, 8))
        inner = _json_value(rng)
        for d in range(depth):
            inner = (f'{{"d{d}":{inner},"n":1}}' if d % 2
                     else f'[{inner},"}}",null]')
        return _json_obj(rng, 1, extra=(f'"ctx":{inner}',)).encode()
    if kind == "escape":
        run = int(rng.choice([1, 2, 3, 14, 15, 16, 17, 24]))
        q = "a" + "\\" * run + ('"' if run % 2 else "") + "b"
        esc = ('"path":"' + q + '"', '"e":"tab\\tnew\\nu\\u00e9"')
        return _json_obj(rng, 1, extra=esc[:int(rng.integers(1, 3))]
                         ).encode()
    if kind == "ws":
        return _json_obj(rng, 2, extra=(
            '"pad":' + " " * int(rng.integers(9, 20)) + "1",)).encode()
    if kind == "long":
        return _json_obj(rng, 2, msg=_msg(rng, 100)).encode()
    if kind == "crlf":
        return _json_obj(rng, 2).encode() + b"\r"
    if kind == "high":
        return _json_obj(rng, 1, msg=_msg(rng, 3) + " ünïcødé ✓ 日本"
                         ).encode()
    raise ValueError(kind)


def make_jsonl_corpus(n_lines: int, seed: int
                      ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` JSON-lines rows (without separators) and their kinds,
    drawn from :data:`JSONL_MIX` with ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    kinds, shares = zip(*JSONL_MIX)
    picks = rng.choice(len(kinds), size=n_lines,
                       p=np.asarray(shares) / sum(shares))
    lines = [make_jsonl_line(rng, kinds[int(k)]) for k in picks]
    return lines, [kinds[int(k)] for k in picks]


# (kind, share) — a day of BSD syslog as daemons write it (RFC 3164
# §4.1, §5.4): "fast" is the layout <PRI>Mmm dd hh:mm:ss host tag[pid]:
# msg with lowercase short names, FQDNs and IPv4 hosts; the rest are
# the shapes the fast path sends to the scalar oracle or that decode
# through it the same way: no PRI (fast), a capitalised single-token
# host (the timezone-lookalike guard), a double space or tab in the
# message, a trailing space, over-512-byte rows, non-ASCII, CRLF
# endings (framing strips the CR: fast), malformed month, time or PRI
RFC3164_MIX = (
    ("fast", 0.85), ("nopri", 0.03), ("tzhost", 0.02), ("space", 0.02),
    ("trailing", 0.01), ("long", 0.02), ("high", 0.02), ("crlf", 0.02),
    ("malformed", 0.01),
)
# the mix the device encode tier takes: ~97 % fast rows, the rest
# outside the tier, under its 5 % decline threshold
RFC3164_TIER_MIX = (("fast", 0.97), ("tzhost", 0.01), ("high", 0.01),
                    ("malformed", 0.01))
_HOSTS = ("web01", "db-3", "cache7", "lb0", "api-gw", "mx2")
_DOMAINS = ("example.com", "corp.internal", "eu-west.prod.net")
_TAGS = ("sshd", "CRON", "kernel", "nginx", "postfix/smtpd", "systemd",
         "su", "dhclient")
_TZ_HOSTS = ("Gateway", "Router", "NAS", "Printer", "UTC", "EST")
_MONTH = "Oct"
_MALFORMED_3164 = (
    "<13>Foo {d} 10:11:12 host app: bad month",
    "<13>{m} {d} 25:61:00 host app: bad time",
    "<999>{m} {d} 10:11:12 host app: bad pri",
    "<13{m} {d} 10:11:12 host app: unterminated pri",
    "<13>{m} {d} 10:11:12",
    "{m} {d}",
    "just some words",
    "",
)


def _host3164(rng) -> str:
    r = int(rng.integers(0, 3))
    if r == 0:
        return _HOSTS[int(rng.integers(0, len(_HOSTS)))]
    if r == 1:
        return (f"{_HOSTS[int(rng.integers(0, len(_HOSTS)))]}."
                f"{_DOMAINS[int(rng.integers(0, len(_DOMAINS)))]}")
    return ".".join(str(int(v)) for v in rng.integers(1, 255, 4))


def make_rfc3164_line(rng, kind: str, day: int, sod: int) -> bytes:
    """One BSD-syslog line of ``kind`` dated ``_MONTH`` ``day`` at second
    ``sod`` of the day (the day padded to two places with a space, RFC
    3164 §4.1.2)."""
    dd = f"{day:2d}"
    stamp = f"{_MONTH} {dd} {sod // 3600:02d}:{sod // 60 % 60:02d}:{sod % 60:02d}"
    pri = f"<{int(rng.integers(0, 192))}>"
    tag = _TAGS[int(rng.integers(0, len(_TAGS)))]
    pid = f"[{int(rng.integers(1, 65536))}]" if rng.random() < 0.7 else ""
    msg = _msg(rng, int(rng.integers(1, 14)))
    if rng.random() < 0.15:
        msg += ' path="/var/log/x" user=\\root'
    host = _host3164(rng)
    if kind == "malformed":
        t = _MALFORMED_3164[int(rng.integers(0, len(_MALFORMED_3164)))]
        return t.format(m=_MONTH, d=dd).encode()
    if kind == "nopri":
        pri = ""
    elif kind == "tzhost":
        host = _TZ_HOSTS[int(rng.integers(0, len(_TZ_HOSTS)))]
    elif kind == "space":
        gap = "  " if rng.random() < 0.5 else "\t"
        msg = msg + gap + "extra"
    elif kind == "trailing":
        msg += " "
    elif kind == "long":
        msg = _msg(rng, 100)
    elif kind == "high":
        msg += " caf\u00e9 \u2713"
    line = f"{pri}{stamp} {host} {tag}{pid}: {msg}".encode()
    return line + b"\r" if kind == "crlf" else line


def _rfc3164_lines(n_lines: int, seed: int, mix, day: int):
    rng = np.random.default_rng(seed)
    kinds, shares = zip(*mix)
    picks = rng.choice(len(kinds), size=n_lines,
                       p=np.asarray(shares) / sum(shares))
    # one day's stream: the seconds of the day rise with the line index
    lines = [make_rfc3164_line(rng, kinds[int(k)], day, i * 86400 // n_lines)
             for i, k in enumerate(picks)]
    return lines, [kinds[int(k)] for k in picks]


def make_rfc3164_corpus(n_lines: int, seed: int, day: int = 17
                        ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` BSD-syslog lines of one day (layout A, a two-digit
    day, by default) and their kinds, drawn from :data:`RFC3164_MIX`
    with ``numpy.random.default_rng(seed)``."""
    return _rfc3164_lines(n_lines, seed, RFC3164_MIX, day)


def make_rfc3164_tier_corpus(n_lines: int, seed: int, day: int = 7
                             ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` BSD-syslog lines the device encode tier takes, from
    :data:`RFC3164_TIER_MIX`; the single-digit day puts every row in
    layout C (``Mon  d``)."""
    return _rfc3164_lines(n_lines, seed, RFC3164_TIER_MIX, day)


# ---------------------------------------------------------------------------
# LTSV: access-log rows with ltsv.org's recommended labels
# ---------------------------------------------------------------------------

# (kind, share) of the sourced LTSV mix: access-log rows (time, host and
# 8-14 of the labels below, so the 6-pair tier declines and the 16-pair
# escalation is probed) with ``time`` in the three forms the decoder
# takes — RFC3339 (Z or an offset), a unix float, and ltsv.org's own
# bracketed Apache form, which the device decode leaves to the scalar
# oracle — and the odd rows of the reference's tests: a colon-less part,
# a repeated special key, ``level:9``, non-ASCII, a row over
# ``tpu_max_line_len``, a signed or a 17-digit stamp
LTSV_MIX = (
    ("rfc3339", 0.40), ("unix", 0.30), ("apache", 0.20), ("colonless", 0.02),
    ("repeated", 0.02), ("level9", 0.01), ("high", 0.02), ("long", 0.01),
    ("signed", 0.01), ("digits17", 0.01),
)
# the mix the device encode tiers take: ~97 % rows of at most 6 pairs
# with an RFC3339 or an unsigned unix stamp of at most 16 digits, ASCII,
# no repeated special name; the rest outside the tiers
LTSV_TIER_MIX = (
    ("tier", 0.97), ("apache", 0.006), ("colonless", 0.006),
    ("repeated", 0.006), ("high", 0.006), ("signed", 0.006),
)
# the labels ltsv.org recommends for access logs (besides time and host)
LTSV_LABELS = ("forwardedfor", "req", "method", "uri", "protocol",
               "status", "size", "reqsize", "referer", "ua", "vhost",
               "reqtime", "cache", "runtime", "apptime")
_PATHS = ("/", "/index.html", "/apache_pb.gif", "/api/v1/items?id=42",
          "/static/app.js", "/login", "/search?q=a%20b")
_UAS = ("Mozilla/4.08 [en] (Win98; I ;Nav)",
        "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36",
        "curl/8.4.0", 'Go-http-client/1.1 "probe"', "kube-probe/1.29")


# a typed schema over ten of those labels: more than the 8 keys the
# block encoder types, so its batches take the Record path
LTSV_SCHEMA_10 = (
    '[input.ltsv_schema]\nstatus = "u64"\nsize = "i64"\nreqsize = "u64"\n'
    'reqtime = "f64"\nruntime = "f64"\napptime = "f64"\ncache = "string"\n'
    'method = "string"\nprotocol = "string"\nvhost = "string"\n')


def _ltsv_time(rng, form: str, i: int) -> str:
    day, sod = 1 + i % 28, (i * 7919) % 86400
    hh, mm, ss = sod // 3600, sod // 60 % 60, sod % 60
    if form == "rfc3339":
        frac = ("", ".5", ".123", ".123456")[int(rng.integers(0, 4))]
        off = ("Z", "+09:00", "-07:00", "z")[int(rng.integers(0, 4))]
        return f"2026-10-{day:02d}T{hh:02d}:{mm:02d}:{ss:02d}{frac}{off}"
    if form == "unix":
        base = 1760000000 + i
        return (str(base) if rng.random() < 0.3
                else f"{base}.{int(rng.integers(0, 1000)):03d}")
    return f"[{day}/Oct/2026:{hh:02d}:{mm:02d}:{ss:02d} +0900]"


def _ltsv_value(rng, label: str) -> str:
    pick = int(rng.integers(0, 1 << 30))
    method = ("GET", "POST", "HEAD", "PUT")[pick % 4]
    path = _PATHS[pick % len(_PATHS)]
    return {
        "forwardedfor": "-" if pick % 3 else f"10.0.{pick % 256}.{pick % 97}",
        "req": f"{method} {path} HTTP/1.1", "method": method, "uri": path,
        "protocol": "HTTP/1.1",
        "status": ("200", "304", "404", "500")[pick % 4],
        "size": str(pick % 100000), "reqsize": str(pick % 2000),
        "referer": "-" if pick % 2 else "http://www.example.com/start.html",
        "ua": _UAS[pick % len(_UAS)], "vhost": "www.example.com",
        "reqtime": f"0.{pick % 1000:03d}", "cache": ("HIT", "MISS")[pick % 2],
        "runtime": f"0.{pick % 100:03d}", "apptime": f"0.{pick % 50:03d}",
    }[label]


def make_ltsv_line(rng, kind: str, i: int, tier: bool = False) -> bytes:
    """One LTSV access-log row of ``kind`` (see :data:`LTSV_MIX` and
    :data:`LTSV_TIER_MIX`): 8-14 labels, or 0-6 for a tier-mix row, in
    ltsv.org's order with time and host first."""
    if tier:
        k = int(rng.integers(0, 7))
    else:
        k = int(rng.integers(8, 15))
    labels = sorted(rng.choice(len(LTSV_LABELS), size=k, replace=False))
    form = kind if kind in ("rfc3339", "unix", "apache") else (
        "rfc3339" if rng.random() < 0.6 else "unix")
    parts = [f"time:{_ltsv_time(rng, form, i)}",
             f"host:192.168.{i % 256}.{(i * 31) % 254 + 1}"]
    parts += [f"{LTSV_LABELS[j]}:{_ltsv_value(rng, LTSV_LABELS[j])}"
              for j in labels]
    if rng.random() < 0.3:
        parts.append(f"message:{_msg(rng, int(rng.integers(1, 8)))}")
    if rng.random() < 0.3:
        parts.append(f"level:{int(rng.integers(0, 8))}")
    if kind == "colonless":
        parts.insert(int(rng.integers(0, len(parts) + 1)), "nocolon")
    elif kind == "repeated":
        parts.append(f"host:10.9.8.{i % 250}")
    elif kind == "level9":
        parts.append("level:9")
    elif kind == "high":
        parts.append("city:caf\u00e9 \u2713 \u65e5\u672c")
    elif kind == "long":
        parts.append(f"referer:http://www.example.com/{'a' * 520}")
    elif kind == "signed":
        parts[0] = f"time:-{1760000000 + i}.5"
    elif kind == "digits17":
        parts[0] = f"time:1760000000.{i % 10000000:07d}"
    return "\t".join(parts).encode()


def _ltsv_lines(n_lines: int, seed: int, mix, tier: bool):
    rng = np.random.default_rng(seed)
    kinds, shares = zip(*mix)
    picks = rng.choice(len(kinds), size=n_lines,
                       p=np.asarray(shares) / sum(shares))
    lines = [make_ltsv_line(rng, kinds[int(k)], i, tier)
             for i, k in enumerate(picks)]
    return lines, [kinds[int(k)] for k in picks]


def make_ltsv_corpus(n_lines: int, seed: int
                     ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` LTSV access-log rows and their kinds, drawn from
    :data:`LTSV_MIX` with ``numpy.random.default_rng(seed)``."""
    return _ltsv_lines(n_lines, seed, LTSV_MIX, tier=False)


def make_ltsv_tier_corpus(n_lines: int, seed: int
                          ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` LTSV rows the device encode tiers take, from
    :data:`LTSV_TIER_MIX` (a "tier" row has 0-6 labels and an RFC3339 or
    an unsigned unix stamp of at most 13 digits)."""
    return _ltsv_lines(n_lines, seed, LTSV_TIER_MIX, tier=True)


# ---------------------------------------------------------------------------
# GELF: Graylog's GELF 1.1 payloads
# ---------------------------------------------------------------------------

# (kind, share) of the sourced GELF mix: payloads as Graylog's "GELF
# Payload Specification" (GELF 1.1) defines them — version "1.1", host,
# short_message, timestamp as epoch seconds with 3-6 decimals, level 0-7,
# 3-9 ``_`` additional fields (strings and integers; 15 % of rows a float
# such as ``_took_ms``), full_message on 20 % with an escaped newline —
# and the odd rows: non-ASCII, no timestamp (the scalar path stamps the
# wall clock), a nested object (flagged by the flat index), invalid
# JSON, level 8, version "2.0".  Rows of 9-15 fields, floats and escaped
# strings keep both device tiers declining (8 fields, then 16).
GELF_MIX = (
    ("gelf", 0.91), ("high", 0.02), ("no_ts", 0.02), ("nested", 0.02),
    ("invalid", 0.01), ("level8", 0.01), ("version2", 0.01),
)
# the mix the device encode tiers take: ~97 % rows of the five specials
# (version, host, short_message, timestamp, level) and 0-3 clean
# additional fields (ASCII strings or canonical integers) with a stamp of
# at most 16 digits; the rest outside the tiers
GELF_TIER_MIX = (
    ("tier", 0.97), ("float", 0.01), ("escaped", 0.01), ("high", 0.01),
)
# additional fields (name, string or integer); no two share an 8-byte
# sort prefix, so their order is never ambiguous to the device tiers
_GELF_FIELDS = (
    ("_app", "s"), ("_env", "s"), ("_user_id", "i"), ("_status", "i"),
    ("_bytes", "i"), ("_path", "s"), ("_method", "s"), ("_trace", "s"),
    ("_region", "s"), ("_pid", "i"), ("_thread", "s"),
)


def _gelf_field(rng, name: str, kind: str) -> str:
    pick = int(rng.integers(0, 1 << 30))
    if kind == "i":
        return f'"{name}":{pick % (10 ** int(rng.integers(1, 10)))}'
    val = {
        "_app": ("checkout", "auth", "search", "billing")[pick % 4],
        "_env": ("prod", "staging", "dev")[pick % 3],
        "_path": _PATHS[pick % len(_PATHS)],
        "_method": ("GET", "POST", "HEAD", "PUT")[pick % 4],
        "_trace": f"{pick:08x}{pick % 65536:04x}",
        "_region": ("eu-west-1", "us-east-2", "ap-south-1")[pick % 3],
        "_thread": f"worker-{pick % 64}",
    }[name]
    return f'"{name}":"{val}"'


def make_gelf_line(rng, kind: str, i: int, tier: bool = False) -> bytes:
    """One GELF 1.1 payload of ``kind`` (see :data:`GELF_MIX` and
    :data:`GELF_TIER_MIX`)."""
    host = _HOSTS[i % len(_HOSTS)] + "." + _DOMAINS[i % len(_DOMAINS)]
    msg = _msg(rng, int(rng.integers(2, 9)))
    if kind == "high":
        msg += " caf\u00e9 \u2713 \u65e5\u672c"
    digits = int(rng.integers(3, 7))
    stamp = (f"{1760000000 + i // 4}."
             f"{int(rng.integers(0, 10 ** digits)):0{digits}d}")
    parts = ['"version":"2.0"' if kind == "version2" else '"version":"1.1"',
             f'"host":"{host}"', f'"short_message":"{msg}"']
    if kind == "escaped" or (not tier and rng.random() < 0.2):
        parts.append(f'"full_message":"{msg}\\nat frame {i % 97}\\n"')
    if kind != "no_ts":
        parts.append(f'"timestamp":{stamp}')
    parts.append(f'"level":{8 if kind == "level8" else int(rng.integers(0, 8))}')
    k = int(rng.integers(0, 4)) if tier else int(rng.integers(3, 10))
    for j in sorted(rng.choice(len(_GELF_FIELDS), size=k, replace=False)):
        parts.append(_gelf_field(rng, *_GELF_FIELDS[int(j)]))
    if kind == "float" or (not tier and rng.random() < 0.15):
        parts.append(f'"_took_ms":{int(rng.integers(0, 5000))}.'
                     f'{int(rng.integers(0, 1000)):03d}')
    if kind == "nested":
        parts.append(f'"_ctx":{{"span":"{i % 1000}","sampled":true}}')
    line = "{" + ",".join(parts) + "}"
    if kind == "invalid":
        line = line[:-1]
    return line.encode()


def _gelf_lines(n_lines: int, seed: int, mix, tier: bool):
    rng = np.random.default_rng(seed)
    kinds, shares = zip(*mix)
    picks = rng.choice(len(kinds), size=n_lines,
                       p=np.asarray(shares) / sum(shares))
    lines = [make_gelf_line(rng, kinds[int(k)], i, tier)
             for i, k in enumerate(picks)]
    return lines, [kinds[int(k)] for k in picks]


def make_gelf_corpus(n_lines: int, seed: int
                     ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` GELF 1.1 payloads and their kinds, drawn from
    :data:`GELF_MIX` with ``numpy.random.default_rng(seed)``."""
    return _gelf_lines(n_lines, seed, GELF_MIX, tier=False)


def make_gelf_tier_corpus(n_lines: int, seed: int
                          ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` GELF payloads the device encode tiers take, from
    :data:`GELF_TIER_MIX`."""
    return _gelf_lines(n_lines, seed, GELF_TIER_MIX, tier=True)


# ---------------------------------------------------------------------------
# DNS: dnstap-style TSV query logs
# ---------------------------------------------------------------------------

# a resolver's query log, one event a line (decoders/dns.py):
# ``ts client qname qtype rcode latency_us``, ts unix seconds with six
# fractional digits and increasing, clients IPv4 (70 %) or IPv6, query
# names of 10-60 bytes from a Zipf-skewed list of a few thousand, the
# qtype and rcode shares below, latencies of 1-7 digits
DNS_QTYPES = (("A", 0.60), ("AAAA", 0.25), ("HTTPS", 0.05), ("PTR", 0.04),
              ("MX", 0.03), ("TXT", 0.02), ("SRV", 0.01))
DNS_RCODES = (("NOERROR", 0.80), ("NXDOMAIN", 0.15), ("SERVFAIL", 0.03),
              ("REFUSED", 0.02))
DNS_NAMES = 3000
# (kind, share): ~3 % edge rows, each kind present
DNS_MIX = (("dns", 0.97), ("edge", 0.03))
# the edge rows: a field count other than six; ts "1." / ".5" / "1e9" /
# a BOM; a 20-digit latency or one with a leading zero (non-canonical:
# the oracle); an empty client or qname; a '"' or '\' in qname (off the
# GELF screen); a raw UTF-8 qname; an empty qtype
DNS_EDGE_KINDS = ("fields5", "fields7", "ts_dot_end", "ts_dot_start",
                  "ts_exp", "ts_bom", "lat20", "lat_zero", "no_client",
                  "no_qname", "quote", "backslash", "utf8", "no_qtype")
_DNS_LABELS = ("www", "api", "cdn", "mail", "static", "img", "auth", "login",
               "m", "shop", "blog", "video", "edge", "ns1", "smtp", "app")
_DNS_ZONES = ("example.com", "example.org", "corp.internal", "akamaiedge.net",
              "cloudfront.net", "googleapis.com", "in-addr.arpa",
              "amazonaws.com", "fbcdn.net", "apple.com")


def _dns_names(rng) -> List[str]:
    """The resolver's name population: ``DNS_NAMES`` names of 10-60
    bytes, in Zipf rank order."""
    names = []
    for i in range(DNS_NAMES):
        zone = _DNS_ZONES[int(rng.integers(0, len(_DNS_ZONES)))]
        label = _DNS_LABELS[int(rng.integers(0, len(_DNS_LABELS)))]
        name = f"{label}{i}.{zone}"
        while len(name) < int(rng.integers(10, 61)):
            name = f"{_DNS_LABELS[int(rng.integers(0, len(_DNS_LABELS)))]}" \
                   f"-{int(rng.integers(0, 1000))}.{name}"
        names.append(name[-60:].lstrip(".-") if len(name) > 60 else name)
    return names


def _dns_client(rng) -> str:
    if rng.random() < 0.7:
        return "10.%d.%d.%d" % tuple(int(v) for v in rng.integers(0, 256, 3))
    return "2001:db8:%x:%x::%x" % tuple(int(v) for v in
                                        rng.integers(0, 65536, 3))


def _dns_pick(rng, table) -> str:
    names, shares = zip(*table)
    return names[int(rng.choice(len(names), p=np.asarray(shares)))]


def make_dns_line(rng, names, zipf_p, i: int, kind: str = "dns") -> bytes:
    """One query-log line: event ``i`` of the stream, or an edge row of
    ``kind`` (one of :data:`DNS_EDGE_KINDS`)."""
    ts = f"{1760000000 + i // 50}.{(i * 20011) % 1000000:06d}"
    client = _dns_client(rng)
    qname = names[int(rng.choice(len(names), p=zipf_p))]
    qtype = _dns_pick(rng, DNS_QTYPES)
    rcode = _dns_pick(rng, DNS_RCODES)
    lat = str(int(rng.integers(1, 10 ** int(rng.integers(1, 8)))))
    if kind == "ts_dot_end":
        ts = ts.split(".")[0] + "."
    elif kind == "ts_dot_start":
        ts = "." + ts.split(".")[1]
    elif kind == "ts_exp":
        ts = "1e9"
    elif kind == "ts_bom":
        ts = "\ufeff" + ts
    elif kind == "lat20":
        lat = "1" + "0" * 19
    elif kind == "lat_zero":
        lat = "0" + lat
    elif kind == "no_client":
        client = ""
    elif kind == "no_qname":
        qname = ""
    elif kind == "quote":
        qname = 'we"ird.' + qname
    elif kind == "backslash":
        qname = "back\\slash." + qname
    elif kind == "utf8":
        qname = "b\u00fccher." + qname
    elif kind == "no_qtype":
        qtype = ""
    fields = [ts, client, qname, qtype, rcode, lat]
    if kind == "fields5":
        fields.pop(3)
    elif kind == "fields7":
        fields.insert(5, "DO")
    return "\t".join(fields).encode("utf-8")


def _dns_lines(n_lines: int, seed: int, mix):
    rng = np.random.default_rng(seed)
    names = _dns_names(rng)
    zipf_p = 1.0 / np.arange(1, len(names) + 1) ** 1.1
    zipf_p /= zipf_p.sum()
    kinds, shares = zip(*mix)
    picks = rng.choice(len(kinds), size=n_lines,
                       p=np.asarray(shares) / sum(shares))
    lines, out_kinds = [], []
    n_edge = 0
    for i, k in enumerate(picks.tolist()):
        kind = kinds[k]
        if kind == "edge":
            # each edge kind in turn, so every kind is present
            kind = DNS_EDGE_KINDS[n_edge % len(DNS_EDGE_KINDS)]
            n_edge += 1
        lines.append(make_dns_line(rng, names, zipf_p, i, kind))
        out_kinds.append(kind)
    return lines, out_kinds


def make_dns_corpus(n_lines: int, seed: int
                    ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` query-log lines and their kinds (``"dns"`` or an edge
    kind), drawn from :data:`DNS_MIX` with
    ``numpy.random.default_rng(seed)``."""
    return _dns_lines(n_lines, seed, DNS_MIX)


def make_dns_tier_corpus(n_lines: int, seed: int
                         ) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` query-log lines of the same stream without edge rows:
    every one takes both block encoders."""
    return _dns_lines(n_lines, seed, (("dns", 1.0),))


# ---------------------------------------------------------------------------
# auto_tpu: one collector's mixed stream
# ---------------------------------------------------------------------------

# (format, share) of the auto mix: RFC5424 from rsyslog, BSD syslog from
# network gear, LTSV from web servers and GELF from applications
AUTO_MIX = (("rfc5424", 0.40), ("rfc3164", 0.30), ("ltsv", 0.15),
            ("gelf", 0.15))
# rows at the classifier's edges: a BOM before each class, PRI digit
# counts 1, 4 and 5, a non-digit PRI, '{' alone, a tab or colon past
# byte 512 (rows longer than tpu_max_line_len are classified from their
# raw bytes), rows of length 0-2, a BOM alone and cut short
AUTO_EDGE = (
    b"\xef\xbb\xbf<13>1 2015-08-05T15:53:45Z host app 69 42 - bom rfc5424",
    b"\xef\xbb\xbf<34>Oct 11 22:14:15 mymachine su: bom rfc3164",
    b"\xef\xbb\xbftime:2015-08-05T15:53:45Z\thost:web1\tmessage:bom ltsv",
    b'\xef\xbb\xbf{"version":"1.1","host":"web1","short_message":"bom",'
    b'"timestamp":1438790025.5}',
    b"<1>1 2015-08-05T15:53:45Z h a p m - one pri digit",
    b"<1234>1 2015-08-05T15:53:45Z h a p m - four pri digits",
    b"<12345>1 2015-08-05T15:53:45Z h a p m - five pri digits",
    b"<1a>1 2015-08-05T15:53:45Z h a p m - a letter in the pri",
    b"<13>2 2015-08-05T15:53:45Z h a p m - version 2",
    b"<>1 2015-08-05T15:53:45Z h a p m - empty pri",
    b"{",
    b"time:1438790025.5\thost:w\tmessage:" + b"x" * 600,
    b"host " + b"y" * 560 + b"\tkey:value past byte 512",
    b"z" * 530 + b":" + b" colon past byte 512\tand a tab",
    b"", b"<", b"\t:", b"a:", b"\xef\xbb", b"\xef\xbb\xbf",
)


# the dns leg's classifier edges (``auto_extra_formats = ["dns"]``):
# dns-shaped rows behind a BOM, a '{' or a '<' (not dns), a head with a
# dot at either edge, two dots or a letter (not dns), six tabs (not
# dns), and a clean one
AUTO_DNS_EDGE = (
    b"\xef\xbb\xbf1760000000.5\t10.0.0.1\tbom.example.com\tA\tNOERROR\t12",
    b"{1760000000.5\t10.0.0.1\tbrace.example.com\tA\tNOERROR\t12",
    b"<1760000000.5\t10.0.0.1\tangle.example.com\tA\tNOERROR\t12",
    b"1760000000.\t10.0.0.1\tdot-end.example.com\tA\tNOERROR\t12",
    b".5\t10.0.0.1\tdot-start.example.com\tA\tNOERROR\t12",
    b"1.2.3\t10.0.0.1\ttwo-dots.example.com\tA\tNOERROR\t12",
    b"17e9\t10.0.0.1\tletter.example.com\tA\tNOERROR\t12",
    b"1760000000\t10.0.0.1\tsix.example.com\tA\tNOERROR\t12\tDO",
    b"1760000000\t10.0.0.1\tkey:colon.example.com\tA\tNOERROR\t12",
)


def make_auto_corpus(n_lines: int, seed: int, tier: bool = False,
                     dns: bool = False) -> Tuple[List[bytes], List[str]]:
    """``n_lines`` lines of one mixed stream and their kinds
    (``"<format>:<kind>"``, ``"edge"`` for :data:`AUTO_EDGE`): the four
    formats' corpora (their tier mixes with ``tier=True``) drawn by
    :data:`AUTO_MIX` with ``numpy.random.default_rng(seed)`` and
    interleaved in that draw's order, the edge rows spread through
    the stream.  With ``dns``, the dns mix (:func:`make_dns_corpus`, its
    tier mix with ``tier``) joins at a share of 0.15 and
    :data:`AUTO_DNS_EDGE` joins the edge rows."""
    rng = np.random.default_rng(seed)
    mix = AUTO_MIX + ((("dns", 0.15),) if dns else ())
    edges = AUTO_EDGE + (AUTO_DNS_EDGE if dns else ())
    fmts, shares = zip(*mix)
    n_mix = max(n_lines - len(edges), 0)
    picks = rng.choice(len(fmts), size=n_mix,
                       p=np.asarray(shares) / sum(shares))
    makers = ((make_tier_corpus, make_rfc3164_tier_corpus,
               make_ltsv_tier_corpus, make_gelf_tier_corpus,
               make_dns_tier_corpus) if tier
              else (make_corpus, make_rfc3164_corpus, make_ltsv_corpus,
                    make_gelf_corpus, make_dns_corpus))[:len(fmts)]
    streams = []
    for i, make in enumerate(makers):
        lines, kinds = make(int((picks == i).sum()), seed + 1 + i)
        streams.append(iter(zip(lines, [f"{fmts[i]}:{k}" for k in kinds])))
    out = [next(streams[int(k)]) for k in picks]
    edge = list(zip(edges, ["edge"] * len(edges)))
    at = np.sort(rng.choice(len(out) + 1, size=min(len(edge), n_lines)))
    for j, pos in enumerate(at[::-1].tolist()):
        out.insert(pos, edge[len(at) - 1 - j])
    return [ln for ln, _ in out], [k for _, k in out]


def mask_wall_stamps(data: bytes, since: float) -> bytes:
    """``data`` (GELF records) with every ``"timestamp"`` value at or
    past ``since`` replaced by 0: the scalar path stamps a GELF row
    without a timestamp with the wall clock (the reference does the
    same), so two runs agree on those rows apart from the stamp.  The
    corpora's own stamps lie before 2026."""
    import re

    def sub(m):
        return (b'"timestamp":0' if float(m.group(1)) >= since
                else m.group(0))

    return re.sub(rb'"timestamp":(-?[0-9][0-9.eE+-]*)', sub, data)


def capnp_messages(data: bytes, framing: str = "noop"):
    """The ``(start, end)`` byte offsets of each Cap'n Proto message in
    ``data``, framed by ``framing`` (noop, line, nul or syslen): steps
    message by message through the segment tables."""
    import struct

    spans = []
    pos = 0
    while pos < len(data):
        if framing == "syslen":
            pos = data.index(b" ", pos) + 1
        nseg = struct.unpack_from("<I", data, pos)[0] + 1
        sizes = struct.unpack_from(f"<{nseg}I", data, pos + 4)
        end = pos + 8 * ((4 + 4 * nseg + 7) // 8) + 8 * sum(sizes)
        spans.append((pos, end))
        pos = end + (framing != "noop")
    return spans


def mask_capnp_stamps(data: bytes, since: float,
                      framing: str = "noop") -> bytes:
    """``data`` (Cap'n Proto messages framed by ``framing``) with the stamp
    of every message whose stamp is at or past ``since`` set to 0: a gelf
    or jsonl row without a timestamp is stamped with the wall clock, as
    in GELF (:func:`mask_wall_stamps`).  The stamp is the root struct's
    first data word."""
    import struct

    out = bytearray(data)
    for start, _ in capnp_messages(data, framing):
        nseg = struct.unpack_from("<I", data, start)[0] + 1
        seg0 = start + 8 * ((4 + 4 * nseg + 7) // 8)
        root = struct.unpack_from("<I", data, seg0)[0]
        stamp = seg0 + 8 * (1 + (root >> 2))
        if struct.unpack_from("<d", data, stamp)[0] >= since:
            out[stamp:stamp + 8] = bytes(8)
    return bytes(out)


def syslen_stream(lines: List[bytes], cut: int = 3) -> bytes:
    """``lines`` as octet-counted frames, back to back; the last frame
    loses its final ``cut`` bytes (a short read at EOF)."""
    data = b"".join(b"%d %s" % (len(ln), ln) for ln in lines)
    return data[:len(data) - cut] if cut else data


def _frames(data: bytes, framing: str):
    """``(records, trailing stderr lines)`` of a stream under the
    splitters' semantics."""
    if framing == "syslen":
        from .splitters import SyslenSplitter, _scan_syslen_region

        starts, lens, n, consumed, err = _scan_syslen_region(data)
        recs = [data[s:s + ln] for s, ln in zip(starts.tolist(),
                                                lens.tolist())]
        rest = data[consumed:]
        if err:
            tail = ["Can't read message's length"]
        elif rest and SyslenSplitter._mid_body(rest):
            tail = ["failed to fill whole buffer"]
        elif rest:
            tail = ["Can't read message's length"]
        else:
            tail = []
        return recs, tail
    if framing == "message":
        # a message queue's elements, NUL-joined: each is handed to the
        # handler whole (nothing stripped, an empty one not skipped)
        return data.split(b"\0"), []
    sep = b"\0" if framing == "nul" else b"\n"
    parts = data.split(sep)
    if parts and parts[-1] == b"":
        parts.pop()
    if framing == "line":
        parts = [p[:-1] if p.endswith(b"\r") else p for p in parts]
    return parts, []


# output.format → encoder, as the pipeline picks it
_OUTPUTS = {"gelf": GelfEncoder, "json": GelfEncoder, "ltsv": LTSVEncoder,
            "rfc5424": RFC5424Encoder, "rfc3164": RFC3164Encoder,
            "passthrough": PassthroughEncoder, "capnp": CapnpEncoder}


def scalar_expectation(data: bytes, framing: str = "line",
                       config: Config = None, merger=NulMerger(),
                       fmt: str = "rfc5424",
                       notices: List[str] = None,
                       output: str = "gelf",
                       record_hook=None) -> Tuple[bytes, List[str]]:
    """Output bytes (``output`` GELF, JSON, LTSV, RFC5424, RFC3164 or
    passthrough, with ``config``'s ``gelf_extra``, ``ltsv_extra`` or
    ``syslog_prepend_timestamp``; NUL-framed unless another merger is
    given, None = no framing) and stderr lines of the reference's per-record
    path over ``data``: frame (line: one trailing CR stripped; syslen:
    the octet-count scan and its EOF/bad-prefix messages; the trailing
    partial frame of line/NUL included; message: the elements of a
    NUL-joined message list, as the redis input hands them on), then decode (``fmt`` is
    ``rfc5424``, ``rfc3164``, ``jsonl``, ``ltsv`` or ``gelf``, the LTSV decoder
    with ``config``'s schema and suffixes; or ``auto``, each line's
    ``autodetect.classify`` class picking its decoder, with ``config``'s
    ``auto_extra_formats``) → encode (``config``'s ``gelf_extra``) → frame
    (line_splitter.rs:17-54, syslen_splitter.rs:26-69).  The rfc3164
    decoder prints its own "Unable to parse" line before the error line
    of a row both of its layouts reject; those come in row order here
    (the batched path prints a batch's before its error lines).  The
    LTSV decoder's "Missing value for name" notices go to stdout; with
    ``notices`` (a list) they are appended to it, in row order.
    ``record_hook`` runs on each decoded record before the encode, as
    ``ScalarHandler.record_hook`` does (template mining and
    enrichment)."""
    import contextlib
    import io

    config = config or Config.from_string("")
    if fmt == "auto":
        from .tpu.autodetect import auto_extra_formats, classify

        extras = auto_extra_formats(config)
        by_class = (RFC5424Decoder(), RFC3164Decoder(), LTSVDecoder(config),
                    GelfDecoder(), JSONLDecoder(), DNSDecoder())

        def decoder_for(raw):
            return by_class[classify(raw, extras)]
    else:
        if fmt == "ltsv":
            decoder = LTSVDecoder(config)
        else:
            decoder = {"jsonl": JSONLDecoder, "rfc3164": RFC3164Decoder,
                       "gelf": GelfDecoder, "dns": DNSDecoder
                       }.get(fmt, RFC5424Decoder)()

        def decoder_for(raw):
            return decoder
    encoder = _OUTPUTS[output](config)
    recs, tail = _frames(data, framing)
    out, errs = [], []
    for raw in recs:
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            errs.append("Invalid UTF-8 input")
            continue
        said, told = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stderr(said), \
                    contextlib.redirect_stdout(told):
                try:
                    record = decoder_for(raw).decode(line)
                finally:
                    if notices is not None:
                        notices.extend(told.getvalue().splitlines())
            if record_hook is not None:
                record_hook(record)
            payload = encoder.encode(record)
            out.append(merger.frame(payload) if merger is not None
                       else payload)
        except (DecodeError, EncodeError) as e:
            errs.extend(said.getvalue().splitlines())
            stripped = line.strip()
            if not (framing == "nul" and not stripped):
                errs.append(f"{e}: [{stripped}]")
    return b"".join(out), errs + tail
