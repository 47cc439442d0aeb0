"""Fused device-resident decode→encode routes: one program per
(in-format, out-format) pair, so the decode's span channels never leave
the device between the decode and the encode.

A trimmed copy of the JAX package's ``tpu/fused_routes.py`` with its
four GELF legs of rfc5424, rfc3164, ltsv and gelf input and its
rfc5424 → LTSV, RFC5424 and capnp and rfc3164 → RFC5424 legs.  The split
tier (``device_gelf`` / ``device_rfc3164`` / ``device_ltsv`` /
``device_gelf_gelf`` / ``device_ltsv_out`` / ``device_rfc5424_out`` /
``device_capnp``) runs the decode and the encode as two launches with
the decode's channel tensor written to device memory in between; a fused
route decodes and probes in one kernel and assembles in a second:

- F1, ``rfc5424_gelf``: K1's row decode (6 pairs) and E1's probe in one
  warp, then E1's assemble (``csrc/fused_gelf.cu``);
- F3, ``rfc3164_gelf``: D3's row decode and E3's probe, then E3's
  assemble;
- FL, ``ltsv_gelf``: L1's row decode and EL's probe at 6 pairs, then
  EL's assemble;
- FG, ``gelf_gelf``: K5's flat row decode (8 fields) and EG's probe,
  then EG's assemble;
- FO/ltsv, ``rfc5424_ltsv``: K1's row decode (6 pairs) and OL's probe,
  then OL's assemble (``csrc/fused_ltsv_out.cu``);
- FO/r5, ``rfc5424_rfc5424`` and ``rfc3164_rfc5424``: K1's row decode (4
  SD blocks, 6 pairs) and O5's probe, or D3's row decode and O5/3164's
  probe, then the assemble of O5 or O5/3164 (``csrc/fused_rfc5424_out.
  cu``);
- FO/capnp, ``rfc5424_capnp``: K1's row decode (4 SD blocks, 6 pairs)
  and OC's probe, then OC's assemble (``csrc/fused_capnp_out.cu``).

One decode per taken batch: the probe decodes each row once, keeps the
channels in shared memory for its encode, and writes the channels the
encode reads for its tier rows to a device tensor that :class:`_FusedRows`
keeps until the assemble, which reads them and runs no decode
(``kernels.FUSED_CARRY`` int32 a row, :func:`carried_columns`): for F1
and F3 the :data:`DEMAND` channels, for FO/ltsv, FO/r5 and FO/capnp the
channels the assemble of OL, O5, O5/3164 or OC reads
(:data:`_OUT_CARRY`), for FL what EL's assemble reads after pair
selection and the sort (the sorted pairs' escaped spans, the
host and message spans, the level), not the 24-part table, and for FG
what EG's assemble reads after special routing and the sort (the sorted
pairs' spans and value classes, the special fields' spans), not the
7 x 8 field table.  The
reference's fused program decodes again in its assemble, since each call
of a jitted program is whole; that is its structure, not its contract: the carried
channels are the same function of the same batch, so the bytes are the
same.  An assemble without the probe's channels raises.  The probe
returns the tier bit before the width test and the length without the
timestamp text, as the split tier's probe does, plus the ``ok`` and
timestamp channels the driver formats the stamp text from; so the
driver (``device_common.fetch_encode_driver``) needs no decode output at
all (FL's timestamp channels are the reference's narrowed ones, and its
host fetch is that of ``_ltsv_small_fetch``).

A typed ``ltsv_schema`` keeps FL off, as it keeps the split ltsv tier
off: the route's gate takes the handler's decoder, as the reference's
``FusedRoute.route_ok(encoder, merger, decoder)`` does.

The decline ladder is the reference's: a fused route keeps its own
hysteresis state (:func:`cooldown_state`, key ``fused:<route>``), whose
cooldown the handler counts down at submit; a declined or cooled batch
goes down the split path — split decode, the split device tier under its
own state, the host block encoder, the scalar oracle — and the bytes are
the same at every rung.  The fused route has no 16-pair wide probe (the
reference passes its driver none).

Left out, on purpose: the fused compile watchdog and
``FLOWGGER_FUSED_COMPILE_TIMEOUT_MS`` (the CUDA kernels build once,
before the first batch, and a failed build raises), the AOT
``fused_wrap`` and the metrics registry.

Plain versions (the CPU): the format's plain decode, narrowed to
:data:`DEMAND`, then the split tier's plain encode; the probe's decode is
kept for the assemble, as the kernels keep theirs.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart the
# fused routes must stay byte-identical to, and the differential tests
# that enforce it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = (
    "tests/test_torch_fused.py::test_fused_split_scalar_bytes_equal",
    "tests/test_torch_fused.py::test_fused_probe_matches_reference",
    "tests/test_torch_fused_gelf.py::test_fused_gelf_matches_reference",
    "tests/test_torch_fused_ltsv_out.py::test_fused_probe_matches_reference",
    "tests/test_torch_fused_rfc5424_out.py::"
    "test_fused_probe_matches_reference",
    "tests/test_torch_fused_capnp.py::test_fused_probe_matches_reference",
)

from typing import Dict, Optional

import torch

# decline hysteresis — same ladder constants as the split device tiers
FALLBACK_FRAC = 0.05
DECLINE_LIMIT = 3
COOLDOWN = 16

_TS4 = ("days", "sod", "off", "nanos")

# Field-demand masks: exactly the decode channels each route's encode and
# fetch driver read.  A missing key fails fast (KeyError in the plain
# encode), so the CPU differential tests double as completeness checks.
DEMAND = {
    "rfc5424_gelf": frozenset((
        "ok", "has_high", "severity", *_TS4,
        "host_start", "host_end", "app_start", "app_end",
        "proc_start", "proc_end", "full_start", "trim_end",
        "msg_trim_start", "sd_count", "sid_start", "sid_end",
        "pair_count", "name_start", "name_end", "val_start", "val_end",
        "val_has_esc",
    )),  # drops: bom, facility, msgid_start/end, msg_start, pair_sd
    "rfc3164_gelf": frozenset((
        "ok", "has_pri", "has_high", "severity", *_TS4,
        "host_start", "host_end", "msg_start",
    )),  # drops: facility
    "ltsv_gelf": frozenset((
        "ok", "has_high", "n_parts", "part_start", "part_end",
        "colon_pos", "time_pos", "host_pos", "msg_pos", "level_pos",
        "host_start", "host_end", "msg_start", "msg_end", "level_val",
        "ts_kind", "ts_hi", "ts_lo", "ts_meta", *_TS4,
    )),  # drops: ts_start, ts_end
    "gelf_gelf": frozenset((
        "ok", "n_fields", "key_start", "key_end", "val_start",
        "val_end", "val_type", "key_esc", "val_esc",
    )),  # the canonicalizing re-encode touches every channel
    "rfc5424_ltsv": frozenset((
        "ok", "has_high", "facility", "severity", *_TS4,
        "host_start", "host_end", "app_start", "app_end",
        "proc_start", "proc_end", "msgid_start", "msgid_end",
        "full_start", "msg_trim_start", "trim_end",
        "pair_count", "name_start", "name_end",
        "val_start", "val_end", "val_has_esc",
    )),  # drops: bom, msg_start, sd_count, sid_start/end, pair_sd
    "rfc5424_rfc5424": frozenset((
        "ok", "has_high", "facility", "severity", *_TS4,
        "host_start", "host_end", "app_start", "app_end",
        "proc_start", "proc_end", "msgid_start", "msgid_end",
        "msg_trim_start", "trim_end", "sd_count", "sid_start", "sid_end",
        "pair_count", "pair_sd", "name_start", "name_end",
        "val_start", "val_end", "val_has_esc",
    )),  # drops: bom, full_start, msg_start
    "rfc3164_rfc5424": frozenset((
        "ok", "has_pri", "has_high", "facility", "severity", *_TS4,
        "host_start", "host_end", "msg_start",
    )),  # the relay upgrade reads every rfc3164 channel
    "rfc5424_capnp": frozenset((
        "ok", "has_high", "facility", "severity", *_TS4,
        "host_start", "host_end", "app_start", "app_end",
        "proc_start", "proc_end", "msgid_start", "msgid_end",
        "full_start", "msg_trim_start", "trim_end",
        "sd_count", "sid_start", "sid_end",
        "pair_count", "pair_sd", "name_start", "name_end",
        "val_start", "val_end", "val_has_esc",
    )),  # drops: bom, msg_start
}
# The carried rows of the non-GELF outputs: the DEMAND channels the
# assemble reads (not ok, has_high, the stamp, val_has_esc or the
# facility and severity, which only the probe reads), in the decode's
# packed order.  FO/ltsv: fused_ltsv_out.cu keptO; FO/r5:
# fused_rfc5424_out.cu kept5 / kept3; FO/capnp: fused_capnp_out.cu keptc
# (sd[0]'s id only: :data:`_SD_WIDTH`).
_LTSV_OUT_CARRY = frozenset((
    "facility", "severity", "host_start", "host_end", "app_start",
    "app_end", "proc_start", "proc_end", "msgid_start", "msgid_end",
    "pair_count", "full_start", "trim_end", "msg_trim_start",
    "name_start", "name_end", "val_start", "val_end"))
_OUT_CARRY = {
    "rfc5424_ltsv": _LTSV_OUT_CARRY,
    "rfc5424_rfc5424": frozenset((
        "host_start", "host_end", "app_start", "app_end", "proc_start",
        "proc_end", "msgid_start", "msgid_end", "sd_count", "pair_count",
        "trim_end", "msg_trim_start", "sid_start", "sid_end",
        "name_start", "name_end", "val_start", "val_end", "pair_sd")),
    "rfc3164_rfc5424": frozenset(("host_start", "host_end", "msg_start")),
    "rfc5424_capnp": frozenset((
        "host_start", "host_end", "app_start", "app_end", "proc_start",
        "proc_end", "msgid_start", "msgid_end", "sd_count", "pair_count",
        "full_start", "trim_end", "msg_trim_start", "sid_start", "sid_end",
        "name_start", "name_end", "val_start", "val_end", "pair_sd")),
}
# the SD slots a route's carried row keeps (capnp emits sd[0] only)
_SD_WIDTH = {"rfc5424_capnp": 1}
# FL's carried row: the row values EL's assemble reads, then each sorted
# pair's four escaped span ends (fused_gelf.cu kCarryL)
_LTSV_CARRY_ROW = ("pair_count", "host_s", "host_e", "msg_s", "msg_e",
                   "has_msg", "level")
_LTSV_CARRY_PAIR = ("ns", "ne", "vs", "ve")
# FG's carried row: the row values EG's assemble reads (``flags``: has
# full_message | has level << 1 | has short_message << 2), then each
# sorted pair's spans and ``vt | us << 3`` (its value class, and whether
# its name starts with '_'); encode_gelf_gelf_row.cuh kCarryG
_GELF_CARRY_ROW = ("pc", "flags", "full_a", "full_b", "host_a", "host_b",
                   "lvl_a", "short_a", "short_b")
_GELF_CARRY_PAIR = ("ns", "ne", "vs", "ve", "vtus")


def carried_columns(route: str):
    """The channels of one row of a fused probe's carried tensor, in
    order, as ``(key, slot)`` (slot None for a row channel): for F1 and
    F3 the split decode's packed layout (``rfc5424.unpack_channels`` at
    4 SD elements and 6 pairs, ``rfc3164.KEYS``) narrowed to
    ``DEMAND[route]``; for FL the keys of ``device_ltsv.select_rows``
    (the row values, then the four spans of each of the 6 sorted pairs,
    slot = pair)."""
    if route == "ltsv_gelf":
        from .device_ltsv import MAX_DEV_PAIRS

        return [(k, None) for k in _LTSV_CARRY_ROW] + [
            (k, p) for p in range(MAX_DEV_PAIRS) for k in _LTSV_CARRY_PAIR]
    if route == "gelf_gelf":
        from .device_gelf_gelf import BASE_FIELDS

        return [(k, None) for k in _GELF_CARRY_ROW] + [
            (k, p) for p in range(BASE_FIELDS) for k in _GELF_CARRY_PAIR]
    demand = _OUT_CARRY.get(route, DEMAND.get(route))
    if route.startswith("rfc3164"):
        from .rfc3164 import KEYS

        return [(k, None) for k in KEYS if k in demand]
    from .rfc5424 import (_KEYS_1D, _KEYS_PAIR, _KEYS_SD, DEFAULT_MAX_PAIRS,
                          DEFAULT_MAX_SD)

    cols = [(k, None) for k in _KEYS_1D if k in demand]
    for keys, width in ((_KEYS_SD, _SD_WIDTH.get(route, DEFAULT_MAX_SD)),
                        (_KEYS_PAIR, DEFAULT_MAX_PAIRS)):
        cols += [(k, s) for k in keys if k in demand for s in range(width)]
    return cols


def carried_plain(dec: Dict[str, torch.Tensor], route: str, batch=None,
                  lens=None) -> torch.Tensor:
    """The carried channels of every row from a plain decode, int32
    [N, C] (the kernel writes only its probe's tier rows).  FL's and
    FG's are computed from the decode and the batch (``batch``, ``lens``)
    by the plain encode's pair selection (FG: special routing) and
    sort."""
    if route == "gelf_gelf":
        from .device_gelf_gelf import analyze

        dec = analyze(batch, lens, dec)
        pv = [p < dec["pc"] for p in range(dec["F"])]
        dec["flags"] = (dec["has_full"].to(torch.int64)
                        | (dec["has_lvl"].to(torch.int64) << 1)
                        | (dec["has_short"].to(torch.int64) << 2))
        for k in ("ns", "ne", "vs", "ve"):
            dec[k] = [torch.where(v, c, 0) for v, c in zip(pv, dec[k])]
        dec["vtus"] = [torch.where(v, t | (u << 3), 0) for v, t, u in
                       zip(pv, dec["vt"], dec["us"])]
    elif route == "ltsv_gelf":
        from .device_common import escape_stage
        from .device_ltsv import MAX_DEV_PAIRS, select_rows

        dec = select_rows(batch, lens, dec,
                          escape_stage(batch, lens, False)["dmap"],
                          MAX_DEV_PAIRS)
    cols = [dec[k] if s is None else
            (dec[k][s] if isinstance(dec[k], list) else dec[k][:, s])
            for k, s in carried_columns(route)]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1)


class FusedHandle:
    """A submitted fused batch: the device inputs plus the route that
    will run them.  The kernels run at fetch time."""

    __slots__ = ("route", "batch_dev", "lens_dev")

    def __init__(self, route, batch_dev, lens_dev):
        self.route = route
        self.batch_dev = batch_dev
        self.lens_dev = lens_dev


# The split tier behind each fused route: its plain encode, consts and
# gate, and for the non-GELF outputs the route's leg (``fused_cuda``, the
# kernels' wrapper; ``ts_render``; ``fused_elide``; ``fused_small``, the
# host fetch of the probe's extra outputs).  Keyed on the output, then,
# into GELF, on the input format.
_SPLIT_OUT = {"ltsv": "device_ltsv_out", "rfc5424": "device_rfc5424_out",
              "capnp": "device_capnp"}
_SPLIT_GELF = {"rfc5424": "device_gelf", "rfc3164": "device_rfc3164",
               "ltsv": "device_ltsv", "gelf": "device_gelf_gelf"}


def split_tier(fmt: str, out: str):
    """The split tier module of the fused route from ``fmt`` into
    ``out``."""
    from importlib import import_module

    name = _SPLIT_GELF[fmt] if out == "gelf" else _SPLIT_OUT[out]
    return import_module(f"{__package__}.{name}")


class _FusedRows:
    """One fused batch as the fetch driver sees it (the contract of
    ``device_gelf._Rows``): ``probe`` and ``assemble`` launch the fused
    kernel on a CUDA batch, and run the plain decode and encode on a CPU
    batch; ``small_channels`` hands back the ``ok`` and timestamp
    channels the probe produced, and the output leg's extra ones.  The
    probe's decode (the kernel's carried channels and tier bits, or the
    plain decode) is kept for the assemble, which raises without it."""

    def __init__(self, route, batch, lens, suffix, extras, year):
        self.route = route
        self.batch, self.lens = batch, lens
        self.N = batch.shape[0]
        self.device = batch.device
        self.suffix, self.extras, self.year = suffix, extras, year
        self.small = None
        # the probe's outputs past the stamp channels, for the leg's
        # fused_small: FO/ltsv's gap0 / gap1 [2, N]; FO/r5's and
        # FO/capnp's fac8 / sev8 (/ pri1), and FO/r5 rfc3164's host
        # lengths
        self.extra = ()
        self.dec = None        # the plain decode, kept from the probe
        self.carried = None    # the kernel's (chan, tier), kept from it
        # the → LTSV, → RFC5424 and → capnp rows leave the stamp to the
        # host splice
        self.ts_in_row = route.out == "gelf"
        self.split = split = split_tier(route.fmt, route.out)
        self.OW = split.out_width(batch.shape[1], suffix, extras)
        if batch.is_cuda:
            from .device_gelf import _bank_on

            if self.ts_in_row:
                from .kernels import fused_gelf_cuda as fused_cuda
            else:
                fused_cuda = split.fused_cuda
            self.fused_cuda = fused_cuda
            bank, self.table = split.kernel_consts(suffix, extras)
            self.bank = _bank_on(bank, batch.device)

    def _plain_decode(self) -> Dict[str, torch.Tensor]:
        if self.route.fmt == "rfc3164":
            from .rfc3164 import decode_rfc3164

            dec = decode_rfc3164(self.batch, self.lens, self.year)
        elif self.route.fmt == "ltsv":
            from .ltsv import decode_ltsv

            dec = decode_ltsv(self.batch, self.lens)
        elif self.route.fmt == "gelf":
            from .gelf import decode_gelf

            dec = decode_gelf(self.batch, self.lens)
        else:
            from .rfc5424 import decode_rfc5424

            dec = decode_rfc5424(self.batch, self.lens)
        demand = DEMAND[self.route.name]
        return {k: v for k, v in dec.items() if k in demand}

    def _plain_encode(self, dec, **kw):
        if self.route.name == "rfc3164_rfc5424":
            return self.split.encode_rows_3164(self.batch, self.lens, dec,
                                               suffix=self.suffix, **kw)
        if self.route.name != "rfc5424_gelf":
            return self.split.encode_rows(self.batch, self.lens, dec,
                                          suffix=self.suffix,
                                          extras=self.extras, **kw)
        from .rfc5424 import DEFAULT_MAX_SD

        return self.split.encode_rows(self.batch, self.lens, dec,
                                      suffix=self.suffix,
                                      max_sd=DEFAULT_MAX_SD,
                                      extras=self.extras, **kw)

    def probe(self, n: int):
        """``(base, base_len)`` of the first ``n`` rows, as the split
        tier's probe; keeps the ``ok`` and timestamp channels (int32
        [5, N]: ok, days, sod, off, nanos; for FL the narrowed buffer of
        ``device_ltsv.small_pack``; for FG EG's int32 [3, N] stamp
        channels, 0 off its tier; 0 past ``n``) and the leg's extra
        outputs."""
        if self.batch.is_cuda:
            res = self.fused_cuda(self.route.fmt, self.batch, self.lens, n,
                                  self.bank, self.table, year=self.year)
            base, base_len, self.small, chan = res[:4]
            self.extra = tuple(res[4:])
            self.carried = (chan, base)
            return base, base_len
        dec = self.dec = self._plain_decode()
        if self.route.fmt == "gelf":
            base, base_len, self.small = self._plain_encode(
                dec, assemble=False, n=n)
            return base, base_len
        live = torch.arange(self.N, device=self.device) < n
        if self.route.fmt == "ltsv":
            self.small = self.split.small_pack(dec, n)
        else:
            self.small = torch.stack([
                torch.where(live, dec[k].to(torch.int32), 0)
                for k in ("ok",) + _TS4])
        res = self._plain_encode(dec, assemble=False, n=n)
        self.extra = tuple(res[2:])
        return res[0], res[1]

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        if self.carried is None and self.dec is None:
            raise RuntimeError("a fused assemble needs its probe's decode: "
                               "probe the batch first")
        ts = {"ts_text": ts_text, "ts_len": ts_len} if self.ts_in_row \
            else {}
        if self.batch.is_cuda:
            chan, tier = self.carried
            return self.fused_cuda(
                self.route.fmt, self.batch, self.lens, n, self.bank,
                self.table, year=self.year, OW=self.OW, row_off=row_off,
                total=total, chan=chan, tier=tier, **ts)
        from .device_gelf import flat_rows

        rows, out_len, _ = self._plain_encode(self.dec, **ts)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        if self.route.fmt == "ltsv":
            # the reference's _ltsv_small_fetch
            return self.split.small_fetch(self.small, self.N, n)
        if self.route.fmt == "gelf":
            return self.split.small_channels(self.small, n)
        h = self.small[:, :n].cpu().numpy()
        small = {"ok": h[0] != 0, "days": h[1], "sod": h[2], "off": h[3],
                 "nanos": h[4]}
        if not self.extra:
            return small, h.nbytes
        extra, ebytes = self.split.fused_small(self.extra, n, self.OW)
        small.update(extra)
        return small, h.nbytes + ebytes


class FusedRoute:
    """One (in-format → out-format) fused program plus its driver
    recipe."""

    __slots__ = ("name", "fmt", "out")

    def __init__(self, name: str, fmt: str, out: str = "gelf"):
        self.name = name
        self.fmt = fmt
        self.out = out

    def route_ok(self, encoder, merger, decoder=None) -> bool:
        """The split device tier's gate (output encoder type, framing
        allowlist, extras placement, ``FLOWGGER_DEVICE_ENCODE``, and for
        ltsv input the decoder's schema): a route the split tier would
        refuse is never fused either."""
        split = split_tier(self.fmt, self.out)
        if self.fmt == "ltsv":
            return split.route_ok(encoder, merger, decoder)
        return split.route_ok(encoder, merger)

    def make_kernel(self, handle: FusedHandle, encoder, merger,
                    decoder=None):
        """The driver's row object plus its kwargs (scalar oracle, the
        elided constants or the splice, the ltsv stamp combine, the
        stamp's text form)."""
        from .block_common import merger_suffix

        suffix, syslen = merger_suffix(merger)
        extras = tuple((k, v) for k, v in getattr(encoder, "extra", ()))
        year = None
        ts_vals_fn = None
        if self.fmt == "ltsv":
            from .device_ltsv import ts_vals_ltsv as ts_vals_fn
            from .materialize_ltsv import _scalar_ltsv

            def scalar_fn(line):
                return _scalar_ltsv(decoder, line)
        elif self.fmt == "gelf":
            from .device_gelf_gelf import ts_vals_gelf as ts_vals_fn
            from .materialize_gelf import _scalar_gelf as scalar_fn
        elif self.fmt == "rfc3164":
            from ..utils.timeparse import current_year_utc
            from .materialize_rfc3164 import _scalar_3164 as scalar_fn

            year = current_year_utc()
        else:
            from .materialize import _scalar_line as scalar_fn
        kern = _FusedRows(self, handle.batch_dev, handle.lens_dev, suffix,
                          extras, year)
        split = kern.split
        if self.out == "gelf":
            elide, ts_render = split.elide_spec(suffix, extras), None
        else:
            elide = split.fused_elide(suffix, self.fmt)
            ts_render = split.ts_render
        return kern, {"suffix": suffix, "syslen": syslen,
                      "scalar_fn": scalar_fn, "elide": elide,
                      "ts_vals_fn": ts_vals_fn, "ts_render": ts_render}


ROUTES = {
    "rfc5424": FusedRoute("rfc5424_gelf", "rfc5424"),
    "rfc3164": FusedRoute("rfc3164_gelf", "rfc3164"),
    "ltsv": FusedRoute("ltsv_gelf", "ltsv"),
    "gelf": FusedRoute("gelf_gelf", "gelf"),
    "rfc5424_ltsv": FusedRoute("rfc5424_ltsv", "rfc5424", out="ltsv"),
    "rfc5424_rfc5424": FusedRoute("rfc5424_rfc5424", "rfc5424",
                                  out="rfc5424"),
    "rfc3164_rfc5424": FusedRoute("rfc3164_rfc5424", "rfc3164",
                                  out="rfc5424"),
    "rfc5424_capnp": FusedRoute("rfc5424_capnp", "rfc5424", out="capnp"),
}


def out_key(encoder) -> str:
    """The output leg of an encoder's concrete type (the reference's
    ``_out_key``, fused_routes.py:611, with the two outputs that have no
    device tier): gelf (``output.format`` gelf and json), ltsv, rfc5424,
    capnp, rfc3164 or passthrough; "" for any other type."""
    from ..encoders import (CapnpEncoder, GelfEncoder, LTSVEncoder,
                            PassthroughEncoder, RFC3164Encoder,
                            RFC5424Encoder)

    for cls, key in ((GelfEncoder, "gelf"), (RFC5424Encoder, "rfc5424"),
                     (LTSVEncoder, "ltsv"), (CapnpEncoder, "capnp"),
                     (RFC3164Encoder, "rfc3164"),
                     (PassthroughEncoder, "passthrough")):
        if type(encoder) is cls:
            return key
    return ""


def route_for(fmt: str, encoder, merger,
              decoder=None) -> Optional[FusedRoute]:
    """The registered fused route for this (fmt, encoder, merger,
    decoder) config, or None when no fused program applies (the split
    path is then the route — ``input.tpu_fuse = "auto"`` semantics).
    The → GELF legs keep their format-keyed registrations, the other
    output legs key on ``{fmt}_{out}`` (:func:`out_key`); the route's
    split tier's gate (output encoder type, framing, extras, and for
    ltsv input no typed schema) decides."""
    okey = out_key(encoder)
    route = ROUTES.get(fmt if okey == "gelf" else f"{fmt}_{okey}")
    if route is None or not route.route_ok(encoder, merger, decoder):
        return None
    return route


def cooldown_state(route_state: dict, route: FusedRoute) -> dict:
    """The per-handler fused decline-hysteresis dict for ``route`` — the
    one key both the submit-side cooldown check and the driver's decline
    bookkeeping share.  Its own namespace: a fused decline must not eat
    the split device tier's decline budget (or the other way round)."""
    return route_state.setdefault(f"fused:{route.name}", {})


def submit(route: FusedRoute, packed, device=None) -> FusedHandle:
    """Put one packed tuple's inputs on the device, on the calling
    thread's current stream (the handler's ingest thread, inside its
    lane's stream).  No kernel runs here: the fused kernels launch in
    :func:`fetch_encode`, on the lane's fetcher thread and stream."""
    batch, lens = packed[0], packed[1]
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(batch)
        lens = torch.from_numpy(lens)
    if device is not None:
        batch = batch.to(device)
        lens = lens.to(device)
    return FusedHandle(route, batch, lens.to(torch.int32))


def fetch_encode(handle: FusedHandle, packed, encoder, merger,
                 route_state=None, timings=None, decoder=None):
    """Run the fused route for a submitted handle through the shared
    fetch driver; returns (BlockResult | None, fetch_seconds).  None =
    the fused tier declined (the tier fraction) — the caller falls back
    to the split path."""
    from .device_common import fetch_encode_driver

    route = handle.route
    state = None
    if route_state is not None:
        state = cooldown_state(route_state, route)
    kern, kw = route.make_kernel(handle, encoder, merger, decoder)
    return fetch_encode_driver(
        kern, packed, encoder, merger, state, kw["suffix"], kw["syslen"],
        scalar_fn=kw["scalar_fn"], fallback_frac=FALLBACK_FRAC,
        decline_limit=DECLINE_LIMIT, cooldown=COOLDOWN,
        elide=kw["elide"], timings=timings, ts_vals_fn=kw["ts_vals_fn"],
        ts_render=kw["ts_render"])
