"""BatchHandler: the port's batched RFC5424 / RFC3164 / JSON-lines / LTSV /
GELF / DNS → GELF (JSON), LTSV, RFC5424, RFC3164, passthrough and Cap'n
Proto paths.

Raw transport chunks reach the handler through one :class:`_RawSession`
per stream.  At flush — when ``input.tpu_batch_size`` records are
pending (for syslen framing: spaces, an upper bound on its frames), when
a session's region reaches 4 MiB, when ``input.tpu_flush_ms`` elapses
with data pending, or at end of stream — each session's region is framed
(line/NUL: cut at its last separator; syslen: up to the first incomplete
frame), the tail stays as carry for the next flush, and the records go
down the reference's ladder (its ``_emit_fast`` and
``block_fetch_encode``):

1. device framing (``framing.device_frame_region``: span and gather
   kernels), or the host splitter when the span kernel declines;
2. with ``input.tpu_fuse`` "auto" (the default) or "on", the fused route
   of the (input, output) pair (``fused_routes``: decode and encode in
   one kernel a phase; RFC5424, RFC3164, LTSV and GELF into GELF, RFC5424
   into LTSV, RFC5424 and RFC3164 into RFC5424, RFC5424 into capnp),
   unless its own cooldown is running, which counts down here, at submit;
3. on a fused decline (or with ``tpu_fuse = "off"``, or for a pair with
   no fused route) the format's decode kernel — RFC5424
   (``rfc5424.decode_rfc5424_submit``, 7-16-pair rows re-decoded at 16
   pairs on the host path), RFC3164 (``rfc3164.decode_rfc3164_submit``),
   JSON-lines (``jsonl.decode_jsonl_submit``, 9-24-key rows re-decoded at
   24 fields), LTSV (``ltsv.decode_ltsv_submit``, 24 parts), GELF
   (``gelf.decode_gelf_submit``, the flat index; 9-24-key rows re-decoded
   at 24 fields on the host path) or DNS (``dns.decode_dns_submit``);
4. the split device encode tier of the (input, output) pair
   (:data:`_TIERS`: ``device_gelf`` / ``device_rfc3164`` /
   ``device_ltsv`` / ``device_gelf_gelf`` into GELF, ``device_ltsv_out``
   for RFC5424 into LTSV, ``device_rfc5424_out`` for RFC5424 and RFC3164
   into RFC5424, ``device_capnp`` for RFC5424 into capnp: probe,
   timestamp text, assemble, one fetch of the tier rows' bytes) under its
   own decline state; each tier hands the batch back
   when more than 5 % of its rows fall outside it (the ltsv → GELF tier
   first tries 16 pairs, the gelf tier 16 fields), and cools down after
   three such batches in a row;
5. the host block encoder of the pair (:data:`_ROUTES` into GELF:
   ``encode_gelf_block``, ``encode_rfc3164_gelf_block``,
   ``encode_jsonl_block``, ``encode_ltsv_gelf_block``,
   ``encode_gelf_gelf_block``, ``encode_dns_block``; :data:`_BLOCK` for
   the other outputs, keyed on (input, ``fused_routes.out_key``):
   ``encode_ltsv_block``, ``encode_jsonl_block`` and ``encode_dns_block``
   into LTSV, ``encode_rfc5424_block`` into RFC5424 from rfc5424, rfc3164,
   ltsv and gelf, ``encode_passthrough_block`` from rfc5424 and rfc3164,
   ``encode_rfc3164_3164_block``, ``encode_capnp_block`` into capnp from
   rfc5424, rfc3164, ltsv and gelf), which runs the scalar oracle for rows
   the kernel flagged and for over-length lines;
6. the merger framing (pre-applied) and the output queue.

The ladder runs in the overlapped executor of :mod:`.overlap` (the
reference's ``_emit_fast`` / ``_pop_emit`` split).  On the ingest thread,
each batch reserves a lane (``LaneSet.next_lane``), is framed on that
lane's device and stream, and is *submitted*: the fused route's
cooldown count-down and its economics arm (``allow_fused``), then the
fused inputs or the split decode launched on the lane's stream, then the
lane's in-flight window (``input.tpu_inflight``, default 2).  On the
lane's fetcher thread, under the same stream, the batch is *popped*: the
fused route's fetch and encode (a decline re-submits the split decode on
the same lane), or the split tier, gated by the economics arm
``allow_device``, or the host block encoder; the pop returns an emit
closure, which the lane set's sequencer runs in submit order, feeding
the lane's ``RouteEconomics`` with the route's measured seconds.  So
framing and decode of batch N+1 overlap the host encode of batch N, and
with ``input.tpu_lanes`` > 1 the lanes' encodes overlap each other.  A
size- or region-triggered flush submits and returns (``drain=False``);
a timer flush, the end of a stream and every synchronous-emit path (the
Record path) fence every lane first.

A network input shares ONE handler among all its connections (the
pipeline's ``handler_factory``): each connection has its own session,
framed on its own at flush, so a flush submits one batch a session with
data.  Any thread that flushes submits under the reserved lane's scope
(its stream), whichever connection it serves.  The UDP input's recvmmsg
path hands regions with one span a datagram (:meth:`BatchHandler.
ingest_spans`, packed on the host at flush); the capnp splitter hands
whole records (:meth:`BatchHandler.handle_record`, encoded on the host
behind a fence).

``input.format = "auto_tpu"`` (``fmt = "auto"``) classifies each batch
(``autodetect.classify_packed``: the AC kernel on the card) and runs
steps 3-5 on each class's row subset, each leg under its own decline
state (``autodetect.encode_auto_gelf_blocks``); it has no fused route.

The Record path (the reference's ``_decode_packed`` and ``_emit_rows``)
takes a batch when the block route cannot engage for the config
(``output.gelf_extra`` keys that need dynamic placement, any
``gelf_extra`` with gelf, jsonl, dns or auto, a typed ``ltsv_schema``
with auto, or with ltsv into LTSV, RFC5424 or capnp, jsonl and dns into
RFC5424 and capnp, ``auto_extra_formats`` into RFC5424 and capnp, every
input but rfc3164 into RFC3164, ``syslog_prepend_timestamp`` with
passthrough or RFC3164: a start-up notice says so, as the reference's
does) or when a block encoder declines the batch (an ``ltsv_schema`` of
more than 8 keys, a suffix for a schema type): the
format's decode kernel, then one Record a row (``materialize*``),
``encoder.encode`` and one queue item a record, which the output thread
frames with the merger.  RFC5424 into GELF takes the per-row span encode
there instead (``encode_gelf.encode_rfc5424_gelf``), as the reference
does; every other encoder of an rfc5424 batch takes the Record path.

Per-line errors go to stderr as ``<err>: [<line>]`` in input order, like
the reference (line_splitter.rs:37-54).  Flushes are serialized by one
decode lock, so a timer flush racing a size flush cannot reorder
output, and the sequencer emits every batch in submit order whatever
the lane count.  A device or kernel failure raises: nothing catches it
and no batch is re-decoded on the host.  A failure on a fetcher thread
is stashed, its ticket released, and it is raised again on the ingest
thread at the next submit or fence, after the batches before it have
been emitted; one that a timer flush's fence meets is kept for the
ingest thread in the same way.

The decode circuit breaker (``tpu/breaker.py``, on unless
``input.tpu_breaker = false``) is the reference's batch-level route for
a stream that sends nearly every row to the scalar oracle anyway: each
emitted block feeds it its oracle share, and after ``window`` batches
all above ``fallback_ratio`` it opens (stderr says so).  While it is
open each batch is framed on the host and goes through the scalar
oracle behind a fence, in its turn; after ``cooldown_ms`` one batch
probes the card again.

The serving front (``tenancy/``): a raw session opened by the admission
wrapper carries the connection's tenant tag and a ``RawCharge``, which
is charged once a framed region before dispatch (a denied region is
dropped whole); the pending lines and spans keep ingest-order (tenant,
rows) runs, which ride each batch to its emit, where the Record path
attributes each row to its tenant (the fair queue's lane, the miner).
With ``tenant.templates = "on"`` the miner reads each batch's fetched
decode channels (``block_fetch_encode``'s column tap; the fused route
and the device tiers are off while it mines) and observes them in the
sequenced emit; ``tenant.template_enrich`` sends GELF onto the Record
path, where each record gets its ``_template_id``.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .. import tenancy as _tenancy
from ..config import Config, ConfigError
from ..encoders import EncodeError, GelfEncoder
from ..splitters import (Handler, ScalarHandler, SyslenSplitter,
                         _scan_syslen_region)
from ..tenancy.templates import TemplateMinerSet, make_gelf_enricher
from . import autodetect, device_gelf, device_gelf_gelf, device_ltsv
from . import device_capnp, device_ltsv_out, device_rfc3164
from . import device_rfc5424_out
from . import encode_passthrough
from . import framing as _framing
from .breaker import DecodeBreaker
from .device_common import _count
from . import fused_routes
from . import overlap
from . import pack as _pack
from . import materialize, materialize_dns, materialize_gelf
from . import materialize_jsonl, materialize_ltsv, materialize_rfc3164
from .dns import decode_dns_fetch, decode_dns_submit
from .encode_capnp_block import (encode_gelf_capnp_block,
                                 encode_ltsv_capnp_block,
                                 encode_rfc3164_capnp_block,
                                 encode_rfc5424_capnp_block)
from .encode_dns_block import encode_dns_gelf_block, encode_dns_ltsv_block
from .encode_gelf import encode_rfc5424_gelf
from .encode_gelf_block import gelf_extra_slots
from .encode_gelf_block import encode_rfc5424_gelf_block
from .encode_gelf_gelf_block import encode_gelf_gelf_block
from .encode_jsonl_block import (encode_jsonl_gelf_block,
                                 encode_jsonl_ltsv_block)
from .encode_ltsv_block import (encode_gelf_ltsv_block,
                                encode_ltsv_ltsv_block,
                                encode_rfc3164_ltsv_block,
                                encode_rfc5424_ltsv_block)
from .encode_ltsv_gelf_block import (encode_ltsv_gelf_block,
                                     gelf_extra_consts_ltsv)
from .encode_passthrough_block import (encode_rfc3164_passthrough_block,
                                       encode_rfc5424_passthrough_block)
from .encode_rfc3164_3164_block import encode_rfc3164_3164_block
from .encode_rfc3164_gelf_block import (encode_rfc3164_gelf_block,
                                        gelf_extra_consts_3164)
from .encode_rfc5424_block import (encode_gelf_rfc5424_block,
                                   encode_ltsv_rfc5424_block,
                                   encode_rfc3164_rfc5424_block,
                                   encode_rfc5424_rfc5424_block)
from .fused_routes import out_key
from .gelf import decode_gelf_fetch, decode_gelf_submit
from .jsonl import decode_jsonl_fetch, decode_jsonl_submit
from .ltsv import decode_ltsv_fetch, decode_ltsv_submit
from .rfc3164 import decode_rfc3164_fetch, decode_rfc3164_submit
from .rfc5424 import (decode_rfc5424_fetch, decode_rfc5424_host,
                     decode_rfc5424_submit)

DEFAULT_BATCH_SIZE = 16384
DEFAULT_FLUSH_MS = 50
DEFAULT_MAX_LINE_LEN = 512
# bound on one session's buffered region (bytes): a flush is forced once
# it is reached, whatever the record estimate, as in the reference, so a
# flood without separators (or a giant syslen body) cannot grow a region
# without limit
_RAW_REGION_CAP = 4 << 20

# decode → GELF block encode per input format (``input.format`` without
# its ``_tpu`` suffix)
_ROUTES = {
    "rfc5424": (decode_rfc5424_submit, decode_rfc5424_fetch,
                encode_rfc5424_gelf_block),
    "rfc3164": (decode_rfc3164_submit, decode_rfc3164_fetch,
                encode_rfc3164_gelf_block),
    "jsonl": (decode_jsonl_submit, decode_jsonl_fetch,
              encode_jsonl_gelf_block),
    "ltsv": (decode_ltsv_submit, decode_ltsv_fetch, encode_ltsv_gelf_block),
    "gelf": (decode_gelf_submit, decode_gelf_fetch, encode_gelf_gelf_block),
    "dns": (decode_dns_submit, decode_dns_fetch, encode_dns_gelf_block),
}
# the host block encoder of every other (input format, output) pair, the
# output keyed as fused_routes.out_key names it (the reference's
# per-encoder dispatch of block_fetch_encode, batch.py:1933-2102, and
# _encode_block_from_host :2178); a pair in neither table has no block
# encoder and takes the Record path (_block_route_ok)
_BLOCK = {
    ("rfc5424", "ltsv"): encode_rfc5424_ltsv_block,
    ("rfc5424", "rfc5424"): encode_rfc5424_rfc5424_block,
    ("rfc5424", "passthrough"): encode_rfc5424_passthrough_block,
    ("rfc3164", "ltsv"): encode_rfc3164_ltsv_block,
    ("rfc3164", "rfc5424"): encode_rfc3164_rfc5424_block,
    ("rfc3164", "rfc3164"): encode_rfc3164_3164_block,
    ("rfc3164", "passthrough"): encode_rfc3164_passthrough_block,
    ("jsonl", "ltsv"): encode_jsonl_ltsv_block,
    ("ltsv", "ltsv"): encode_ltsv_ltsv_block,
    ("ltsv", "rfc5424"): encode_ltsv_rfc5424_block,
    ("gelf", "ltsv"): encode_gelf_ltsv_block,
    ("gelf", "rfc5424"): encode_gelf_rfc5424_block,
    ("dns", "ltsv"): encode_dns_ltsv_block,
    ("rfc5424", "capnp"): encode_rfc5424_capnp_block,
    ("rfc3164", "capnp"): encode_rfc3164_capnp_block,
    ("ltsv", "capnp"): encode_ltsv_capnp_block,
    ("gelf", "capnp"): encode_gelf_capnp_block,
}
# the split device encode tier of an (input format, output) pair, as
# (route_ok, fetch_encode) (the reference's _rfc5424_device_module,
# batch.py:2135, and the rfc3164 leg's tiers :1924-1952)
_TIERS = {
    ("rfc5424", "gelf"): (device_gelf.route_ok, device_gelf.fetch_encode),
    ("rfc3164", "gelf"): (device_rfc3164.route_ok,
                          device_rfc3164.fetch_encode),
    ("ltsv", "gelf"): (device_ltsv.route_ok, device_ltsv.fetch_encode),
    ("gelf", "gelf"): (device_gelf_gelf.route_ok,
                       device_gelf_gelf.fetch_encode),
    ("rfc5424", "ltsv"): (device_ltsv_out.route_ok,
                          device_ltsv_out.fetch_encode),
    ("rfc5424", "rfc5424"): (device_rfc5424_out.route_ok,
                             device_rfc5424_out.fetch_encode),
    ("rfc3164", "rfc5424"): (device_rfc5424_out.route_ok,
                             device_rfc5424_out.fetch_encode_3164),
    ("rfc5424", "capnp"): (device_capnp.route_ok, device_capnp.fetch_encode),
}
# the Record path's materializer of each format that takes no decoder
_MATERIALIZE = {"rfc3164": materialize_rfc3164.materialize_rfc3164,
                "gelf": materialize_gelf.materialize_gelf,
                "jsonl": materialize_jsonl.materialize_jsonl,
                "dns": materialize_dns.materialize_dns}


class BatchHandler(Handler):
    def __init__(self, tx, encoder, config: Config, merger,
                 device: torch.device, start_timer: bool = True,
                 fmt: str = "rfc5424"):
        self.tx = tx
        self.fmt = fmt
        self.encoder = encoder
        self.merger = merger
        self.batch_size = config.lookup_int(
            "input.tpu_batch_size", "input.tpu_batch_size must be an integer",
            DEFAULT_BATCH_SIZE)
        self.flush_ms = config.lookup_int(
            "input.tpu_flush_ms", "input.tpu_flush_ms must be an integer",
            DEFAULT_FLUSH_MS)
        self.max_len = config.lookup_int(
            "input.tpu_max_line_len",
            "input.tpu_max_line_len must be an integer", DEFAULT_MAX_LINE_LEN)
        self._start_timer = start_timer
        # the ltsv scalar decoder (schema and suffixes from the config):
        # the oracle rows', the block encoder's and the tiers' gates; the
        # auto format's ltsv leg takes it too
        self.decoder = None
        if fmt in ("ltsv", "auto"):
            from ..decoders.ltsv import LTSVDecoder

            self.decoder = LTSVDecoder(config)
        # the opt-in extra auto legs (input.auto_extra_formats)
        self._auto_extras = (autodetect.auto_extra_formats(config)
                             if fmt == "auto" else ())
        self._cfg = config
        # the decode circuit breaker (tpu/breaker.py): whole batches take
        # the scalar oracle while nearly every row goes there anyway
        # (None: input.tpu_breaker = false)
        self._breaker = DecodeBreaker.from_config(config)
        # the scalar oracle of a breaker-open batch (auto: one a class)
        self.scalar = ScalarHandler(tx, self._scalar_decoder(fmt), encoder)
        self._auto_scalars: dict = {}
        # online template mining (tenancy/templates.py): None unless
        # tenant.templates = "on"
        self._miners = TemplateMinerSet.from_config(config)
        # template-ID enrichment rides the Record path (per-row JSON
        # fields do not fit the block encoders), GELF output only
        self._enrich_hook = None
        if (self._miners is not None and self._miners.enrich
                and type(encoder) is GelfEncoder):
            self._enrich_hook = make_gelf_enricher(self._miners)
            self.scalar.record_hook = self._enrich_hook
        # mining reads the fetched decode channels: the host block path
        # is pinned while it is on (no fused route, no device tier)
        self._mine_block = (self._miners is not None
                            and fmt in ("rfc5424", "rfc3164", "ltsv",
                                        "jsonl", "dns"))
        self._lines: List[bytes] = []
        # regions with their frame spans (the UDP input's recvmmsg path)
        self._span_chunks: List[bytes] = []
        self._span_sets: list = []
        self._span_count = 0
        # ingest-order (tenant, rows) runs beside the pending lines and
        # spans, so rows attribute to the tenant whose connection sent
        # them (mining, and the fair queue's lane on a Record-path emit);
        # kept while mining or while the ingest thread has a tenant tag
        self._line_runs: list = []
        self._span_runs: list = []
        self._next_runs = None
        self._raw_sessions: List["_RawSession"] = []
        self._raw_est = 0
        self._lock = threading.Lock()
        # serializes flushes so a timer flush racing a size flush cannot
        # reorder output (reentrant: the timer's callback holds it across
        # its flush)
        self._decode_lock = threading.RLock()
        self._timer = None
        # a failure the timer's flush met (its fence raises what a
        # fetcher stashed): kept here for the ingest thread, which raises
        # it at its next push or flush
        self._timer_exc: Optional[BaseException] = None
        # told of such a failure as soon as the timer keeps it (the
        # pipeline, which then stops its input: a network input's ingest
        # threads may push nothing more)
        self.on_failure = None
        # the device encode tiers' decline hysteresis and counts: the
        # split tier's under the input format (the auto format's legs
        # each under theirs), the fused route's under "fused:<route>"
        # (fused_routes.cooldown_state), never shared
        self.route_state: dict = {}
        # fused decode→encode routes: "auto" (default) runs the fused
        # route whenever the (format, encoder, merger) has one, declining
        # to the split path; "off" pins the split path; "on" is "auto"
        # plus a startup notice when this config can never fuse
        self._fuse_mode = config.lookup_str(
            "input.tpu_fuse", "input.tpu_fuse must be a string", "auto")
        if self._fuse_mode not in ("auto", "on", "off"):
            raise ConfigError("input.tpu_fuse must be auto, on or off")
        # the overlap executor (tpu/overlap.py): one lane a card when
        # several are visible (or input.tpu_lanes), each with its own
        # stream, pinned staging, fetcher thread, in-flight window and
        # route economics; the sequencer emits in strict batch order
        nlanes, lane_devs = overlap.resolve_lanes(config, device)
        self._lanes = [overlap.Lane(d) for d in lane_devs]
        self._econs = [
            overlap.RouteEconomics.from_config(
                config, label=f"lane{i}" if nlanes > 1 else None)
            for i in range(nlanes)]
        self._window = overlap.LaneSet(
            overlap.inflight_depth_from_config(config), self._pop_emit,
            lanes=nlanes, name=f"tpu-{fmt}")
        # the columnar block route is config-static: when it can never
        # engage, every batch takes the Record path, and the reference
        # says so once at startup (batch.py:284-292)
        self._block_ok = self._block_route_ok()
        reason = self._route_cliff_reason()
        if reason:
            print(f"flowgger-tpu: columnar block route disabled for "
                  f"format '{fmt}' ({reason}); throughput falls to the "
                  f"per-record path (~30x slower)", file=sys.stderr)
        elif self._fuse_mode == "on" and self._fused_route() is None:
            print(
                'flowgger-tpu: input.tpu_fuse = "on" but this '
                f"config cannot fuse format '{fmt}' (no registered "
                "fused program for the route, template mining on, "
                "or a sharded mesh owns the format); using the "
                "split decode/encode path", file=sys.stderr)

    def _block_route_ok(self) -> bool:
        """Whether the columnar block route can take this config's
        batches (the reference's ``_block_route_ok``, batch.py:1136-1228,
        on the output as :func:`fused_routes.out_key` names it).  Every
        merger the pipeline makes has a block form (``noop``: an empty
        suffix).

        - GELF: the ``gelf_extra`` keys must place statically for
          rfc5424, rfc3164 and ltsv, and be absent for gelf, jsonl, dns
          and auto; auto also takes no typed ``ltsv_schema``.
        - LTSV, RFC5424 and capnp: every input but jsonl and dns into
          RFC5424 and capnp; a typed ``ltsv_schema`` keeps ltsv and auto
          on the Record path, and ``auto_extra_formats`` keeps auto off
          RFC5424 and capnp.
        - RFC3164 (from rfc3164 only) and passthrough (from rfc5424 and
          rfc3164): only while ``syslog_prepend_timestamp`` is unset."""
        if self._enrich_hook is not None:
            # per-row _template_id fields ride the Record path
            return False
        out = out_key(self.encoder)
        fmt = self.fmt
        if out == "gelf":
            extra = self.encoder.extra
            if fmt == "rfc5424":
                return gelf_extra_slots(extra) is not None
            if fmt == "rfc3164":
                return gelf_extra_consts_3164(extra) is not None
            if fmt == "ltsv":
                return gelf_extra_consts_ltsv(extra) is not None
            if fmt == "auto":
                return not extra and not self.decoder.schema
            return not extra
        if out in ("rfc3164", "passthrough"):
            return ((fmt, out) in _BLOCK
                    and self.encoder.header_time_format is None)
        if fmt == "auto":
            ok = ("ltsv",) if self._auto_extras else ("ltsv", "rfc5424",
                                                       "capnp")
            return out in ok and not self.decoder.schema
        if (fmt, out) not in _BLOCK:
            return False
        return fmt != "ltsv" or not self.decoder.schema

    def _route_cliff_reason(self):
        """Why the block route can never engage for this config (None
        when it does): the reference's ``_route_cliff_reason`` words
        (batch.py:1230-1287)."""
        if self._block_ok:
            return None
        if self._enrich_hook is not None:
            return ("tenant.template_enrich is set (per-record "
                    "_template_id rides the Record path)")
        out = out_key(self.encoder)
        no_columnar = (f"output.format {type(self.encoder).__name__} has "
                       f"no columnar encoder for input format '{self.fmt}'")
        if out in ("ltsv", "rfc5424", "capnp"):
            if (self.fmt == "auto" and self._auto_extras
                    and out in ("rfc5424", "capnp")):
                return ("input.auto_extra_formats is set (the jsonl/dns "
                        "legs block-encode GELF/LTSV only)")
            if self.fmt in ("ltsv", "auto"):
                return "input.ltsv_schema is set"
            return no_columnar
        if out == "gelf":
            if self.encoder.extra:
                if self.fmt in ("rfc5424", "rfc3164", "ltsv"):
                    return ("output.gelf_extra keys need dynamic placement "
                            "(leading '_' or a fixed-key overwrite)")
                return "output.gelf_extra is set"
            if self.fmt == "auto" and self.decoder.schema:
                return "input.ltsv_schema is set"
            return no_columnar
        if out == "passthrough" and self.fmt in ("rfc5424", "rfc3164"):
            return "output.syslog_prepend_timestamp is set"
        if out == "rfc3164" and self.fmt == "rfc3164":
            return "output.syslog_prepend_timestamp is set"
        return no_columnar

    def _fused_route(self):
        """The fused route for this handler's config, or None: fuse mode
        off, the auto format (its legs take the split path), or no fused
        program for this (format, output encoder, merger), or template
        mining on (the miner reads the fetched decode channels, which a
        fused route never fetches)."""
        if (self._fuse_mode == "off" or self.fmt == "auto"
                or self._mine_block):
            return None
        return fused_routes.route_for(self.fmt, self.encoder, self.merger,
                                      self.decoder)

    # -- ingest --------------------------------------------------------------
    def wants_raw(self, framing: str) -> bool:
        """The port frames line, NUL and syslen streams on the card: the
        splitter hands raw chunks to a session (:meth:`open_raw`)."""
        return framing in ("line", "nul", "syslen")

    def open_raw(self, framing: str) -> "_RawSession":
        sess = _RawSession(self, framing)
        with self._lock:
            self._raw_sessions.append(sess)
        return sess

    def handle_bytes(self, raw: bytes) -> None:
        """One already-framed record (the end-of-stream partial frame)."""
        self._raise_timer_exc()
        tag = _tenancy.current_name()
        with self._lock:
            self._lines.append(raw)
            if self._miners is not None or tag is not None:
                tenant = tag or _tenancy.DEFAULT_TENANT
                if self._line_runs and self._line_runs[-1][0] == tenant:
                    self._line_runs[-1][1] += 1
                else:
                    self._line_runs.append([tenant, 1])
            full = self._pending_locked() >= self.batch_size
            if not full:
                self._arm_timer_locked()
        if full:
            self.flush(drain=False)

    def ingest_spans(self, chunk: bytes, starts, lens) -> None:
        """A region and the spans of its frames (the UDP input's recvmmsg
        path: one datagram a span).  At flush the spans are packed on the
        host into one batch, which decodes on the card (the reference's
        ``ingest_spans`` and ``_decode_spans``, batch.py:448-466,
        713-730)."""
        self._raise_timer_exc()
        tag = _tenancy.current_name()
        with self._lock:
            self._span_chunks.append(chunk)
            self._span_sets.append((starts, lens))
            self._span_count += len(starts)
            if self._miners is not None or tag is not None:
                self._span_runs.append(
                    (tag or _tenancy.DEFAULT_TENANT, len(starts)))
            full = self._pending_locked() >= self.batch_size
            if not full:
                self._arm_timer_locked()
        if full:
            self.flush(drain=False)

    def handle_record(self, record) -> None:
        """One record the capnp splitter built: every lane is fenced
        first, so it keeps its place behind the batches in flight, then
        it is encoded on the host (the reference's ``handle_record``,
        batch.py:505-507)."""
        self._raise_timer_exc()
        self._window.fence()
        try:
            encoded = self.encoder.encode(record)
        except EncodeError as e:
            print(e, file=sys.stderr)
            return
        self.tx.put(encoded)

    def _pending_locked(self) -> int:
        return len(self._lines) + self._span_count + self._raw_est

    def _arm_timer_locked(self) -> None:
        if self._timer is None and self._start_timer:
            self._timer = threading.Timer(self.flush_ms / 1000.0,
                                          self._timer_flush)
            self._timer.daemon = True
            self._timer.start()

    def _timer_flush(self) -> None:
        """The flush timer's callback.  A failure it meets (a kernel or
        fetch failure its fence raises) is kept for the ingest thread:
        raised here it would end only the timer's thread, and the run
        would go on without the batch."""
        with self._decode_lock:
            # kept before the decode lock is let go, so no flush after
            # it submits a batch behind the failed one
            try:
                self.flush()
            except BaseException as e:  # noqa: BLE001 - raised on ingest
                with self._lock:
                    if self._timer_exc is None:
                        self._timer_exc = e
                if self.on_failure is not None:
                    self.on_failure(e)

    def _raise_timer_exc(self) -> None:
        """Raise, on the calling (ingest) thread, a failure the timer's
        flush kept."""
        if self._timer_exc is not None:
            with self._lock:
                exc, self._timer_exc = self._timer_exc, None
            if exc is not None:
                raise exc

    # -- flush ---------------------------------------------------------------
    def flush(self, drain: bool = True) -> None:
        """Frame and submit everything pending, in order.  The lanes'
        fetcher threads fetch, encode and enqueue behind us;
        ``drain=True`` (a timer flush, the end of a stream) also fences
        every lane, so every submitted batch has reached the queue when
        it returns."""
        with self._lock:
            lines, self._lines = self._lines, []
            span_chunks, self._span_chunks = self._span_chunks, []
            span_sets, self._span_sets = self._span_sets, []
            self._span_count = 0
            line_runs, self._line_runs = self._line_runs, []
            span_runs, self._span_runs = self._span_runs, []
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        with self._decode_lock:
            self._raise_timer_exc()
            # raw sessions snapshot inside the decode lock: each session's
            # carry chains across flushes, so snapshot order must equal
            # processing order whichever thread flushes
            with self._lock:
                raw = [(s, s.chunks) for s in self._raw_sessions if s.chunks]
                for s, _ in raw:
                    s.chunks = []
                    s.nbytes = 0
                    self._raw_est -= s.est
                    s.est = 0
            for s, chunks in raw:
                self._decode_raw(s, chunks)
            if span_chunks:
                if self._device_allowed():
                    self._submit_with(_pack_spans(span_chunks, span_sets,
                                                  self.max_len),
                                      None, span_runs or None)
                else:
                    # breaker open: the scalar oracle, behind a fence
                    self._window.fence()
                    for chunk, (starts, lens) in zip(span_chunks, span_sets):
                        for st, ln in zip(np.asarray(starts).tolist(),
                                          np.asarray(lens).tolist()):
                            self._scalar_handle(chunk[st:st + ln])
            if lines:
                if self._device_allowed():
                    self._submit_with(
                        _pack.pack_lines_2d(lines, self.max_len), None,
                        line_runs or None)
                else:
                    self._window.fence()
                    for raw_line in lines:
                        self._scalar_handle(raw_line)
            if drain:
                self._window.fence()

    def close(self) -> None:
        """Fence every lane and stop their fetcher threads (the pipeline's
        drain); a later submit starts them again."""
        self._window.close()

    def drain_after_failure(self) -> None:
        """Fence every lane after a failure has ended the run, so the
        batches submitted before it are emitted; a further failure met
        while draining is reported on stderr (the first one is the one
        the caller raises)."""
        try:
            self._window.fence()
        except Exception as e:  # noqa: BLE001 - the first failure is raised
            print(f"flowgger-tpu: a further batch failed while draining "
                  f"({type(e).__name__}: {e})", file=sys.stderr)
        self._window.close()

    def economics(self) -> list:
        """Each lane's route-economics snapshot."""
        return [e.snapshot() for e in self._econs]

    def _frame(self, region: bytes, framing: str, n_records: int,
               lane: int):
        """Device framing of one region on ``lane``'s device, from its
        pinned staging, on its stream (the caller is inside the lane's
        scope)."""
        ln = self._lanes[lane]
        return _framing.device_frame_region(
            region, framing, self.max_len, n_records=n_records,
            device=ln.device, staging=ln.staging)

    def _decode_raw(self, sess: "_RawSession", chunks: List[bytes]) -> None:
        region = sess.carry + b"".join(chunks)
        sess.carry = b""
        if not region or sess.dead:
            return
        runs_tag = None
        if self._miners is not None or sess.tag is not None:
            runs_tag = sess.tag or _tenancy.DEFAULT_TENANT
        breaker_open = not self._device_allowed()
        if sess.framing == "syslen":
            self._decode_raw_syslen(sess, region, breaker_open, runs_tag)
            return
        cut = region.rfind(sess.sep)
        if cut < 0:
            sess.carry = region
            return
        framed, sess.carry = region[:cut + 1], region[cut + 1:]
        n = framed.count(sess.sep)
        # record-aligned admission: the tenant pays what the host
        # splitter would have charged, all or nothing a framed region
        # (the carry stays; it is charged when it frames)
        if (sess.charge is not None and n
                and not sess.charge.admit_region(n, len(framed))):
            return
        if breaker_open:
            # the scalar oracle, behind a fence so the batches in flight
            # keep their place
            self._window.fence()
            self._scalar_raw_lines(framed, sess.sep, sess.framing == "line")
            return
        runs = [(runs_tag, n)] if runs_tag is not None else None
        # the lane is reserved before framing, so the batch is framed on
        # its device and stream
        lane = self._window.next_lane()
        with self._lanes[lane].scope():
            try:
                packed, _consumed, _err = self._frame(framed, sess.framing,
                                                      n, lane)
            except _framing.FramingDeclined:
                # more records than the separator count sized the spans
                # for: the same bytes framed on the host
                packed = _pack.pack_region_2d(
                    framed, self.max_len, sep=sess.sep[0],
                    strip_cr=sess.framing == "line")
            self._submit_with(packed, lane, runs)

    def _decode_raw_syslen(self, sess: "_RawSession", region: bytes,
                           breaker_open: bool, runs_tag) -> None:
        """Octet-count framing of one session region on the card; a
        decline (a prefix over 9 digits, or more frames than spaces)
        re-frames the same bytes with the host scan, as does an open
        breaker (whose records then take the scalar oracle)."""
        charge = sess.charge
        lane = None
        if not breaker_open:
            lane = self._window.next_lane()
            with self._lanes[lane].scope():
                try:
                    packed, consumed, err = self._frame(
                        region, "syslen", max(region.count(b" "), 1), lane)
                except _framing.FramingDeclined:
                    pass
                else:
                    n = int(packed[5])
                    if n and charge is not None:
                        _framing.host_ready(packed)
                        if not charge.admit_region(
                                n, int(np.asarray(packed[4][:n]).sum())):
                            # the framed records drop as a unit; the
                            # carry stays with the session
                            n = 0
                    if n:
                        runs = [(runs_tag, n)] if runs_tag is not None \
                            else None
                        self._submit_with(packed, lane, runs)
                    self._finish_raw_syslen(sess, region, consumed, err)
                    return
        starts, lens, n, consumed, err = _scan_syslen_region(region)
        if n and charge is not None and not charge.admit_region(
                int(n), int(lens.sum())):
            self._finish_raw_syslen(sess, region, consumed, err)
            return
        if breaker_open:
            self._window.fence()
            for st, ln in zip(starts.tolist(), lens.tolist()):
                self._scalar_handle(region[st:st + ln])
        elif n:
            packed = _pack.pack_spans_2d(region[:consumed], starts, lens,
                                         self.max_len)
            runs = [(runs_tag, n)] if runs_tag is not None else None
            self._submit_with(packed, lane, runs)
        self._finish_raw_syslen(sess, region, consumed, err)

    def _finish_raw_syslen(self, sess: "_RawSession", region: bytes,
                           consumed: int, err: bool) -> None:
        sess.carry = region[consumed:]
        if err:
            # host-scan parity: a malformed length prefix ends the stream
            # (the session goes dead; the splitter's next push sees it)
            print("Can't read message's length", file=sys.stderr)
            sess.dead = True
            sess.carry = b""

    # -- the breaker's scalar path -------------------------------------------
    def _device_allowed(self) -> bool:
        return self._breaker is None or self._breaker.allow()

    def _scalar_decoder(self, fmt: str):
        """The scalar oracle's decoder of a format (auto: its rfc5424
        class; the other classes build theirs at first use)."""
        from .. import decoders

        if fmt in ("ltsv", "auto"):
            return self.decoder if fmt == "ltsv" else \
                decoders.RFC5424Decoder(self._cfg)
        return {"rfc5424": decoders.RFC5424Decoder,
                "rfc3164": decoders.RFC3164Decoder,
                "jsonl": decoders.JSONLDecoder,
                "gelf": decoders.GelfDecoder,
                "dns": decoders.DNSDecoder}[fmt](self._cfg)

    def _scalar_handle(self, raw: bytes) -> None:
        """One record through its format's scalar oracle, with the
        splitter's flags set on this handler."""
        handler = (self._auto_scalar_for(raw) if self.fmt == "auto"
                   else self.scalar)
        handler.quiet_empty = self.quiet_empty
        handler.bare_errors = self.bare_errors
        handler.handle_bytes(raw)

    def _auto_scalar_for(self, raw: bytes) -> ScalarHandler:
        """auto: classify the record on the host (the classifier's own
        table) and take that class's scalar oracle, so the breaker's
        path stays byte-identical to the batched one."""
        from .. import decoders

        cls = autodetect.classify(raw, self._auto_extras)
        handler = self._auto_scalars.get(cls)
        if handler is None:
            decoder = {
                autodetect.F_RFC5424: lambda: self.scalar.decoder,
                autodetect.F_LTSV: lambda: self.decoder,
                autodetect.F_GELF: lambda: decoders.GelfDecoder(self._cfg),
                autodetect.F_JSONL: lambda: decoders.JSONLDecoder(self._cfg),
                autodetect.F_DNS: lambda: decoders.DNSDecoder(self._cfg),
            }.get(cls, lambda: decoders.RFC3164Decoder(self._cfg))()
            handler = ScalarHandler(self.tx, decoder, self.encoder)
            handler.record_hook = self.scalar.record_hook
            self._auto_scalars[cls] = handler
        return handler

    def _scalar_raw_lines(self, framed: bytes, sep: bytes,
                          strip_cr: bool) -> None:
        lines = framed.split(sep)
        lines.pop()  # framed regions end with the separator
        for raw in lines:
            if strip_cr and raw.endswith(b"\r"):
                raw = raw[:-1]
            self._scalar_handle(raw)

    def _dispatch(self, packed) -> None:
        """One packed batch down the ladder, emitted before this
        returns: submit, then fence every lane."""
        self._submit(packed)
        self._window.fence()

    def _submit_with(self, packed, lane, runs) -> None:
        """:meth:`_submit` of a batch with its ingest-order (tenant, rows)
        runs (None: no tenant attribution).  The runs ride an attribute
        that ``_submit`` takes at once: flushes are serialized by the
        decode lock."""
        self._next_runs = runs
        self._submit(packed, lane)

    def _submit(self, packed, lane=None) -> None:
        """The submit half of the ladder (the reference's ``_emit_fast``),
        on the ingest thread under the lane's stream: the Record path
        (fenced, synchronous), or the lane's window — auto's batches as
        they are, the fused route's inputs (its cooldown counted down
        here, its economics arm consulted), or the split decode; the
        batch's runs (:meth:`_submit_with`) ride along."""
        runs, self._next_runs = self._next_runs, None
        if lane is None:
            lane = self._window.next_lane()
        ln = self._lanes[lane]
        with ln.scope():
            batch, lens, chunk, starts, orig_lens, n_real = packed
            if not isinstance(batch, torch.Tensor):
                batch = torch.from_numpy(batch).to(ln.device)
                lens = torch.from_numpy(lens).to(ln.device)
                packed = (batch, lens, chunk, starts, orig_lens, n_real)
            if not self._block_ok:
                # a synchronous emit keeps its place behind the in-flight
                # batches of every lane
                self._window.fence()
                _framing.host_ready(packed)
                self._emit_record_path(packed, runs)
                if self._breaker is not None:
                    self._breaker.record_success()
                return
            if self.fmt == "auto":
                # the classifier and the per-class legs run on the lane's
                # fetcher thread
                self._window.submit(lane, (None, packed, runs))
                return
            route = self._fused_route()
            if route is not None:
                state = fused_routes.cooldown_state(self.route_state, route)
                if state.get("cooldown", 0) > 0:
                    # fused route cooling down after declines: the split
                    # path takes this batch
                    state["cooldown"] -= 1
                    state["cooled"] = state.get("cooled", 0) + 1
                elif self._econs[lane].allow_fused():
                    handle = fused_routes.submit(route, (batch, lens))
                    self._window.submit(lane, (handle, packed, runs))
                    return
                else:
                    # the economics measured the split path cheaper
                    _count(state, "econ_split")
            self._window.submit(lane, (block_submit(self.fmt, packed),
                                       packed, runs))

    def _pop_emit(self, payload, lane: int = 0):
        """The pop half (the reference's ``_pop_emit``), on the lane's
        fetcher thread under its stream: fetch and encode one batch, and
        return the emit closure the sequencer runs in submit order, which
        feeds the lane's economics with the route's measured seconds (a
        declined attempt's seconds taken out) and tells the breaker of
        the emitted batch (a half-open probe closes it here)."""
        handle, packed, runs = payload
        econ = self._econs[lane]
        stats: dict = {}
        with self._lanes[lane].scope():
            # the span arrays device framing copies back without blocking
            _framing.host_ready(packed)
            t0 = time.perf_counter()
            emit = self._pop_emit_inner(handle, packed, stats, econ, runs)
            compute_s = (time.perf_counter() - t0
                         - stats.get("declined_s", 0.0))
        path = stats.get("path")

        def finish():
            emit()
            if self._breaker is not None:
                self._breaker.record_success()
            if path is not None:
                econ.observe(path, int(packed[5]), compute_s)

        return finish

    def _pop_emit_inner(self, handle, packed, stats, econ, runs=None):
        """Fetch and encode one batch; returns a zero-argument emit
        closure."""
        n_real = int(packed[5])
        if self.fmt == "auto":
            # economics does not govern auto's legs: each keeps its own
            # decline / cooldown hysteresis only
            res = autodetect.encode_auto_gelf_blocks(
                packed, self.encoder, self.merger, self.decoder,
                self.route_state, self._auto_extras)
            if res is None:
                results = autodetect.decode_auto_packed(
                    packed, self.decoder, self._auto_extras)
                return lambda: self._emit(results, runs)
            return lambda: self._emit_block(res, n_real)
        fused_declined_s = 0.0
        if isinstance(handle, fused_routes.FusedHandle):
            tf0 = time.perf_counter()
            res, _fetch_s = fused_routes.fetch_encode(
                handle, packed, self.encoder, self.merger,
                self.route_state, decoder=self.decoder)
            if res is not None:
                stats["path"] = "fused"
                return lambda: self._emit_block(res, n_real)
            # the fused route declined: the split decode, submitted again
            # on this lane's stream, takes the batch; the declined
            # attempt's seconds are not the split path's
            fused_declined_s = time.perf_counter() - tf0
            handle = block_submit(self.fmt, packed)
        mined: list = []
        column_tap = None
        if self._mine_block:
            # extraction only, on this (concurrent) fetcher thread; the
            # miner observes inside the sequenced emit, so template IDs
            # are assigned in batch order at every lane count
            column_tap = lambda host_out: mined.append(  # noqa: E731
                self._miners.extract_block(self.fmt, packed, host_out))
        res, host_out = block_fetch_encode(
            self.fmt, handle, packed, self.encoder, self.merger,
            self.decoder, self.route_state,
            # mining reads the fetched decode channels: the host block
            # path is pinned while it is on
            allow_device=econ.allow_device() and not self._mine_block,
            stats=stats, column_tap=column_tap)
        stats["declined_s"] = stats.get("declined_s", 0.0) + fused_declined_s
        if res is None:
            # the block encoder declined the batch after the fact (an
            # ltsv_schema of more than 8 keys, a suffix for a schema
            # type): the Record path, on the channels already fetched,
            # emitted in the batch's turn
            results = _materialize_packed(self.fmt, packed, host_out,
                                          self.decoder)
            return lambda: self._emit(results, runs)
        if mined and mined[0] is not None:
            def emit_mined():
                self._miners.observe_rows(mined[0], runs)
                self._emit_block(res, n_real)

            return emit_mined
        return lambda: self._emit_block(res, n_real)

    def _emit_record_path(self, packed, runs=None) -> None:
        """A batch of a config the block route cannot take: rfc5424 into
        GELF per row from the decode's spans (the reference's
        ``_encode_packed_rfc5424_gelf``), and into passthrough without a
        prepend format per row too (``encode_passthrough``); auto through
        its per-class Record path; every other format and encoder, and
        rfc5424 with template enrichment (every row gets its
        ``_template_id`` before the encode), through its Record path
        (rfc5424 into RFC3164, and into passthrough with
        ``syslog_prepend_timestamp`` set, among them)."""
        out = out_key(self.encoder)
        if self.fmt == "rfc5424" and self._enrich_hook is None and (
                out == "gelf" or (out == "passthrough"
                                  and self.encoder.header_time_format
                                  is None)):
            batch, lens, chunk, starts, orig_lens, n_real = packed
            encode = (encode_rfc5424_gelf if out == "gelf" else
                      encode_passthrough.encode_rfc5424_passthrough)
            self._emit_encoded(encode(
                chunk, starts, orig_lens, decode_rfc5424_host(batch, lens),
                n_real, batch.shape[1], self.encoder), runs)
        elif self.fmt == "auto":
            self._emit(autodetect.decode_auto_packed(
                packed, self.decoder, self._auto_extras), runs)
        else:
            self._emit(_decode_packed(self.fmt, packed, self.decoder), runs)

    def _print_error(self, error: str, line: str) -> None:
        if error == "__utf8__":
            print("Invalid UTF-8 input", file=sys.stderr)
        elif self.bare_errors:
            print(error, file=sys.stderr)
        else:
            stripped = line.strip()
            if not (self.quiet_empty and not stripped):
                print(f"{error}: [{stripped}]", file=sys.stderr)

    def _emit_block(self, res, n_real: int) -> None:
        if self._breaker is not None:
            self._breaker.observe_batch(n_real, res.fallback_rows)
        for error, line in res.errors:
            self._print_error(error, line)
        if len(res.block):
            self.tx.put(res.block)

    @staticmethod
    def _expand_runs(runs, n_rows: int):
        """One tenant a row from the ingest-order runs, or None when the
        runs do not cover the batch."""
        if runs and sum(n for _, n in runs) == n_rows:
            return [t for t, n in runs for _ in range(n)]
        return None

    def _emit(self, results, runs=None) -> None:
        """Record-path rows in order: a decode error's line, or the
        record (mined, and enriched with its ``_template_id``, when
        mining is on) encoded into one queue item (the output thread
        frames it with the merger), or an encode error's line.  With
        runs covering the batch, each row is attributed to its own
        tenant: for mining, and for the fair queue's lane (the put rides
        the row's tag, not the flusher's)."""
        expanded = self._expand_runs(runs, len(results))
        default_tenant = None
        if self._miners is not None and expanded is None:
            default_tenant = _tenancy.current_or_default()
        prev_tag = _tenancy.current_name() if expanded is not None else None
        try:
            for i, res in enumerate(results):
                if res.record is None:
                    self._print_error(res.error, res.line)
                    continue
                if self._miners is not None:
                    tenant = (expanded[i] if expanded is not None
                              else default_tenant)
                    if self._enrich_hook is not None:
                        self._enrich_hook(res.record, tenant)
                    else:
                        self._miners.observe_msg(tenant,
                                                 res.record.msg or "")
                try:
                    encoded = self.encoder.encode(res.record)
                except EncodeError as e:
                    stripped = res.line.strip()
                    if not (self.quiet_empty and not stripped):
                        print(f"{e}: [{stripped}]", file=sys.stderr)
                    continue
                if expanded is not None:
                    _tenancy.set_current(expanded[i])
                self.tx.put(encoded)
        finally:
            if expanded is not None:
                _tenancy.set_current(prev_tag)

    def _emit_encoded(self, results, runs=None) -> None:
        """The per-row span encode's rows in order: an error's line, or
        the encoded bytes as one queue item (on its row's tenant lane)."""
        expanded = self._expand_runs(runs, len(results))
        prev_tag = _tenancy.current_name() if expanded is not None else None
        try:
            for i, res in enumerate(results):
                if res.encoded is None:
                    self._print_error(res.error, res.line)
                    continue
                if expanded is not None:
                    _tenancy.set_current(expanded[i])
                self.tx.put(res.encoded)
        finally:
            if expanded is not None:
                _tenancy.set_current(prev_tag)


def _pack_spans(chunks: List[bytes], span_sets: list, max_len: int):
    """The spans of several regions as one batch packed on the host (the
    reference's ``pack.pack_spans_2d`` of a chunk list)."""
    if len(chunks) == 1:
        starts, lens = span_sets[0]
        return _pack.pack_spans_2d(chunks[0], starts, lens, max_len)
    offs = np.cumsum([0] + [len(c) for c in chunks[:-1]])
    starts = np.concatenate([np.asarray(s, np.int64) + o
                             for (s, _), o in zip(span_sets, offs)])
    lens = np.concatenate([np.asarray(ln) for _, ln in span_sets])
    return _pack.pack_spans_2d(b"".join(chunks), starts, lens, max_len)


def block_submit(fmt: str, packed):
    """Launch the format's decode of one packed batch (on its device);
    pair with :func:`block_fetch_encode`."""
    batch, lens = packed[0], packed[1]
    if fmt in ("ltsv", "dns"):
        # the ltsv and dns decodes take the real row count (padding rows
        # unread)
        return _ROUTES[fmt][0](batch, lens, packed[5])
    return _ROUTES[fmt][0](batch, lens)


def block_fetch_encode(fmt: str, handle, packed, encoder, merger,
                       ltsv_decoder=None, route_state=None,
                       allow_device: bool = True, stats=None,
                       column_tap=None):
    """The split device encode tier of a submitted decode, then (on its
    decline, with ``allow_device`` False — the route economics measured
    the host path as cheaper — or with no tier for the format and
    output) the fetch and the host block encoder of the output encoder's
    type.  Returns ``(BlockResult, None)`` from the tier,
    ``(BlockResult, channels)`` from the host block encoder, or ``(None,
    channels)`` when the block encoder declines the batch: the caller
    then takes the Record path on the fetched channels.  The tier's
    decline and cooldown state lives in ``route_state[fmt]``, so the
    auto format's legs never share one.  ``stats`` (a dict, optional)
    gets the reference's ``path`` (``"device"`` or ``"host"``, for
    whichever tier made the block), ``fetch_s`` and ``declined_s``, the
    seconds a declined device attempt cost.  ``column_tap`` (template
    mining) is called with the fetched decode channels on the host path;
    its caller passes ``allow_device=False``, so the channels are
    fetched.  A tap failure is reported, never a lost batch."""
    t0 = time.perf_counter()
    declined_s = 0.0
    dec = (ltsv_decoder,) if fmt == "ltsv" else ()
    dec_kw = {"decoder": ltsv_decoder} if fmt == "ltsv" else {}
    out = out_key(encoder)
    tier = _TIERS.get((fmt, out))
    if tier is not None and tier[0](encoder, merger, **dec_kw):
        state = route_state.setdefault(fmt, {}) \
            if route_state is not None else None
        if not allow_device:
            # the economics measured the host path cheaper
            _count(state, "econ_host")
            tier = None
    else:
        tier = None
    if tier is not None:
        res, fetch_s = tier[1](handle, packed, encoder, merger, state,
                               **dec_kw)
        if res is not None:
            if stats is not None:
                stats.update(path="device", fetch_s=fetch_s, declined_s=0.0)
            return res, None
        declined_s = time.perf_counter() - t0
        t0 = time.perf_counter()
    _, fetch, encode = _ROUTES[fmt]
    if out != "gelf":
        encode = _BLOCK[(fmt, out)]
    batch, _, chunk, starts, orig_lens, n_real = packed
    host_out = fetch(handle)
    fetch_s = time.perf_counter() - t0
    if column_tap is not None:
        try:
            column_tap(host_out)
        except Exception as e:  # noqa: BLE001 - mining never costs the batch
            print(f"template column tap failed ({type(e).__name__}: {e}); "
                  "batch not mined", file=sys.stderr)
    res = encode(chunk, starts, orig_lens, host_out, n_real, batch.shape[1],
                 encoder, merger, *dec)
    if stats is not None:
        stats.update(fetch_s=fetch_s, declined_s=declined_s)
        if res is not None:
            stats["path"] = "host"
    return res, host_out


def _decode_packed(fmt: str, packed, decoder=None):
    """The Record path of one packed batch: the format's decode kernel
    (on the batch's device, with its rescue), its channels fetched, and
    one LineResult a real row (the reference's ``_decode_packed``,
    batch.py:2219)."""
    host_out = _ROUTES[fmt][1](block_submit(fmt, packed))
    return _materialize_packed(fmt, packed, host_out, decoder)


def _materialize_packed(fmt: str, packed, host_out, decoder=None):
    """One LineResult a real row of a packed batch, from its fetched
    decode channels."""
    batch, lens, chunk, starts, orig_lens, n_real = packed
    L = batch.shape[1]
    if fmt == "rfc5424":
        return materialize.materialize(chunk, starts, lens, orig_lens,
                                       host_out, n_real, L)
    if fmt == "ltsv":
        return materialize_ltsv.materialize_ltsv(
            chunk, starts, orig_lens, host_out, n_real, L, decoder)
    return _MATERIALIZE[fmt](chunk, starts, orig_lens, host_out, n_real, L)


class _RawSession:
    """Per-stream region buffer for device framing: raw chunks accumulate
    untouched, the handler frames them at flush, and the carry-over tail
    — a record split across a chunk or flush boundary — stays here
    between flushes.  ``est`` drives the batch-size flush trigger: one
    separator count per chunk (exact for line/NUL), or one space count
    (an upper bound for syslen: each frame consumes at least one).
    ``nbytes`` (the chunks' bytes) with the carry drives the region cap,
    :data:`_RAW_REGION_CAP`.  ``dead`` marks a syslen stream whose length
    prefix was malformed."""

    def __init__(self, handler: BatchHandler, framing: str):
        self.handler = handler
        self.framing = framing
        self.sep = b"\0" if framing == "nul" else b"\n"
        self.carry = b""
        self.chunks: List[bytes] = []
        self.est = 0
        self.nbytes = 0
        self.dead = False
        # the connection's tenant (one stream, one tenant) and its
        # admission charge (tenancy/admission.RawCharge), or None
        self.tag = _tenancy.current_name()
        self.charge = None

    def push(self, chunk: bytes) -> bool:
        """Buffer one raw chunk; returns False once the session died."""
        if self.dead:
            return False
        h = self.handler
        h._raise_timer_exc()
        est = chunk.count(b" " if self.framing == "syslen" else self.sep)
        with h._lock:
            self.chunks.append(chunk)
            self.nbytes += len(chunk)
            self.est += est
            h._raw_est += est
            full = (h._pending_locked() >= h.batch_size
                    or self.nbytes + len(self.carry) >= _RAW_REGION_CAP)
            if not full:
                h._arm_timer_locked()
        if full:
            h.flush(drain=False)
        return not self.dead

    def finish(self, idle: bool = False) -> None:
        """End of stream: flush pending data, then resolve the carry with
        the host splitters' EOF semantics — line/NUL emit a trailing
        partial frame (BufRead::lines parity, one trailing CR stripped
        for line framing); syslen prints the host scan's short-read,
        idle or bad-length message."""
        h = self.handler
        h.flush()
        with h._lock:
            carry, self.carry = self.carry, b""
            if self in h._raw_sessions:
                h._raw_sessions.remove(self)
        if self.dead:
            return
        if self.framing == "syslen":
            # a carry mid-body is a short read; an idle timeout outside a
            # body closes quietly; a hard EOF on a non-body carry is a
            # bad-length error
            if carry and SyslenSplitter._mid_body(carry):
                print("failed to fill whole buffer", file=sys.stderr)
            elif idle:
                print("Client hasn't sent any data for a while - Closing "
                      "idle connection", file=sys.stderr)
            elif carry:
                print("Can't read message's length", file=sys.stderr)
            return
        if carry:
            if self.framing == "line" and carry.endswith(b"\r"):
                carry = carry[:-1]
            if self.charge is not None and not self.charge.admit_region(
                    1, len(carry)):
                # the end-of-stream partial frame is charged as the host
                # splitter's handle_bytes would be: one record
                return
            h.handle_bytes(carry)
