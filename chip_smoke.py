"""Chip smoke run of flowgger_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--lines N] [--host-ab ROUNDS]

Phases, each printing JSON lines:

1. device — ``nvidia-smi`` name and power limit, torch's device name,
   the SM clock under a spin kernel, the host's CPU model and count;
2. build  — the native host tier (``csrc/flowgger_host.cpp``, g++; a
   ``host_build`` line with the compiler's version, the flags, the
   seconds and whether the library was cached), then the fifteen CUDA
   sources compiled from ``flowgger_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), with a ``kernel_build`` line
   for each entry function: registers, shared memory, stack and spill
   bytes as ``nvcc -Xptxas -v`` reports them (E1's, EL's and EG's four
   instantiations, E3's, F1's, F3's, FL's, FG's, OL's, FO/ltsv's and AC's
   two each, D3, L1, DN, K5 at 8, 16 and 24 fields, and O5's and FO/r5's
   four each must be among them);
3. kernels — each kernel against its plain PyTorch version on the card at
   the main paths' shapes, on every element of every row, with CUDA-event
   times and the bound of each (K2 and K3 checked again on a launch after
   their timing loop): line framing of a 16 384-line region → spans →
   [16384, 512] batch → RFC5424 channels at 6 and 16 pairs (and K3 at
   [16384, 500], K2 over the region NUL-framed and over seven such
   regions back to back, >= 16 MiB); the octet-counted framing of the
   syslen path's flush region (and of a whole 16 384-frame region); the
   JSON-lines structural index at 8 and 24 fields on a gathered
   [16384, 512] JSON-lines batch; the gather and decodes at the e2e runs'
   other shapes (the line paths' flush regions and batches — a flush
   holds up to one 64 KiB read more than 16 384 records, so its batch is
   [32768, 512] — the syslen flush batch, the rescue sub-batches, a
   2 048-row JSON-lines batch); both chained framing → decode entries
   against the kernels called one by one; the device GELF encode
   (E1) at 6 and 16 pairs, probe and assemble, on a gathered
   [16384, 512] batch of the tier mix (every row's base tier bit and
   base length, zeros past the real rows, every tier row's bytes), at 6
   pairs on the tier path's flush batch and on 256 rows (its
   end-of-stream batch's shape, 200 of them real), and E1's phase-1
   probes at 6 and 16 pairs on the rfc5424 line path's flush batch and
   the syslen flush batch (K1 at both widths there too); the fused
   rfc5424 route F1 (the probe with the ok and timestamp channels and
   each tier row's carried channels, then the assemble from those
   channels; its wrapper refuses an assemble without them or of a row
   outside the probe's tier) at the same tier shapes, and its probe on
   the rfc5424 line and syslen flush batches;
   the rfc3164 decode D3 (every channel), its split encode E3 and its
   fused route F3 (probe and assemble) on a gathered [16384, 512] batch
   of the rfc3164 tier mix, on the flush batches of both rfc3164 paths
   and on 256 rows; the ltsv decode L1 (every channel, padding rows
   included), its split encode EL at 6 and 16 pairs and its fused route
   FL (probe with its narrowed stamp channels and each tier row's carried
   selection, then assemble) on a gathered [16384, 512] batch of the ltsv
   tier mix, on the flush batches of both ltsv paths and on 256 rows;
   K5's flat mode (``nested = 0``, the GELF decode) at 8, 16 and 24
   fields (every channel), its split encode EG at 8 and 16 fields and
   its fused route FG (probe with its stamp channels and each tier row's
   carried selection, then assemble) on a gathered [16384, 512] batch of
   the gelf tier mix, on the flush batches of both gelf paths (and the
   line path's 24-field rescue sub-batch) and on 256 rows; the
   auto-detect classifier AC on every real row of a gathered
   [16384, 512] batch of the auto tier mix (with its registers, stack
   and spill bytes), of the edge batch (``corpus.AUTO_EDGE`` and their
   prefixes) and of both auto paths' flush batches; the → LTSV encode OL
   (from K1's channels) and its fused route FO/ltsv (probe with its gaps,
   stamp channels and carried channels, then the assemble from them), each
   probe and assemble on a gathered [16384, 512] batch of the → LTSV tier
   mix (``corpus.make_ltsv_out_tier_corpus``) and on 256 rows; the dns
   decode DN (every channel) on a gathered [16384, 512] batch of the dns
   tier mix and of the dns mix; AC with its dns flag (AC+dns) on a
   gathered [16384, 512] batch of the auto mix with the dns leg; the →
   RFC5424 encodes O5 (from K1's channels) and O5/3164 (from D3's) and
   their fused routes FO/r5 (probe with fac8 / sev8 — and pri1 and the
   host length on the rfc3164 leg — the stamp channels and the carried
   channels, then the assemble from them), each probe and assemble on a
   gathered [16384, 512] batch of the rfc5424 or rfc3164 tier mix
   (:func:`r5_case`);
4. native — each export of the native host tier against its plain
   numpy or Python version, byte for byte, at the e2e runs' shapes (the
   tier path's stamps and constant splice, the jsonl path's body
   gather, the GELF row engine against the numpy engine on the rfc5424
   path's flush batch), with the host-clock time of both;
5. breakdown — the host-clock wall of each stage of the RFC5424, the
   JSON-lines, the LTSV and the GELF paths over one full region each
   (``AB_BATCHES``; framing, decode, block
   encode split into its engine and its oracle rows, sink write; the
   RFC5424 path again on the block encoder's numpy engine, which must
   write the same bytes), and of the tier mix through the device encode
   tier (its block encode split into probe, timestamp text, assemble +
   fetch, splice and oracle rows) and through the host tier on either
   engine (engine and oracle rows apart); then
   (``encode_ab``) what the split tier costs the rfc5424 mix, which it
   declines: one batch's decline alone, and the rfc5424 / line
   configuration in process with the tier on and off, alternating; then
   (``fuse_ab``) the four tier mixes with ``input.tpu_fuse`` "auto" and
   "off" in one process (block-encode walls, launches; the same bytes),
   and the device ms of F1 (probe + assemble from the carried channels)
   against K1 + E1 probe + E1 assemble, of F3 against D3 + E3 probe +
   E3 assemble, of FL against L1 + EL probe + EL assemble and of FG
   against K5/0 + EG probe + EG assemble at a flush batch;
6. e2e    — ten single-format configurations through the port's entry points on
   ``cuda``: stdin → rfc5424_tpu → GELF (line framing, ``--lines``
   lines), stdin → jsonl_tpu → GELF (line framing, 32 768 lines),
   stdin → rfc5424_tpu → GELF (syslen framing, 32 768), stdin →
   rfc5424_tpu → GELF over the tier mix (line framing, 32 768),
   stdin → rfc3164_tpu → GELF (line framing, one day of BSD syslog,
   65 536), stdin → rfc3164_tpu → GELF over the rfc3164 tier mix
   (32 768), stdin → ltsv_tpu → GELF (line framing, access-log rows
   with ltsv.org's labels, 65 536), stdin → ltsv_tpu → GELF over
   the ltsv tier mix (32 768), stdin → gelf_tpu → GELF (line framing,
   GELF 1.1 payloads, 65 536) and stdin → gelf_tpu → GELF over the gelf
   tier mix (32 768); ``--lines`` defaults to 65 536.  A tier mix's
   batches need not cool, so two flushes do (``TIER_LINES``).
   Each line mix runs first as ``python -m flowgger_tpu_torch cfg.toml``
   in a subprocess, started while the scalar expectation is made beside
   it (the tier mixes skip it since the capnp paths came: their line
   mixes drive the same configurations through the CLI), then each
   configuration once in process through
   ``flowgger_tpu_torch.start`` with every kernel launch count reset
   just before and read just after (the run must launch each kernel of
   its path; the syslen run must decline no region; on the rfc5424,
   rfc3164, ltsv and gelf line mixes both tiers must decline and then
   cool; the tier-mix runs
   must have the fused route take every batch, and a second in-process
   run of each with ``tpu_fuse = "off"`` the split device tier, each
   fetching fewer bytes a tier row than it emits; every run must launch
   E1, D3, E3, F1 and F3 only at batch shapes the kernels phase checked
   (K1's shapes that it did not, a rescue sub-batch's rows follow its
   data, are checked after the runs on rows of the rfc5424 mix),
   and launch one probe a probed batch and one assemble a taken batch on
   each tier; the native row engine must have written every rfc5424
   host-tier batch that had tier rows and the native formatter every
   taken batch's timestamp text, by ``native.CALLS``).  Every
   run's GELF bytes and stderr lines must equal the port's scalar path
   over the same bytes (``corpus.scalar_expectation``; for rfc3164 the
   decoder's own "Unable to parse" lines and the error lines each in
   order, since a batch prints its oracle rows' before their errors; for
   gelf the wall-clock stamps of rows without a timestamp masked on both
   sides, ``corpus.mask_wall_stamps``),
   and its stdout the ltsv decoder's "Missing value" notices in order
   (none for the other formats; the CLI's banner line first).
   Each reports the fused route's and the split device tier's batches
   taken, declined and cooled, their rows, and their fetched and
   emitted bytes a tier row.  Then eight more (:data:`MIXED_PATHS`, in
   process with the launch counts reset just before and read just after,
   and those in :data:`MIXED_CLI` through the CLI as above): stdin → auto_tpu → GELF over the four
   line mixes interleaved with the classifier's edge rows
   (``auto_line``) and over the four tier mixes (``auto_tier``, every
   leg's split tier taking batches), 65 536 and 32 768 lines; and the
   Record path, 8 192 lines each: rfc5424 with a dynamic ``gelf_extra``,
   rfc3164 with ``level``, ltsv with a 10-key typed schema, gelf and
   jsonl with a ``gelf_extra``, auto with ``_env``.  Each must launch AC
   (auto) and each leg's decode, be byte-identical to the scalar path
   (stderr split as for rfc3164, the reference's start-up notice first
   where the block route cannot engage) and reports lines/s, each leg's
   split tier taken / declined / cooled and AC's launches; the legs'
   sub-batch shapes the kernels phase did not check are checked after
   the runs with the others (:func:`phase_late_shapes`).  Then ten more
   (:data:`OUT_PATHS`, in process with the launch counts reset just
   before and read just after; dns → GELF also through the CLI, and
   rfc5424 → LTSV's line mix until the transports came, whose
   tcp_cli_sigterm is the LTSV output's CLI run since):
   stdin → rfc5424_tpu → LTSV over cell 1's rfc5424 mix (65 536 lines,
   reporting its share of rows outside OL: over 5 %, so both tiers must
   decline and cool) and over the → LTSV tier mix (32 768, FO/ltsv taking
   every batch, and with ``tpu_fuse = "off"`` OL), dns_tpu → GELF (the
   dns mix, 32 768) and → LTSV (its tier mix, 16 384), auto_tpu with
   ``auto_extra_formats = ["dns"]`` → LTSV (the four line mixes and the
   dns mix, 16 384), and rfc3164, ltsv, gelf and jsonl → LTSV and ltsv
   with ``corpus.LTSV_SCHEMA_10`` → LTSV (the Record path);
   each byte-identical to the scalar path (LTSV's ``time`` of rows
   stamped with the wall clock masked), each new kernel's launch shapes
   checked after the runs.  Then the → RFC5424 and other syslog outputs
   (:data:`OUT_PATHS` too): rfc5424_tpu → RFC5424 over cell 1's mix
   (65 536 lines, line framing, in process (its CLI run dropped when the
   capnp paths came), its share of rows outside O5 reported: over 5 %, so
   both tiers must decline and cool), rfc5424_tpu and rfc3164_tpu →
   RFC5424 over their tier mixes (32 768 each, in process: FO/r5 taking
   every batch, and with ``tpu_fuse = "off"`` O5 or O5/3164), and in
   process only, 4 096 lines each (8 192 before the capnp paths came):
   gelf, ltsv and auto → RFC5424, jsonl → RFC5424 (the Record path,
   its start-up notice), rfc5424 and rfc3164 → passthrough, rfc3164 →
   RFC3164, rfc5424 → json on stdout (the inferred ``noop`` framing) and
   rfc5424 → passthrough with ``syslog_prepend_timestamp`` (the Record
   path, the prefix masked).  The → LTSV runs of rfc3164, ltsv, gelf and
   jsonl run 8 192 lines since the syslog outputs came.  Five of the
   Record-path configs run in process only (:data:`MIXED_CLI`).  Then the
   capnp output (:data:`OUT_PATHS` too, the inferred ``noop`` framing unless
   a path sets one): rfc5424_tpu → capnp over cell 1's mix (65 536
   lines, in process and through the CLI, its share of rows outside OC
   reported: over 5 %, so both tiers must decline and cool) and over the
   tier mix (32 768, in process: FO/capnp taking every batch, and with
   ``tpu_fuse = "off"`` OC), and in process only, 8 192 lines each:
   rfc3164, ltsv, gelf and auto → capnp, rfc5424 → capnp with a
   two-pair ``capnp_extra`` and syslen framing, jsonl → capnp (the
   Record path, its notice); the messages' stamps at or past the run's
   start (rows without a timestamp) masked by
   ``corpus.mask_capnp_stamps``.  The kernels phase holds OC (probe and
   assemble at 6 and 16 pairs) and FO/capnp against their plain
   versions on the rfc5424 tier batch, its flush batch and its
   end-of-stream batch, without and with a ``capnp_extra``
   (:func:`oc_cases`).  Every e2e run goes through the overlap executor
   at its defaults (one lane, ``input.tpu_inflight = 2``, the route
   economics on): the economics' switch notices are split off stderr
   and reported (:func:`econ_split`) with each lane's snapshot, and the
   batches it sends past a tier are counted apart.  The tier mixes'
   two taker runs are the exception: they set
   ``input.tpu_encode_economics = false``, so that the taker must take
   every batch and the other tier see none (:func:`check_tier_mix`);
   a third in-process run of each, with the fused route off and the
   economics on, is held to the bytes and reported.  The syslen and
   jsonl line mixes (and ``record_auto``) run in process only since the
   executor came (8 CLI runs left);
7. overlap_ab — the main path (rfc5424 / line, 65 536 lines) and the
   rfc5424 tier mix (32 768) in process at ``input.tpu_inflight = 0``,
   at the default window and at ``input.tpu_lanes = 2``, in turns forth
   and back, on the e2e runs' inputs, each byte-identical to the scalar
   path: lines/s, the overlap share (1 − wall ÷ (ingest-thread busy
   seconds + the lanes' pop seconds), :func:`executor_clock`), each
   lane's economics snapshot, and the CUDA streams the wrappers launched
   on (:func:`launch_streams`: one non-default stream a lane, the lanes'
   own, or the phase fails);
8. transports — the network inputs on ``cuda`` (:func:`phase_transports`),
   each in process through ``Pipeline.run`` on a thread and
   ``Pipeline.shutdown`` (the drain) unless said, launch counts reset
   just before and read just after, a ``transport`` line each with
   lines/s, wall, batches submitted, mean rows a batch, batches a flush,
   launches per kernel and byte identity: ``tcp_line`` (rfc5424_line's
   65 536-line input over one tcp connection, byte-identical to its
   expectation, which is reused; its lines/s beside rfc5424_line's from
   the same call), ``tcp_conns`` (the same lines over 8 connections at
   once, 8 192 each: the records as a multiset, each connection's in
   its order; one shared batch handler frames each connection's session
   on its own, so a flush submits a batch a session), ``udp_dgram``
   (16 384 paced datagrams of the same corpus, every 16th
   zlib-compressed, through the recvmmsg path into the batch handler's
   span ingest: every received record its datagram's expected record,
   at most 1 % lost, the lost count reported, no rate), ``scalar_tcp``
   (``input.format = "rfc5424"``, the host path, 4 096 lines: no kernel
   may launch, and its bytes and stderr are rfc5424_tpu's over tcp on
   the same lines) and ``tcp_cli_sigterm`` (``python3 -m
   flowgger_tpu_torch`` with a tcp input into the LTSV output, started
   before udp_dgram so that it boots beside udp_dgram and scalar_tcp:
   16 384 lines on one connection, closed, then SIGTERM: exit 0,
   "Received signal 15", the scalar path's LTSV bytes).  The TLS and file inputs run in the CPU tests
   only (their card path is the shared handler these drive); then
   ``late_shapes``, one corpus a mix, also at the transport runs' new
   launch shapes.  Since the transports came, the ltsv and gelf line
   mixes and rfc5424 → LTSV run in process only (5 CLI runs left in the
   e2e phases: rfc5424_line, rfc3164_line, auto_line, dns_line,
   rfc5424_capnp_line; tcp_cli_sigterm drives the LTSV output's CLI);
9. sinks — :func:`phase_sinks`, in process: ``redis_kafka`` (16 384
   lines of cell 1's corpus in a fake Redis list, :class:`RespFake`,
   through the redis input, ``rfc5424_tpu`` on the card and the Kafka
   sink — capnp, snappy, ``kafka_coalesce = 1000``, ``kafka_acks = 1``
   — into a fake broker, :class:`KafkaFake`, which checks each record
   batch's CRC32C and decompresses it in Python: the records in order
   are the scalar path's capnp records; lines/s, Produce requests,
   batches, records a batch, RESP commands a line, launches) and
   ``file_rotate`` (rfc5424_line's input into GELF in a file rotating at
   4 MiB behind a 64 KiB buffer: the files, oldest to newest, are
   rfc5424_line's expectation; file count, lines/s).  The TLS sink runs
   in the CPU tests only;
10. serving — :func:`phase_serving`, in process at cell 1's widths
   (``tpu_batch_size`` 16 384 unless said, lines of up to 512 bytes,
   cell 1's mix): ``tenants_tcp`` (three tcp connections at once from
   127.0.0.2 — a tenant limited to 5 000 lines/s, ``drop_oldest`` —,
   127.0.0.3 — weight 8, ``block`` — and 127.0.0.1, the catch-all,
   65 536 lines each, into GELF through the fair queue: each tenant's
   records an in-order subsequence of its expectation, the unlimited
   tenants' all there, the limited one's shed in whole regions; K1, K2
   and K3 launched), ``templates_enrich`` (rfc5424_line's input with
   ``tenant.template_enrich``: the scalar path with the same miner, byte
   for byte) and ``templates_mine`` (mining only: rfc5424_line's
   expectation, byte for byte, with no fused route or device tier
   launched), ``breaker_trip`` (40 960 rows over 512 bytes, then 16 384
   of cell 1's mix, at ``tpu_batch_size`` 4 096, ``tpu_breaker_window =
   4``, ``tpu_breaker_cooldown_ms = 100``: byte-identical, one trip, the
   probes re-opening it until the clean tail closes it, K1 launched in a
   probe) and ``queue_drop`` (rfc5424_line's input at ``tpu_batch_size``
   4 096 with ``drop_newest`` and ``queue_pressure = "every:4"``: the
   output is the expectation less exactly the shed items); then how
   many earlier in-process runs were held to a closed breaker with no
   trip (every run of the e2e, overlap, transports and sinks phases).

Every e2e path's input and scalar expectation (the host's record-by-
record reference path) is made before the build by a pool of worker
processes (spawn; one intra-op thread each; the cores less two), and
each e2e phase waits only for its own (``expectation_wait`` in
``phase_seconds``, with the pool's size), checking the input file's
SHA-256 against the one the expectation was made from.

Kernel times: ``ms`` is the device time of one launch (calls issued back
to back behind a spin kernel that holds the stream, :func:`device_ms`);
``plain_ms`` is one call of the plain version between two events on an
idle stream (:func:`cuda_ms`; K2 and K3 the median of 10 after 2
warm-ups, the others one call after one, :data:`PLAIN_TIMING`), so it
also holds the host's time to issue it, tens of microseconds against
its milliseconds.  To time only the
kernels of a tree, call the first three phases from its root:
``python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build();
c.phase_kernels(20261016)"``.

It then prints the kernel table, the card's ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.

``--host-ab ROUNDS`` runs the device and build phases and then only
:func:`phase_host_ab`: the rfc5424, jsonl and tier-mix breakdowns in
fresh processes with the native host tier as shipped, on one thread a
call, and not loaded at all, rotating for ``ROUNDS`` rounds, to see
whether the library slows the Python it does not replace (the oracle
rows).  It ends with the ``nvidia-smi`` line.  Any failed phase raises
and the script exits non-zero; without a CUDA device it exits non-zero
before printing any result.  Scratch files go to ``build/chip_smoke``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
# INT32 lanes outside the tensor cores: 132 SMs x 64 lanes x 1.98 GHz
# boost (H100 SXM, Hopper architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BATCH = 16384
MAX_LEN = 512
SYSLEN_LINES = 2 * BATCH    # lines of the syslen-framed e2e run (cut from
                            # 4 × when the LTSV-output and dns paths came:
                            # its flushes past the third decline still
                            # fall in a cooldown, so no new E1 / F1 shape)
RFC3164_LINES = 4 * BATCH   # lines of each rfc3164 e2e run (cut from 8 ×
                            # for time when the ltsv paths came)
LTSV_LINES = 4 * BATCH      # lines of each ltsv e2e run (cut from 8 ×
                            # when the auto and Record-path runs came)
JSONL_LINES = 2 * BATCH     # lines of the jsonl e2e run (cut from 16 × for
                            # time when the rfc3164 paths came, from 8 ×
                            # when the gelf paths came, from 4 × when the
                            # LTSV-output and dns paths came)
GELF_LINES = 4 * BATCH      # lines of each gelf e2e run
RFC5424_LINES = 4 * BATCH   # --lines default: the rfc5424 line paths (cut
                            # from 8 × when the gelf paths came)
AB_BATCHES = 1              # batches of the breakdowns, encode_ab and
                            # fuse_ab (cut from 8 when the gelf paths came,
                            # from 4 when the auto and Record-path runs
                            # came, from 2 when the LTSV-output and dns
                            # paths came)
AUTO_LINES = 4 * BATCH      # lines of the auto_tpu line-mix e2e run
TIER_LINES = 2 * BATCH      # lines of each tier-mix e2e run: its batches
                            # need not cool, so two flushes do (the tier
                            # mixes into GELF and LTSV and auto's cut
                            # from 4 × when the syslog-output paths came)
OUT_LINES = BATCH // 2      # lines of each in-process-only output path
                            # (the → LTSV ones cut from BATCH when the
                            # syslog-output paths came)
SYSLOG_OUT_LINES = BATCH // 4  # lines of each syslog_out_* path (cut from
                               # BATCH // 2 when the capnp paths came)
RECORD_LINES = BATCH // 2   # lines of each Record-path e2e run (cut from
                            # BATCH when the syslog-output paths came)
DNS_LINES = 2 * BATCH       # lines of the dns → GELF e2e run (cut from
                            # 4 × when the syslog-output paths came)
BIG_REGION = 16 << 20       # bytes of K2's many-wave region
# how each plain version's time is taken, K2's and K3's apart (10 calls
# after 2): one call after one warm-up (cut from 5 after 1 when the
# transports came, their calls passing 550 s on a slow host)
PLAIN_TIMING = {"iters": 1, "warmup": 1}
WORK = ROOT / "build" / "chip_smoke"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of ``iters`` single-call times between CUDA events.  The
    first event is recorded on an idle stream, so each time also holds
    the host's work to issue the call (the wrapper's Python and ctypes
    time, tens of microseconds): what one synchronous call costs, not the
    kernel's own time (see :func:`device_ms`)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` (no host synchronization
    inside): a spin kernel holds the stream while the host issues
    ``iters`` calls, so they run back to back and the time between the
    two events is theirs alone.  If the hold ended before the last call
    was issued, the host may have left gaps: the hold is lengthened and
    the run repeated, and if no hold up to 2**32 cycles covers the
    issue, there is no device time to give and it raises."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hold = 1 << 22   # cycles (~2 ms at 1.98 GHz)
    while True:
        torch.cuda._sleep(hold)
        held = torch.cuda.Event()
        held.record()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        covered = not held.query()
        b.synchronize()
        if covered:
            return a.elapsed_time(b) / iters
        if hold >= 1 << 32:
            raise AssertionError(f"device_ms: a hold of {hold} cycles ended "
                                 f"before {iters} calls were issued")
        hold <<= 2


def bound(nbytes: int, nops: int) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over HBM bandwidth and its integer operations
    over the INT32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes_ms": b_ms, "ops_ms": o_ms, "bound_bytes": nbytes,
            "bound_ops": nops}


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype == torch.bool:
        a, b = a.to(torch.int64), b.to(torch.int64)
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def channels_err(what: str, got: dict, ref: dict) -> float:
    """Max abs error over every channel of every row; raises on any
    difference or dtype mismatch."""
    err = 0.0
    for k, v in ref.items():
        g = got[k]
        if g.dtype != v.dtype or g.shape != v.shape:
            raise AssertionError(f"{what}: {k} is {g.dtype} {tuple(g.shape)}"
                                 f", plain {v.dtype} {tuple(v.shape)}")
        err = max(err, max_abs_err(g, v))
    if err:
        raise AssertionError(f"{what}: channels differ from the plain "
                             f"version (max_abs_err {err} over all rows)")
    return err


def upload(data: bytes):
    """A raw region padded to its bucket, on the card."""
    import torch

    from flowgger_tpu_torch.tpu import framing

    buf = torch.zeros(framing.region_bucket(len(data)), dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return buf.to("cuda")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    emit({"phase": "device", "nvidia_smi": line,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sm_clock_mhz": spin_clock_mhz(), "host_cpu": host_cpu(),
          "host_cpu_count": os.cpu_count()})
    return line


def host_cpu() -> str:
    """The host's CPU model and architecture (``lscpu``, else
    ``/proc/cpuinfo``): the host tier's stages run there."""
    import platform

    model = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not model:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((ln.split(":", 1)[1].strip() for ln in f
                              if ln.startswith("model name")), "")
        except OSError:
            pass
    return f"{model or 'unknown model'} ({platform.machine()})"


def spin_clock_mhz(cycles: int = 1 << 26) -> float:
    """The SM clock under load: a spin kernel of ``cycles`` clock ticks
    timed between CUDA events, after one spin that lets the clock ramp up
    from idle."""
    import torch

    torch.cuda._sleep(cycles)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / (a.elapsed_time(b) * 1e3)


def kernel_name(mangled: str) -> str:
    """The last component of an Itanium-mangled nested name (the
    kernel's own name) with its integer and bool template arguments
    written out: ``_ZN<len><ns><len><name>I<args>E...`` → ``name<a,
    b>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    targs = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[i:])
    if targs:
        args = [v if t == "i" else ("false", "true")[int(v)] for t, v in
                re.findall(r"L([ib])(-?\d+)E", targs.group(1))]
        name += "<" + ", ".join(args) + ">"
    return name


def ptxas_resources(log: str) -> list:
    """Per entry function of one ``nvcc -Xptxas -v`` log: its kernel name
    (template arguments written out), registers, shared memory, stack
    frame and spill bytes."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"function": kernel_name(m.group(1))})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[-1].update(stack_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


# ptxas resources of each entry function (phase_build): registers,
# stack and spill bytes for the kernel rows
BUILD_RES: dict = {}


def phase_build():
    from flowgger_tpu_torch import native
    from flowgger_tpu_torch.tpu import kernels

    # the native host tier (g++, a few seconds) first, then the kernels
    host = native.build()
    emit({"phase": "host_build", "compiler": host["compiler"],
          "version": host["version"], "flags": host["flags"],
          "seconds": host["seconds"], "cached": host["cached"],
          "library": os.path.relpath(host["path"], ROOT)})
    t0 = time.perf_counter()
    res = kernels.build()
    wall = time.perf_counter() - t0
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "build_log.txt").write_text("\n".join(
        f"== {k} ({v['seconds']:.2f}s, cached={v['cached']})\n{v['log']}"
        for k, v in res.items()))
    emit({"phase": "build", "wall_s": wall,
          "seconds": {k: v["seconds"] for k, v in res.items()}})
    seen = set()
    for source, v in res.items():
        found = ptxas_resources(v["log"])
        if not found:
            raise AssertionError(f"no ptxas resource lines in the build log "
                                 f"of {source}")
        for r in found:
            seen.add(r["function"])
            BUILD_RES[r["function"]] = r
            emit({"phase": "kernel_build", "source": source, **r})
    # E1's and EL's four instantiations (probe and assemble at 6 and 16
    # pairs), EG's four (at 8 and 16 fields), E3's, F1's, F3's, FL's,
    # FG's, OL's and FO/ltsv's two each, AC's two (with and without the
    # dns flag), D3, L1 and DN, K5 nested and flat at 8 and 24 fields and
    # flat at 16
    phases = ("false", "true")
    missing = ({f"{k}<{p}, {a}>" for k in ("encode_gelf_kernel",
                                            "encode_gelf_ltsv_kernel")
                for p in (6, 16) for a in phases}
               | {f"encode_gelf_gelf_kernel<{f}, {a}>" for f in (8, 16)
                  for a in phases}
               | {f"{k}<{a}>" for k in ("encode_gelf3164_kernel",
                                         "fused_rfc5424_gelf_kernel",
                                         "fused_rfc3164_gelf_kernel",
                                         "fused_ltsv_gelf_kernel",
                                         "fused_gelf_gelf_kernel")
                  for a in phases}
               | {f"structural_index_kernel<{f}, {a}>" for f in (8, 24)
                  for a in phases}
               | {"structural_index_kernel<16, true>"}
               | {f"{k}<{a}>" for k in ("classify_auto_kernel",
                                         "encode_ltsv_out_kernel",
                                         "fused_ltsv_out_kernel")
                  for a in phases}
               | {"decode_rfc3164_kernel", "decode_ltsv_kernel",
                  "decode_dns_kernel"}) - seen
    if missing:
        raise AssertionError(f"no kernel_build line for {sorted(missing)}")


def gather_case(region, starts, lens, max_len: int = MAX_LEN):
    """K3 against its plain version on every byte of every row, once
    before and once after its timing loop: ``(row, (batch, lens_c))``."""
    from flowgger_tpu_torch.tpu import framing, kernels

    def k3():
        return kernels.frame_gather_cuda(region, starts, lens, max_len)

    def p3():
        return framing.frame_gather(region, starts, lens, max_len)

    def check():
        (gb, gl), (pb, pl) = k3(), p3()
        err = max(max_abs_err(gb, pb), max_abs_err(gl, pl))
        if err:
            raise AssertionError(f"frame_gather disagrees: max_abs_err {err}")
        return err, gb, gl

    err, gb, gl = check()
    ms = device_ms(k3)
    check()   # a launch after the timing loop: no state leaks between launches
    n = starts.shape[0]
    return {
        "name": "frame_gather", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/frame_gather.cu",
        "replaces": "flowgger_tpu/tpu/pallas_kernels.py:399",
        "max_abs_err": err, "ms": ms, "plain_ms": cuda_ms(p3),
        # one select per output byte
        **bound(int(gl.sum()) + 8 * n + n * max_len + 4 * n, n * max_len),
        "library_ms": None, "shape": f"[{n}, {max_len}]"}, (gb, gl)


def sep_case(region, rlen: int, sep: int, strip_cr: bool, ncap: int,
             records: int):
    """K2 against its plain version on every slot and meta word, once
    before and once after its timing loop; ``records`` is the count it
    must find: ``(row, spans)``."""
    from flowgger_tpu_torch.tpu import framing, kernels

    def k2():
        return kernels.frame_sep_spans_cuda(region, rlen, sep, strip_cr, ncap)

    def p2():
        return framing.frame_sep_spans(region, rlen, sep, strip_cr, ncap)

    def check():
        got, ref = k2(), p2()
        meta = got["meta"].cpu().tolist()
        errs = [max_abs_err(got["starts"], ref["starts"]),
                max_abs_err(got["lens"], ref["lens"]),
                abs(meta[0] - int(ref["n"])),
                abs(meta[1] - int(ref["consumed"])),
                abs(meta[2] - int(ref["overflow"])), abs(meta[3])]
        if any(errs) or meta[0] != records:
            raise AssertionError(f"frame_sep_spans disagrees with its plain "
                                 f"version: {errs}, n={meta[0]}")
        return max(errs), got

    err, got = check()
    ms = device_ms(k2)
    check()   # a launch after the timing loop: the scratch came back clean
    return {
        "name": "frame_sep_spans", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/frame_sep_spans.cu",
        "replaces": "flowgger_tpu/tpu/pallas_kernels.py:237",
        "max_abs_err": err, "ms": ms, "plain_ms": cuda_ms(p2),
        # one compare per region byte
        **bound(rlen + 8 * ncap + 16, rlen), "library_ms": None,
        "shape": f"region {rlen} B, ncap {ncap}, sep {sep}"}, got


def decode_case(kind: str, width: int, batch, lens_c):
    """K1 at ``width`` pairs (``kind`` rfc5424) or K5 at ``width``
    fields (``kind`` jsonl: its nested mode; ``gelf``: its flat mode,
    nested = 0) against its plain version on every channel of every row,
    rejected and padding rows included: ``(row, plain channels)``."""
    from flowgger_tpu_torch.tpu import jsonidx, jsonl, kernels, rfc5424

    if kind == "rfc5424":
        kern = functools.partial(kernels.decode_rfc5424_cuda, batch, lens_c,
                                 4, width)
        plain = functools.partial(rfc5424.decode_rfc5424, batch, lens_c, 4,
                                  width)
        unpack = functools.partial(rfc5424.unpack_channels, max_sd=4,
                                   max_pairs=width)
        name, C, passes = (f"decode_rfc5424_p{width}",
                           rfc5424.n_channels(4, width), 6)
        source, replaces = ("flowgger_tpu_torch/csrc/decode_rfc5424.cu",
                            "flowgger_tpu/tpu/rfc5424.py:1095")
    else:
        nested = jsonl.NESTED_DEPTH if kind == "jsonl" else 0
        kern = functools.partial(kernels.structural_index_cuda, batch, lens_c,
                                 width, nested)
        plain = functools.partial(jsonidx.structural_index, batch, lens_c,
                                  width, nested=nested)
        unpack = functools.partial(jsonidx.unpack_channels, max_fields=width)
        name, C, passes = (f"structural_index{'' if nested else '_flat'}"
                           f"_f{width}", jsonidx.n_channels(width), 1)
        source, replaces = ("flowgger_tpu_torch/csrc/structural_index.cu",
                            "flowgger_tpu/tpu/pallas_kernels.py:439")
    ref = plain()
    err = channels_err(name, unpack(kern()), ref)
    if kind != "jsonl":
        CHECKED.add((name, tuple(batch.shape)))
    n, valid = batch.shape[0], int(lens_c.sum())
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "max_abs_err": err, "ms": device_ms(kern),
        "plain_ms": cuda_ms(plain, **PLAIN_TIMING),
        # bytes: each row's valid bytes (the definitions mask everything
        # past its length), the lengths and the int32 channels written;
        # operations: one per valid byte for each pass the definitions
        # need over a row (K1 six, K5 one)
        **bound(valid + 4 * n + 4 * C * n, passes * valid),
        "library_ms": None,
        "shape": f"[{n}, {batch.shape[1]}], {valid} valid bytes, "
                 f"{int(ref['ok'].sum())} ok rows"}, ref


def rescue_batch(batch, lens_c, idx):
    """The sub-batch ``rescue_refetch`` dispatches for rows ``idx``."""
    import torch

    rows = 256
    while rows < idx.numel():
        rows <<= 1
    sub_b = torch.zeros((rows, batch.shape[1]), dtype=torch.uint8,
                        device=batch.device)
    sub_l = torch.zeros(rows, dtype=lens_c.dtype, device=batch.device)
    sub_b[:idx.numel()] = batch.index_select(0, idx)
    sub_l[:idx.numel()] = lens_c.index_select(0, idx)
    return sub_b, sub_l


def syslen_case(data: bytes, ncap: int, frames: int = 0):
    """K4 against its plain version over one region (``frames``, when
    given, is the frame count it must find): ``(row, region, spans,
    n)``."""
    import torch

    from flowgger_tpu_torch.tpu import framing, kernels

    rlen = len(data)
    region = upload(data)

    def k4():
        return kernels.frame_syslen_spans_cuda(region, rlen, ncap)

    def p4():
        return framing.frame_syslen_spans(region, rlen, ncap)

    got, ref = k4(), p4()
    meta = got["meta"].cpu().tolist()
    errs = [max_abs_err(got["starts"], ref["starts"]),
            max_abs_err(got["lens"], ref["lens"]),
            abs(meta[0] - int(ref["n"])), abs(meta[1] - int(ref["consumed"])),
            abs(meta[2] - int(ref["err"])), abs(meta[3] - int(ref["decline"]))]
    if (any(errs) or meta[2] or meta[3] or not meta[0]
            or (frames and meta[0] != frames)):
        raise AssertionError(f"frame_syslen_spans disagrees with its plain "
                             f"version: {errs}, meta={meta}")
    rest = torch.cat([got["starts"][meta[0]:], got["lens"][meta[0]:]])
    if rest.any():
        raise AssertionError("frame_syslen_spans left slots past n unset")
    return {
        "name": "frame_syslen_spans", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/frame_syslen_spans.cu",
        "replaces": "flowgger_tpu/tpu/pallas_kernels.py:343",
        "max_abs_err": max(errs), "ms": device_ms(k4),
        "plain_ms": cuda_ms(p4, **PLAIN_TIMING),
        # one classify per region byte
        **bound(rlen + 8 * ncap + 16, rlen), "library_ms": None,
        "shape": f"region {rlen} B, ncap {ncap}, {meta[0]} frames"}, \
        region, got, meta[0]


def syslen_flush_region(data: bytes):
    """The region of the syslen path's first flush over ``data`` and its
    space count: the splitter's reads, taken until their spaces reach
    the batch size (``_RawSession.push``'s trigger).  The spaces size
    the spans (``ncap``)."""
    from flowgger_tpu_torch.splitters import _CHUNK

    end = spaces = 0
    while spaces < BATCH and end < len(data):
        spaces += data.count(b" ", end, end + _CHUNK)
        end = min(end + _CHUNK, len(data))
    return data[:end], spaces


def line_flush(lines: list):
    """The region of the line path's first flush over ``lines`` joined
    by newlines, and its record count: the splitter's reads, taken until
    their separators reach the batch size (``_RawSession.push``'s
    trigger), cut at the last separator.  A flush holds up to one read
    more than the batch size, so its batch has ``bucket_rows`` of that
    count rows: [32768, 512] at the defaults, about half of them
    padding."""
    from flowgger_tpu_torch.splitters import _CHUNK

    data = b"\n".join(lines)
    end = n = 0
    while n < BATCH and end < len(data):
        n += data.count(b"\n", end, end + _CHUNK)
        end = min(end + _CHUNK, len(data))
    return data[:data.rfind(b"\n", 0, end) + 1], n


def flush_batch(lines: list, where: str, shapes: list):
    """K2 and K3 on the line path's first flush over ``lines``, as
    ``device_frame_region`` launches them (spans at ``bucket_rows(n)``
    slots, the batch from its first ``bucket_rows(n)`` spans): the
    gathered ``(batch, lens_c, n)``, ``n`` its real rows."""
    from flowgger_tpu_torch.tpu import pack

    region_b, n = line_flush(lines)
    region = upload(region_b)
    rows = pack.bucket_rows(n)
    row, got = sep_case(region, len(region_b), 10, True, rows, n)
    shapes.append({**row, "where": f"{where}, flush region"})
    row, (batch, lens_c) = gather_case(region, got["starts"][:rows],
                                       got["lens"][:rows])
    shapes.append({**row, "where": f"{where}, flush batch"})
    return batch, lens_c, n


def kernels_line_path(seed: int, rows: list, shapes: list):
    """K2 spans, K3 gather, K1 decode at 6 and 16 pairs and at the
    rescue's sub-batch, and the chained RFC5424 entry, on one 16 384-line
    region; K3 also at a row width that is not a multiple of 16, K2 also
    over the records NUL-framed and over a region of >= 16 MiB; K2, K3,
    K1 p6 and E1's phase-1 probes at the e2e run's flush shapes."""
    import torch

    from flowgger_tpu_torch.corpus import make_corpus
    from flowgger_tpu_torch.tpu import kernels, pack, rfc5424

    lines, _ = make_corpus(BATCH, seed)
    region_b = b"\n".join(lines) + b"\n"
    rlen = len(region_b)
    region = upload(region_b)
    ncap = pack.bucket_rows(BATCH)

    # K2: spans over one flush region
    row, got = sep_case(region, rlen, 10, True, ncap, BATCH)
    rows.append(row)

    # K3: gather to [16384, 512], and at a row width that is not a
    # multiple of 16 bytes (input.tpu_max_line_len is any integer)
    starts, lens = got["starts"], got["lens"]
    row, (batch, lens_c) = gather_case(region, starts, lens)
    rows.append(row)
    row, _ = gather_case(region, starts, lens, MAX_LEN - 12)
    shapes.append({**row, "where": "rfc5424 line path, row width not a "
                                   "multiple of 16"})

    # K2 over the same records NUL-framed, and over a region of more
    # tiles than the card holds at once (the tickets order the look-back
    # beyond one wave)
    nul = upload(b"\0".join(lines) + b"\0")
    row, _ = sep_case(nul, rlen, 0, False, ncap, BATCH)
    shapes.append({**row, "where": "NUL-framed region"})
    reps = -(-BIG_REGION // rlen)
    big = upload(region_b * reps)
    row, _ = sep_case(big, reps * rlen, 10, True,
                      pack.bucket_rows(reps * BATCH), reps * BATCH)
    shapes.append({**row, "where": f"{reps} line regions back to back "
                                   f"(>= {BIG_REGION >> 20} MiB)"})
    del nul, big

    # K1 at 6 pairs (main batch) and 16 pairs (rescue width), then at
    # the sub-batch the rescue really dispatches
    lo, hi = rfc5424.DEFAULT_MAX_PAIRS, rfc5424.RESCUE_MAX_PAIRS
    refs = {}
    for mp in (lo, hi):
        row, refs[mp] = decode_case("rfc5424", mp, batch, lens_c)
        rows.append(row)
    pc = refs[lo]["pair_count"]
    row, _ = decode_case("rfc5424", hi, *rescue_batch(
        batch, lens_c, torch.nonzero((pc > lo) & (pc <= hi)).flatten()))
    shapes.append({**row, "where": "rfc5424 line path, rescue sub-batch"})

    # the batch of a flush as the e2e run gathers it: K1, and E1's
    # phase-1 probes as this path's declining batches launch them
    fb, fl, fn = flush_batch(make_corpus(2 * BATCH, seed + 7)[0],
                             "rfc5424 line path", shapes)
    for mp in (lo, hi):
        row, _ = decode_case("rfc5424", mp, fb, fl)
        shapes.append({**row, "where": "rfc5424 line path, flush batch"})
    phase1_probes(fb, fl, kernels.decode_rfc5424_cuda(fb, fl, 4, lo), fn,
                  "rfc5424 line path, flush batch", shapes)
    # the fused route's probe, as this path's declining batches launch it
    for row in route_case("f1", fb, fl, fn, assemble=False):
        shapes.append({**row, "where": "rfc5424 line path, flush batch"})

    # the chained entry (spans -> gather -> decode on one stream) gives
    # the same spans and 6-pair channels as the kernels called one by one
    spans_f, ch_f = kernels.fused_frame_decode_rfc5424(
        region, rlen, sep=10, strip_cr=True, ncap=ncap, max_len=MAX_LEN)
    if not (torch.equal(spans_f["starts"], starts)
            and torch.equal(spans_f["lens"], lens)
            and all(torch.equal(ch_f[k], v) for k, v in refs[lo].items())):
        raise AssertionError("fused_frame_decode_rfc5424 disagrees with the "
                             "kernels called one by one")


def kernels_syslen(seed: int, rows: list, shapes: list):
    """K4 over the syslen path's flush region (the shape its e2e run
    launches it at) and over a whole 16 384-frame region; K3, K1 and
    E1's phase-1 probes at the flush's batch and rescue shapes."""
    import torch

    from flowgger_tpu_torch.corpus import make_corpus, syslen_stream
    from flowgger_tpu_torch.tpu import kernels, pack, rfc5424

    lines, _ = make_corpus(BATCH, seed + 2)
    data = syslen_stream(lines, cut=0)
    flush, spaces = syslen_flush_region(data)
    row, region, spans, n = syslen_case(flush, pack.bucket_rows(spaces))
    rows.append(row)
    row = syslen_case(data, pack.bucket_rows(data.count(b" ")),
                      frames=BATCH)[0]
    shapes.append({**row, "where": "whole 16 384-frame syslen region"})

    # the flush's batch: bucket_rows(n) rows, as device_frame_region
    # gathers it
    r = pack.bucket_rows(n)
    row, (batch, lens_c) = gather_case(region, spans["starts"][:r],
                                       spans["lens"][:r])
    shapes.append({**row, "where": "syslen path, flush batch"})
    lo, hi = rfc5424.DEFAULT_MAX_PAIRS, rfc5424.RESCUE_MAX_PAIRS
    row, ref = decode_case("rfc5424", lo, batch, lens_c)
    shapes.append({**row, "where": "syslen path, flush batch"})
    pc = ref["pair_count"]
    row, _ = decode_case("rfc5424", hi, *rescue_batch(
        batch, lens_c, torch.nonzero((pc > lo) & (pc <= hi)).flatten()))
    shapes.append({**row, "where": "syslen path, rescue sub-batch"})
    phase1_probes(batch, lens_c, kernels.decode_rfc5424_cuda(batch, lens_c,
                                                             4, lo), n,
                  "syslen path, flush batch", shapes)
    for row in route_case("f1", batch, lens_c, n, assemble=False):
        shapes.append({**row, "where": "syslen path, flush batch"})


def kernels_jsonl(seed: int, rows: list, shapes: list):
    """K5 at 8 and 24 fields on a gathered [16384, 512] JSON-lines batch,
    at 24 fields on the rescue's sub-batch, at 8 fields on the batch's
    first 2 048 rows (a small flush) and on a flush batch as the e2e run
    gathers it (after K2 and K3 at its shapes), and the chained
    JSON-lines entry."""
    import torch

    from flowgger_tpu_torch.corpus import make_jsonl_corpus
    from flowgger_tpu_torch.tpu import framing, jsonl, kernels, pack

    lines, _ = make_jsonl_corpus(BATCH, seed + 3)
    region_b = b"\n".join(lines) + b"\n"
    rlen = len(region_b)
    region = upload(region_b)
    ncap = pack.bucket_rows(BATCH)
    spans = framing.sep_spans(region, rlen, 10, True, ncap)
    batch, lens_c = framing.gather(region, spans["starts"], spans["lens"],
                                   MAX_LEN)
    lo, hi = jsonl.DEFAULT_MAX_FIELDS, jsonl.RESCUE_MAX_FIELDS
    refs = {}
    for F in (lo, hi):
        row, refs[F] = decode_case("jsonl", F, batch, lens_c)
        rows.append(row)
    nf = refs[lo]["n_fields"]
    row, _ = decode_case("jsonl", hi, *rescue_batch(batch, lens_c, torch.nonzero(
        ~refs[lo]["ok"] & (nf > lo) & (nf <= hi)).flatten()))
    shapes.append({**row, "where": "jsonl path, rescue sub-batch"})
    small = 2048
    row, _ = decode_case("jsonl", lo, batch[:small], lens_c[:small])
    shapes.append({**row, "where": "jsonl path, 2 048-row batch"})
    fb, fl, _ = flush_batch(make_jsonl_corpus(2 * BATCH, seed + 8)[0],
                            "jsonl path", shapes)
    row, _ = decode_case("jsonl", lo, fb, fl)
    shapes.append({**row, "where": "jsonl path, flush batch"})

    spans_f, ch_f = kernels.fused_frame_decode_jsonl(
        region, rlen, sep=10, strip_cr=True, ncap=ncap, max_len=MAX_LEN)
    if not (torch.equal(spans_f["starts"], spans["starts"])
            and torch.equal(spans_f["lens"], spans["lens"])
            and all(torch.equal(ch_f[k], v) for k, v in refs[lo].items())):
        raise AssertionError("fused_frame_decode_jsonl disagrees with the "
                             "kernels called one by one")


# the (kernel name, batch shape) pairs at which K1, E1, D3, E3, F1 and F3
# were held against their plain versions; the e2e phase fails if its runs
# launch one of them at another (K1 and the ltsv kernels: checks them
# there, phase_late_shapes)
CHECKED: set = set()


def encode_case(P: int, batch, lens_c, packed, n: int, ts_len=None,
                ts_text=None):
    """E1 (the device GELF encode) at ``P`` pairs against its plain
    version on one batch of ``n`` real rows: the probe's base tier bit
    and base length of every row (zeros at and past ``n``), and with
    ``ts_len`` and ``ts_text`` the assemble's bytes of every tier row
    (``base & (base_len + ts_len <= OW)``, ``fetch_encode_driver``'s
    rule) at its offset, each checked once before and once after its
    timing loop: ``[probe row]`` or ``[probe row, assemble row]``."""
    import torch

    from flowgger_tpu_torch.tpu import device_gelf, kernels, rfc5424

    suffix, max_sd = b"\0", 4
    N, L = batch.shape
    dec = rfc5424.unpack_channels(packed, max_sd, P)
    bank_b, table = device_gelf.kernel_consts(suffix)
    bank = device_gelf._bank_on(bank_b, batch.device)
    OW = device_gelf.out_width(L, suffix)
    kw = {"suffix": suffix, "max_sd": max_sd}

    def k_probe():
        return kernels.encode_gelf_cuda(batch, lens_c, packed, n, bank, table,
                                        max_sd, P)

    def p_probe():
        return device_gelf.encode_rows(batch, lens_c, dec, assemble=False,
                                       n=n, **kw)

    ref_base, ref_len = p_probe()

    def check_probe():
        base, base_len = k_probe()
        err = max(max_abs_err(base, ref_base), max_abs_err(base_len, ref_len))
        if err:
            raise AssertionError(f"encode_gelf probe p{P} [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_p = check_probe()
    ms_p = device_ms(k_probe)
    check_probe()   # a launch after the timing loop
    CHECKED.add((f"encode_gelf_probe_p{P}", (N, L)))

    # bytes the function needs a real row: its length, the 14 one-per-row
    # channels it reads, the last SD element's id span (rows with 1..max_sd
    # elements), and 5 channels for each pair up to min(pair_count, P)
    # (pairs past a row's count are gated off); int32 each
    real = torch.arange(N, device=batch.device) < n
    pc = dec["pair_count"].to(torch.int64).clamp(0, P)
    sdc = dec["sd_count"].to(torch.int64)
    ch_row = 4 * (14 + 5 * pc + 2 * ((sdc >= 1) & (sdc <= max_sd)))
    n_base = int(ref_base.sum())
    valid = int(torch.where(real, lens_c, 0).sum())
    common = {"route": "cuda", "source": "flowgger_tpu_torch/csrc/encode_gelf.cu",
              "replaces": "flowgger_tpu/tpu/device_gelf.py:141",
              "library_ms": None}
    shape = f"[{N}, {L}], n={n}, {n_base} base tier rows, {valid} valid bytes"
    out = [{
        "name": f"encode_gelf_probe_p{P}", **common, "max_abs_err": err_p,
        "ms": ms_p, "plain_ms": cuda_ms(p_probe, **PLAIN_TIMING),
        # bytes: each real row's valid bytes, length and the channels it
        # needs, every row's bit and length; operations: one escape test
        # per valid byte
        **bound(valid + int(ch_row[real].sum()) + 4 * n + 5 * N, valid),
        "shape": shape}]
    if ts_text is None:
        return out

    length = ref_len.to(torch.int64) + ts_len
    tier = ref_base & (length <= OW)
    gated = torch.where(tier, length, 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    total = int(gated.sum())

    def k_asm():
        return kernels.encode_gelf_cuda(batch, lens_c, packed, n, bank, table,
                                        max_sd, P, OW, ts_text=ts_text,
                                        ts_len=ts_len, row_off=row_off,
                                        total=total)

    def p_asm():
        rows, out_len, _ = device_gelf.encode_rows(batch, lens_c, dec,
                                                   ts_text, ts_len, **kw)
        return device_gelf.flat_rows(rows, out_len, row_off, total)

    ref_flat = p_asm()

    def check_asm():
        err = max_abs_err(k_asm(), ref_flat)
        if err:
            raise AssertionError(f"encode_gelf assemble p{P} [{N}, {L}] "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_a = check_asm()
    ms_a = device_ms(k_asm)
    check_asm()   # a launch after the timing loop
    CHECKED.add((f"encode_gelf_assemble_p{P}", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    ts_bytes = int(torch.where(tier, ts_len, 0).sum())
    out.append({
        "name": f"encode_gelf_assemble_p{P}", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, **PLAIN_TIMING),
        # bytes: the tier rows' valid bytes, lengths, channels, timestamp
        # text and lengths, every row's offset, and the output written;
        # operations: one escape test per valid byte of a tier row
        **bound(tier_valid + int(ch_row[tier].sum()) + 8 * n_tier
                + ts_bytes + 8 * N + total, tier_valid),
        "shape": f"[{N}, {L}], n={n}, {n_tier} tier rows, {total} output "
                 f"bytes"})
    return out


def phase1_probes(batch, lens_c, packed6, n: int, where: str, shapes: list):
    """E1's phase-1 probes as a declining batch meets them: at 6 pairs
    from the main decode and at 16 from the wide decode."""
    from flowgger_tpu_torch.tpu import kernels, rfc5424

    hi = rfc5424.RESCUE_MAX_PAIRS
    for P, packed in ((rfc5424.DEFAULT_MAX_PAIRS, packed6),
                      (hi, kernels.decode_rfc5424_cuda(batch, lens_c, 4, hi))):
        row, = encode_case(P, batch, lens_c, packed, n)
        shapes.append({**row, "where": f"{where}, phase-1 probe"})


def ts_text_of(packed):
    """``(ts_len, ts_text)`` on the card for every ok row of a packed
    decode, as the tier formats them."""
    import torch

    from flowgger_tpu_torch.tpu import device_common

    small = {"ok": (packed[0] != 0).cpu().numpy()}
    small.update(zip(("days", "sod", "off", "nanos"),
                     packed[4:8].cpu().numpy()))
    txt, tl = device_common.ts_text_block(small)
    return torch.from_numpy(tl).to("cuda"), torch.from_numpy(txt).to("cuda")


def kernels_encode(seed: int, rows: list, shapes: list):
    """E1's probe and assemble at 6 and 16 pairs on a gathered
    [16384, 512] batch of the tier mix, from the decode kernel's packed
    channels at each width, with the rows' real timestamp text; at 6
    pairs also on a flush batch of the tier path (what its e2e run
    launches, [32768, 512] with ~16 500 real rows) and on 256 rows (the
    end-of-stream batch's shape, here with 200 real rows)."""
    from flowgger_tpu_torch.corpus import make_tier_corpus
    from flowgger_tpu_torch.tpu import framing, kernels, pack, rfc5424

    lines, _ = make_tier_corpus(BATCH, seed + 5)
    region_b = b"\n".join(lines) + b"\n"
    region = upload(region_b)
    ncap = pack.bucket_rows(BATCH)
    spans = framing.sep_spans(region, len(region_b), 10, True, ncap)
    batch, lens_c = framing.gather(region, spans["starts"], spans["lens"],
                                   MAX_LEN)
    lo = rfc5424.DEFAULT_MAX_PAIRS
    for P in (lo, rfc5424.RESCUE_MAX_PAIRS):
        packed = kernels.decode_rfc5424_cuda(batch, lens_c, 4, P)
        ts_len, ts_text = ts_text_of(packed)
        rows.extend(encode_case(P, batch, lens_c, packed, BATCH, ts_len,
                                ts_text))
        if P == lo:
            # the fused route F1 on the same batch
            rows.extend(route_case("f1", batch, lens_c, BATCH))
            # O5 and FO/r5 (→ RFC5424) on the same batch
            rows.extend(r5_cases("rfc5424", batch, lens_c, BATCH))
            # OC and FO/capnp (→ capnp) on the same batch
            oc_cases(batch, lens_c, BATCH, rows, shapes)
            fb, fl, fn = flush_batch(
                make_tier_corpus(2 * BATCH, seed + 9)[0], "tier path", shapes)
            fp = kernels.decode_rfc5424_cuda(fb, fl, 4, lo)
            for row in (encode_case(P, fb, fl, fp, fn, *ts_text_of(fp))
                        + route_case("f1", fb, fl, fn)
                        + r5_cases("rfc5424", fb, fl, fn)):
                shapes.append({**row, "where": "tier path, flush batch"})
            oc_cases(fb, fl, fn, rows, shapes, "tier path, flush batch")
            # the smallest batch the tier path takes: the end-of-stream
            # partial frame, one row in a 256-row bucket
            small_n = pack.bucket_rows(1)
            sb, sl = batch[:small_n], lens_c[:small_n]
            for row in (encode_case(P, sb, sl,
                                    packed[:, :small_n].contiguous(), 200,
                                    ts_len[:small_n], ts_text[:small_n])
                        + route_case("f1", sb, sl, 200)
                        + r5_cases("rfc5424", sb, sl, 200)):
                shapes.append({**row, "where": "tier path, end-of-stream "
                                               "batch"})
            oc_cases(sb, sl, 200, rows, shapes,
                     "tier path, end-of-stream batch")


def d3_case(batch, lens_c, year: int):
    """D3 (the rfc3164 decode) against its plain version on every
    channel of every row, rejected and padding rows included, once
    before and once after its timing loop: ``(row, plain channels)``."""
    from flowgger_tpu_torch.tpu import kernels, rfc3164

    def kern():
        return kernels.decode_rfc3164_cuda(batch, lens_c, year)

    def plain():
        return rfc3164.decode_rfc3164(batch, lens_c, year)

    ref = plain()
    err = channels_err("decode_rfc3164", rfc3164.unpack_channels(kern()), ref)
    ms = device_ms(kern)
    channels_err("decode_rfc3164", rfc3164.unpack_channels(kern()), ref)
    CHECKED.add(("decode_rfc3164", tuple(batch.shape)))
    n, valid = batch.shape[0], int(lens_c.sum())
    return {
        "name": "decode_rfc3164", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/decode_rfc3164.cu",
        "replaces": "flowgger_tpu/tpu/rfc3164.py:55",
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(plain, **PLAIN_TIMING),
        # bytes: each row's valid bytes, its length and its 12 int32
        # channels; operations: one per valid byte (one pass settles
        # every whole-row reduction)
        **bound(valid + 4 * n + 4 * len(rfc3164.KEYS) * n, valid),
        "library_ms": None,
        "shape": f"[{n}, {batch.shape[1]}], {valid} valid bytes, "
                 f"{int(ref['ok'].sum())} ok rows"}, ref


# route_case kinds: (format, table row name, source, reference def)
ROUTE_KINDS = {
    "e3": ("rfc3164", "encode_gelf3164",
           "flowgger_tpu_torch/csrc/encode_gelf.cu",
           "flowgger_tpu/tpu/device_rfc3164.py:100"),
    "f1": ("rfc5424", "fused_rfc5424_gelf",
           "flowgger_tpu_torch/csrc/fused_gelf.cu",
           "flowgger_tpu/tpu/fused_routes.py:179"),
    "f3": ("rfc3164", "fused_rfc3164_gelf",
           "flowgger_tpu_torch/csrc/fused_gelf.cu",
           "flowgger_tpu/tpu/fused_routes.py:197"),
}


def route_case(kind: str, batch, lens_c, n: int, assemble: bool = True):
    """E3 (``kind`` "e3": the split rfc3164 tier's encode, from D3's
    packed channels), F1 ("f1") or F3 ("f3": the fused routes, decode and
    encode in one kernel) against its plain version on one batch of
    ``n`` real rows: the probe's base tier bit and base length of every
    row (zeros at and past ``n``; for F1 and F3 also the ok and timestamp
    channels), and with ``assemble`` the assemble's bytes of every tier
    row (``base & (base_len + ts_len <= OW)`` at the rows' real stamp
    text) at its offset, each checked once before and once after its
    timing loop.  F1's and F3's probes also carry each tier row's
    channels (held against the plain decode's) and their assembles read
    them.  The plain versions of F1 and F3 are the format's plain decode,
    narrowed to ``fused_routes.DEMAND``, then the split tier's plain
    encode; their assembles reuse the probe's decode, as the kernels do.
    Returns ``[probe row]`` or ``[probe row, assemble row]``."""
    import torch

    from flowgger_tpu_torch.tpu import (device_common, device_gelf,
                                        device_rfc3164, fused_routes, kernels,
                                        rfc3164, rfc5424)
    from flowgger_tpu_torch.utils.timeparse import current_year_utc

    fmt, name, source, replaces = ROUTE_KINDS[kind]
    split = device_gelf if fmt == "rfc5424" else device_rfc3164
    suffix = b"\0"
    year = current_year_utc()
    N, L = batch.shape
    dev = batch.device
    live = torch.arange(N, device=dev) < n
    kw = {"suffix": suffix, **({"max_sd": 4} if fmt == "rfc5424" else {})}
    bank_b, table = split.kernel_consts(suffix)
    bank = device_gelf._bank_on(bank_b, dev)
    OW = split.out_width(L, suffix)
    small_keys = ("ok", "days", "sod", "off", "nanos")

    def plain_decode():
        if fmt == "rfc5424":
            dec = rfc5424.decode_rfc5424(batch, lens_c)
        else:
            dec = rfc3164.decode_rfc3164(batch, lens_c, year)
        if kind == "e3":
            return dec
        demand = fused_routes.DEMAND[f"{fmt}_gelf"]
        return {k: v for k, v in dec.items() if k in demand}

    dec0 = plain_decode()
    packed = (kernels.decode_rfc3164_cuda(batch, lens_c, year)
              if kind == "e3" else None)
    route = f"{fmt}_gelf"

    def k_probe():
        if kind == "e3":
            return kernels.encode_gelf3164_cuda(batch, lens_c, packed, n,
                                                bank, table)
        return kernels.fused_gelf_cuda(fmt, batch, lens_c, n, bank, table,
                                       year=year)

    def p_probe():
        # the fused routes' plain probe decodes, as their kernels do
        dec = dec0 if kind == "e3" else plain_decode()
        base, base_len = split.encode_rows(batch, lens_c, dec,
                                           assemble=False, n=n, **kw)
        if kind == "e3":
            return base, base_len
        return base, base_len, torch.stack(
            [torch.where(live, dec[k].to(torch.int32), 0)
             for k in small_keys])

    ref = p_probe()
    # F1 and F3 carry the encode's channels of each tier row to the
    # assemble: the plain decode's, on those rows
    ref_carried = (None if kind == "e3"
                   else fused_routes.carried_plain(dec0, route))
    probed = {}

    def check_probe():
        got = k_probe()
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        if ref_carried is not None:
            on = ref[0]
            err = max(err, max_abs_err(got[3][on], ref_carried[on]))
            probed["chan"], probed["tier"] = got[3], got[0]
        if err:
            raise AssertionError(f"{name} probe [{N}, {L}] n={n} disagrees "
                                 f"with its plain version: max_abs_err "
                                 f"{err}")
        return err

    err_p = check_probe()
    ms_p = device_ms(k_probe)
    check_probe()   # a launch after the timing loop
    CHECKED.add((f"{name}_probe", (N, L)))

    ref_base = ref[0]
    real_valid = int(torch.where(live, lens_c, 0).sum())
    gate = live & dec0["ok"].to(torch.bool) & ~dec0["has_high"].to(torch.bool)
    gated_valid = int(torch.where(gate, lens_c, 0).sum())
    n_gate = int(gate.sum())
    common = {"route": "cuda", "source": source, "replaces": replaces,
              "library_ms": None}
    if kind == "e3":
        # bytes: the ok and has_high channels of each real row, the valid
        # bytes, length and five other channels (has_pri, severity, the
        # host span, msg_start) of the rows they pass, every row's bit and
        # length; operations: one escape test per loaded byte
        probe_bytes = 8 * n + gated_valid + 24 * n_gate + 5 * N
        probe_ops = gated_valid
    else:
        # bytes: each real row's valid bytes and length, every row's bit,
        # length and five channels, the carried channels of each base
        # tier row; operations: the decode's passes (K1's six, D3's one)
        # and one escape test per valid byte
        carry = 4 * kernels.FUSED_CARRY[fmt]
        probe_bytes = (real_valid + 4 * n + 25 * N
                       + carry * int(ref_base.sum()))
        probe_ops = (7 if fmt == "rfc5424" else 2) * real_valid
    out = [{
        "name": f"{name}_probe", **common, "max_abs_err": err_p, "ms": ms_p,
        "plain_ms": cuda_ms(p_probe, **PLAIN_TIMING),
        **bound(probe_bytes, probe_ops),
        "shape": f"[{N}, {L}], n={n}, {int(ref_base.sum())} base tier rows, "
                 f"{real_valid} valid bytes"}]
    if not assemble:
        return out

    small = {k: dec0[k][:n].cpu().numpy() for k in small_keys}
    txt, tl = device_common.ts_text_block(small)
    ts_text = torch.zeros((N, device_common.TS_W), dtype=torch.uint8)
    ts_len = torch.zeros(N, dtype=torch.int32)
    ts_text[:n], ts_len[:n] = torch.from_numpy(txt), torch.from_numpy(tl)
    ts_text, ts_len = ts_text.to(dev), ts_len.to(dev)
    length = ref[1].to(torch.int64) + ts_len
    tier = ref_base & (length <= OW)
    gated = torch.where(tier, length, 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    total = int(gated.sum())

    def k_asm():
        if kind == "e3":
            return kernels.encode_gelf3164_cuda(
                batch, lens_c, packed, n, bank, table, OW, ts_text=ts_text,
                ts_len=ts_len, row_off=row_off, total=total)
        # from the channels the probe carried
        return kernels.fused_gelf_cuda(fmt, batch, lens_c, n, bank, table,
                                       year=year, OW=OW, ts_text=ts_text,
                                       ts_len=ts_len, row_off=row_off,
                                       total=total, chan=probed["chan"],
                                       tier=probed["tier"])

    def t_asm():
        # the timed call: the wrapper's launch without its contract check,
        # which reads a flag back from the card
        if kind == "e3":
            return k_asm()
        return kernels.fused_assemble_launch(fmt, batch, lens_c, n, bank,
                                             table, OW, ts_text, ts_len,
                                             row_off, total, probed["chan"])

    def p_asm():
        # the plain routes keep their probe's decode
        rows_, out_len, _ = split.encode_rows(batch, lens_c, dec0, ts_text,
                                              ts_len, **kw)
        return device_gelf.flat_rows(rows_, out_len, row_off, total)

    ref_flat = p_asm()
    if kind != "e3":
        # the wrapper's contract: no assemble without the probe's channels,
        # and none of a row outside the probe's tier
        def refused(**kw):
            try:
                kernels.fused_gelf_cuda(fmt, batch, lens_c, n, bank, table,
                                        year=year, OW=OW, ts_text=ts_text,
                                        ts_len=ts_len, total=total, **kw)
            except ValueError:
                return True
            return False

        outside = torch.nonzero(live & ~ref_base).flatten()[:1]
        bad_off = row_off.clone()
        bad_off[outside] = 0
        if (not refused(row_off=row_off, chan=None, tier=probed["tier"])
                or (outside.numel() and not refused(
                    row_off=bad_off, chan=probed["chan"],
                    tier=probed["tier"]))):
            raise AssertionError(f"{name} assemble ran against its contract")

    def check_asm():
        err = max_abs_err(k_asm(), ref_flat)
        if err:
            raise AssertionError(f"{name} assemble [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_a = check_asm()
    ms_a = device_ms(t_asm)
    check_asm()   # a launch after the timing loop
    CHECKED.add((f"{name}_assemble", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    ts_bytes = int(torch.where(tier, ts_len, 0).sum())
    # bytes: the tier rows' valid bytes, lengths, the channels the encode
    # reads (E3: seven of D3's; F1, F3: the probe's carried row, 56 or 11
    # int32), timestamp text and lengths, every row's offset, the output
    # written; operations: one escape test a byte (E1's or E3's encode;
    # no decode runs)
    ch_bytes = (28 if kind == "e3" else 4 * kernels.FUSED_CARRY[fmt]) * n_tier
    out.append({
        "name": f"{name}_assemble", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, **PLAIN_TIMING),
        **bound(tier_valid + 8 * n_tier + ch_bytes + ts_bytes + 8 * N + total,
                tier_valid),
        "shape": f"[{N}, {L}], n={n}, {n_tier} tier rows, {total} output "
                 f"bytes"})
    return out


def kernels_rfc3164(seed: int, rows: list, shapes: list):
    """D3, E3 (probe and assemble) and F3 (probe and assemble) on a
    gathered [16384, 512] batch of the rfc3164 tier mix; on the flush
    batches of the rfc3164 line path (D3, E3's and F3's probes, as its
    declining batches launch them) and of the rfc3164 tier path (all
    five); and on 256 rows, 200 of them real (the end-of-stream batch's
    shape)."""
    from flowgger_tpu_torch.corpus import (make_rfc3164_corpus,
                                           make_rfc3164_tier_corpus)
    from flowgger_tpu_torch.tpu import framing, pack
    from flowgger_tpu_torch.utils.timeparse import current_year_utc

    year = current_year_utc()
    lines, _ = make_rfc3164_tier_corpus(BATCH, seed + 11)
    region_b = b"\n".join(lines) + b"\n"
    region = upload(region_b)
    spans = framing.sep_spans(region, len(region_b), 10, True,
                              pack.bucket_rows(BATCH))
    batch, lens_c = framing.gather(region, spans["starts"], spans["lens"],
                                   MAX_LEN)
    rows.append(d3_case(batch, lens_c, year)[0])
    rows.extend(route_case("e3", batch, lens_c, BATCH))
    rows.extend(route_case("f3", batch, lens_c, BATCH))
    # O5/3164 and FO/r5 rfc3164 (→ RFC5424) on the same batch
    rows.extend(r5_cases("rfc3164", batch, lens_c, BATCH))

    fb, fl, fn = flush_batch(make_rfc3164_corpus(2 * BATCH, seed + 12)[0],
                             "rfc3164 line path", shapes)
    where = "rfc3164 line path, flush batch"
    shapes.append({**d3_case(fb, fl, year)[0], "where": where})
    for row in (route_case("e3", fb, fl, fn, assemble=False)
                + route_case("f3", fb, fl, fn, assemble=False)):
        shapes.append({**row, "where": where})

    fb, fl, fn = flush_batch(
        make_rfc3164_tier_corpus(2 * BATCH, seed + 14)[0],
        "rfc3164 tier path", shapes)
    where = "rfc3164 tier path, flush batch"
    shapes.append({**d3_case(fb, fl, year)[0], "where": where})
    for row in (route_case("e3", fb, fl, fn) + route_case("f3", fb, fl, fn)
                + r5_cases("rfc3164", fb, fl, fn)):
        shapes.append({**row, "where": where})

    small_n = pack.bucket_rows(1)
    sb, sl = batch[:small_n], lens_c[:small_n]
    where = "rfc3164 paths, end-of-stream batch"
    shapes.append({**d3_case(sb, sl, year)[0], "where": where})
    for row in (route_case("e3", sb, sl, 200) + route_case("f3", sb, sl, 200)
                + r5_cases("rfc3164", sb, sl, 200)):
        shapes.append({**row, "where": where})


def l1_case(batch, lens_c, n: int):
    """L1 (the ltsv decode) against its plain version on every channel of
    every row, rejected and padding rows included, once before and once
    after its timing loop: ``(row, plain channels)``."""
    import torch

    from flowgger_tpu_torch.tpu import kernels, ltsv

    def kern():
        return kernels.decode_ltsv_cuda(batch, lens_c, n)

    def plain():
        return ltsv.decode_ltsv(batch, lens_c, n=n)

    ref = plain()
    err = channels_err("decode_ltsv", ltsv.unpack_channels(kern()), ref)
    ms = device_ms(kern)
    channels_err("decode_ltsv", ltsv.unpack_channels(kern()), ref)
    CHECKED.add(("decode_ltsv", tuple(batch.shape)))
    N = batch.shape[0]
    live = torch.arange(N, device=batch.device) < n
    valid = int(torch.where(live, lens_c, 0).sum())
    return {
        "name": "decode_ltsv", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/decode_ltsv.cu",
        "replaces": "flowgger_tpu/tpu/ltsv.py:68",
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(plain, **PLAIN_TIMING),
        # bytes: each real row's valid bytes and length, every row's 94
        # int32 channels; operations: one per valid byte (one pass settles
        # the part table and the key matches)
        **bound(valid + 4 * n + 4 * ltsv.n_channels() * N, valid),
        "library_ms": None,
        "shape": f"[{N}, {batch.shape[1]}], n={n}, {valid} valid bytes, "
                 f"{int(ref['ok'].sum())} ok rows"}, ref


def ltsv_route_case(kind: str, batch, lens_c, n: int, assemble: bool = True):
    """EL (``kind`` "el6" / "el16": the split ltsv tier's encode at 6 or
    16 pairs, from L1's packed channels) or FL ("fl": the fused route,
    L1's row decode and EL's probe in one kernel) against its plain
    version on one batch of ``n`` real rows: the probe's base tier bit and
    base length of every row (zeros at and past ``n``; for FL also its
    nine small channels and each tier row's carried selection, held
    against ``fused_routes.carried_plain``), and with ``assemble`` the
    assemble's bytes of every tier row (``base & (base_len + ts_len <=
    OW)`` at the rows' real stamp text) at its offset, each checked once
    before and once after its timing loop; FL's assemble reads the
    probe's carried selection.  Returns ``[probe row]`` or ``[probe row,
    assemble row]``."""
    import torch

    from flowgger_tpu_torch.tpu import (device_common, device_gelf,
                                        device_ltsv, fused_routes, kernels,
                                        ltsv)

    fused = kind == "fl"
    P = 16 if kind == "el16" else 6
    name = "fused_ltsv_gelf" if fused else "encode_gelf_ltsv"
    tag = "" if fused else f"_p{P}"
    source = ("flowgger_tpu_torch/csrc/fused_gelf.cu" if fused
              else "flowgger_tpu_torch/csrc/encode_gelf.cu")
    replaces = ("flowgger_tpu/tpu/fused_routes.py:215" if fused
                else "flowgger_tpu/tpu/device_ltsv.py:127")
    suffix = b"\0"
    N, L = batch.shape
    dev = batch.device
    live = torch.arange(N, device=dev) < n
    bank_b, table = device_ltsv.kernel_consts(suffix)
    bank = device_gelf._bank_on(bank_b, dev)
    OW = device_ltsv.out_width(L, suffix)
    kw = {"suffix": suffix, "max_pairs": P}
    dec0 = ltsv.decode_ltsv(batch, lens_c, n=n)
    demand = fused_routes.DEMAND["ltsv_gelf"]
    packed = None if fused else kernels.decode_ltsv_cuda(batch, lens_c, n)

    def k_probe():
        if fused:
            return kernels.fused_gelf_cuda("ltsv", batch, lens_c, n, bank,
                                           table)
        return kernels.encode_gelf_ltsv_cuda(batch, lens_c, packed, n, bank,
                                             table, P)

    def p_probe():
        # the fused route's plain probe decodes, as its kernel does
        dec = dec0
        if fused:
            dec = {k: v for k, v in ltsv.decode_ltsv(batch, lens_c, n=n)
                   .items() if k in demand}
        base, base_len = device_ltsv.encode_rows(batch, lens_c, dec,
                                                 assemble=False, n=n, **kw)
        return base, base_len, device_ltsv.small_pack(dec, n)

    ref = p_probe()
    ref_carried = (fused_routes.carried_plain(
        {k: v for k, v in dec0.items() if k in demand}, "ltsv_gelf", batch,
        lens_c) if fused else None)
    probed = {}

    def check_probe():
        # the tier bits, base lengths and narrowed stamp channels
        got = k_probe()
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        if fused:
            on = ref[0]
            err = max(err, max_abs_err(got[3][on], ref_carried[on]))
            probed["chan"], probed["tier"] = got[3], got[0]
        if err:
            raise AssertionError(f"{name}{tag} probe [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_p = check_probe()
    ms_p = device_ms(k_probe)
    check_probe()   # a launch after the timing loop
    CHECKED.add((f"{name}_probe{tag}", (N, L)))

    ref_base = ref[0]
    n_base = int(ref_base.sum())
    real_valid = int(torch.where(live, lens_c, 0).sum())
    n_parts = torch.where(live, dec0["n_parts"].to(torch.int64).clamp(0, 24),
                          0)
    gate = (live & dec0["ok"].to(torch.bool)
            & ~dec0["has_high"].to(torch.bool))
    gated_valid = int(torch.where(gate, lens_c, 0).sum())
    common = {"route": "cuda", "source": source, "replaces": replaces,
              "library_ms": None}
    if fused:
        # bytes: each real row's valid bytes and length, every row's bit,
        # length and 25 bytes of narrowed stamp channels, the carried
        # selection of each base tier row; operations: L1's pass and one
        # escape test per valid byte
        carry = 4 * kernels.FUSED_CARRY["ltsv"]
        probe_bytes = real_valid + 4 * n + 30 * N + carry * n_base
        probe_ops = 2 * real_valid
    else:
        # bytes: the fourteen one-per-row channels each real row's gates
        # and stamp channels read, the part starts and colons of its parts,
        # the valid bytes of the rows the channels pass, every row's bit,
        # length and 25 bytes of narrowed stamp channels; operations: one
        # escape test per loaded byte
        probe_bytes = (56 * n + 8 * int(n_parts.sum()) + gated_valid
                       + 30 * N)
        probe_ops = gated_valid
    out = [{
        "name": f"{name}_probe{tag}", **common, "max_abs_err": err_p,
        "ms": ms_p, "plain_ms": cuda_ms(p_probe, **PLAIN_TIMING),
        **bound(probe_bytes, probe_ops),
        "shape": f"[{N}, {L}], n={n}, {n_base} base tier rows, "
                 f"{real_valid} valid bytes"}]
    if not assemble:
        return out

    small = {k: dec0[k][:n].cpu().numpy() for k in ("ok",)
             + device_ltsv.TS_KEYS}
    txt, tl = device_common.ts_text_block(small, device_ltsv.ts_vals_ltsv)
    ts_text = torch.zeros((N, device_common.TS_W), dtype=torch.uint8)
    ts_len = torch.zeros(N, dtype=torch.int32)
    ts_text[:n], ts_len[:n] = torch.from_numpy(txt), torch.from_numpy(tl)
    ts_text, ts_len = ts_text.to(dev), ts_len.to(dev)
    length = ref[1].to(torch.int64) + ts_len
    tier = ref_base & (length <= OW)
    gated = torch.where(tier, length, 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    total = int(gated.sum())

    def k_asm():
        if fused:
            # from the selection the probe carried
            return kernels.fused_gelf_cuda(
                "ltsv", batch, lens_c, n, bank, table, OW=OW,
                ts_text=ts_text, ts_len=ts_len, row_off=row_off, total=total,
                chan=probed["chan"], tier=probed["tier"])
        return kernels.encode_gelf_ltsv_cuda(
            batch, lens_c, packed, n, bank, table, P, OW, ts_text=ts_text,
            ts_len=ts_len, row_off=row_off, total=total)

    def t_asm():
        # the timed call: the fused wrapper's launch without its contract
        # check, which reads a flag back from the card
        if not fused:
            return k_asm()
        return kernels.fused_assemble_launch("ltsv", batch, lens_c, n, bank,
                                             table, OW, ts_text, ts_len,
                                             row_off, total, probed["chan"])

    def p_asm():
        rows_, out_len, _ = device_ltsv.encode_rows(batch, lens_c, dec0,
                                                    ts_text, ts_len, **kw)
        return device_gelf.flat_rows(rows_, out_len, row_off, total)

    ref_flat = p_asm()

    def check_asm():
        err = max_abs_err(k_asm(), ref_flat)
        if err:
            raise AssertionError(f"{name}{tag} assemble [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_a = check_asm()
    ms_a = device_ms(t_asm)
    check_asm()   # a launch after the timing loop
    CHECKED.add((f"{name}_assemble{tag}", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    ts_bytes = int(torch.where(tier, ts_len, 0).sum())
    if fused:
        ch_bytes = 4 * kernels.FUSED_CARRY["ltsv"] * n_tier
    else:
        # the channels EL's assemble reads a tier row: n_parts, the four
        # special positions, the host and message spans, the level, and
        # the part starts of its parts, the pairs' colons and ends
        pc = dec0["n_parts"].to(torch.int64)
        ch_bytes = int(torch.where(tier, 4 * (12 + 3 * pc), 0).sum())
    out.append({
        "name": f"{name}_assemble{tag}", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, **PLAIN_TIMING),
        # bytes: the tier rows' valid bytes, lengths and channels (or
        # carried selection), timestamp text and lengths, every row's
        # offset, the output written; operations: one escape test a byte
        **bound(tier_valid + 8 * n_tier + ch_bytes + ts_bytes + 8 * N + total,
                tier_valid),
        "shape": f"[{N}, {L}], n={n}, {n_tier} tier rows, {total} output "
                 f"bytes"})
    return out


def kernels_ltsv(seed: int, rows: list, shapes: list):
    """L1, EL (probe and assemble at 6 and 16 pairs) and FL (probe and
    assemble) on a gathered [16384, 512] batch of the ltsv tier mix; on
    the flush batch of the ltsv line path (L1, EL's probes at both widths
    and FL's probe, as its declining batches launch them) and of the ltsv
    tier path (L1, EL at both widths and FL, probe and assemble); and all
    of them on 256 rows, 200 of them real (the end-of-stream batch's
    shape)."""
    from flowgger_tpu_torch.corpus import make_ltsv_corpus, make_ltsv_tier_corpus
    from flowgger_tpu_torch.tpu import framing, pack

    lines, _ = make_ltsv_tier_corpus(BATCH, seed + 21)
    region_b = b"\n".join(lines) + b"\n"
    region = upload(region_b)
    spans = framing.sep_spans(region, len(region_b), 10, True,
                              pack.bucket_rows(BATCH))
    batch, lens_c = framing.gather(region, spans["starts"], spans["lens"],
                                   MAX_LEN)
    rows.append(l1_case(batch, lens_c, BATCH)[0])
    for kind in ("el6", "el16", "fl"):
        rows.extend(ltsv_route_case(kind, batch, lens_c, BATCH))

    fb, fl, fn = flush_batch(make_ltsv_corpus(2 * BATCH, seed + 22)[0],
                             "ltsv line path", shapes)
    where = "ltsv line path, flush batch"
    shapes.append({**l1_case(fb, fl, fn)[0], "where": where})
    for kind in ("el6", "el16", "fl"):
        for row in ltsv_route_case(kind, fb, fl, fn, assemble=False):
            shapes.append({**row, "where": where})

    fb, fl, fn = flush_batch(make_ltsv_tier_corpus(2 * BATCH, seed + 23)[0],
                             "ltsv tier path", shapes)
    where = "ltsv tier path, flush batch"
    shapes.append({**l1_case(fb, fl, fn)[0], "where": where})
    for kind in ("el6", "el16", "fl"):
        for row in ltsv_route_case(kind, fb, fl, fn):
            shapes.append({**row, "where": where})

    small_n = pack.bucket_rows(1)
    sb, sl = batch[:small_n], lens_c[:small_n]
    where = "ltsv paths, end-of-stream batch"
    shapes.append({**l1_case(sb, sl, 200)[0], "where": where})
    for kind in ("el6", "el16", "fl"):
        for row in ltsv_route_case(kind, sb, sl, 200):
            shapes.append({**row, "where": where})


def gelf_route_case(kind: str, batch, lens_c, n: int, assemble: bool = True):
    """EG (``kind`` "eg8" / "eg16": the split gelf tier's encode at 8 or
    16 fields, from K5's flat-mode packed channels) or FG ("fg": the
    fused route, K5's flat row index and EG's probe in one kernel) against
    its plain version on one batch of ``n`` real rows: the probe's base
    tier bit and base length of every row and its ts_hi / ts_lo / ts_meta
    channels (zeros off the tier and at and past ``n``; for FG also each
    tier row's carried selection, held against
    ``fused_routes.carried_plain``), and with ``assemble`` the assemble's
    bytes of every tier row (``base & (base_len + ts_len <= OW)`` at the
    rows' real stamp text) at its offset, each checked once before and
    once after its timing loop; FG's assemble reads the probe's carried
    selection.  Returns ``[probe row]`` or ``[probe row, assemble
    row]``."""
    import torch

    from flowgger_tpu_torch.tpu import (device_common, device_gelf,
                                        device_gelf_gelf, fused_routes, gelf,
                                        jsonidx, kernels)

    fused = kind == "fg"
    F = 16 if kind == "eg16" else 8
    name = "fused_gelf_gelf" if fused else "encode_gelf_gelf"
    tag = "" if fused else f"_f{F}"
    source = ("flowgger_tpu_torch/csrc/fused_gelf.cu" if fused
              else "flowgger_tpu_torch/csrc/encode_gelf.cu")
    replaces = ("flowgger_tpu/tpu/fused_routes.py:276" if fused
                else "flowgger_tpu/tpu/device_gelf_gelf.py:99")
    suffix = b"\0"
    N, L = batch.shape
    dev = batch.device
    live = torch.arange(N, device=dev) < n
    bank_b, table = device_gelf_gelf.kernel_consts(suffix)
    bank = device_gelf._bank_on(bank_b, dev)
    OW = device_gelf_gelf.out_width(L, suffix)
    dec0 = gelf.decode_gelf(batch, lens_c, F)
    packed = (None if fused
              else kernels.structural_index_cuda(batch, lens_c, F, 0))

    def k_probe():
        if fused:
            return kernels.fused_gelf_cuda("gelf", batch, lens_c, n, bank,
                                           table)
        return kernels.encode_gelf_gelf_cuda(batch, lens_c, packed, n, bank,
                                             table, F)

    def p_probe():
        # the fused route's plain probe decodes, as its kernel does
        dec = gelf.decode_gelf(batch, lens_c, F) if fused else dec0
        return device_gelf_gelf.encode_rows(batch, lens_c, dec,
                                            assemble=False, n=n,
                                            suffix=suffix)

    ref = p_probe()
    ref_carried = (fused_routes.carried_plain(dec0, "gelf_gelf", batch,
                                              lens_c) if fused else None)
    probed = {}

    def check_probe():
        # the tier bits, base lengths and stamp channels
        got = k_probe()
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        if fused:
            on = ref[0]
            err = max(err, max_abs_err(got[3][on], ref_carried[on]))
            probed["chan"], probed["tier"] = got[3], got[0]
        if err:
            raise AssertionError(f"{name}{tag} probe [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_p = check_probe()
    ms_p = device_ms(k_probe)
    check_probe()   # a launch after the timing loop
    CHECKED.add((f"{name}_probe{tag}", (N, L)))

    ref_base = ref[0]
    n_base = int(ref_base.sum())
    real_valid = int(torch.where(live, lens_c, 0).sum())
    ok = live & dec0["ok"].to(torch.bool)
    nf = torch.where(ok, dec0["n_fields"].to(torch.int64).clamp(0, F), 0)
    key_esc = (dec0["key_esc"] & (torch.arange(F, device=dev)[None, :]
                                  < nf[:, None])).any(dim=1)
    gated_valid = int(torch.where(ok & ~key_esc, lens_c, 0).sum())
    common = {"route": "cuda", "source": source, "replaces": replaces,
              "library_ms": None}
    if fused:
        # bytes: each real row's valid bytes and length, every row's bit,
        # length and three stamp channels, the carried selection of each
        # base tier row; operations: K5's pass and EG's screen per valid
        # byte
        carry = 4 * kernels.FUSED_CARRY["gelf"]
        probe_bytes = real_valid + 4 * n + 17 * N + carry * n_base
        probe_ops = 2 * real_valid
    else:
        # bytes: each real row's ok and n_fields, the seven channels of
        # each field of an ok row, the valid bytes of the rows the channels
        # pass, every row's bit, length and three stamp channels;
        # operations: one screen per loaded byte
        probe_bytes = 8 * n + 28 * int(nf.sum()) + gated_valid + 17 * N
        probe_ops = gated_valid
    out = [{
        "name": f"{name}_probe{tag}", **common, "max_abs_err": err_p,
        "ms": ms_p, "plain_ms": cuda_ms(p_probe, **PLAIN_TIMING),
        **bound(probe_bytes, probe_ops),
        "shape": f"[{N}, {L}], n={n}, {n_base} base tier rows, "
                 f"{real_valid} valid bytes"}]
    if not assemble:
        return out

    small, _ = device_gelf_gelf.small_channels(ref[2], n)
    txt, tl = device_common.ts_text_block(small,
                                          device_gelf_gelf.ts_vals_gelf)
    ts_text = torch.zeros((N, device_common.TS_W), dtype=torch.uint8)
    ts_len = torch.zeros(N, dtype=torch.int32)
    ts_text[:n], ts_len[:n] = torch.from_numpy(txt), torch.from_numpy(tl)
    ts_text, ts_len = ts_text.to(dev), ts_len.to(dev)
    length = ref[1].to(torch.int64) + ts_len
    tier = ref_base & (length <= OW)
    gated = torch.where(tier, length, 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    total = int(gated.sum())

    def k_asm():
        if fused:
            # from the selection the probe carried
            return kernels.fused_gelf_cuda(
                "gelf", batch, lens_c, n, bank, table, OW=OW,
                ts_text=ts_text, ts_len=ts_len, row_off=row_off, total=total,
                chan=probed["chan"], tier=probed["tier"])
        return kernels.encode_gelf_gelf_cuda(
            batch, lens_c, packed, n, bank, table, F, OW, ts_text=ts_text,
            ts_len=ts_len, row_off=row_off, total=total)

    def t_asm():
        # the timed call: the fused wrapper's launch without its contract
        # check, which reads a flag back from the card
        if not fused:
            return k_asm()
        return kernels.fused_assemble_launch("gelf", batch, lens_c, n, bank,
                                             table, OW, ts_text, ts_len,
                                             row_off, total, probed["chan"])

    def p_asm():
        rows_, out_len, _ = device_gelf_gelf.encode_rows(
            batch, lens_c, dec0, ts_text, ts_len, suffix=suffix)
        return device_gelf.flat_rows(rows_, out_len, row_off, total)

    ref_flat = p_asm()

    def check_asm():
        err = max_abs_err(k_asm(), ref_flat)
        if err:
            raise AssertionError(f"{name}{tag} assemble [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_a = check_asm()
    ms_a = device_ms(t_asm)
    check_asm()   # a launch after the timing loop
    CHECKED.add((f"{name}_assemble{tag}", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    ts_bytes = int(torch.where(tier, ts_len, 0).sum())
    if fused:
        ch_bytes = 4 * kernels.FUSED_CARRY["gelf"] * n_tier
    else:
        # ok, n_fields and the seven channels of each field of a tier row
        ch_bytes = int(torch.where(tier, 8 + 28 * nf, 0).sum())
    out.append({
        "name": f"{name}_assemble{tag}", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, **PLAIN_TIMING),
        # bytes: the tier rows' valid bytes and lengths, channels (or
        # carried selection), timestamp text and lengths, every row's
        # offset, the output written; operations: one per valid byte
        **bound(tier_valid + 4 * n_tier + ch_bytes + ts_bytes + 8 * N + total,
                tier_valid),
        "shape": f"[{N}, {L}], n={n}, {n_tier} tier rows, {total} output "
                 f"bytes"})
    return out


def kernels_gelf(seed: int, rows: list, shapes: list):
    """K5 in its flat mode at 8, 16 and 24 fields, EG (probe and assemble
    at 8 and 16 fields) and FG (probe and assemble) on a gathered
    [16384, 512] batch of the gelf tier mix; on the flush batch of the
    gelf line path (K5/0 at 8 and 16 fields, EG's probes at both widths
    and FG's probe, as its declining batches launch them) and of the gelf
    tier path (K5/0 at 8 fields, EG at both widths and FG, probe and
    assemble); K5/0 at 24 fields on the line path's rescue sub-batch; and
    all of them on 256 rows, 200 of them real (the end-of-stream batch's
    shape)."""
    import torch

    from flowgger_tpu_torch.corpus import make_gelf_corpus, make_gelf_tier_corpus
    from flowgger_tpu_torch.tpu import framing, pack

    lines, _ = make_gelf_tier_corpus(BATCH, seed + 31)
    region_b = b"\n".join(lines) + b"\n"
    region = upload(region_b)
    spans = framing.sep_spans(region, len(region_b), 10, True,
                              pack.bucket_rows(BATCH))
    batch, lens_c = framing.gather(region, spans["starts"], spans["lens"],
                                   MAX_LEN)
    for F in (8, 16, 24):
        rows.append(decode_case("gelf", F, batch, lens_c)[0])
    for kind in ("eg8", "eg16", "fg"):
        rows.extend(gelf_route_case(kind, batch, lens_c, BATCH))

    fb, fl, fn = flush_batch(make_gelf_corpus(2 * BATCH, seed + 32)[0],
                             "gelf line path", shapes)
    where = "gelf line path, flush batch"
    for F in (8, 16):
        row, ref = decode_case("gelf", F, fb, fl)
        shapes.append({**row, "where": where})
        if F == 8:
            nf = ref["n_fields"]
            idx = torch.nonzero(~ref["ok"] & (nf > 8) & (nf <= 24)).flatten()
    row, _ = decode_case("gelf", 24, *rescue_batch(fb, fl, idx))
    shapes.append({**row, "where": "gelf line path, rescue sub-batch"})
    for kind in ("eg8", "eg16", "fg"):
        for row in gelf_route_case(kind, fb, fl, fn, assemble=False):
            shapes.append({**row, "where": where})

    fb, fl, fn = flush_batch(make_gelf_tier_corpus(2 * BATCH, seed + 33)[0],
                             "gelf tier path", shapes)
    where = "gelf tier path, flush batch"
    shapes.append({**decode_case("gelf", 8, fb, fl)[0], "where": where})
    for kind in ("eg8", "eg16", "fg"):
        for row in gelf_route_case(kind, fb, fl, fn):
            shapes.append({**row, "where": where})

    small_n = pack.bucket_rows(1)
    sb, sl = batch[:small_n], lens_c[:small_n]
    where = "gelf paths, end-of-stream batch"
    for F in (8, 16, 24):
        shapes.append({**decode_case("gelf", F, sb, sl)[0], "where": where})
    for kind in ("eg8", "eg16", "fg"):
        for row in gelf_route_case(kind, sb, sl, 200):
            shapes.append({**row, "where": where})


def ac_case(batch, lens_c, n: int, dns: bool = False):
    """AC (the auto-detect classifier; with ``dns`` its dns overlay too,
    AC+dns) against its plain version on every one of the ``n`` real
    rows, once before and once after its timing loop; the row carries the
    kernel's registers, stack and spill bytes (``kernel_build``)."""
    import torch

    from flowgger_tpu_torch.tpu import autodetect, kernels

    name = "classify_auto_dns" if dns else "classify_auto"

    def kern():
        return kernels.classify_auto_cuda(batch, lens_c, n, dns=dns)

    def plain():
        return autodetect.classify_plain(batch[:n], lens_c[:n], dns=dns)

    ref = plain()
    err = max_abs_err(kern(), ref)
    if err or kern().dtype != torch.int8:
        raise AssertionError(f"{name} disagrees with its plain "
                             f"version: max_abs_err {err}")
    ms = device_ms(kern)
    if max_abs_err(kern(), ref):
        raise AssertionError(f"{name} disagrees after its timing loop")
    CHECKED.add((name, tuple(batch.shape)))
    # bytes the function must read: a row's valid bytes up to where both
    # a tab and a colon were seen (all of them when not both), at least
    # its header (the first 11 bytes decide '{', '<' and the RFC5424
    # signature behind a BOM), its length; one byte written a row.
    # Operations: two compares a scanned byte, ~40 a row for the header.
    L = batch.shape[1]
    b, ln = batch[:n], lens_c[:n].to(torch.int64)
    iota = torch.arange(L, device=batch.device)
    valid = iota[None, :] < ln[:, None]
    big = torch.full_like(ln, L)

    def first(mask):
        return torch.where(mask.any(1), mask.to(torch.int32).argmax(1),
                           big)

    both = torch.maximum(first((b == 9) & valid), first((b == 58) & valid))
    if dns:
        # the overlay needs the tab count: up to the sixth tab (and past
        # both a tab and a colon), else the whole row
        tabs = ((b == 9) & valid).to(torch.int32).cumsum(1)
        both = torch.maximum(both, first((tabs == 6) & (b == 9) & valid))
    need = torch.where(both < big, both + 1, ln)
    need = torch.maximum(need, torch.minimum(ln, torch.full_like(ln, 11)))
    scanned = int(need.sum())
    res = BUILD_RES.get(f"classify_auto_kernel<{str(dns).lower()}>", {})
    counts = torch.bincount(ref.to(torch.int64),
                            minlength=6 if dns else 4).tolist()
    return {
        "name": name, "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/classify_auto.cu",
        "replaces": "flowgger_tpu/tpu/autodetect.py:97" + (
            " + :159" if dns else ""),
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(plain, **PLAIN_TIMING),
        **bound(scanned + 4 * n + n, 2 * scanned + 40 * n),
        "library_ms": None,
        "registers": res.get("registers"),
        "stack_bytes": res.get("stack_bytes"),
        "spill_bytes": res.get("spill_store_bytes"),
        "shape": f"[{batch.shape[0]}, {L}], n={n}, {scanned} bytes "
                 f"scanned, classes rfc5424/rfc3164/ltsv/gelf"
                 f"{'/jsonl/dns' if dns else ''} {counts}"}


def edge_batch():
    """The classifier's edge rows (``corpus.AUTO_EDGE``) with each cut to
    every length up to 12 and the auto mix around them, packed at the
    default width and put on the card: ``(batch, lens_c, n)``."""
    import torch

    from flowgger_tpu_torch.corpus import AUTO_EDGE, make_auto_corpus
    from flowgger_tpu_torch.tpu import pack

    rows = list(AUTO_EDGE) + [r[:k] for r in AUTO_EDGE for k in range(13)]
    rows += make_auto_corpus(1000, 5)[0]
    b, ln, _, _, _, n = pack.pack_lines_2d(rows, MAX_LEN)
    return (torch.from_numpy(b).cuda(),
            torch.from_numpy(ln.astype("int32")).cuda(), n)


def kernels_auto(seed: int, rows: list, shapes: list):
    """AC on a gathered [16384, 512] batch of the auto tier mix (its
    table row), on the edge batch, and on the first flush batch of each
    auto path ([32768, 512], ~16 500 real rows)."""
    from flowgger_tpu_torch.corpus import make_auto_corpus
    from flowgger_tpu_torch.tpu import framing, pack

    lines, _ = make_auto_corpus(BATCH, seed + 41, tier=True)
    region_b = b"\n".join(lines) + b"\n"
    region = upload(region_b)
    spans = framing.sep_spans(region, len(region_b), 10, True,
                              pack.bucket_rows(BATCH))
    batch, lens_c = framing.gather(region, spans["starts"], spans["lens"],
                                   MAX_LEN)
    rows.append(ac_case(batch, lens_c, BATCH))
    shapes.append({**ac_case(*edge_batch()), "where": "edge batch"})
    for tier in (False, True):
        where = f"auto {'tier' if tier else 'line'} path"
        fb, fl, fn = flush_batch(
            make_auto_corpus(2 * BATCH, seed + 42 + tier, tier=tier)[0],
            where, shapes)
        shapes.append({**ac_case(fb, fl, fn), "where": f"{where}, flush batch"})


def dn_case(batch, lens_c, n: int):
    """DN (the dns decode) against its plain version on every channel of
    every row, rejected and padding rows included, once before and once
    after its timing loop: ``(row, plain channels)``."""
    import torch

    from flowgger_tpu_torch.tpu import dns, kernels

    def kern():
        return kernels.decode_dns_cuda(batch, lens_c, n)

    def plain():
        return dns.decode_dns(batch, lens_c, n=n)

    ref = plain()
    err = channels_err("decode_dns", dns.unpack_channels(kern()), ref)
    ms = device_ms(kern)
    channels_err("decode_dns", dns.unpack_channels(kern()), ref)
    CHECKED.add(("decode_dns", tuple(batch.shape)))
    N = batch.shape[0]
    live = torch.arange(N, device=batch.device) < n
    valid = int(torch.where(live, lens_c, 0).sum())
    return {
        "name": "decode_dns", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/decode_dns.cu",
        "replaces": "flowgger_tpu/tpu/dns.py:44",
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(plain, **PLAIN_TIMING),
        # bytes: each real row's valid bytes and length, every row's 14
        # int32 channels; operations: a tab compare in the first pass, a
        # digit / dot class in the second, per valid byte
        **bound(valid + 4 * n + 4 * len(dns.KEYS) * N, 2 * valid),
        "library_ms": None,
        "shape": f"[{N}, {batch.shape[1]}], n={n}, {valid} valid bytes, "
                 f"{int(ref['ok'].sum())} ok rows"}, ref


def ol_case(kind: str, batch, lens_c, n: int, assemble: bool = True):
    """OL (``kind`` "ol": the split rfc5424 → LTSV tier's encode, from
    K1's packed channels at 6 pairs) or FO/ltsv ("fo": the fused route,
    K1's row decode and OL's probe in one kernel) against its plain
    version on one batch of ``n`` real rows: the probe's base tier bit,
    elided length and gaps of every row (zeros at and past ``n``; for FO
    also the ok / stamp channels and each tier row's carried channels),
    and with ``assemble`` the assemble's bytes of every tier row (``base
    & (base_len <= OW)``: the stamp is not in the device row) at its
    offset, each checked once before and once after its timing loop.
    Returns ``[probe row]`` or ``[probe row, assemble row]``."""
    import torch

    from flowgger_tpu_torch.tpu import (device_gelf, device_ltsv_out,
                                        fused_routes, kernels, rfc5424)

    suffix = b"\n"
    N, L = batch.shape
    dev = batch.device
    live = torch.arange(N, device=dev) < n
    bank_b, table = device_ltsv_out.kernel_consts(suffix)
    bank = device_gelf._bank_on(bank_b, dev)
    OW = device_ltsv_out.out_width(L, suffix)
    name = ("encode_ltsv_out" if kind == "ol" else "fused_rfc5424_ltsv")
    source = ("flowgger_tpu_torch/csrc/encode_ltsv_out.cu" if kind == "ol"
              else "flowgger_tpu_torch/csrc/fused_ltsv_out.cu")
    replaces = ("flowgger_tpu/tpu/device_ltsv_out.py:133" if kind == "ol"
                else "flowgger_tpu/tpu/fused_routes.py:329")
    small_keys = ("ok", "days", "sod", "off", "nanos")
    demand = fused_routes.DEMAND["rfc5424_ltsv"]

    def plain_decode():
        dec = rfc5424.decode_rfc5424(batch, lens_c)
        return dec if kind == "ol" else {k: v for k, v in dec.items()
                                         if k in demand}

    dec0 = plain_decode()
    packed = kernels.decode_rfc5424_cuda(batch, lens_c) if kind == "ol" \
        else None

    def k_probe():
        if kind == "ol":
            return kernels.encode_ltsv_out_cuda(batch, lens_c, packed, n,
                                                bank, table)
        base, base_len, small, chan, gaps = kernels.fused_ltsv_out_cuda(
            batch, lens_c, n, bank, table)
        return base, base_len, gaps, small, chan

    def p_probe():
        dec = dec0 if kind == "ol" else plain_decode()
        base, base_len, gaps = device_ltsv_out.encode_rows(
            batch, lens_c, dec, suffix=suffix, assemble=False, n=n)
        if kind == "ol":
            return base, base_len, gaps
        return base, base_len, gaps, torch.stack(
            [torch.where(live, dec[k].to(torch.int32), 0)
             for k in small_keys])

    ref = p_probe()
    ref_carried = (None if kind == "ol"
                   else fused_routes.carried_plain(dec0, "rfc5424_ltsv"))
    probed = {}

    def check_probe():
        got = k_probe()
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        if ref_carried is not None:
            on = ref[0]
            err = max(err, max_abs_err(got[4][on], ref_carried[on]))
            probed["chan"], probed["tier"] = got[4], got[0]
        if err:
            raise AssertionError(f"{name} probe [{N}, {L}] n={n} disagrees "
                                 f"with its plain version: max_abs_err "
                                 f"{err}")
        return err

    err_p = check_probe()
    ms_p = device_ms(k_probe)
    check_probe()   # a launch after the timing loop
    CHECKED.add((f"{name}_probe", (N, L)))

    ref_base = ref[0]
    real_valid = int(torch.where(live, lens_c, 0).sum())
    gate = live & dec0["ok"].to(torch.bool) & ~dec0["has_high"].to(torch.bool)
    gated_valid = int(torch.where(gate, lens_c, 0).sum())
    n_gate = int(gate.sum())
    pairs = int(torch.where(gate, dec0["pair_count"].to(torch.int64),
                            0).sum())
    common = {"route": "cuda", "source": source, "replaces": replaces,
              "library_ms": None}
    if kind == "ol":
        # bytes: ok, has_high and pair_count of each real row, the valid
        # bytes and the ~13 span channels of the rows they pass, five
        # int32 of each of their pairs, every row's bit, length and two
        # gaps; operations: a tab / newline compare per loaded byte and
        # a colon compare per name byte (counted as one per byte)
        probe_bytes = (12 * n + gated_valid + 52 * n_gate + 20 * pairs
                       + 13 * N)
        probe_ops = 2 * gated_valid
    else:
        # bytes: each real row's valid bytes and length, every row's bit,
        # length, gaps and five stamp channels, the carried channels of
        # each base tier row; operations: K1's passes and OL's screens
        probe_bytes = (real_valid + 4 * n + 33 * N
                       + 4 * kernels.FUSED_LTSV_OUT_CARRY
                       * int(ref_base.sum()))
        probe_ops = 9 * real_valid
    out = [{
        "name": f"{name}_probe", **common, "max_abs_err": err_p, "ms": ms_p,
        "plain_ms": cuda_ms(p_probe, **PLAIN_TIMING),
        **bound(probe_bytes, probe_ops),
        "shape": f"[{N}, {L}], n={n}, {int(ref_base.sum())} base tier rows, "
                 f"{real_valid} valid bytes"}]
    if not assemble:
        return out

    tier = ref_base & (ref[1] <= OW)
    gated = torch.where(tier, ref[1].to(torch.int64), 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    total = int(gated.sum())

    def k_asm():
        if kind == "ol":
            return kernels.encode_ltsv_out_cuda(batch, lens_c, packed, n,
                                                bank, table, OW,
                                                row_off=row_off, total=total)
        return kernels.fused_ltsv_out_cuda(batch, lens_c, n, bank, table, OW,
                                           row_off=row_off, total=total,
                                           chan=probed["chan"],
                                           tier=probed["tier"])

    def t_asm():
        # the timed call: FO's launch without its contract check, which
        # reads a flag back from the card
        if kind == "ol":
            return k_asm()
        return kernels.fused_ltsv_out_assemble_launch(
            batch, lens_c, n, bank, table, OW, row_off, total,
            probed["chan"])

    def p_asm():
        rows_, out_len, _ = device_ltsv_out.encode_rows(batch, lens_c, dec0,
                                                        suffix=suffix)
        return device_gelf.flat_rows(rows_, out_len, row_off, total)

    ref_flat = p_asm()
    if kind == "fo":
        # the wrapper's contract: no assemble without the probe's channels,
        # and none of a row outside the probe's tier
        def refused(**kw):
            try:
                kernels.fused_ltsv_out_cuda(batch, lens_c, n, bank, table,
                                            OW, total=total, **kw)
            except ValueError:
                return True
            return False

        outside = torch.nonzero(live & ~ref_base).flatten()[:1]
        bad_off = row_off.clone()
        bad_off[outside] = 0
        if (not refused(row_off=row_off, chan=None, tier=probed["tier"])
                or (outside.numel() and not refused(
                    row_off=bad_off, chan=probed["chan"],
                    tier=probed["tier"]))):
            raise AssertionError(f"{name} assemble ran against its contract")

    def check_asm():
        err = max_abs_err(k_asm(), ref_flat)
        if err:
            raise AssertionError(f"{name} assemble [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_a = check_asm()
    ms_a = device_ms(t_asm)
    check_asm()   # a launch after the timing loop
    CHECKED.add((f"{name}_assemble", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    tier_pairs = int(torch.where(tier, dec0["pair_count"].to(torch.int64),
                                 0).sum())
    # bytes: the tier rows' valid bytes and lengths, the channels the
    # encode reads (OL: 14 row channels and four a pair of K1's; FO: the
    # probe's carried row, 38 int32), every row's offset, the output
    # written; operations: one source lookup a byte written
    ch_bytes = (4 * (14 * n_tier + 4 * tier_pairs) if kind == "ol"
                else 4 * kernels.FUSED_LTSV_OUT_CARRY * n_tier)
    out.append({
        "name": f"{name}_assemble", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, **PLAIN_TIMING),
        **bound(tier_valid + 4 * n_tier + ch_bytes + 8 * N + total, total),
        "shape": f"[{N}, {L}], n={n}, {n_tier} tier rows, {total} output "
                 f"bytes"})
    return out


def gathered_batch(lines: list):
    """``lines`` (at most a batch) framed and gathered on the card as the
    line path's kernels do: ``(batch, lens_c)`` at [16384, 512]."""
    from flowgger_tpu_torch.tpu import framing, pack

    region_b = b"\n".join(lines) + b"\n"
    region = upload(region_b)
    spans = framing.sep_spans(region, len(region_b), 10, True,
                              pack.bucket_rows(len(lines)))
    return framing.gather(region, spans["starts"], spans["lens"], MAX_LEN)


def kernels_ltsv_out(seed: int, rows: list, shapes: list):
    """OL and FO/ltsv (probe and assemble) on a gathered [16384, 512]
    batch of the → LTSV tier mix (``corpus.make_ltsv_out_tier_corpus``),
    and at 256 rows (an end-of-stream batch's shape, 200 of them real)."""
    from flowgger_tpu_torch.corpus import make_ltsv_out_tier_corpus

    lines, _ = make_ltsv_out_tier_corpus(BATCH, seed + 61)
    batch, lens_c = gathered_batch(lines)
    rows.extend(ol_case("ol", batch, lens_c, BATCH))
    rows.extend(ol_case("fo", batch, lens_c, BATCH))
    for kind in ("ol", "fo"):
        for row in ol_case(kind, batch[:256].contiguous(),
                           lens_c[:256].contiguous(), 200):
            shapes.append({**row, "where": "end-of-stream batch"})


# O5 / O5/3164 (split) and FO/r5 (fused) kinds of r5_case: (input
# format, kernel name, source, the reference function's file:line)
R5_KINDS = {
    "o5": ("rfc5424", "encode_rfc5424_out",
           "flowgger_tpu_torch/csrc/encode_rfc5424_out.cu",
           "flowgger_tpu/tpu/device_rfc5424_out.py:220"),
    "o3": ("rfc3164", "encode_rfc3164_rfc5424",
           "flowgger_tpu_torch/csrc/encode_rfc5424_out.cu",
           "flowgger_tpu/tpu/device_rfc5424_out.py:335"),
    "fo5": ("rfc5424", "fused_rfc5424_rfc5424",
            "flowgger_tpu_torch/csrc/fused_rfc5424_out.cu",
            "flowgger_tpu/tpu/fused_routes.py:297"),
    "fo3": ("rfc3164", "fused_rfc3164_rfc5424",
            "flowgger_tpu_torch/csrc/fused_rfc5424_out.cu",
            "flowgger_tpu/tpu/fused_routes.py:313"),
}


def r5_case(kind: str, batch, lens_c, n: int, assemble: bool = True):
    """O5 (``kind`` "o5": the split rfc5424 → RFC5424 tier's encode, from
    K1's packed channels at 4 SD blocks and 6 pairs), O5/3164 ("o3", from
    D3's packed channels) or FO/r5 ("fo5", "fo3": the fused routes, the
    decode and the probe in one kernel) against its plain version on one
    batch of ``n`` real rows: the probe's base tier bit, elided length and
    small channels (fac8, sev8; pri1 and hostl16 on the rfc3164 leg) of
    every row (zeros at and past ``n``; for FO/r5 also the ok / stamp
    channels and each tier row's carried channels), and with ``assemble``
    the assemble's bytes of every tier row (``base & (base_len <= OW)``:
    the stamp is not in the device row) at its offset, each checked once
    before and once after its timing loop.  Returns ``[probe row]`` or
    ``[probe row, assemble row]``."""
    import torch

    from flowgger_tpu_torch.tpu import (device_gelf, device_rfc5424_out,
                                        fused_routes, kernels, rfc3164,
                                        rfc5424)
    from flowgger_tpu_torch.utils.timeparse import current_year_utc

    fmt, name, source, replaces = R5_KINDS[kind]
    fused = kind.startswith("fo")
    r3 = fmt == "rfc3164"
    suffix = b"\n"
    N, L = batch.shape
    dev = batch.device
    live = torch.arange(N, device=dev) < n
    year = current_year_utc()
    bank_b, table = device_rfc5424_out.kernel_consts(suffix)
    bank = device_gelf._bank_on(bank_b, dev)
    OW = device_rfc5424_out.out_width(L, suffix)
    route = f"{fmt}_rfc5424"
    demand = fused_routes.DEMAND[route]
    small_keys = ("ok", "days", "sod", "off", "nanos")
    encode = (device_rfc5424_out.encode_rows_3164 if r3
              else device_rfc5424_out.encode_rows)

    def plain_decode():
        dec = (rfc3164.decode_rfc3164(batch, lens_c, year) if r3
               else rfc5424.decode_rfc5424(batch, lens_c))
        return {k: v for k, v in dec.items() if k in demand} if fused \
            else dec

    dec0 = plain_decode()
    packed = None
    if not fused:
        packed = (kernels.decode_rfc3164_cuda(batch, lens_c, year) if r3
                  else kernels.decode_rfc5424_cuda(batch, lens_c))

    def k_probe():
        if not fused:
            return kernels.encode_rfc5424_out_cuda(fmt, batch, lens_c, packed,
                                                   n, bank, table)
        base, base_len, small, chan, small8, hostl16 = \
            kernels.fused_rfc5424_out_cuda(fmt, batch, lens_c, n, bank,
                                           table, year=year)
        out = (base, base_len, small8) + ((hostl16,) if r3 else ())
        return out + (small, chan)

    def p_probe():
        dec = plain_decode() if fused else dec0
        res = encode(batch, lens_c, dec, suffix=suffix, assemble=False, n=n)
        if not fused:
            return res
        return tuple(res) + (torch.stack(
            [torch.where(live, dec[k].to(torch.int32), 0)
             for k in small_keys]),)

    def as_int(t):
        return t.to(torch.int32) if t.dtype == torch.uint16 else t

    ref = p_probe()
    ref_carried = (fused_routes.carried_plain(dec0, route) if fused
                   else None)
    probed = {}

    def check_probe():
        got = k_probe()
        err = max(max_abs_err(as_int(g), as_int(r))
                  for g, r in zip(got, ref))
        if ref_carried is not None:
            on = ref[0]
            err = max(err, max_abs_err(got[-1][on], ref_carried[on]))
            probed["chan"], probed["tier"] = got[-1], got[0]
        if err:
            raise AssertionError(f"{name} probe [{N}, {L}] n={n} disagrees "
                                 f"with its plain version: max_abs_err "
                                 f"{err}")
        return err

    err_p = check_probe()
    ms_p = device_ms(k_probe)
    check_probe()   # a launch after the timing loop
    CHECKED.add((f"{name}_probe", (N, L)))

    ref_base = ref[0]
    real_valid = int(torch.where(live, lens_c, 0).sum())
    gate = live & dec0["ok"].to(torch.bool) & ~dec0["has_high"].to(torch.bool)
    n_gate = int(gate.sum())
    pairs = 0 if r3 else int(torch.where(
        gate, dec0["pair_count"].to(torch.int64), 0).sum())
    n_small = 3 if r3 else 2
    common = {"route": "cuda", "source": source, "replaces": replaces,
              "library_ms": None}
    carry = kernels.FUSED_R5_OUT_CARRY[fmt]
    if not fused:
        # bytes: the screen's channels of each real row (rfc5424: ok,
        # has_high, pair and SD counts, fac / sev; rfc3164: its eight),
        # the span channels of the rows they pass (rfc5424: 10 head, 8 SD
        # and five a pair), every row's bit, length and small channels;
        # operations: a few a channel (counted as one a row)
        probe_bytes = ((32 * n if r3 else 24 * n + 72 * n_gate
                        + 20 * pairs) + (5 + n_small + 2 * r3) * N)
        probe_ops = n
    else:
        # bytes: each real row's valid bytes and length, every row's
        # outputs and five stamp channels, the carried channels of each
        # base tier row; operations: the decode's passes
        probe_bytes = (real_valid + 4 * n + (25 + n_small + 2 * r3) * N
                       + 4 * carry * int(ref_base.sum()))
        probe_ops = (4 if r3 else 9) * real_valid
    out = [{
        "name": f"{name}_probe", **common, "max_abs_err": err_p, "ms": ms_p,
        "plain_ms": cuda_ms(p_probe, **PLAIN_TIMING),
        **bound(probe_bytes, probe_ops),
        "shape": f"[{N}, {L}], n={n}, {int(ref_base.sum())} base tier rows, "
                 f"{n_gate} rows past ok / has_high, {real_valid} valid "
                 f"bytes"}]
    if not assemble:
        return out

    tier = ref_base & (ref[1] <= OW)
    gated = torch.where(tier, ref[1].to(torch.int64), 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    total = int(gated.sum())

    def k_asm():
        if not fused:
            return kernels.encode_rfc5424_out_cuda(
                fmt, batch, lens_c, packed, n, bank, table, OW,
                row_off=row_off, total=total)
        return kernels.fused_rfc5424_out_cuda(
            fmt, batch, lens_c, n, bank, table, year=year, OW=OW,
            row_off=row_off, total=total, chan=probed["chan"],
            tier=probed["tier"])

    def t_asm():
        # the timed call: FO/r5's launch without its contract check,
        # which reads a flag back from the card
        if not fused:
            return k_asm()
        return kernels.fused_rfc5424_out_assemble_launch(
            fmt, batch, lens_c, n, bank, table, OW, row_off, total,
            probed["chan"])

    def p_asm():
        rows_, out_len, _ = encode(batch, lens_c, dec0, suffix=suffix)
        return device_gelf.flat_rows(rows_, out_len, row_off, total)

    ref_flat = p_asm()
    if fused:
        # the wrapper's contract: no assemble without the probe's channels,
        # and none of a row outside the probe's tier
        def refused(**kw):
            try:
                kernels.fused_rfc5424_out_cuda(fmt, batch, lens_c, n, bank,
                                               table, year=year, OW=OW,
                                               total=total, **kw)
            except ValueError:
                return True
            return False

        outside = torch.nonzero(live & ~ref_base).flatten()[:1]
        bad_off = row_off.clone()
        bad_off[outside] = 0
        if (not refused(row_off=row_off, chan=None, tier=probed["tier"])
                or (outside.numel() and not refused(
                    row_off=bad_off, chan=probed["chan"],
                    tier=probed["tier"]))):
            raise AssertionError(f"{name} assemble ran against its contract")

    def check_asm():
        err = max_abs_err(k_asm(), ref_flat)
        if err:
            raise AssertionError(f"{name} assemble [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_a = check_asm()
    ms_a = device_ms(t_asm)
    check_asm()   # a launch after the timing loop
    CHECKED.add((f"{name}_assemble", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    tier_pairs = 0 if r3 else int(torch.where(
        tier, dec0["pair_count"].to(torch.int64), 0).sum())
    # bytes: the tier rows' valid bytes and lengths, the channels the
    # assemble reads (O5: 12 row channels, 8 SD spans and five a pair;
    # O5/3164: three; FO/r5: the carried row), every row's offset, the
    # output written; operations: one source lookup a byte written
    if fused:
        ch_bytes = 4 * carry * n_tier
    else:
        ch_bytes = 4 * (3 * n_tier if r3 else 20 * n_tier + 5 * tier_pairs)
    out.append({
        "name": f"{name}_assemble", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, **PLAIN_TIMING),
        **bound(tier_valid + 4 * n_tier + ch_bytes + 8 * N + total, total),
        "shape": f"[{N}, {L}], n={n}, {n_tier} tier rows, {total} output "
                 f"bytes"})
    return out


def r5_cases(fmt: str, batch, lens_c, n: int) -> list:
    """The split → RFC5424 encode of ``fmt``'s leg (O5 or O5/3164) and its
    fused route (FO/r5), probe and assemble, on one batch; the kernels
    phase runs them on the batches of the rfc5424 and rfc3164 tier mixes
    that E1 / F1 and E3 / F3 run on."""
    kinds = ("o5", "fo5") if fmt == "rfc5424" else ("o3", "fo3")
    return [row for kind in kinds
            for row in r5_case(kind, batch, lens_c, n)]


# OC (split, 6 or 16 pairs) and FO/capnp (fused) kinds of oc_case: (kernel
# name, source, the reference function's file:line)
OC_KINDS = {
    "oc": ("encode_capnp", "flowgger_tpu_torch/csrc/encode_capnp.cu",
           "flowgger_tpu/tpu/device_capnp.py:148"),
    "fo": ("fused_rfc5424_capnp", "flowgger_tpu_torch/csrc/fused_capnp_out.cu",
           "flowgger_tpu/tpu/fused_routes.py:346"),
}
# the capnp_extra of the kernels phase's extra cases and of capnp_out_extra
CAPNP_EXTRA = (("env", "prod"), ("dc", "eu-west-1"))


def oc_case(kind: str, batch, lens_c, n: int, P: int = 6, extras=(),
            assemble: bool = True):
    """OC (``kind`` "oc": the split rfc5424 → capnp tier's encode, from
    K1's packed channels at 4 SD blocks and ``P`` pairs) or FO/capnp
    ("fo": the fused route, the decode and the probe in one kernel, 6
    pairs) against its plain version on one batch of ``n`` real rows,
    with the ``capnp_extra`` pairs ``extras``: the probe's base tier bit,
    elided length and fac8 / sev8 of every row (zeros at and past ``n``;
    for FO/capnp also the ok / stamp channels and each tier row's carried
    channels), and with ``assemble`` the assemble's bytes of every tier
    row (``base & (base_len <= OW)``) at its offset, each checked once
    before and once after its timing loop.  Returns ``[probe row]`` or
    ``[probe row, assemble row]``; the rows' names carry ``_p6`` /
    ``_p16`` for OC as its launch counts do."""
    import torch

    from flowgger_tpu_torch.tpu import (device_capnp, device_gelf,
                                        fused_routes, kernels, rfc5424)

    base_name, source, replaces = OC_KINDS[kind]
    fused = kind == "fo"
    tag = "" if fused else f"_p{P}"
    suffix = b""
    N, L = batch.shape
    dev = batch.device
    live = torch.arange(N, device=dev) < n
    bank_b, table = device_capnp.kernel_consts(suffix, extras)
    bank = device_gelf._bank_on(bank_b, dev)
    OW = device_capnp.out_width(L, suffix, extras, P)
    route = "rfc5424_capnp"
    demand = fused_routes.DEMAND[route]
    small_keys = ("ok", "days", "sod", "off", "nanos")

    def plain_decode():
        dec = rfc5424.decode_rfc5424(batch, lens_c, max_pairs=P)
        return {k: v for k, v in dec.items() if k in demand} if fused \
            else dec

    dec0 = plain_decode()
    packed = None if fused else kernels.decode_rfc5424_cuda(batch, lens_c,
                                                            4, P)

    def k_probe():
        if not fused:
            return kernels.encode_capnp_cuda(batch, lens_c, packed, n, bank,
                                             table)
        base, base_len, small, chan, small8 = kernels.fused_capnp_out_cuda(
            batch, lens_c, n, bank, table)
        return base, base_len, small8, small, chan

    def p_probe():
        dec = plain_decode() if fused else dec0
        res = device_capnp.encode_rows(batch, lens_c, dec, suffix=suffix,
                                       extras=extras, assemble=False, n=n)
        if not fused:
            return res
        return tuple(res) + (torch.stack(
            [torch.where(live, dec[k].to(torch.int32), 0)
             for k in small_keys]),)

    ref = p_probe()
    ref_carried = (fused_routes.carried_plain(dec0, route) if fused
                   else None)
    probed = {}

    def check_probe():
        got = k_probe()
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        if ref_carried is not None:
            on = ref[0]
            err = max(err, max_abs_err(got[-1][on], ref_carried[on]))
            probed["chan"], probed["tier"] = got[-1], got[0]
        if err:
            raise AssertionError(f"{base_name}{tag} probe [{N}, {L}] n={n} "
                                 f"disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_p = check_probe()
    ms_p = device_ms(k_probe)
    check_probe()   # a launch after the timing loop
    CHECKED.add((f"{base_name}_probe{tag}", (N, L)))

    ref_base = ref[0]
    real_valid = int(torch.where(live, lens_c, 0).sum())
    gate = live & dec0["ok"].to(torch.bool) & ~dec0["has_high"].to(torch.bool)
    n_gate = int(gate.sum())
    # the pair slots below each row's pair_count, and those of them that
    # are sd[0]'s (the only pairs whose spans the encode loads)
    in_pc = (torch.arange(P, device=dev)[None, :]
             < dec0["pair_count"].to(torch.int64)[:, None])
    sd0 = in_pc & (dec0["pair_sd"] == 0)

    def pair_slots(rows, m=in_pc):
        return int((m & rows.to(torch.bool)[:, None]).sum())

    common = {"route": "cuda", "source": source, "replaces": replaces,
              "library_ms": None}
    carry = kernels.FUSED_CAPNP_CARRY
    if not fused:
        # bytes: the screen's channels of each real row (ok, has_high,
        # pair_count, fac / sev) and the escape flags of its pairs below
        # pair_count; of each row past the screen its 14 row channels
        # (the host, app, proc and msgid spans, msg_trim_start, trim_end,
        # full_start, sd_count, sd[0]'s id span), pair_sd of each pair
        # below pair_count and the name and value spans of sd[0]'s pairs;
        # every row's bit, length and fac8 / sev8; operations: a few a
        # channel (counted as one a row)
        probe_bytes = (20 * n + 4 * pair_slots(gate)
                       + 56 * int(ref_base.sum()) + 4 * pair_slots(ref_base)
                       + 16 * pair_slots(ref_base, sd0) + 7 * N)
        probe_ops = n
    else:
        # bytes: each real row's valid bytes and length, every row's
        # outputs and five stamp channels, the carried channels of each
        # base tier row; operations: the decode's passes
        probe_bytes = (real_valid + 4 * n + 27 * N
                       + 4 * carry * int(ref_base.sum()))
        probe_ops = 9 * real_valid
    what = ", capnp_extra 2 pairs" if extras else ""
    out = [{
        "name": f"{base_name}_probe{tag}", **common, "max_abs_err": err_p,
        "ms": ms_p, "plain_ms": cuda_ms(p_probe, **PLAIN_TIMING),
        **bound(probe_bytes, probe_ops),
        "shape": f"[{N}, {L}], n={n}, {int(ref_base.sum())} base tier rows, "
                 f"{n_gate} rows past ok / has_high, {real_valid} valid "
                 f"bytes{what}"}]
    if not assemble:
        return out

    tier = ref_base & (ref[1] <= OW)
    gated = torch.where(tier, ref[1].to(torch.int64), 0)
    row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
    total = int(gated.sum())

    def k_asm():
        if not fused:
            return kernels.encode_capnp_cuda(batch, lens_c, packed, n, bank,
                                             table, OW, row_off=row_off,
                                             total=total)
        return kernels.fused_capnp_out_cuda(
            batch, lens_c, n, bank, table, OW=OW, row_off=row_off,
            total=total, chan=probed["chan"], tier=probed["tier"])

    def t_asm():
        # the timed call: FO/capnp's launch without its contract check,
        # which reads a flag back from the card
        if not fused:
            return k_asm()
        return kernels.fused_capnp_out_assemble_launch(
            batch, lens_c, n, bank, table, OW, row_off, total,
            probed["chan"])

    def p_asm():
        rows_, out_len, _ = device_capnp.encode_rows(
            batch, lens_c, dec0, suffix=suffix, extras=extras)
        return device_gelf.flat_rows(rows_, out_len, row_off, total)

    ref_flat = p_asm()
    if fused:
        # the wrapper's contract: no assemble without the probe's channels,
        # and none of a row outside the probe's tier
        def refused(**kw):
            try:
                kernels.fused_capnp_out_cuda(batch, lens_c, n, bank, table,
                                             OW=OW, total=total, **kw)
            except ValueError:
                return True
            return False

        outside = torch.nonzero(live & ~ref_base).flatten()[:1]
        bad_off = row_off.clone()
        bad_off[outside] = 0
        if (not refused(row_off=row_off, chan=None, tier=probed["tier"])
                or (outside.numel() and not refused(
                    row_off=bad_off, chan=probed["chan"],
                    tier=probed["tier"]))):
            raise AssertionError(f"{base_name} assemble ran against its "
                                 f"contract")

    def check_asm():
        err = max_abs_err(k_asm(), ref_flat)
        if err:
            raise AssertionError(f"{base_name}{tag} assemble [{N}, {L}] "
                                 f"n={n} disagrees with its plain version: "
                                 f"max_abs_err {err}")
        return err

    err_a = check_asm()
    ms_a = device_ms(t_asm)
    check_asm()   # a launch after the timing loop
    CHECKED.add((f"{base_name}_assemble{tag}", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    # bytes: the tier rows' valid bytes and lengths, the channels the
    # assemble reads (OC: 15 row channels, pair_sd of each pair below
    # pair_count and the name and value spans of sd[0]'s pairs; FO/capnp:
    # the carried row), the blob a tier row, every row's offset, the
    # output written; operations: one store a byte written
    blob = len(device_capnp._bank(suffix, tuple(extras))[2]["blob"])
    ch_bytes = (4 * carry * n_tier if fused
                else 60 * n_tier + 4 * pair_slots(tier)
                + 16 * pair_slots(tier, sd0))
    out.append({
        "name": f"{base_name}_assemble{tag}", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, **PLAIN_TIMING),
        **bound(tier_valid + 4 * n_tier + ch_bytes + blob * n_tier + 8 * N
                + total, total),
        "shape": f"[{N}, {L}], n={n}, {n_tier} tier rows, {total} output "
                 f"bytes{what}"})
    return out


def oc_cases(batch, lens_c, n: int, rows: list, shapes: list,
             where: str = "") -> None:
    """OC at 6 and 16 pairs and FO/capnp, probe and assemble, on one
    rfc5424 batch, without a ``capnp_extra`` and with :data:`CAPNP_EXTRA`:
    into ``rows`` (the kernel table's rows: the tier batch, no extra) when
    ``where`` is empty, else into ``shapes`` as ``kernel_shape`` lines;
    the extra cases always go to ``shapes``."""
    for kind, P in (("oc", 6), ("oc", 16), ("fo", 6)):
        for extras in ((), CAPNP_EXTRA):
            got = oc_case(kind, batch, lens_c, n, P=P, extras=extras)
            if not where and not extras:
                rows.extend(got)
            else:
                shapes.extend({**r, "where": where or "rfc5424 tier batch"}
                              for r in got)


def kernels_dns(seed: int, rows: list, shapes: list):
    """DN on a gathered [16384, 512] batch of the dns tier mix (and on the
    dns mix, edge rows included, as a shape line); AC with the dns flag on
    a gathered [16384, 512] batch of the auto mix with the dns leg."""
    from flowgger_tpu_torch.corpus import (make_auto_corpus, make_dns_corpus,
                                           make_dns_tier_corpus)

    batch, lens_c = gathered_batch(make_dns_tier_corpus(BATCH, seed + 62)[0])
    rows.append(dn_case(batch, lens_c, BATCH)[0])
    batch, lens_c = gathered_batch(make_dns_corpus(BATCH, seed + 63)[0])
    shapes.append({**dn_case(batch, lens_c, BATCH)[0],
                   "where": "dns mix with its edge rows"})
    batch, lens_c = gathered_batch(
        make_auto_corpus(BATCH, seed + 64, dns=True)[0])
    rows.append(ac_case(batch, lens_c, BATCH, dns=True))


def phase_kernels(seed: int):
    """Each kernel vs its plain version on the card; returns the table
    rows without launch counts (the e2e phase fills them in).  The
    table row of each kernel is taken at its line-framed main path's
    shape (K4: the syslen path's flush region); the ``kernel_shape``
    lines time the kernels at the e2e runs' other shapes."""
    rows, shapes = [], []
    kernels_line_path(seed, rows, shapes)
    kernels_syslen(seed, rows, shapes)
    kernels_jsonl(seed, rows, shapes)
    kernels_encode(seed, rows, shapes)
    kernels_rfc3164(seed, rows, shapes)
    kernels_ltsv(seed, rows, shapes)
    kernels_gelf(seed, rows, shapes)
    kernels_auto(seed, rows, shapes)
    kernels_ltsv_out(seed, rows, shapes)
    kernels_dns(seed, rows, shapes)
    for r in rows:
        emit({"phase": "kernel", **r})
    for r in shapes:
        emit({"phase": "kernel_shape", **r})
    return rows


def host_ms(fn, iters: int = 5) -> float:
    """Median host-clock ms of ``iters`` calls of ``fn`` after one
    unrecorded call."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def recorded_calls(module, attr: str, calls: list):
    """Records the arguments of each call of ``module.attr`` made inside
    the block."""
    fn = getattr(module, attr)

    def rec(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, attr, rec)
    try:
        yield calls
    finally:
        setattr(module, attr, fn)


@contextlib.contextmanager
def numpy_engine():
    """The GELF block encoder on its numpy engine (the JAX package's
    ``gelf_extra`` engine) inside the block: the package has no knob, so
    the engine check is patched."""
    from flowgger_tpu_torch import native

    avail = native.gelf_rows_available
    native.gelf_rows_available = lambda: False
    try:
        yield
    finally:
        native.gelf_rows_available = avail


@contextlib.contextmanager
def plain_gather():
    """Every segment gather on the plain numpy version inside the
    block (``concat_segments`` is imported by name in four modules)."""
    from flowgger_tpu_torch.tpu import (assemble, block_common,
                                        device_common, encode_gelf_block,
                                        encode_jsonl_block)

    mods = (assemble, block_common, device_common, encode_gelf_block,
            encode_jsonl_block)
    saved = [m.concat_segments for m in mods]
    for m in mods:
        m.concat_segments = assemble._concat_segments_np
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.concat_segments = fn


def _same_arrays(what: str, got, ref) -> None:
    import numpy as np

    for g, r in zip(got, ref):
        if isinstance(r, np.ndarray):
            if g.dtype != r.dtype or not np.array_equal(g, r):
                raise AssertionError(f"native {what} differs from its plain "
                                     f"version")
        elif g != r:
            raise AssertionError(f"native {what} differs from its plain "
                                 f"version: {g!r} vs {r!r}")


def phase_native(seed: int):
    """Each export of the native host tier (``csrc/flowgger_host.cpp``)
    against its plain numpy or Python version at the e2e runs' shapes,
    byte for byte, with the host-clock time of both: the timestamp text
    of the tier path's flush batch (~16 470 records) and the segment
    gather of its constant splice, the jsonl path's body gather, and the
    GELF row engine inside the block encoder against the numpy engine on
    the rfc5424 path's flush batch."""
    import numpy as np
    import torch

    from flowgger_tpu_torch import native
    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import (make_corpus, make_jsonl_corpus,
                                           make_tier_corpus)
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import (assemble, device_common, device_gelf,
                                        encode_gelf_block, encode_jsonl_block,
                                        framing)
    from flowgger_tpu_torch.tpu.batch import _ROUTES
    from flowgger_tpu_torch.tpu.rfc5424 import (decode_rfc5424_fetch,
                                                decode_rfc5424_submit)

    src = "flowgger_tpu_torch/csrc/flowgger_host.cpp"
    dev = torch.device("cuda")
    encoder, merger = GelfEncoder(Config.from_string("")), NulMerger()

    def case(name, export, replaces, fast, plain, work):
        got, ref = fast(), plain()
        _same_arrays(name, got, ref)
        row = {"phase": "native", "name": name, "export": export,
               "source": src, "replaces": replaces, "identical": True,
               "ms": host_ms(fast), "plain_ms": host_ms(plain), **work}
        emit(row)

    region, n = line_flush(make_tier_corpus(2 * BATCH, seed + 9)[0])

    # the tier path's flush batch through the device tier, recording the
    # splice's gather
    packed, _, _ = framing.device_frame_region(region, "line", MAX_LEN, n,
                                               dev)
    handle = decode_rfc5424_submit(packed[0], packed[1])
    kern = device_gelf._Rows(handle[1], handle[2], handle[0], handle[3], 6,
                             b"\0", ())
    small, _ = kern.small_channels(n)
    case("format_f64_json", "fg_format_f64_json",
         "native/flowgger_host.cpp:980",
         lambda: device_common.ts_text_block(small),
         lambda: device_common._ts_text_block_np(small),
         {"where": "tier path, flush batch stamps", "values": n,
          "distinct": int(np.unique(device_common._ts_vals(small)).size)})
    calls = []
    with recorded_calls(device_common, "concat_segments", calls):
        res, _ = device_gelf.fetch_encode(handle, packed, encoder, merger, {})
    if res is None or len(calls) != 1:
        raise AssertionError(f"the device tier did not take the tier path's "
                             f"flush batch through one splice ({len(calls)})")
    args = calls[0][0]
    case("concat_segments", "fg_concat_segments",
         "native/flowgger_host.cpp:893",
         lambda: (assemble.concat_segments(*args),),
         lambda: (assemble._concat_segments_np(*args),),
         {"where": "tier path, constant splice", "segments": int(
             args[1].size), "bytes": int(args[2].sum())})

    # the GELF row engine: the rfc5424 path's flush batch through the host
    # tier's block encoder with each engine
    rregion, rn = line_flush(make_corpus(2 * BATCH, seed + 3)[0])
    rpacked, _, _ = framing.device_frame_region(rregion, "line", MAX_LEN, rn,
                                                dev)
    host = decode_rfc5424_fetch(decode_rfc5424_submit(rpacked[0],
                                                      rpacked[1]))

    def encode():
        return encode_gelf_block.encode_rfc5424_gelf_block(
            rpacked[2], rpacked[3], rpacked[4], host, rpacked[5], MAX_LEN,
            encoder, merger)

    def encode_np():
        with numpy_engine():
            return encode()

    nat, nump = encode(), encode_np()
    if bytes(nat.block.data) != bytes(nump.block.data) or \
            nat.errors != nump.errors:
        raise AssertionError("the native and numpy GELF engines differ on "
                             "the rfc5424 flush batch")
    calls = []
    with recorded_calls(native, "gelf_rows_native", calls):
        encode()
    rargs = calls[0][0]
    # the JSON-lines block encoder's body gather on the jsonl path's
    # flush batch, and its whole block encode with the native gather and
    # with the plain one, alternating
    jregion, jn = line_flush(make_jsonl_corpus(2 * BATCH, seed + 7)[0])
    jpacked, _, _ = framing.device_frame_region(jregion, "line", MAX_LEN,
                                                jn, dev)
    jsubmit, jfetch, jencode = _ROUTES["jsonl"]
    jhost = jfetch(jsubmit(jpacked[0], jpacked[1]))

    def jenc():
        return jencode(jpacked[2], jpacked[3], jpacked[4], jhost, jpacked[5],
                       MAX_LEN, encoder, merger)

    calls = []
    with recorded_calls(encode_jsonl_block, "concat_segments", calls):
        jres = jenc()
    jargs = calls[-1][0]
    case("concat_segments", "fg_concat_segments",
         "native/flowgger_host.cpp:893",
         lambda: (assemble.concat_segments(*jargs),),
         lambda: (assemble._concat_segments_np(*jargs),),
         {"where": "jsonl path, block body", "segments": int(jargs[1].size),
          "bytes": int(jargs[2].sum())})
    ab = {"native": [], "plain": []}
    for i in range(10):
        side = ("native", "plain")[(i + i // 2) % 2]
        with contextlib.ExitStack() as stack:
            if side == "plain":
                stack.enter_context(plain_gather())
            t0 = time.perf_counter()
            res = jenc()
            ab[side].append((time.perf_counter() - t0) * 1e3)
        if bytes(res.block.data) != bytes(jres.block.data):
            raise AssertionError("the JSON-lines block encoder's output "
                                 "depends on its gather")
    emit({"phase": "native", "name": "jsonl_block_encode",
          "where": "jsonl path, flush batch", "records": jn,
          "oracle_rows": jres.fallback_rows, "gather_calls": len(calls),
          "ms_native_gather": ab["native"], "ms_plain_gather": ab["plain"]})

    emit({"phase": "native", "name": "gelf_rows",
          "export": "fg_gelf_lens_v2 + fg_gelf_write_v2", "source": src,
          "replaces": "native/flowgger_host.cpp:687, :701",
          "identical": True, "where": "rfc5424 line path, flush batch",
          "records": rn, "tier_rows": int(rargs[1].shape[0]),
          "engine_ms": host_ms(lambda: native.gelf_rows_native(*rargs)),
          "block_encode_ms": host_ms(encode),
          "oracle_rows": nat.fallback_rows,
          "numpy_block_encode_ms": host_ms(encode_np),
          "numpy_oracle_rows": nump.fallback_rows})


@contextlib.contextmanager
def stage_clock(module, walls: dict, **stages):
    """Adds the host-clock seconds of each call of ``module.<attr>``
    made inside the block to ``walls[key]``, for each ``key=attr`` of
    ``stages``: a block encoder's scalar-oracle rows (``finish_block``,
    which also splices them with the tier rows) and its timestamp text
    (``ts_scratch`` / ``span_f64_scratch``)."""
    saved = {attr: getattr(module, attr) for attr in stages.values()}

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                walls[key] = walls.get(key, 0.0) + time.perf_counter() - t0
        return run

    for key, attr in stages.items():
        walls.setdefault(key, 0.0)
        setattr(module, attr, timed(key, saved[attr]))
    try:
        yield walls
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)


def phase_breakdown(seed: int, fmt: str, n_batches: int = AB_BATCHES,
                    engine: str = "native", lines=None):
    """Host-clock walls of one path's stages, each ending in a
    synchronize, over ``n_batches`` full line regions: device framing
    (upload, span and gather kernels, span metadata back), decode
    (kernel, fetch, wider rescue), block encode (the engine, then the
    scalar oracle rows, timed apart), and the sink write.  ``engine =
    "numpy"`` runs the GELF block encoder on its numpy engine;
    ``lines`` replaces the corpus made from ``seed``.  Returns the
    written bytes."""
    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import (make_corpus, make_gelf_corpus,
                                           make_jsonl_corpus,
                                           make_ltsv_corpus)
    from flowgger_tpu_torch.decoders import LTSVDecoder
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import (encode_gelf_block,
                                        encode_gelf_gelf_block,
                                        encode_jsonl_block,
                                        encode_ltsv_gelf_block, framing)
    from flowgger_tpu_torch.tpu.batch import _ROUTES

    dev = torch.device("cuda")
    if lines is None:
        make = {"jsonl": make_jsonl_corpus, "ltsv": make_ltsv_corpus,
                "gelf": make_gelf_corpus}.get(fmt, make_corpus)
        lines, _ = make(n_batches * BATCH, seed + 1)
    submit, fetch, encode = _ROUTES[fmt]
    encoder, merger = GelfEncoder(Config.from_string("")), NulMerger()
    # the ltsv block encoder takes the scalar decoder (its oracle rows)
    extra = (LTSVDecoder(Config.from_string("")),) if fmt == "ltsv" else ()
    walls = {"frame": 0.0, "decode": 0.0, "encode": 0.0, "write": 0.0}
    inner = {}
    fallback = 0
    WORK.mkdir(parents=True, exist_ok=True)
    out = WORK / f"breakdown_{fmt}_{engine}.out"
    if fmt == "jsonl":
        module, stamps = encode_jsonl_block, "span_f64_scratch"
    elif fmt == "gelf":
        module, stamps = encode_gelf_gelf_block, "span_f64_scratch"
    elif fmt == "ltsv":
        module, stamps = encode_ltsv_gelf_block, "ts_scratch"
    else:
        module, stamps = encode_gelf_block, "ts_scratch"
    with contextlib.ExitStack() as stack:
        stack.enter_context(stage_clock(module, inner, oracle="finish_block",
                                        stamps=stamps))
        # the ltsv oracle rows' "Missing value" notices go to stdout
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        if engine == "numpy":
            stack.enter_context(numpy_engine())
        sink = stack.enter_context(open(out, "wb", buffering=0))
        for b in range(n_batches):
            region = b"\n".join(lines[b * BATCH:(b + 1) * BATCH]) + b"\n"
            t0 = time.perf_counter()
            packed, _, _ = framing.device_frame_region(region, "line",
                                                       MAX_LEN, BATCH, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = fetch(submit(packed[0], packed[1]))
            t2 = time.perf_counter()
            res = encode(packed[2], packed[3], packed[4], host, packed[5],
                         MAX_LEN, encoder, merger, *extra)
            t3 = time.perf_counter()
            sink.write(res.block.data)
            t4 = time.perf_counter()
            walls["frame"] += t1 - t0
            walls["decode"] += t2 - t1
            walls["encode"] += t3 - t2
            walls["write"] += t4 - t3
            fallback += res.fallback_rows
    total = sum(walls.values())
    # the engine's share includes its timestamp text, shown apart too
    walls["encode_engine"] = walls["encode"] - inner["oracle"]
    walls["encode_engine_stamps"] = inner["stamps"]
    walls["encode_oracle"] = inner["oracle"]
    emit({"phase": "breakdown", "format": fmt, "engine": engine,
          "lines": n_batches * BATCH, "wall_s": walls,
          "share": {k: v / total for k, v in walls.items()},
          "oracle_rows": fallback,
          "lines_per_s": n_batches * BATCH / total})
    return out.read_bytes()


def phase_breakdown_tier(seed: int, n_batches: int = AB_BATCHES,
                         tiers=("device", "host", "host_numpy"), lines=None):
    """The tier mix over ``n_batches`` full line regions three times on
    one card: through the device encode tier, its block encode split into
    the probe (phase 1 and wide), the timestamp text, assemble + fetch,
    the constant splice and the oracle rows (``finish_block``); then
    through the host tier (channels fetched, the block encoder's native
    engine, then its oracle rows, timed apart), and through the host tier
    on the numpy engine (``tiers`` picks some of the three).  Host
    clock, each stage ending in a synchronize or a fetch.  The three must
    write the same bytes.  ``lines`` replaces the corpus made from
    ``seed``.  Returns the bytes each wrote."""
    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import make_tier_corpus
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import device_gelf, encode_gelf_block, framing
    from flowgger_tpu_torch.tpu.batch import _ROUTES

    dev = torch.device("cuda")
    if lines is None:
        lines, _ = make_tier_corpus(n_batches * BATCH, seed + 4)
    submit, fetch, encode = _ROUTES["rfc5424"]
    encoder, merger = GelfEncoder(Config.from_string("")), NulMerger()
    WORK.mkdir(parents=True, exist_ok=True)
    outs = {}
    for tier in tiers:
        walls = {"frame": 0.0, "decode": 0.0, "write": 0.0}
        state, stages, fallback = {}, {}, 0
        inner = {}
        with contextlib.ExitStack() as stack:
            if tier != "device":
                stack.enter_context(stage_clock(
                    encode_gelf_block, inner, oracle="finish_block",
                    stamps="ts_scratch"))
            if tier == "host_numpy":
                stack.enter_context(numpy_engine())
            sink = stack.enter_context(open(
                WORK / f"breakdown_tier_{tier}.out", "wb", buffering=0))
            for b in range(n_batches):
                region = b"\n".join(lines[b * BATCH:(b + 1) * BATCH]) + b"\n"
                t0 = time.perf_counter()
                packed, _, _ = framing.device_frame_region(
                    region, "line", MAX_LEN, BATCH, dev)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                handle = submit(packed[0], packed[1])
                if tier == "device":
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    res, _ = device_gelf.fetch_encode(
                        handle, packed, encoder, merger, state,
                        timings=stages)
                    if res is None:
                        raise AssertionError(f"the device tier declined "
                                             f"batch {b} of the tier mix")
                else:
                    host = fetch(handle)
                    t2 = time.perf_counter()
                    res = encode(packed[2], packed[3], packed[4], host,
                                 packed[5], MAX_LEN, encoder, merger)
                    stages["block_encode"] = stages.get(
                        "block_encode", 0.0) + time.perf_counter() - t2
                t3 = time.perf_counter()
                sink.write(res.block.data)
                t4 = time.perf_counter()
                walls["frame"] += t1 - t0
                walls["decode"] += t2 - t1
                walls["write"] += t4 - t3
                fallback += res.fallback_rows
        outs[tier] = (WORK / f"breakdown_tier_{tier}.out").read_bytes()
        walls.update(stages)
        total = sum(walls.values())
        if tier != "device":
            walls["block_encode_engine"] = (walls["block_encode"]
                                            - inner["oracle"])
            walls["block_encode_engine_stamps"] = inner["stamps"]
            walls["block_encode_oracle"] = inner["oracle"]
        emit({"phase": "breakdown", "format": "rfc5424_tier", "tier": tier,
              "lines": n_batches * BATCH, "wall_s": walls,
              "share": {k: v / total for k, v in walls.items()},
              "oracle_rows": fallback, "route_state": state,
              "lines_per_s": n_batches * BATCH / total})
    if len(set(outs.values())) > 1:
        raise AssertionError("the device tier and the host tier's two "
                             "engines wrote different bytes for the tier "
                             "mix")
    return outs


# e2e configurations: name -> (input.format, input.framing, the scalar
# expectation's fmt, the kernels its run must launch, and for the tier
# mixes the kernels a second run with input.tpu_fuse = "off" must launch)
PATHS = {
    "rfc5424_line": ("rfc5424_tpu", "line", "rfc5424",
                     ("frame_sep_spans", "frame_gather",
                      "fused_rfc5424_gelf_probe", "decode_rfc5424_p6",
                      "decode_rfc5424_p16"), None),
    "jsonl_line": ("jsonl_tpu", "line", "jsonl",
                   ("frame_sep_spans", "frame_gather", "structural_index_f8",
                    "structural_index_f24"), None),
    "rfc5424_syslen": ("rfc5424_tpu", "syslen", "rfc5424",
                       ("frame_syslen_spans", "frame_gather",
                        "fused_rfc5424_gelf_probe", "decode_rfc5424_p6"),
                       None),
    # the mix the device encode tiers take (corpus.make_tier_corpus): no
    # batch may decline; the fused route takes every batch, and with
    # tpu_fuse = "off" the split tier does
    "rfc5424_tier": ("rfc5424_tpu", "line", "rfc5424",
                     ("frame_sep_spans", "frame_gather",
                      "fused_rfc5424_gelf_probe",
                      "fused_rfc5424_gelf_assemble"),
                     ("frame_sep_spans", "frame_gather", "decode_rfc5424_p6",
                      "encode_gelf_probe_p6", "encode_gelf_assemble_p6")),
    # one day of BSD syslog (corpus.make_rfc3164_corpus, the 17th: layout
    # A), not chosen to engage the tiers
    "rfc3164_line": ("rfc3164_tpu", "line", "rfc3164",
                     ("frame_sep_spans", "frame_gather",
                      "fused_rfc3164_gelf_probe", "decode_rfc3164",
                      "encode_gelf3164_probe"), None),
    # the rfc3164 mix the tiers take (corpus.make_rfc3164_tier_corpus, the
    # 7th: layout C)
    "rfc3164_tier": ("rfc3164_tpu", "line", "rfc3164",
                     ("frame_sep_spans", "frame_gather",
                      "fused_rfc3164_gelf_probe",
                      "fused_rfc3164_gelf_assemble"),
                     ("frame_sep_spans", "frame_gather", "decode_rfc3164",
                      "encode_gelf3164_probe", "encode_gelf3164_assemble")),
    # LTSV access-log rows with ltsv.org's labels (corpus.make_ltsv_corpus:
    # 8-14 pairs, 20 % Apache stamps), not chosen to engage the tiers: the
    # 6-pair tier declines, the 16-pair escalation is probed
    "ltsv_line": ("ltsv_tpu", "line", "ltsv",
                  ("frame_sep_spans", "frame_gather", "fused_ltsv_gelf_probe",
                   "decode_ltsv", "encode_gelf_ltsv_probe_p6",
                   "encode_gelf_ltsv_probe_p16"), None),
    # the ltsv mix the tiers take (corpus.make_ltsv_tier_corpus)
    "ltsv_tier": ("ltsv_tpu", "line", "ltsv",
                  ("frame_sep_spans", "frame_gather", "fused_ltsv_gelf_probe",
                   "fused_ltsv_gelf_assemble"),
                  ("frame_sep_spans", "frame_gather", "decode_ltsv",
                   "encode_gelf_ltsv_probe_p6",
                   "encode_gelf_ltsv_assemble_p6")),
    # GELF 1.1 payloads as Graylog defines them (corpus.make_gelf_corpus:
    # 8-14 fields, floats, escaped full messages), not chosen to engage
    # the tiers: the 8-field tier declines, the 16-field escalation is
    # probed, the host path rescues rows at 24 fields
    "gelf_line": ("gelf_tpu", "line", "gelf",
                  ("frame_sep_spans", "frame_gather", "fused_gelf_gelf_probe",
                   "structural_index_flat_f8", "structural_index_flat_f16",
                   "structural_index_flat_f24", "encode_gelf_gelf_probe_f8",
                   "encode_gelf_gelf_probe_f16"), None),
    # the gelf mix the tiers take (corpus.make_gelf_tier_corpus)
    "gelf_tier": ("gelf_tpu", "line", "gelf",
                  ("frame_sep_spans", "frame_gather", "fused_gelf_gelf_probe",
                   "fused_gelf_gelf_assemble"),
                  ("frame_sep_spans", "frame_gather",
                   "structural_index_flat_f8", "encode_gelf_gelf_probe_f8",
                   "encode_gelf_gelf_assemble_f8")),
}
# the wrappers whose launch shapes the e2e runs record (checked against
# CHECKED), and each one's name in LAUNCHES for a launch
SHAPE_CHECKED = ("encode_gelf_cuda", "encode_gelf3164_cuda",
                 "fused_gelf_cuda", "decode_rfc3164_cuda",
                 "decode_rfc5424_cuda", "decode_ltsv_cuda",
                 "encode_gelf_ltsv_cuda", "encode_gelf_gelf_cuda")
# the kernels whose e2e launch shapes follow the data (K1: a rescue
# sub-batch's rows; the ltsv and gelf kernels: a flush's record count,
# which a timer flush cuts where it falls): their shapes in the e2e runs
# that the kernels phase did not check are held against the plain
# versions after the runs, by phase_late_shapes
LATE_PREFIXES = ("decode_rfc5424_p", "decode_ltsv", "encode_gelf_ltsv",
                 "fused_ltsv_gelf", "encode_gelf_gelf", "fused_gelf_gelf")
LATE: set = set()
# the PATHS that run in process only: the tier mixes (their line mixes
# drive the same configurations through the CLI), since the overlap
# executor came the syslen and jsonl line mixes, and since the transports
# came the ltsv and gelf line mixes (rfc5424_line drives the GELF
# output's CLI; the CPU tests hold their CLIs against the JAX package)
INPROC_ONLY = ("rfc5424_tier", "rfc3164_tier", "ltsv_tier", "gelf_tier",
               "rfc5424_syslen", "jsonl_line", "ltsv_line", "gelf_line")
# the OVERLAP_PATHS runs' inputs and scalar expectations, for
# phase_overlap_ab: name -> (lines, seed, input path, input bytes, bytes,
# (stderr, stdout))
EXPECTED: dict = {}


# -- the scalar expectations, made in worker processes ----------------------
# Each e2e path's input and its scalar expectation (the host's reference
# path, record by record in Python) are made by a pool of worker
# processes started before the build (start_expectations), so that they
# overlap the build, kernels, native and A/B phases; an e2e phase then
# waits only for its own result (expected()), its CLI run and its
# in-process runs.  A job is a plain dict (name, family, lines, seed, the
# path's table entry and the scratch directory), so a worker needs none
# of the parent's state.  The worker writes <name>.in, <name>.exp (the
# expected bytes) and <name>.exp.json (stderr and stdout lines, the
# input's SHA-256, when its wall-clock window began, the mix); the
# parent checks the hash against the input file it runs and fails on a
# mismatch.  The pool uses the spawn start method (the parent holds a
# CUDA context by then, and forking one is unsafe), one intra-op thread
# a worker, and leaves two cores to the parent's build and kernels.
POOL: dict = {"executor": None, "jobs": {}, "workers": 0, "wait_s": 0.0,
        "started": 0.0, "done": 0.0}


def _pool_init() -> None:
    """A worker's start: one intra-op thread (set before torch loads)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)


def pool_workers() -> int:
    """Cores this process may use, less two for the parent's build and
    kernel phases; at least one."""
    return max(1, len(os.sched_getaffinity(0)) - 2)


def _job_key(job: dict) -> str:
    return json.dumps(job, sort_keys=True, default=str)


def submit_expectation(job: dict) -> None:
    """Queue ``job`` on the pool (started with one worker if no pool
    runs); a job already queued is not queued again."""
    key = _job_key(job)
    if key in POOL["jobs"]:
        return
    if POOL["executor"] is None:
        start_expectations([], workers=1)
    future = POOL["executor"].submit(make_expected, job)
    # when the pool's last job so far finished, from the pool's start
    future.add_done_callback(lambda f: POOL.update(
        done=max(POOL["done"], time.perf_counter() - POOL["started"])))
    POOL["jobs"][key] = future


def start_expectations(jobs: list, workers: int = 0) -> int:
    """Start the pool (``workers`` processes, default
    :func:`pool_workers`) and queue ``jobs`` in the order the phases
    take them; returns the pool's size."""
    import concurrent.futures
    import multiprocessing

    if POOL["executor"] is None:
        POOL["workers"] = workers or pool_workers()
        POOL["started"] = time.perf_counter()
        POOL["executor"] = concurrent.futures.ProcessPoolExecutor(
            max_workers=POOL["workers"],
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_pool_init)
    for job in jobs:
        submit_expectation(job)
    return POOL["workers"]


def wait_expectations() -> None:
    """Block until every queued job is done (the seconds blocked add to
    ``POOL["wait_s"]``), so that the pool's workers load no core while a
    phase takes its host-clock rates."""
    import concurrent.futures

    t0 = time.perf_counter()
    concurrent.futures.wait(list(POOL["jobs"].values()))
    POOL["wait_s"] += time.perf_counter() - t0


def close_expectations() -> None:
    """Stop the pool's processes (queued jobs are cancelled)."""
    executor = POOL["executor"]
    POOL.update(executor=None, jobs={}, workers=0, done=0.0)
    if executor is not None:
        executor.shutdown(wait=True, cancel_futures=True)


def _paths_job(name: str, n_lines: int, seed: int) -> dict:
    return {"family": "paths", "name": name, "lines": n_lines, "seed": seed,
            "entry": list(PATHS[name][:3]), "work": str(WORK)}


def _mixed_job(name: str, seed: int) -> dict:
    fmt, _, _, kind, n_lines, _ = MIXED_PATHS[name]
    in_t, out_t = _mixed_tables(name)
    return {"family": "mixed", "name": name, "lines": n_lines, "seed": seed,
            "entry": [fmt, kind, in_t, out_t], "work": str(WORK)}


def _out_job(name: str, seed: int) -> dict:
    from flowgger_tpu_torch import corpus

    fmt_in, keys, output, kind, n_lines, maker = OUT_PATHS[name][:6]
    in_t = getattr(corpus, keys) if keys.startswith("LTSV") else \
        ("[input]\n" + keys if keys else "")
    return {"family": "out", "name": name, "lines": n_lines, "seed": seed,
            "entry": [keys, output, kind, maker, in_t, _out_keys(name),
                      _out_framing(name)], "work": str(WORK)}


def _sinks_job(seed: int) -> dict:
    return {"family": "redis_kafka", "name": "redis_kafka",
            "lines": REDIS_KAFKA_LINES, "seed": seed, "entry": [],
            "work": str(WORK)}


def expectation_jobs(seed: int, lines: int) -> list:
    """Every e2e path's job, in the order the phases take them: PATHS,
    MIXED_PATHS, OUT_PATHS, the sinks phase's redis_kafka, then the
    serving phase's."""
    return ([_paths_job(name, path_lines(name, lines), seed)
             for name in PATHS]
            + [_mixed_job(name, seed) for name in MIXED_PATHS]
            + [_out_job(name, seed) for name in OUT_PATHS]
            + [_sinks_job(seed)] + serving_jobs(seed, lines))


def _write_input(job: dict):
    """A job's input: written to ``<work>/<name>.in``; returns (path,
    bytes, mix: {row kind: count})."""
    from flowgger_tpu_torch import corpus

    name, n_lines, seed = job["name"], job["lines"], job["seed"]
    family = job["family"]
    if family == "paths":
        fmt, framing, kind = job["entry"]
        make = {"jsonl_line": corpus.make_jsonl_corpus,
                "rfc5424_tier": corpus.make_tier_corpus,
                "rfc3164_line": corpus.make_rfc3164_corpus,
                "rfc3164_tier": corpus.make_rfc3164_tier_corpus,
                "ltsv_line": corpus.make_ltsv_corpus,
                "ltsv_tier": corpus.make_ltsv_tier_corpus,
                "gelf_line": corpus.make_gelf_corpus,
                "gelf_tier": corpus.make_gelf_tier_corpus
                }.get(name, corpus.make_corpus)
        lines, kinds = make(n_lines, seed)
    elif family == "mixed":
        kind = job["entry"][1]
        if kind == "auto":
            lines, kinds = corpus.make_auto_corpus(
                n_lines, seed + 51, tier=name == "auto_tier")
            kinds = [k.split(":")[0] for k in kinds]
        else:
            lines, kinds = {"rfc5424": corpus.make_corpus,
                            "rfc3164": corpus.make_rfc3164_corpus,
                            "ltsv": corpus.make_ltsv_corpus,
                            "gelf": corpus.make_gelf_corpus,
                            "jsonl": corpus.make_jsonl_corpus
                            }[kind](n_lines, seed + 52)
    elif family == "out":
        keys, maker = job["entry"][0], job["entry"][3]
        make = getattr(corpus, maker)
        if maker == "make_auto_corpus":
            lines, kinds = make(n_lines, seed + 71, dns="dns" in keys)
            kinds = [k.split(":")[0] for k in kinds]
        else:
            lines, kinds = make(n_lines, seed + 71)
    elif family == "serving":
        lines, kinds, newline = _serving_input(job)
    else:
        lines, kinds = corpus.make_corpus(n_lines, seed)
    if family == "paths" and job["entry"][1] == "syslen":
        # the last frame is cut short: a short read at EOF
        data = corpus.syslen_stream(lines)
    elif family == "redis_kafka":
        # one message a list element: NUL-joined, so that the records
        # keep their CRs (no line framing strips them)
        data = b"\0".join(lines)
    elif family == "serving" and newline:
        data = b"\n".join(lines) + b"\n"
    else:
        # the last record has no newline: the end-of-stream partial frame
        data = b"\n".join(lines)
    path = Path(job["work"]) / f"{name}.in"
    path.write_bytes(data)
    mix = {k: kinds.count(k) for k in sorted(set(kinds))}
    return path, data, mix


def _expectation(job: dict, data: bytes):
    """The scalar path's bytes, stderr lines and stdout lines (the ltsv
    decoder's "Missing value" notices) for a job's input."""
    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import scalar_expectation
    from flowgger_tpu_torch.mergers import (LineMerger, NulMerger,
                                            SyslenMerger)

    notices = []
    family = job["family"]
    if family == "paths":
        _, framing, kind = job["entry"]
        exp_out, exp_err = scalar_expectation(data, framing, fmt=kind,
                                              notices=notices)
    elif family == "mixed":
        _, kind, in_t, out_t = job["entry"]
        exp_out, exp_err = scalar_expectation(
            data, "line", config=Config.from_string(in_t + out_t), fmt=kind,
            notices=notices)
    elif family == "out":
        _, output, kind, _, in_t, out_keys, framing = job["entry"]
        merger = {"noop": None, "nul": NulMerger(), "line": LineMerger(),
                  "syslen": SyslenMerger()}[framing]
        exp_out, exp_err = scalar_expectation(
            data, "line",
            config=Config.from_string(in_t + "[output]\n" + out_keys),
            merger=merger, fmt=kind, notices=notices, output=output)
    elif family == "serving":
        exp_out, exp_err = scalar_expectation(
            data, record_hook=(serving_enricher()
                               if job["name"] == "serving_enrich" else None))
    else:
        # redis_kafka: each list element reaches the handler whole
        exp_out, exp_err = scalar_expectation(data, "message", merger=None,
                                              output="capnp")
    return exp_out, exp_err, notices


def make_expected(job: dict) -> str:
    """A worker's job: the input and its scalar expectation, written next
    to it (the bytes last but one, the JSON last: its presence says the
    rest is whole)."""
    import hashlib

    path, data, mix = _write_input(job)
    # a row without a timestamp is stamped with the wall clock from here
    # on (the runs that read this come later)
    since = time.time()
    exp_out, exp_err, notices = _expectation(job, data)
    meta = {"job": job, "sha256": hashlib.sha256(data).hexdigest(),
            "since": since, "stderr": exp_err, "stdout": notices,
            "mix": mix, "input_bytes": len(data)}
    for suffix, payload in ((".exp", exp_out),
                            (".exp.json", json.dumps(meta).encode())):
        dst = path.with_suffix(suffix)
        tmp = dst.with_name(dst.name + ".tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, dst)
    return str(path)


def expected(job: dict):
    """A job's result for the phase that runs it, waiting for the pool
    (the seconds blocked add to ``POOL["wait_s"]``): (input path, input
    bytes, expected bytes, stderr lines, stdout lines, wall-clock window
    start, mix).  Fails if the input file's SHA-256 is not the one the
    expectation was made from."""
    import hashlib

    submit_expectation(job)
    t0 = time.perf_counter()
    path = Path(POOL["jobs"][_job_key(job)].result())
    POOL["wait_s"] += time.perf_counter() - t0
    meta = json.loads(path.with_suffix(".exp.json").read_text())
    data = path.read_bytes()
    if (hashlib.sha256(data).hexdigest() != meta["sha256"]
            or meta["job"] != job):
        raise AssertionError(f"{job['name']}: the input file is not the one "
                             f"its scalar expectation was made from")
    return (path, data, path.with_suffix(".exp").read_bytes(),
            meta["stderr"], meta["stdout"], meta["since"], meta["mix"])


def path_lines(name: str, lines: int) -> int:
    """The lines of a PATHS run (``lines``: the rfc5424 line runs')."""
    return {"rfc5424_syslen": SYSLEN_LINES, "jsonl_line": JSONL_LINES,
            "rfc3164_line": RFC3164_LINES,
            "rfc3164_tier": TIER_LINES, "ltsv_line": LTSV_LINES,
            "ltsv_tier": TIER_LINES, "gelf_line": GELF_LINES,
            "gelf_tier": TIER_LINES,
            "rfc5424_tier": TIER_LINES}.get(name, lines)


# when each path's wall-clock window began (its worker's expectation)
STAMPED_SINCE: dict = {}
# lines/s of in-process runs the transports phase reports beside its own:
# "e2e_<path>" (the e2e run, fused route auto) and "overlap_<path>" (the
# overlap_ab medians at the default window)
RATES: dict = {}


def same_bytes(name: str, got: bytes, want: bytes) -> bool:
    """A run's GELF bytes against the scalar path's.  The gelf paths stamp
    a row without a timestamp with the wall clock (the scalar decoder
    does, in the reference too), so their stamps from the expectation's
    making on are compared apart: masked on both sides
    (``corpus.mask_wall_stamps``)."""
    if PATHS[name][2] != "gelf":
        return got == want
    from flowgger_tpu_torch.corpus import mask_wall_stamps

    since = STAMPED_SINCE[name] - 1.0
    return mask_wall_stamps(got, since) == mask_wall_stamps(want, since)


def _config(name: str, tag: str, fuse: str = "auto",
            extra: str = "") -> Path:
    fmt, framing, _, _, _ = PATHS[name]
    out = WORK / f"{name}_{tag}.out"
    cfg = WORK / f"{name}_{tag}.toml"
    cfg.write_text(
        f'[input]\ntype = "stdin"\nformat = "{fmt}"\nframing = "{framing}"\n'
        f'tpu_fuse = "{fuse}"\n' + extra +
        f'[output]\ntype = "file"\nformat = "gelf"\nfile_path = "{out}"\n')
    if out.exists():
        out.unlink()
    return cfg


_UNABLE = "Unable to parse the rfc3164 input: "


def same_stderr(kind: str, got: list, want: list) -> bool:
    """The stderr lines of a run against the scalar path's.  The rfc3164
    decoder prints its own line for a row both of its layouts reject,
    when the oracle runs it; the batched path runs a batch's oracle rows
    before it prints their error lines, so for rfc3164 each of the two
    kinds of line must come in the scalar path's order on its own."""
    if kind != "rfc3164":
        return got == want

    def split(lines):
        return ([ln for ln in lines if ln.startswith(_UNABLE)],
                [ln for ln in lines if not ln.startswith(_UNABLE)])

    return split(got) == split(want)


@contextlib.contextmanager
def launch_shapes(wrappers=SHAPE_CHECKED):
    """Collects the (kernel name, batch shape) of each launch made inside
    the block by ``wrappers`` (default :data:`SHAPE_CHECKED`; the
    launches the wrapper counted on its own thread say which entry ran:
    the ingest thread and the lanes' fetcher threads launch at once)."""
    import torch

    from flowgger_tpu_torch.tpu import kernels

    seen = set()
    saved = {w: getattr(kernels, w) for w in wrappers}
    launched = kernels._launched
    local = threading.local()

    def logging_launched(name):
        launched(name)
        log = getattr(local, "log", None)
        if log is not None:
            log.append(name)

    def recording(launch):
        def run(*args, **kw):
            batch = next(a for a in args if isinstance(a, torch.Tensor))
            outer = getattr(local, "log", None)
            local.log = []
            try:
                res = launch(*args, **kw)
                seen.update((k, tuple(batch.shape)) for k in local.log)
            finally:
                if outer is not None:
                    outer.extend(local.log)
                local.log = outer
            return res
        return run

    kernels._launched = logging_launched
    for w, fn in saved.items():
        setattr(kernels, w, recording(fn))
    try:
        yield seen
    finally:
        kernels._launched = launched
        for w, fn in saved.items():
            setattr(kernels, w, fn)


class CliRun:
    """``python -m flowgger_tpu_torch cfg`` with ``path`` as stdin, started
    in a subprocess at once, so that the caller can do other work
    meanwhile.  :meth:`result` waits for it; leaving the ``with`` block
    kills it if it still runs."""

    def __init__(self, cfg: Path, path: Path):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self._stdin = open(path, "rb")
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "flowgger_tpu_torch", str(cfg)],
            stdin=self._stdin, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env, cwd=str(ROOT))
        self._out = None
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        out, err = self.proc.communicate()
        self._out = (self.proc.returncode, out, err,
                     time.perf_counter() - self._t0)

    def result(self, timeout: float = 600.0):
        """(exit code, stdout bytes, stderr bytes, wall seconds)."""
        self._waiter.join(timeout)
        if self._out is None:
            raise AssertionError(f"the CLI run did not end in {timeout} s")
        return self._out

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._stdin.close()


# the in-process runs held to a closed decode breaker with no trip
BREAKER_CLOSED: list = []


def breaker_closed(pipe, name: str) -> None:
    """Fail unless a run's batch handler (a ``*_tpu`` pipeline's) kept its
    decode breaker — on by default — closed with no trip: the breaker
    moves no configuration of the e2e, transports and sinks phases off
    the card."""
    handler = getattr(pipe, "_handler", None)
    if handler is None:
        return
    br = handler._breaker
    if br is None or br.state != "closed" or br.trips:
        raise AssertionError(f"{name}: the decode breaker is "
                             f"{br and br.state} after {br and br.trips} "
                             f"trips")
    BREAKER_CLOSED.append(name)


def run_inproc(cfg: Path, path: Path, breaker: bool = True):
    """One run through ``flowgger_tpu_torch.start`` on ``cuda`` with
    ``path`` as stdin: (wall seconds, pipeline, stderr lines, stdout
    lines: the ltsv decoder's notices).  Unless ``breaker`` is False, the
    run's decode breaker must have stayed closed (:func:`breaker_closed`)."""
    import torch

    import flowgger_tpu_torch

    err_buf, out_buf = io.StringIO(), io.StringIO()
    saved_stdin = sys.stdin
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with open(path, "rb") as raw, contextlib.redirect_stderr(err_buf), \
                contextlib.redirect_stdout(out_buf):
            sys.stdin = io.TextIOWrapper(io.BufferedReader(raw))
            pipe = flowgger_tpu_torch.start(str(cfg), device="cuda")
    finally:
        sys.stdin = saved_stdin
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if breaker:
        breaker_closed(pipe, cfg.stem)
    return (wall, pipe, err_buf.getvalue().splitlines(),
            out_buf.getvalue().splitlines())


_STATE_KEYS = ("taken", "declined", "cooled", "wide", "tier_rows")
_ECON = "route economics ["


def econ_split(lines: list):
    """A run's stderr lines without the route-economics switch notices
    (they follow the measured speeds, not the records), and the notices
    apart."""
    return ([ln for ln in lines if not ln.startswith(_ECON)],
            [ln for ln in lines if ln.startswith(_ECON)])


def _tier_report(state: dict) -> dict:
    """One tier's batches taken, declined (over 5 % of rows outside it)
    and skipped in cooldown, its rows, the batches the route economics
    sent past it (``econ``: to the host tier, or from the fused route to
    the split path), and bytes fetched and emitted a tier row."""
    rows = state.get("tier_rows", 0)
    rep = {k: state.get(k, 0) for k in _STATE_KEYS}
    rep["econ"] = state.get("econ_host", 0) + state.get("econ_split", 0)
    rep.update(
        fetch_bytes=state.get("fetch_bytes", 0),
        fetch_bytes_per_tier_row=state.get("fetch_bytes", 0) / max(rows, 1),
        emit_bytes_per_tier_row=state.get("emit_bytes", 0) / max(rows, 1))
    return rep


# the key a tier mix's taker runs add: the taker must take every batch
ECON_OFF = "tpu_encode_economics = false\n"


def _econ_tag(fuse: str, econ: bool) -> str:
    return ("inproc" if fuse == "auto" else f"inproc_{fuse}") + \
        ("" if econ else "_noecon")


def e2e_inproc(name: str, path: Path, exp_out: bytes, exp_err: tuple,
               checked, fuse: str, econ: bool = True):
    """One in-process run of a configuration with ``input.tpu_fuse =
    fuse`` (and ``input.tpu_encode_economics = false`` unless ``econ``),
    every launch count reset just before and read just after;
    fails unless its bytes and stderr are the scalar path's, it launched
    every kernel of its path, and the tiers' counts agree with the
    launches.  Returns the report."""
    from flowgger_tpu_torch import native
    from flowgger_tpu_torch.tpu import batch as batch_mod
    from flowgger_tpu_torch.tpu import framing, kernels

    fmt_in, _, kind, need, need_split = PATHS[name]
    tag = _econ_tag(fuse, econ)
    cfg = _config(name, tag, fuse, "" if econ else ECON_OFF)
    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    native.reset_calls()
    host_tier = {"batches": 0, "with_tier_rows": 0}
    # the host tier's block encodes, and those with tier rows apart
    submit, fetch, encode = batch_mod._ROUTES[kind]

    def counted(*args, **kw):
        res = encode(*args, **kw)
        host_tier["batches"] += 1
        host_tier["with_tier_rows"] += int(args[4]) > res.fallback_rows
        return res

    batch_mod._ROUTES[kind] = (submit, fetch, counted)
    try:
        with launch_shapes() as seen:
            wall, pipe, errs, notices = run_inproc(cfg, path)
    finally:
        batch_mod._ROUTES[kind] = (submit, fetch, encode)
    errs, econ_notices = econ_split(errs)
    exp_err, exp_notices = exp_err
    launches = dict(kernels.LAUNCHES)
    calls = dict(native.CALLS)
    declines = dict(framing.DECLINES)
    got = (WORK / f"{name}_{tag}.out").read_bytes()
    if (not same_bytes(name, got, exp_out)
            or not same_stderr(kind, errs, exp_err)
            or notices != exp_notices):
        raise AssertionError(
            f"{name} ({fuse}): in-process e2e differs from the scalar path: "
            f"bytes {len(got)} vs {len(exp_out)}, equal="
            f"{same_bytes(name, got, exp_out)}; "
            f"stderr lines {len(errs)} vs {len(exp_err)}; stdout lines "
            f"{len(notices)} vs {len(exp_notices)}")
    need = need if fuse == "auto" else need_split
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} ({fuse}): the run launched no "
                             f"{missing} kernel")
    if any(declines.values()):
        raise AssertionError(f"{name}: device framing declined {declines}")
    if checked is not None:
        late = {(k, v) for k, v in seen - checked
                if k.startswith(LATE_PREFIXES)}
        LATE.update(late)
        if seen - checked - late:
            raise AssertionError(f"{name}: kernels launched at shapes the "
                                 f"kernels phase did not check: "
                                 f"{sorted(seen - checked - late)}")
    rstate = pipe._handler.route_state
    split = _tier_report(rstate.get(kind, {}))
    fused = _tier_report(rstate.get(f"fused:{kind}_gelf", {}))
    # one probe a probed batch (taken or declined; a cooled batch is not
    # probed) and one assemble a taken batch, on each tier; the split
    # rfc5424 tier's 16-pair probes are its wide attempts, counted apart
    e_probe, e_asm = {
        "rfc5424": ("encode_gelf_probe_p6", ("encode_gelf_assemble_p6",
                                             "encode_gelf_assemble_p16")),
        "ltsv": ("encode_gelf_ltsv_probe_p6",
                 ("encode_gelf_ltsv_assemble_p6",
                  "encode_gelf_ltsv_assemble_p16")),
        "gelf": ("encode_gelf_gelf_probe_f8",
                 ("encode_gelf_gelf_assemble_f8",
                  "encode_gelf_gelf_assemble_f16")),
    }.get(kind, ("encode_gelf3164_probe", ("encode_gelf3164_assemble",)))
    if kind in ("rfc5424", "rfc3164", "ltsv", "gelf"):
        f_name = f"fused_{kind}_gelf"
        if (launches[e_probe] != split["taken"] + split["declined"]
                or sum(launches[k] for k in e_asm) != split["taken"]
                or launches[f"{f_name}_probe"]
                != fused["taken"] + fused["declined"]
                or launches[f"{f_name}_assemble"] != fused["taken"]):
            raise AssertionError(f"{name} ({fuse}): {launches} for split "
                                 f"{split} and fused {fused}: not one probe "
                                 f"a probed batch and one assemble a taken "
                                 f"batch")
        if kind == "rfc5424":
            split["wide_probes"] = launches["encode_gelf_probe_p16"]
        if kind == "ltsv":
            split["wide_probes"] = launches["encode_gelf_ltsv_probe_p16"]
        if kind == "gelf":
            split["wide_probes"] = launches["encode_gelf_gelf_probe_f16"]
    # the native host tier: its row engine wrote every rfc5424 host-tier
    # batch with tier rows, and its formatter every taken batch's
    # timestamp text (split or fused)
    rfc = kind == "rfc5424"
    if (calls["fg_gelf_write_v2"] != (host_tier["with_tier_rows"] if rfc
                                      else 0)
            or calls["fg_gelf_lens_v2"] != calls["fg_gelf_write_v2"]
            or (kind in ("rfc5424", "rfc3164", "ltsv", "gelf")
                and host_tier["batches"]
                != split["declined"] + split["cooled"] + split["econ"])
            or calls["fg_format_f64_json"]
            != split["taken"] + fused["taken"]):
        raise AssertionError(f"{name} ({fuse}): native calls {calls} for "
                             f"host-tier batches {host_tier}, split {split}, "
                             f"fused {fused}")
    if name in COOLING and fuse == "auto" and not all(
            t["declined"] and t["cooled"] for t in (fused, split)):
        raise AssertionError(f"{name}: the tiers did not decline and then "
                             f"cool: fused {fused}, split {split}")
    if name.endswith("_tier"):
        # the tier mixes: the fused route takes every batch (the split
        # tier sees none), or with the fused route off the split tier
        # does; fewer bytes fetched than emitted a tier row
        took, idle = (fused, split) if fuse == "auto" else (split, fused)
        if not econ:
            check_tier_mix(f"{name} ({fuse})", took, idle)
    return {"fuse": fuse, "economics_on": econ, "launches": launches,
            "framing_declines": declines,
            "fused_route": fused, "split_tier": split, "native_calls": calls,
            "host_tier_batches": host_tier,
            "economics": pipe._handler.economics(),
            "economics_notices": econ_notices,
            "launch_shapes": sorted(f"{k} {list(v)}" for k, v in seen),
            "inproc_wall_s": wall,
            "inproc_lines_per_s": None}


def check_tier_mix(what: str, took: dict, idle: dict) -> None:
    """A tier mix, run with the route economics off: the tier that takes
    it takes every batch (it declines none, cools none and sends none
    past itself), the other tier sees none, and the taker fetches fewer
    bytes than it emits a tier row."""
    if (took["declined"] or took["cooled"] or took["econ"]
            or not took["taken"]
            or any(idle[k] for k in _STATE_KEYS + ("econ",))
            or took["fetch_bytes_per_tier_row"]
            >= took["emit_bytes_per_tier_row"]):
        raise AssertionError(f"{what}: the tier did not take every batch "
                             f"under the emitted bytes: taker {took}, "
                             f"other {idle}")


# the line mixes not chosen to engage the tiers: both tiers of each must
# decline (DECLINE_LIMIT batches) and then cool
COOLING = ("rfc5424_line", "rfc3164_line", "ltsv_line", "gelf_line",
           "rfc5424_ltsv_line", "rfc5424_r5_line", "rfc5424_capnp_line")


def phase_e2e(name: str, n_lines: int, seed: int, checked=None):
    """One configuration through the CLI (the line mixes only: a tier mix
    runs in process only since the capnp paths came, its line mix
    driving the same configuration through the CLI) and then in process (counts reset just
    before, read just after; the tier mixes a second time with the fused
    route off); returns the launch counts summed over the in-process
    runs.  With ``checked`` (the kernels phase's :data:`CHECKED`) it
    fails if a run launched E1, D3, E3, F1 or F3 at a batch shape not
    checked there (the unchecked shapes of K1 and the ltsv kernels go
    to :data:`LATE`)."""
    WORK.mkdir(parents=True, exist_ok=True)
    # the input and its scalar expectation, from the pool's worker
    path, data, exp_out, errs, notices, since, mix = expected(
        _paths_job(name, n_lines, seed))
    STAMPED_SINCE[name] = since
    exp_err = (errs, notices)
    kind = PATHS[name][2]

    # (a) the CLI in a subprocess
    cli = name not in INPROC_ONLY
    if cli:
        with CliRun(_config(name, "cli"), path) as run:
            rc, cli_out, cli_err, wall_cli = run.result()
        if rc != 0:
            raise AssertionError(f"{name}: CLI run failed:\n"
                                 + cli_err.decode()[-4000:])
    if name in OVERLAP_PATHS:
        EXPECTED[name] = (n_lines, seed, path, data, exp_out, exp_err)

    # (b) in process, through the library entry point, counts reset; a
    # tier mix's taker runs with the economics off, then once with the
    # fused route off and the economics on, reported
    tier = name.endswith("_tier")
    runs = [e2e_inproc(name, path, exp_out, exp_err, checked, "auto",
                       econ=not tier)]
    if PATHS[name][4] is not None:
        runs.append(e2e_inproc(name, path, exp_out, exp_err, checked, "off",
                               econ=not tier))
    if tier:
        runs.append(e2e_inproc(name, path, exp_out, exp_err, checked, "off"))
    for r in runs:
        r["inproc_lines_per_s"] = n_lines / r["inproc_wall_s"]
    RATES[f"e2e_{name}"] = runs[0]["inproc_lines_per_s"]

    cli_report = {}
    if cli:
        got = (WORK / f"{name}_cli.out").read_bytes()
        errs, cli_econ = econ_split(cli_err.decode().splitlines())
        # stdout: the CLI's banner, then the ltsv decoder's notices
        banner, *notices = cli_out.decode().splitlines()
        if (not same_bytes(name, got, exp_out)
                or not same_stderr(kind, errs, exp_err[0])
                or not banner.startswith("Flowgger")
                or notices != exp_err[1]):
            raise AssertionError(
                f"{name}: CLI e2e differs from the scalar path: bytes equal="
                f"{same_bytes(name, got, exp_out)}; stderr lines "
                f"{len(errs)} vs {len(exp_err[0])}; stdout lines "
                f"{len(notices)} vs {len(exp_err[1])}")
        cli_report = {"cli_wall_s": wall_cli,
                      "cli_lines_per_s": n_lines / wall_cli,
                      "cli_economics_notices": cli_econ}
    emit({"phase": "e2e", "path": name, "lines": n_lines,
          "input_bytes": len(data), "output_bytes": len(exp_out),
          "error_lines": len(exp_err[0]), "notice_lines": len(exp_err[1]),
          "mix": mix, "runs": runs, **cli_report,
          "identical_to_scalar_path": True})
    total = {}
    for r in runs:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# e2e configurations of the auto input and of the Record path: name ->
# (input.format, [input.*] tables (by their name in corpus: the package
# is imported only after main's checks), [output.*] tables, the scalar
# expectation's fmt, lines, the kernels its run must launch).  The auto
# runs interleave the four line mixes (auto_line) or the four tier mixes
# (auto_tier) ~40 / 30 / 15 / 15 % with the classifier's edge rows
# (corpus.make_auto_corpus); the Record-path runs are the configs the
# block route cannot take (a start-up notice) or whose batches its block
# encoder declines (the 10-key schema)
_LEGS = ("decode_rfc5424_p6", "decode_rfc3164", "decode_ltsv",
         "structural_index_flat_f8")
MIXED_PATHS = {
    "auto_line": ("auto_tpu", "", "", "auto", AUTO_LINES,
                  ("frame_sep_spans", "frame_gather", "classify_auto",
                   *_LEGS, "encode_gelf_probe_p6", "encode_gelf3164_probe",
                   "encode_gelf_ltsv_probe_p6", "encode_gelf_gelf_probe_f8")),
    "auto_tier": ("auto_tpu", "", "", "auto", TIER_LINES,
                  ("frame_sep_spans", "frame_gather", "classify_auto",
                   *_LEGS, "encode_gelf_assemble_p6",
                   "encode_gelf3164_assemble", "encode_gelf_ltsv_assemble_p6",
                   "encode_gelf_gelf_assemble_f8")),
    "record_rfc5424": ("rfc5424_tpu", "",
                       '[output.gelf_extra]\n_env = "prod"\nhost = "relay"\n',
                       "rfc5424", RECORD_LINES,
                       ("frame_sep_spans", "frame_gather",
                        "decode_rfc5424_p6")),
    "record_rfc3164": ("rfc3164_tpu", "", '[output.gelf_extra]\nlevel = "3"\n',
                       "rfc3164", RECORD_LINES,
                       ("frame_sep_spans", "frame_gather", "decode_rfc3164")),
    "record_ltsv": ("ltsv_tpu", "LTSV_SCHEMA_10", "", "ltsv", RECORD_LINES,
                    ("frame_sep_spans", "frame_gather", "decode_ltsv")),
    "record_gelf": ("gelf_tpu", "", '[output.gelf_extra]\nx = "y"\n', "gelf",
                    RECORD_LINES, ("frame_sep_spans", "frame_gather",
                                   "structural_index_flat_f8")),
    "record_jsonl": ("jsonl_tpu", "", '[output.gelf_extra]\nx = "y"\n',
                     "jsonl", RECORD_LINES,
                     ("frame_sep_spans", "frame_gather",
                      "structural_index_f8")),
    "record_auto": ("auto_tpu", "", '[output.gelf_extra]\n_env = "prod"\n',
                    "auto", RECORD_LINES,
                    ("frame_sep_spans", "frame_gather", "classify_auto",
                     *_LEGS)),
}
# the kernels whose launch shapes a mixed run may show that the kernels
# phase did not check (the legs' sub-batches follow each flush's class
# counts): held against the plain versions after the runs
MIXED_LATE = LATE_PREFIXES + ("decode_rfc3164", "encode_gelf3164",
                              "encode_gelf_probe", "encode_gelf_assemble",
                              "structural_index", "classify_auto")
_MIXED_WRAPPERS = SHAPE_CHECKED + ("structural_index_cuda",
                                   "classify_auto_cuda")
_NOTICE = "flowgger-tpu: columnar block route disabled for format "
# the mixed paths that also run through the CLI (the other Record-path
# configs run in process only since the LTSV-output and dns paths came,
# and record_rfc5424 since the syslog-output paths came: their CLI is
# held by the CPU tests, and auto_tier since the capnp paths came:
# auto_line drives its configuration through the CLI)
MIXED_CLI = ("auto_line",)


def _mixed_tables(name: str):
    from flowgger_tpu_torch import corpus

    fmt, in_t, out_t, *_ = MIXED_PATHS[name]
    return getattr(corpus, in_t) if in_t else "", out_t


def _mixed_config(name: str, tag: str) -> Path:
    fmt = MIXED_PATHS[name][0]
    in_t, out_t = _mixed_tables(name)
    out = WORK / f"{name}_{tag}.out"
    cfg = WORK / f"{name}_{tag}.toml"
    cfg.write_text(
        f'[input]\ntype = "stdin"\nformat = "{fmt}"\nframing = "line"\n'
        + in_t + '[output]\ntype = "file"\nformat = "gelf"\n'
        f'file_path = "{out}"\n' + out_t)
    if out.exists():
        out.unlink()
    return cfg


def _mixed_same(got, errs, notices, exp) -> bool:
    """Bytes (wall-clock stamps masked), stderr (the rfc3164 decoder's
    own lines and the rest each in order; a start-up notice first where
    the scalar path has none) and stdout notices against the scalar
    path's."""
    from flowgger_tpu_torch.corpus import mask_wall_stamps

    exp_out, exp_err, exp_notices, since = exp
    if errs and errs[0].startswith(_NOTICE):
        errs = errs[1:]
    return (mask_wall_stamps(got, since) == mask_wall_stamps(exp_out, since)
            and same_stderr("rfc3164", errs, exp_err)
            and notices == exp_notices)


def phase_e2e_mixed(name: str, seed: int):
    """One auto_tpu or Record-path configuration through the CLI (the
    paths in :data:`MIXED_CLI`) and in process (every launch count reset
    just before, read just after: each kernel of its path launched), both
    byte-identical to the scalar path (made by the pool's worker); reports
    lines/s, each leg's split tier taken / declined / cooled and AC's
    launches, and returns the in-process launch counts.  The launch
    shapes not checked by the kernels phase go to :data:`LATE`."""
    from flowgger_tpu_torch.tpu import framing, kernels

    WORK.mkdir(parents=True, exist_ok=True)
    fmt_in, _, _, _, n_lines, need = MIXED_PATHS[name]
    path, data, exp_out, exp_err, notices, since, mix = expected(
        _mixed_job(name, seed))
    since -= 1.0
    in_t, out_t = _mixed_tables(name)

    # (a) the CLI in a subprocess
    cli = name in MIXED_CLI
    if cli:
        with CliRun(_mixed_config(name, "cli"), path) as run:
            rc, cli_out, cli_err, wall_cli = run.result()
        if rc != 0:
            raise AssertionError(f"{name}: CLI run failed:\n"
                                 + cli_err.decode()[-4000:])
    exp = (exp_out, exp_err, notices, since)

    # (b) in process, counts reset just before
    cfg = _mixed_config(name, "inproc")
    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    with launch_shapes(_MIXED_WRAPPERS) as seen:
        wall, pipe, errs, said = run_inproc(cfg, path)
    errs, econ_notices = econ_split(errs)
    launches = dict(kernels.LAUNCHES)
    got = (WORK / f"{name}_inproc.out").read_bytes()
    if not _mixed_same(got, errs, said, exp):
        raise AssertionError(f"{name}: in-process e2e differs from the "
                             f"scalar path (bytes {len(got)} vs "
                             f"{len(exp_out)}, stderr lines {len(errs)} vs "
                             f"{len(exp_err)})")
    notice = errs[0] if errs and errs[0].startswith(_NOTICE) else None
    if (notice is None) != (name in ("auto_line", "auto_tier",
                                     "record_ltsv")):
        raise AssertionError(f"{name}: start-up notice {notice!r}")
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: the run launched no {missing} kernel")
    if any(framing.DECLINES.values()):
        raise AssertionError(f"{name}: device framing declined "
                             f"{framing.DECLINES}")
    late = {(k, v) for k, v in seen - CHECKED if k.startswith(MIXED_LATE)}
    if seen - CHECKED - late:
        raise AssertionError(f"{name}: kernels launched at shapes no phase "
                             f"checks: {sorted(seen - CHECKED - late)}")
    LATE.update(late)
    legs = {leg: {k: st.get(k, 0) for k in _STATE_KEYS}
            for leg, st in pipe._handler.route_state.items()}
    if name == "auto_tier" and any(
            legs.get(leg, {}).get("taken", 0) == 0
            for leg in ("rfc5424", "rfc3164", "ltsv", "gelf")):
        raise AssertionError(f"{name}: a leg's split tier took no batch: "
                             f"{legs}")

    cli_report = {}
    if cli:
        banner, *cli_said = cli_out.decode().splitlines()
        cli_errs = econ_split(cli_err.decode().splitlines())[0]
        if (not banner.startswith("Flowgger")
                or not _mixed_same((WORK / f"{name}_cli.out").read_bytes(),
                                   cli_errs, cli_said, exp)
                or (cli_errs[:1] == [notice]) != (notice is not None)):
            raise AssertionError(f"{name}: CLI e2e differs from the scalar "
                                 f"path")
        cli_report = {"cli_wall_s": wall_cli,
                      "cli_lines_per_s": n_lines / wall_cli}
    emit({"phase": "e2e", "path": name, "format": fmt_in,
          "config_tables": in_t + out_t, "lines": n_lines,
          "input_bytes": len(data), "output_bytes": len(exp_out),
          "error_lines": len(exp_err), "notice_lines": len(notices),
          "startup_notice": notice, "mix": mix,
          "launches": launches, "classify_auto_launches":
              launches["classify_auto"], "legs": legs,
          "economics_notices": econ_notices,
          "launch_shapes": sorted(f"{k} {list(v)}" for k, v in seen),
          "inproc_wall_s": wall, "inproc_lines_per_s": n_lines / wall,
          **cli_report, "identical_to_scalar_path": True})
    return launches


# e2e configurations of the LTSV output and the dns input: name ->
# (input.format, [input] keys or the name of a corpus table of [input.*]
# keys, output.format, the scalar expectation's fmt, lines, the corpus
# maker (a name in flowgger_tpu_torch.corpus), whether it also runs
# through the CLI, the kernels its run must launch, and the kernels a
# second run with input.tpu_fuse = "off" must launch (None: no such run)).
# rfc5424_ltsv_line is cell 1's rfc5424 line mix into LTSV (not chosen to
# engage OL: both tiers decline and cool); rfc5424_ltsv_tier the mix OL's
# screen takes (the tier mix without tabs: the fused route takes every
# batch, and with it off the split tier does); dns_line the dns mix into
# GELF (DN and the host block encoder), dns_ltsv the dns tier mix into
# LTSV, auto_dns_ltsv cell 11's four line mixes and the dns mix into
# LTSV; the ltsv_out_* runs the other inputs into LTSV (ltsv_out_schema:
# the Record path), in process only.  rfc5424_ltsv_tier, dns_ltsv and
# auto_dns_ltsv run in process only since the capnp paths came, and
# rfc5424_ltsv_line since the transports came: the CLI drives the LTSV
# output in the transports' tcp_cli_sigterm, the dns input in dns_line
# and auto in auto_line, and the CPU tests hold each configuration's CLI
# against the JAX package
_FRAME = ("frame_sep_spans", "frame_gather")
OUT_PATHS = {
    "rfc5424_ltsv_line": ("rfc5424_tpu", "", "ltsv", "rfc5424",
                          RFC5424_LINES, "make_corpus", False,
                          (*_FRAME, "fused_rfc5424_ltsv_probe",
                           "decode_rfc5424_p6", "decode_rfc5424_p16",
                           "encode_ltsv_out_probe"), None),
    "rfc5424_ltsv_tier": ("rfc5424_tpu", "", "ltsv", "rfc5424",
                          TIER_LINES, "make_ltsv_out_tier_corpus", False,
                          (*_FRAME, "fused_rfc5424_ltsv_probe",
                           "fused_rfc5424_ltsv_assemble"),
                          (*_FRAME, "decode_rfc5424_p6",
                           "encode_ltsv_out_probe",
                           "encode_ltsv_out_assemble")),
    "dns_line": ("dns_tpu", "", "gelf", "dns", DNS_LINES, "make_dns_corpus",
                 True, (*_FRAME, "decode_dns"), None),
    "dns_ltsv": ("dns_tpu", "", "ltsv", "dns", BATCH, "make_dns_tier_corpus",
                 False, (*_FRAME, "decode_dns"), None),
    "auto_dns_ltsv": ("auto_tpu", 'auto_extra_formats = ["dns"]\n', "ltsv",
                      "auto", BATCH, "make_auto_corpus", False,
                      (*_FRAME, "classify_auto_dns", "decode_rfc5424_p6",
                       "decode_rfc3164", "decode_ltsv",
                       "structural_index_flat_f8", "decode_dns",
                       "encode_ltsv_out_probe"), None),
    "ltsv_out_rfc3164": ("rfc3164_tpu", "", "ltsv", "rfc3164", OUT_LINES,
                         "make_rfc3164_corpus", False,
                         (*_FRAME, "decode_rfc3164"), None),
    "ltsv_out_ltsv": ("ltsv_tpu", "", "ltsv", "ltsv", OUT_LINES,
                      "make_ltsv_corpus", False, (*_FRAME, "decode_ltsv"),
                      None),
    "ltsv_out_gelf": ("gelf_tpu", "", "ltsv", "gelf", OUT_LINES,
                      "make_gelf_corpus", False,
                      (*_FRAME, "structural_index_flat_f8"), None),
    "ltsv_out_jsonl": ("jsonl_tpu", "", "ltsv", "jsonl", OUT_LINES,
                       "make_jsonl_corpus", False,
                       (*_FRAME, "structural_index_f8"), None),
    "ltsv_out_schema": ("ltsv_tpu", "LTSV_SCHEMA_10", "ltsv", "ltsv",
                        OUT_LINES, "make_ltsv_corpus", False,
                        (*_FRAME, "decode_ltsv"), None),
    # cell 1's mix into RFC5424 (line framing): over 5 % of its rows fall
    # outside O5, so FO/r5 and O5 decline and cool (in process only since
    # the capnp paths came: the CPU tests hold its CLI against the JAX
    # package)
    "rfc5424_r5_line": ("rfc5424_tpu", "", "rfc5424", "rfc5424",
                        RFC5424_LINES, "make_corpus", False,
                        (*_FRAME, "fused_rfc5424_rfc5424_probe",
                         "decode_rfc5424_p6", "decode_rfc5424_p16",
                         "encode_rfc5424_out_probe"), None),
    # cell 4's and cell 6's tier mixes into RFC5424: FO/r5 takes every
    # batch; with tpu_fuse = "off" O5 or O5/3164 does
    "rfc5424_r5_tier": ("rfc5424_tpu", "", "rfc5424", "rfc5424",
                        TIER_LINES, "make_tier_corpus", False,
                        (*_FRAME, "fused_rfc5424_rfc5424_probe",
                         "fused_rfc5424_rfc5424_assemble"),
                        (*_FRAME, "decode_rfc5424_p6",
                         "encode_rfc5424_out_probe",
                         "encode_rfc5424_out_assemble")),
    "rfc3164_r5_tier": ("rfc3164_tpu", "", "rfc5424", "rfc3164",
                        TIER_LINES, "make_rfc3164_tier_corpus", False,
                        (*_FRAME, "fused_rfc3164_rfc5424_probe",
                         "fused_rfc3164_rfc5424_assemble"),
                        (*_FRAME, "decode_rfc3164",
                         "encode_rfc3164_rfc5424_probe",
                         "encode_rfc3164_rfc5424_assemble")),
    # the other inputs into RFC5424 and the other syslog outputs, in
    # process only (the CPU tests hold their CLIs against the JAX package)
    "syslog_out_gelf": ("gelf_tpu", "", "rfc5424", "gelf",
                        SYSLOG_OUT_LINES, "make_gelf_tier_corpus", False,
                        (*_FRAME, "structural_index_flat_f8"), None),
    "syslog_out_ltsv": ("ltsv_tpu", "", "rfc5424", "ltsv",
                        SYSLOG_OUT_LINES, "make_ltsv_corpus", False,
                        (*_FRAME, "decode_ltsv"), None),
    "syslog_out_auto": ("auto_tpu", "", "rfc5424", "auto",
                        SYSLOG_OUT_LINES, "make_auto_corpus", False,
                        (*_FRAME, "classify_auto", *_LEGS,
                         "encode_rfc5424_out_probe",
                         "encode_rfc3164_rfc5424_probe"), None),
    "syslog_out_jsonl": ("jsonl_tpu", "", "rfc5424", "jsonl",
                         SYSLOG_OUT_LINES, "make_jsonl_corpus", False,
                         (*_FRAME, "structural_index_f8"), None),
    "syslog_out_pass5424": ("rfc5424_tpu", "", "passthrough", "rfc5424",
                            SYSLOG_OUT_LINES, "make_corpus", False,
                            (*_FRAME, "decode_rfc5424_p6"), None),
    "syslog_out_pass3164": ("rfc3164_tpu", "", "passthrough", "rfc3164",
                            SYSLOG_OUT_LINES, "make_rfc3164_corpus", False,
                            (*_FRAME, "decode_rfc3164"), None),
    "syslog_out_rfc3164": ("rfc3164_tpu", "", "rfc3164", "rfc3164",
                           SYSLOG_OUT_LINES, "make_rfc3164_corpus", False,
                           (*_FRAME, "decode_rfc3164"), None),
    "syslog_out_json": ("rfc5424_tpu", "", "json", "rfc5424",
                        SYSLOG_OUT_LINES, "make_tier_corpus", False,
                        (*_FRAME, "fused_rfc5424_gelf_probe",
                         "fused_rfc5424_gelf_assemble"), None),
    "syslog_out_prepend": ("rfc5424_tpu", "", "passthrough", "rfc5424",
                           SYSLOG_OUT_LINES, "make_corpus", False,
                           (*_FRAME, "decode_rfc5424_p6"), None),
    # cell 1's mix into capnp (the inferred noop framing): over 5 % of its
    # rows fall outside OC, so FO/capnp and OC decline and cool
    "rfc5424_capnp_line": ("rfc5424_tpu", "", "capnp", "rfc5424",
                           RFC5424_LINES, "make_corpus", True,
                           (*_FRAME, "fused_rfc5424_capnp_probe",
                            "decode_rfc5424_p6", "decode_rfc5424_p16",
                            "encode_capnp_probe_p6"), None),
    # cell 4's tier mix into capnp: FO/capnp takes every batch; with
    # tpu_fuse = "off" OC does
    "rfc5424_capnp_tier": ("rfc5424_tpu", "", "capnp", "rfc5424",
                           TIER_LINES, "make_tier_corpus", False,
                           (*_FRAME, "fused_rfc5424_capnp_probe",
                            "fused_rfc5424_capnp_assemble"),
                           (*_FRAME, "decode_rfc5424_p6",
                            "encode_capnp_probe_p6",
                            "encode_capnp_assemble_p6")),
    # the other inputs into capnp, in process only (the CPU tests hold
    # their CLIs against the JAX package): the host block encoders, auto's
    # legs (its rfc5424 leg probes OC), rfc5424 with a capnp_extra and
    # syslen framing (FO/capnp takes the tier mix), jsonl (the Record path)
    "capnp_out_rfc3164": ("rfc3164_tpu", "", "capnp", "rfc3164", OUT_LINES,
                          "make_rfc3164_corpus", False,
                          (*_FRAME, "decode_rfc3164"), None),
    "capnp_out_ltsv": ("ltsv_tpu", "", "capnp", "ltsv", OUT_LINES,
                       "make_ltsv_corpus", False, (*_FRAME, "decode_ltsv"),
                       None),
    "capnp_out_gelf": ("gelf_tpu", "", "capnp", "gelf", OUT_LINES,
                       "make_gelf_corpus", False,
                       (*_FRAME, "structural_index_flat_f8"), None),
    "capnp_out_auto": ("auto_tpu", "", "capnp", "auto", OUT_LINES,
                       "make_auto_corpus", False,
                       (*_FRAME, "classify_auto", *_LEGS,
                        "encode_capnp_probe_p6"), None),
    "capnp_out_extra": ("rfc5424_tpu", "", "capnp", "rfc5424", OUT_LINES,
                        "make_tier_corpus", False,
                        (*_FRAME, "fused_rfc5424_capnp_probe",
                         "fused_rfc5424_capnp_assemble"), None),
    "capnp_out_jsonl": ("jsonl_tpu", "", "capnp", "jsonl", OUT_LINES,
                        "make_jsonl_corpus", False,
                        (*_FRAME, "structural_index_f8"), None),
}
# the [output] keys of a path beside its format (default: line framing
# into the file; json goes to stdout with the inferred noop framing)
OUT_KEYS = {
    "syslog_out_json": 'type = "stdout"\n',
    "syslog_out_prepend": ('framing = "line"\nsyslog_prepend_timestamp = '
                           '"[year]-[month]-[day]T[hour]:[minute]:[second]Z '
                           '"\n'),
    "capnp_out_extra": ('framing = "syslen"\n[output.capnp_extra]\n'
                        + "".join(f'{k} = "{v}"\n' for k, v in CAPNP_EXTRA)),
}
# the paths whose config the block route cannot take: a start-up notice
NOTICE_PATHS = ("ltsv_out_schema", "syslog_out_jsonl", "syslog_out_prepend",
                "capnp_out_jsonl")
# the split tier and fused route of an (input, output) pair whose probes
# and assembles a run's counts are held against: the kernels' names
TIER_LAUNCHES = {
    ("rfc5424", "ltsv"): ("encode_ltsv_out", "fused_rfc5424_ltsv"),
    ("rfc5424", "rfc5424"): ("encode_rfc5424_out", "fused_rfc5424_rfc5424"),
    ("rfc3164", "rfc5424"): ("encode_rfc3164_rfc5424",
                             "fused_rfc3164_rfc5424"),
    ("rfc5424", "capnp"): ("encode_capnp", "fused_rfc5424_capnp"),
}
_OUT_WRAPPERS = _MIXED_WRAPPERS + ("decode_dns_cuda", "encode_ltsv_out_cuda",
                                   "fused_ltsv_out_cuda",
                                   "encode_rfc5424_out_cuda",
                                   "fused_rfc5424_out_cuda",
                                   "encode_capnp_cuda",
                                   "fused_capnp_out_cuda")
_OUT_LATE = MIXED_LATE + ("decode_dns", "encode_ltsv_out",
                          "fused_rfc5424_ltsv", "encode_rfc5424_out",
                          "encode_rfc3164_rfc5424", "fused_rfc5424_rfc5424",
                          "fused_rfc3164_rfc5424", "fused_rfc5424_gelf",
                          "fused_rfc3164_gelf", "encode_capnp",
                          "fused_rfc5424_capnp")
_PREPEND_WALL = re.compile(rb"(^|[\n\0])\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ ")
_RFC3339_HEAD = re.compile(rb"(<[0-9]+>1 )([0-9]{4}-[0-9][0-9]-[0-9][0-9]T"
                           rb"[0-9:.]+Z) ")


def mask_stamps(data: bytes, since: float, output: str) -> bytes:
    """``data`` with the wall-clock stamps of rows without a timestamp
    (gelf and jsonl rows, from ``since`` on) set to 0:
    ``corpus.mask_wall_stamps`` for GELF, the ``time`` field for LTSV,
    the head's stamp for RFC5424, the root struct's stamp for capnp
    (``capnp:<framing>``: ``corpus.mask_capnp_stamps``); the
    ``syslog_prepend_timestamp`` prefix of each row
    (``passthrough_prepend``) masked."""
    from flowgger_tpu_torch.corpus import mask_capnp_stamps, mask_wall_stamps
    from flowgger_tpu_torch.utils.timeparse import rfc3339_to_unix

    if output.startswith("capnp"):
        # "capnp:<framing>": the messages' raw f64 stamps
        return mask_capnp_stamps(data, since, output.partition(":")[2])
    if output in ("gelf", "json"):
        return mask_wall_stamps(data, since)
    if output == "passthrough_prepend":
        return _PREPEND_WALL.sub(rb"\1<wall> ", data)
    if output in ("passthrough", "rfc3164"):
        return data
    if output == "rfc5424":
        def head(m):
            wall = rfc3339_to_unix(m.group(2).decode()) >= since
            return m.group(1) + (b"0 " if wall else m.group(2) + b" ")

        return _RFC3339_HEAD.sub(head, data)

    def sub(m):
        return b"\ttime:0" if float(m.group(1)) >= since else m.group(0)

    return re.sub(rb"\ttime:([0-9][0-9.]*)", sub, data)


def _out_keys(name: str) -> str:
    """The [output] keys of a path beside ``format``, ``type`` and
    ``file_path``: :data:`OUT_KEYS`, else line framing into a syslog
    output (inferred: GELF nul, LTSV line)."""
    output = OUT_PATHS[name][2]
    return OUT_KEYS.get(name, 'framing = "line"\n' if output in (
        "rfc5424", "rfc3164", "passthrough") else "")


def _out_framing(name: str) -> str:
    """The output framing of a path: its ``framing`` key, else the one
    the pipeline infers (stdout and capnp: noop; GELF: nul; LTSV: line)."""
    m = re.search(r'framing = "(\w+)"', _out_keys(name))
    if m:
        return m.group(1)
    output = OUT_PATHS[name][2]
    if 'type = "stdout"' in _out_keys(name) or output == "capnp":
        return "noop"
    return "nul" if output == "gelf" else "line"


def _masking(name: str) -> str:
    """The ``output`` argument of :func:`mask_stamps` for a path."""
    output = OUT_PATHS[name][2]
    if name == "syslog_out_prepend":
        return "passthrough_prepend"
    if output == "capnp":
        return f"capnp:{_out_framing(name)}"
    return output


def _out_config(name: str, tag: str, fuse: str = "auto",
                input_keys: str = "") -> Path:
    from flowgger_tpu_torch import corpus

    fmt, keys, output = OUT_PATHS[name][:3]
    in_t = getattr(corpus, keys) if keys.startswith("LTSV") else ""
    out = WORK / f"{name}_{tag}.out"
    cfg = WORK / f"{name}_{tag}.toml"
    extra = _out_keys(name)
    sink = "" if "type =" in extra else \
        f'type = "file"\nfile_path = "{out}"\n'
    cfg.write_text(
        f'[input]\ntype = "stdin"\nformat = "{fmt}"\nframing = "line"\n'
        f'tpu_fuse = "{fuse}"\n' + input_keys + ("" if in_t else keys)
        + in_t
        + f'[output]\nformat = "{output}"\n' + sink + extra)
    if out.exists():
        out.unlink()
    return cfg


def ol_screen_share(lines: list, output: str = "ltsv") -> float:
    """The share of ``lines`` outside OL's tier (``output`` ltsv), O5's
    (rfc5424) or OC's (capnp): its screens, the width test, over-length
    rows, from the plain decode and the plain probe on the card, a batch
    at a time."""
    import torch

    from flowgger_tpu_torch.tpu import device_ltsv_out, pack, rfc5424
    from flowgger_tpu_torch.tpu import device_capnp, device_rfc5424_out

    split = {"rfc5424": device_rfc5424_out,
             "capnp": device_capnp}.get(output, device_ltsv_out)

    out = 0
    for i in range(0, len(lines), BATCH):
        b, ln, _, _, orig, n = pack.pack_lines_2d(lines[i:i + BATCH],
                                                  MAX_LEN)
        bt = torch.from_numpy(b).cuda()
        lt = torch.from_numpy(ln.astype("int32")).cuda()
        dec = rfc5424.decode_rfc5424(bt, lt)
        base, base_len = split.encode_rows(
            bt, lt, dec, suffix=b"\n", assemble=False, n=n)[:2]
        OW = split.out_width(MAX_LEN, b"\n")
        tier = (base & (base_len <= OW)).cpu().numpy()[:n]
        out += int((~(tier & (orig[:n] <= MAX_LEN))).sum())
    return out / max(len(lines), 1)


def e2e_out_inproc(name: str, path: Path, exp, fuse: str,
                   econ: bool = True):
    """One in-process run of an OUT_PATHS configuration (the economics
    off unless ``econ``), every launch count reset just before and read
    just after: its bytes (wall-clock
    stamps masked), stderr and stdout notices must be the scalar path's,
    and it must launch each kernel of its path.  Returns the report."""
    from flowgger_tpu_torch.tpu import framing, kernels

    fmt_in, _, output, kind, n_lines, _, _, need, need_off = OUT_PATHS[name]
    exp_out, exp_err, exp_notices, since = exp
    tag = _econ_tag(fuse, econ)
    cfg = _out_config(name, tag, fuse, "" if econ else ECON_OFF)
    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    with launch_shapes(_OUT_WRAPPERS) as seen:
        wall, pipe, errs, said = run_inproc(cfg, path)
    errs, econ_notices = econ_split(errs)
    launches = dict(kernels.LAUNCHES)
    masking = _masking(name)
    if 'type = "stdout"' in _out_keys(name):
        # the records went to stdout, as text
        got, said = "\n".join(said).encode(), []
        exp_out = "\n".join(exp_out.decode("utf-8", "replace").splitlines(
        )).encode()
    else:
        got = (WORK / f"{name}_{tag}.out").read_bytes()
    notice = errs[0] if errs and errs[0].startswith(_NOTICE) else None
    if notice is not None:
        errs = errs[1:]
    if (mask_stamps(got, since, masking)
            != mask_stamps(exp_out, since, masking)
            or not same_stderr("rfc3164", errs, exp_err)
            or said != exp_notices):
        raise AssertionError(f"{name} ({fuse}): in-process e2e differs from "
                             f"the scalar path (bytes {len(got)} vs "
                             f"{len(exp_out)}, stderr lines {len(errs)} vs "
                             f"{len(exp_err)})")
    if (notice is None) == (name in NOTICE_PATHS):
        raise AssertionError(f"{name}: start-up notice {notice!r}")
    want = need if fuse == "auto" else need_off
    missing = [k for k in want if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} ({fuse}): the run launched no "
                             f"{missing} kernel")
    if any(framing.DECLINES.values()):
        raise AssertionError(f"{name}: device framing declined "
                             f"{framing.DECLINES}")
    late = {(k, v) for k, v in seen - CHECKED if k.startswith(_OUT_LATE)}
    if seen - CHECKED - late:
        raise AssertionError(f"{name}: kernels launched at shapes no phase "
                             f"checks: {sorted(seen - CHECKED - late)}")
    LATE.update(late)
    rstate = pipe._handler.route_state
    split = _tier_report(rstate.get(kind, {}))
    # json output is GELF (fused_routes.out_key)
    out = "gelf" if output == "json" else output
    fused = _tier_report(rstate.get(f"fused:{kind}_{out}", {}))
    tiers = TIER_LAUNCHES.get((kind, output))
    if tiers is not None:
        # one probe a probed batch and one assemble a taken batch, on
        # each tier
        s_name, f_name = tiers

        def count(prefix):
            # OC counts its pair widths apart (_p6, _p16)
            return sum(v for k, v in launches.items()
                       if k.startswith(prefix))

        if (count(f"{s_name}_probe") != split["taken"] + split["declined"]
                or count(f"{s_name}_assemble") != split["taken"]
                or count(f"{f_name}_probe")
                != fused["taken"] + fused["declined"]
                or count(f"{f_name}_assemble") != fused["taken"]):
            raise AssertionError(f"{name} ({fuse}): {launches} for split "
                                 f"{split} and fused {fused}: not one probe "
                                 f"a probed batch and one assemble a taken "
                                 f"batch")
    if name in COOLING and not all(t["declined"] and t["cooled"]
                                   for t in (fused, split)):
        raise AssertionError(f"{name}: the tiers did not decline and then "
                             f"cool: fused {fused}, split {split}")
    if name.endswith("_tier") and not econ:
        took, idle = (fused, split) if fuse == "auto" else (split, fused)
        check_tier_mix(f"{name} ({fuse})", took, idle)
    legs = {leg: {k: st.get(k, 0) for k in _STATE_KEYS}
            for leg, st in rstate.items()}
    return {"fuse": fuse, "economics_on": econ, "launches": launches,
            "fused_route": fused, "split_tier": split, "legs": legs,
            "startup_notice": notice,
            "economics": pipe._handler.economics(),
            "economics_notices": econ_notices,
            "launch_shapes": sorted(f"{k} {list(v)}" for k, v in seen),
            "inproc_wall_s": wall, "inproc_lines_per_s": n_lines / wall}


def phase_e2e_out(name: str, seed: int):
    """One configuration of :data:`OUT_PATHS` through the CLI (where it has
    one) and in process (the tier mix a second time with the fused route
    off), each byte-identical to the scalar path (made by the pool's
    worker); returns the launch counts summed over the in-process runs."""
    WORK.mkdir(parents=True, exist_ok=True)
    fmt_in, _, output, _, n_lines, _, cli, _, need_off = OUT_PATHS[name]
    path, data, exp_out, exp_err, notices, since, mix = expected(
        _out_job(name, seed))
    since -= 1.0
    report = {"phase": "e2e", "path": name, "format": fmt_in,
              "output": output, "lines": n_lines, "input_bytes": len(data),
              "mix": mix}
    if name in ("rfc5424_ltsv_line", "rfc5424_r5_line", "rfc5424_r5_tier",
                "rfc5424_capnp_line", "rfc5424_capnp_tier"):
        # the line mixes: over 5 % of their rows outside OL, O5 or OC, so
        # both tiers must decline and cool (COOLING lists them); the tier
        # mixes: at most 5 %
        share = ol_screen_share(data.split(b"\n"), output)
        tag = {"ltsv": "ol", "rfc5424": "o5", "capnp": "oc"}[output]
        report[f"outside_{tag}_share"] = share
        if (share > 0.05) != name.endswith("_line"):
            raise AssertionError(f"{name}: {share:.4f} of the rows fall "
                                 f"outside {tag.upper()}")

    if cli:
        with CliRun(_out_config(name, "cli"), path) as run:
            rc, cli_out, cli_err, wall_cli = run.result()
        if rc != 0:
            raise AssertionError(f"{name}: CLI run failed:\n"
                                 + cli_err.decode()[-4000:])
        banner, *cli_said = cli_out.decode().splitlines()
        got = (WORK / f"{name}_cli.out").read_bytes()
        if (not banner.startswith("Flowgger")
                or mask_stamps(got, since, _masking(name))
                != mask_stamps(exp_out, since, _masking(name))
                or not same_stderr(
                    "rfc3164", econ_split(cli_err.decode().splitlines())[0],
                    exp_err) or cli_said != notices):
            raise AssertionError(f"{name}: CLI e2e differs from the scalar "
                                 f"path")
        report.update(cli_wall_s=wall_cli,
                      cli_lines_per_s=n_lines / wall_cli)
    exp = (exp_out, exp_err, notices, since)
    tier = name.endswith("_tier")
    runs = [e2e_out_inproc(name, path, exp, "auto", econ=not tier)]
    if need_off is not None:
        runs.append(e2e_out_inproc(name, path, exp, "off", econ=not tier))
    if tier:
        runs.append(e2e_out_inproc(name, path, exp, "off"))
    emit({**report, "output_bytes": len(exp_out),
          "error_lines": len(exp_err), "notice_lines": len(notices),
          "runs": runs, "identical_to_scalar_path": True})
    total = {}
    for r in runs:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# the executors overlap_ab holds against each other: input.tpu_inflight
# 0 (strictly serial), the default window (one lane, depth 2) and two
# lanes (two streams on the one card, depth 2 each)
OVERLAP_EXECUTORS = (("inflight0", "tpu_inflight = 0\n", 1),
                     ("inflight2", "", 1),
                     ("lanes2", "tpu_lanes = 2\n", 2))
OVERLAP_PATHS = ("rfc5424_line", "rfc5424_tier")


@contextlib.contextmanager
def executor_clock():
    """Busy seconds of the executor's threads inside the block: the
    ingest thread's seconds blocked in the lane set (a full window's
    backpressure, a fence, and at depth 0 the inline pops) and each
    lane's pop seconds (fetch and encode, then the emit closure; the
    sequencer's wait for the batch's turn left out)."""
    from flowgger_tpu_torch.tpu import batch as batch_mod
    from flowgger_tpu_torch.tpu import overlap

    clock = {"blocked_s": 0.0, "pop_s": {}, "pops": 0}
    lock = threading.Lock()
    # the pipeline's accept thread ingests (its caller waits for it)
    ingest = "input-accept"
    pop = batch_mod.BatchHandler._pop_emit
    submit, fence = overlap.LaneSet.submit, overlap.LaneSet.fence

    def add_pop(lane, secs):
        with lock:
            clock["pop_s"][lane] = clock["pop_s"].get(lane, 0.0) + secs

    def timed_pop(self, payload, lane=0):
        t0 = time.perf_counter()
        emit = pop(self, payload, lane)
        add_pop(lane, time.perf_counter() - t0)
        with lock:
            clock["pops"] += 1

        def finish():
            t1 = time.perf_counter()
            emit()
            add_pop(lane, time.perf_counter() - t1)
        return finish

    def blocking(fn):
        def run(self, *a, **k):
            if threading.current_thread().name != ingest:
                return fn(self, *a, **k)
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                clock["blocked_s"] += time.perf_counter() - t0
        return run

    batch_mod.BatchHandler._pop_emit = timed_pop
    overlap.LaneSet.submit = blocking(submit)
    overlap.LaneSet.fence = blocking(fence)
    try:
        yield clock
    finally:
        batch_mod.BatchHandler._pop_emit = pop
        overlap.LaneSet.submit, overlap.LaneSet.fence = submit, fence


@contextlib.contextmanager
def launch_streams():
    """The set of CUDA stream handles the kernel wrappers launched on
    inside the block: each wrapper asks ``kernels._stream`` for the
    calling thread's current stream as it launches."""
    from flowgger_tpu_torch.tpu import kernels

    seen = set()
    lock = threading.Lock()
    stream = kernels._stream

    def recording():
        handle = stream()
        with lock:
            seen.add(handle)
        return handle

    kernels._stream = recording
    try:
        yield seen
    finally:
        kernels._stream = stream


def phase_overlap_ab(seed: int):
    """The main path (rfc5424 / line, cell 1's mix) and the rfc5424 →
    GELF tier mix in process at ``input.tpu_inflight = 0``, at the default
    window and at ``input.tpu_lanes = 2``, in turns forth and back, on the
    inputs of their e2e runs (:data:`EXPECTED`): each run byte for byte
    the scalar path's, stderr
    included (the economics notices reported apart).  Reports lines/s,
    the executor's overlap share, 1 − wall ÷ (ingest-thread busy seconds
    + the lanes' pop seconds), each lane's economics snapshot and the
    CUDA streams the kernel wrappers launched on (:func:`launch_streams`):
    one non-default stream a lane, the lanes' own.  Returns the launch
    counts summed over the runs."""
    import torch

    from flowgger_tpu_torch.tpu import kernels

    total = {}
    for name in OVERLAP_PATHS:
        n_lines, _, path, data, exp_out, exp_err = EXPECTED[name]
        kind = PATHS[name][2]
        runs = []
        # in turns, forth and back (a, b, c, c, b, a): the host's speed
        # drifts within a call, so each executor is timed on both sides
        for tag, keys, lanes in OVERLAP_EXECUTORS + OVERLAP_EXECUTORS[::-1]:
            cfg = _config(name, f"overlap_{tag}", extra=keys)
            kernels.reset_launch_counts()
            with executor_clock() as clock, launch_streams() as seen:
                wall, pipe, errs, notices = run_inproc(cfg, path)
            launches = dict(kernels.LAUNCHES)
            streams = sorted(seen)
            errs, econ_notices = econ_split(errs)
            got = (WORK / f"{name}_overlap_{tag}.out").read_bytes()
            if (not same_bytes(name, got, exp_out)
                    or not same_stderr(kind, errs, exp_err[0])
                    or notices != exp_err[1]):
                raise AssertionError(
                    f"overlap_ab {name} {tag}: differs from the scalar path "
                    f"(bytes {len(got)} vs {len(exp_out)}, stderr lines "
                    f"{len(errs)} vs {len(exp_err[0])})")
            h = pipe._handler
            own = sorted(ln.stream.cuda_stream for ln in h._lanes)
            default = torch.cuda.default_stream().cuda_stream
            if (len(h._lanes) != lanes or streams != own
                    or default in streams or len(set(streams)) != lanes):
                raise AssertionError(
                    f"overlap_ab {name} {tag}: kernels launched on streams "
                    f"{streams}, the lanes' are {own} (default {default})")
            busy = (wall - clock["blocked_s"]) + sum(clock["pop_s"].values())
            runs.append({
                "executor": tag, "lanes": lanes,
                "inflight": h._window.depth, "wall_s": wall,
                "lines_per_s": n_lines / wall,
                "ingest_busy_s": wall - clock["blocked_s"],
                "ingest_blocked_s": clock["blocked_s"],
                "lane_pop_s": {str(k): v for k, v in
                               sorted(clock["pop_s"].items())},
                "batches": clock["pops"],
                "overlap_share": 1.0 - wall / busy if busy else None,
                "economics": h.economics(),
                "economics_notices": econ_notices,
                "streams": streams, "default_stream": default,
                "fused_route": _tier_report(
                    h.route_state.get(f"fused:{kind}_gelf", {})),
                "split_tier": _tier_report(h.route_state.get(kind, {})),
                "launches": {k: v for k, v in launches.items() if v}})
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        medians = {tag: statistics.median(r["lines_per_s"] for r in runs
                                          if r["executor"] == tag)
                   for tag, _, _ in OVERLAP_EXECUTORS}
        RATES[f"overlap_{name}"] = medians["inflight2"]
        emit({"phase": "overlap_ab", "path": name, "lines": n_lines,
              "input_bytes": len(data), "runs": runs,
              "lines_per_s": medians, "identical_to_scalar_path": True})
    return total


TCP_CONNS = 8                 # connections of tcp_conns, at once
UDP_DGRAMS = BATCH            # datagrams of udp_dgram
UDP_ZLIB_EVERY = 16           # every 16th datagram zlib-compressed
UDP_MAX_LOST = 0.01           # the share of datagrams udp_dgram may lose
SCALAR_TCP_LINES = BATCH // 4  # lines of scalar_tcp (and its *_tpu twin)
SIGTERM_LINES = BATCH         # lines of tcp_cli_sigterm
NET_WAIT = 120.0              # bound on every wait of a transport run


def _net_config(name: str, in_keys: str, fmt: str = "rfc5424_tpu",
                out_keys: str = 'format = "gelf"\n') -> Path:
    out = WORK / f"{name}.out"
    cfg = WORK / f"{name}.toml"
    cfg.write_text(f'[input]\nformat = "{fmt}"\n' + in_keys
                   + '[output]\ntype = "file"\n' + out_keys
                   + f'file_path = "{out}"\n')
    if out.exists():
        out.unlink()
    return cfg


def _wait_for(cond, what: str, wait: float = NET_WAIT) -> None:
    deadline = time.monotonic() + wait
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {wait} s waiting for "
                                 f"{what}")
        time.sleep(0.01)


@contextlib.contextmanager
def batch_counts():
    """The batches the handler submits inside the block (rows summed) and
    how many each flush that submitted any submitted: a network input
    frames each connection's session on its own, so a flush submits one
    batch a session with data."""
    from flowgger_tpu_torch.tpu import batch as batch_mod

    counts = {"batches": 0, "rows": 0, "per_flush": []}
    lock = threading.Lock()
    local = threading.local()
    submit = batch_mod.BatchHandler._submit
    flush = batch_mod.BatchHandler.flush

    def counted_submit(self, packed, lane=None):
        with lock:
            counts["batches"] += 1
            counts["rows"] += int(packed[5])
        local.n = getattr(local, "n", 0) + 1
        return submit(self, packed, lane)

    def counted_flush(self, drain=True):
        local.n = 0
        try:
            return flush(self, drain)
        finally:
            if local.n:
                with lock:
                    counts["per_flush"].append(local.n)

    batch_mod.BatchHandler._submit = counted_submit
    batch_mod.BatchHandler.flush = counted_flush
    try:
        yield counts
    finally:
        batch_mod.BatchHandler._submit = submit
        batch_mod.BatchHandler.flush = flush


def net_run(cfg: Path, drive,
            ready=lambda pipe: pipe.input.bound_port is not None,
            wrappers=SHAPE_CHECKED) -> dict:
    """One in-process run of a network input's ``cfg`` on ``cuda``: the
    pipeline on a thread (``Pipeline.run``), ``drive(pipe)`` sending its
    traffic and waiting until the pipeline has it, then
    ``Pipeline.shutdown`` (the drain); launch counts reset just before
    and read just after, stdout and stderr captured.  The wall runs from
    the first byte sent (once ``ready(pipe)``: the listener is up) to
    the drain's end."""
    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.pipeline import Pipeline
    from flowgger_tpu_torch.tpu import framing, kernels

    pipe = Pipeline(Config.from_path(str(cfg)), device="cuda")
    exc = []

    def run():
        try:
            pipe.run()
        except BaseException as e:  # noqa: BLE001 - raised below
            exc.append(e)

    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    err_buf, out_buf = io.StringIO(), io.StringIO()
    thread = threading.Thread(target=run, name="net-run")
    with contextlib.redirect_stderr(err_buf), \
            contextlib.redirect_stdout(out_buf), \
            launch_shapes(wrappers) as seen, batch_counts() as counts:
        thread.start()
        try:
            _wait_for(lambda: ready(pipe) or exc, "the listener")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drive(pipe)
        finally:
            pipe.shutdown(timeout=NET_WAIT)
            thread.join(NET_WAIT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if thread.is_alive():
        raise AssertionError(f"{cfg.stem}: the pipeline's run did not end")
    if exc:
        raise exc[0]
    breaker_closed(pipe, cfg.stem)
    if any(framing.DECLINES.values()):
        raise AssertionError(f"{cfg.stem}: device framing declined "
                             f"{dict(framing.DECLINES)}")
    late = {(k, v) for k, v in seen - CHECKED}
    LATE.update(late)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    per_flush = counts["per_flush"]
    out = WORK / f"{cfg.stem}.out"
    return {"wall_s": wall, "pipe": pipe,
            "errs": err_buf.getvalue().splitlines(),
            "stdout": out_buf.getvalue().splitlines(),
            "out": out.read_bytes() if out.exists() else b"",
            "report": {
                "wall_s": wall, "batches": counts["batches"],
                "rows_per_batch": counts["rows"] / max(counts["batches"], 1),
                "flushes": len(per_flush),
                "batches_per_flush": (sum(per_flush) / len(per_flush)
                                      if per_flush else 0.0),
                "max_batches_a_flush": max(per_flush, default=0),
                "launches": launches,
                "late_shapes": sorted(f"{k} {list(v)}" for k, v in late)}}


def _need_rfc5424(name: str, launches: dict, framed: bool = True) -> None:
    """A rfc5424_tpu run decoded on the card (F1's probe or K1), and over
    a line-framed transport (``framed``) framed there too (K2, K3)."""
    if ((framed and not (launches.get("frame_sep_spans")
                         and launches.get("frame_gather")))
            or not (launches.get("fused_rfc5424_gelf_probe")
                    or launches.get("decode_rfc5424_p6"))):
        raise AssertionError(f"{name}: the run did not frame and decode on "
                             f"the card: {launches}")


def _wait_output(name: str, size: int) -> None:
    """Wait until the run's output file holds ``size`` bytes (its whole
    expectation: every connection has been read, framed, decoded and
    written)."""
    out = WORK / f"{name}.out"
    _wait_for(lambda: out.exists() and out.stat().st_size >= size,
              f"{name}'s {size} output bytes")


def _records(out: bytes) -> list:
    return out.split(b"\0")[:-1]


def _send_tcp(port: int, data: bytes) -> None:
    with socket.create_connection(("127.0.0.1", port), timeout=NET_WAIT) as s:
        s.sendall(data)


def _tcp_line(expected) -> dict:
    """tcp_line: rfc5424_line's input over one tcp connection, its
    expectation reused."""
    n_lines, _, path, data, exp_out, exp_err = expected

    def drive(pipe):
        _send_tcp(pipe.input.bound_port, data)
        _wait_output("tcp_line", len(exp_out))

    r = net_run(_net_config("tcp_line", 'type = "tcp"\n'
                            'listen = "127.0.0.1:0"\n'), drive)
    errs, econ = econ_split(r["errs"])
    same = r["out"] == exp_out and same_stderr("rfc5424", errs, exp_err[0])
    if not same:
        raise AssertionError(f"tcp_line: differs from rfc5424_line's "
                             f"expectation (bytes {len(r['out'])} vs "
                             f"{len(exp_out)}, stderr lines {len(errs)} vs "
                             f"{len(exp_err[0])})")
    _need_rfc5424("tcp_line", r["report"]["launches"])
    rep = r["report"]
    emit({"phase": "transport", "run": "tcp_line", "lines": n_lines,
          "connections": 1, "lines_per_s": n_lines / rep["wall_s"],
          "rfc5424_line_lines_per_s": {
              "e2e_inproc": RATES.get("e2e_rfc5424_line"),
              "overlap_ab_default_window": RATES.get(
                  "overlap_rfc5424_line")},
          **rep, "economics_notices": econ,
          "identical_to_expectation": same})
    return rep


def _is_subsequence(want: list, got: list) -> bool:
    it = iter(got)
    return all(any(g == w for g in it) for w in want)


def _tcp_conns(expected, single: dict) -> dict:
    """tcp_conns: the same corpus over TCP_CONNS connections at once, one
    slice each; the records as a multiset, and each connection's in its
    order."""
    from collections import Counter

    from flowgger_tpu_torch.corpus import scalar_expectation

    n_lines, _, path, data, exp_out, exp_err = expected
    lines = data.split(b"\n")[:n_lines]
    per = n_lines // TCP_CONNS
    slices = [b"".join(ln + b"\n" for ln in lines[c * per:(c + 1) * per])
              for c in range(TCP_CONNS)]
    exps = [scalar_expectation(sl) for sl in slices]

    def drive(pipe):
        port = pipe.input.bound_port
        barrier = threading.Barrier(TCP_CONNS)

        def send(sl):
            barrier.wait(NET_WAIT)
            _send_tcp(port, sl)

        senders = [threading.Thread(target=send, args=(sl,))
                   for sl in slices]
        for t in senders:
            t.start()
        for t in senders:
            t.join(NET_WAIT)
        _wait_output("tcp_conns", sum(len(out) for out, _ in exps))

    r = net_run(_net_config("tcp_conns", 'type = "tcp"\n'
                            'listen = "127.0.0.1:0"\n'), drive)
    got = _records(r["out"])
    want = [rec for out, _ in exps for rec in _records(out)]
    errs, econ = econ_split(r["errs"])
    same = (Counter(got) == Counter(want)
            and all(_is_subsequence(_records(out), got) for out, _ in exps)
            and Counter(errs) == Counter(e for _, es in exps for e in es))
    if not same:
        raise AssertionError(f"tcp_conns: {len(got)} records vs {len(want)} "
                             f"expected, or a connection out of order, or "
                             f"stderr {len(errs)} lines differ")
    _need_rfc5424("tcp_conns", r["report"]["launches"])
    rep = r["report"]
    emit({"phase": "transport", "run": "tcp_conns", "lines": per * TCP_CONNS,
          "connections": TCP_CONNS,
          "lines_per_s": per * TCP_CONNS / rep["wall_s"], **rep,
          "against_tcp_line": {
              k: single[k] for k in ("batches", "rows_per_batch",
                                     "batches_per_flush", "launches")},
          "economics_notices": econ,
          "identical_as_multiset_and_in_order_a_connection": same})
    return rep


def _udp_dgram(expected) -> dict:
    """udp_dgram: UDP_DGRAMS paced datagrams of the rfc5424_line corpus,
    every UDP_ZLIB_EVERY-th zlib-compressed, through the recvmmsg path
    into the batch handler's span ingest; every received record must be
    its datagram's expected record (the scalar path, one datagram at a
    time), and at most UDP_MAX_LOST of them may be lost (counted)."""
    import zlib
    from collections import Counter

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.decoders import RFC5424Decoder
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.splitters import ScalarHandler
    from flowgger_tpu_torch.tpu import batch as batch_mod
    from flowgger_tpu_torch.utils import recvmmsg

    if not recvmmsg.available():
        raise AssertionError("udp_dgram: recvmmsg is not available")
    lines = expected[3].split(b"\n")[:UDP_DGRAMS]
    dgrams = [zlib.compress(ln) if i % UDP_ZLIB_EVERY == 0 else ln
              for i, ln in enumerate(lines)]

    class _Tx(list):
        put = list.append

    tx = _Tx()
    scalar = ScalarHandler(tx, RFC5424Decoder(),
                           GelfEncoder(Config.from_string("")))
    scalar.bare_errors = True
    err_buf = io.StringIO()
    with contextlib.redirect_stderr(err_buf):
        for ln in lines:
            scalar.handle_bytes(ln)
    want = Counter(rec + b"\0" for rec in tx)
    want_errs = Counter(err_buf.getvalue().splitlines())
    spans = {"calls": 0, "datagrams": 0}
    ingest = batch_mod.BatchHandler.ingest_spans

    def counted(self, chunk, starts, lens):
        spans["calls"] += 1
        spans["datagrams"] += len(starts)
        return ingest(self, chunk, starts, lens)

    def drive(pipe):
        port = pipe.input.bound_port
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i, d in enumerate(dgrams):
                s.sendto(d, ("127.0.0.1", port))
                if i % 32 == 31:
                    time.sleep(0.001)  # paced: a burst overflows loopback
        out = WORK / "udp_dgram.out"
        last = [-1, time.monotonic()]

        def settled():
            n = out.stat().st_size if out.exists() else 0
            if n != last[0]:
                last[:] = [n, time.monotonic()]
            return n > 0 and time.monotonic() - last[1] > 0.5

        _wait_for(settled, "the datagrams' records")

    batch_mod.BatchHandler.ingest_spans = counted
    try:
        r = net_run(_net_config("udp_dgram", 'type = "udp"\n'
                                'listen = "127.0.0.1:0"\n'), drive)
    finally:
        batch_mod.BatchHandler.ingest_spans = ingest
    got = Counter(rec + b"\0" for rec in _records(r["out"]))
    errs, econ = econ_split(r["errs"])
    got_errs = Counter(errs)
    differ = sum((got - want).values())
    lost = sum(want.values()) - sum(got.values())
    if differ or got_errs - want_errs:
        raise AssertionError(f"udp_dgram: {differ} received records differ "
                             f"from their datagrams' expected records "
                             f"({list(got - want)[:3]}), stderr lines not "
                             f"expected: {list(got_errs - want_errs)[:5]}")
    if lost > UDP_MAX_LOST * len(dgrams):
        raise AssertionError(f"udp_dgram: {lost} of {len(dgrams)} datagrams "
                             f"lost")
    if not spans["calls"]:
        raise AssertionError("udp_dgram: ingest_spans took no datagram")
    _need_rfc5424("udp_dgram", r["report"]["launches"], framed=False)
    rep = r["report"]
    emit({"phase": "transport", "run": "udp_dgram", "datagrams": len(dgrams),
          "zlib_every": UDP_ZLIB_EVERY, "expected_records":
          sum(want.values()), "received_records": sum(got.values()),
          "lost_records": lost, "ingest_spans": spans, **rep,
          "economics_notices": econ, "received_records_identical": True})
    return rep


def _scalar_tcp(expected) -> dict:
    """scalar_tcp: the scalar rfc5424 format over tcp (host only: no
    kernel may launch), SCALAR_TCP_LINES lines, against rfc5424_tpu over
    tcp on the same lines in the same call."""
    from flowgger_tpu_torch.corpus import scalar_expectation

    lines = expected[3].split(b"\n")[:SCALAR_TCP_LINES]
    data = b"".join(ln + b"\n" for ln in lines)
    size = len(scalar_expectation(data)[0])
    runs = {}
    for fmt in ("rfc5424", "rfc5424_tpu"):
        def drive(pipe, name=f"scalar_tcp_{fmt}"):
            _send_tcp(pipe.input.bound_port, data)
            _wait_output(name, size)

        runs[fmt] = net_run(_net_config(
            f"scalar_tcp_{fmt}", 'type = "tcp"\nlisten = "127.0.0.1:0"\n',
            fmt), drive)
    scalar, tpu = runs["rfc5424"], runs["rfc5424_tpu"]
    if scalar["report"]["launches"]:
        raise AssertionError(f"scalar_tcp: the scalar format launched "
                             f"{scalar['report']['launches']}")
    errs, econ = econ_split(tpu["errs"])
    if scalar["out"] != tpu["out"] or scalar["errs"] != errs:
        raise AssertionError(f"scalar_tcp: the scalar format's bytes "
                             f"({len(scalar['out'])}) or stderr differ from "
                             f"rfc5424_tpu's ({len(tpu['out'])})")
    _need_rfc5424("scalar_tcp", tpu["report"]["launches"])
    emit({"phase": "transport", "run": "scalar_tcp", "lines": len(lines),
          "scalar": {"lines_per_s": len(lines) / scalar["wall_s"],
                     "wall_s": scalar["wall_s"]},
          "rfc5424_tpu": {"lines_per_s": len(lines) / tpu["wall_s"],
                          **tpu["report"]},
          "economics_notices": econ, "identical_to_rfc5424_tpu": True})
    return tpu["report"]


class SigtermCli:
    """tcp_cli_sigterm: ``python3 -m flowgger_tpu_torch cfg.toml`` with a
    tcp input into the LTSV output (line framing), started first (it
    boots while other runs go on, as the e2e phase's CLI runs boot beside
    their expectations); :meth:`run` sends SIGTERM_LINES lines on one
    connection, closes it, then (the output complete) SIGTERM: exit 0,
    the "Received signal 15" line, the output byte-identical to the
    scalar path's LTSV bytes.  It is the LTSV output's CLI run on the
    card since rfc5424_ltsv_line's was cut."""

    def __init__(self):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            self.port = probe.getsockname()[1]
        cfg = _net_config("tcp_cli_sigterm",
                          f'type = "tcp"\nlisten = "127.0.0.1:{self.port}"\n',
                          out_keys='format = "ltsv"\nframing = "line"\n')
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "flowgger_tpu_torch", str(cfg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=str(ROOT))

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def run(self, expected) -> None:
        _tcp_cli_sigterm(self, expected)


def _tcp_cli_sigterm(cli: SigtermCli, expected) -> None:
    import signal

    from flowgger_tpu_torch.corpus import scalar_expectation
    from flowgger_tpu_torch.mergers import LineMerger

    lines = expected[3].split(b"\n")[:SIGTERM_LINES]
    data = b"".join(ln + b"\n" for ln in lines)
    exp_out, exp_err = scalar_expectation(data, merger=LineMerger(),
                                          output="ltsv")
    port, proc, t0 = cli.port, cli.proc, cli.t0
    out = WORK / "tcp_cli_sigterm.out"
    try:
        deadline = time.monotonic() + NET_WAIT
        while True:
            try:
                conn = socket.create_connection(("127.0.0.1", port),
                                                timeout=NET_WAIT)
                break
            except OSError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise AssertionError("tcp_cli_sigterm: the CLI never "
                                         "listened")
                time.sleep(0.05)
        t_listen = time.perf_counter() - t0
        t_send = time.perf_counter()
        with conn:
            conn.sendall(data)
        _wait_for(lambda: out.exists() and out.stat().st_size
                  >= len(exp_out), "the CLI's output")
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=NET_WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t_end = time.perf_counter()
    errs = stderr.decode().splitlines()
    rest, econ = econ_split([e for e in errs if not e.startswith(
        "Received signal ")])
    ok = (proc.returncode == 0 and out.read_bytes() == exp_out
          and "Received signal 15, draining and exiting" in errs
          and rest == exp_err)
    if not ok:
        raise AssertionError(f"tcp_cli_sigterm: exit {proc.returncode}, "
                             f"bytes equal={out.read_bytes() == exp_out}, "
                             f"stderr:\n" + stderr.decode()[-3000:])
    emit({"phase": "transport", "run": "tcp_cli_sigterm",
          "lines": len(lines), "output": "ltsv", "exit_code": proc.returncode,
          "listening_after_s": t_listen, "send_to_exit_s": t_end - t_send,
          "wall_s": t_end - t0,
          "stdout_lines": stdout.decode().splitlines()[:3],
          "economics_notices": econ, "identical_to_expectation": True})


def phase_transports(seed: int):
    """The network inputs on ``cuda`` (after ``overlap_ab``, on the e2e
    runs' rfc5424_line input, :data:`EXPECTED`): ``tcp_line``,
    ``tcp_conns``, ``udp_dgram``, ``scalar_tcp`` in process through
    ``Pipeline.run`` / ``Pipeline.shutdown``, and ``tcp_cli_sigterm``
    through the CLI; a ``transport`` line each.  Launch shapes the
    kernels phase did not check are checked after, with the others
    (:func:`phase_late_shapes`).  Returns the in-process runs' launch
    counts summed."""
    expected = EXPECTED["rfc5424_line"]
    total = {}
    single = _tcp_line(expected)
    reps = [single, _tcp_conns(expected, single)]
    # the CLI boots beside the two runs that follow (the rates of
    # tcp_line and tcp_conns are taken without it)
    with SigtermCli() as cli:
        reps += [_udp_dgram(expected), _scalar_tcp(expected)]
        cli.run(expected)
    for rep in reps:
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# -- the sinks phase: redis → Kafka, and the rotating file ------------------
REDIS_KAFKA_LINES = BATCH      # lines of redis_kafka (cell 1's corpus)
RESP_LOOP_LINES = 2048         # lines of redis_kafka's loop-alone control
ROTATE_SIZE = 4 << 20          # file_rotate's output.file_rotation_size
ROTATE_MAXFILES = 1000         # file_rotate's file_rotation_maxfiles
ROTATE_BUFFER = 64 << 10       # file_rotate's output.file_buffer_size


def _resp_bulk(v: bytes) -> bytes:
    return b"$%d\r\n%s\r\n" % (len(v), v)


def _resp_array(items) -> bytes:
    return b"*%d\r\n" % len(items) + b"".join(
        b":%d\r\n" % v if isinstance(v, int) else _resp_bulk(v)
        for v in items)


def _resp_encode(parts) -> bytes:
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        p = p.encode() if isinstance(p, str) else p
        out.append(_resp_bulk(p))
    return b"".join(out)


def _resp_items(buf: bytearray, end: int):
    """The items of a RESP array reply whose header ends at ``end``
    (integers and bulk strings), or None while it is incomplete."""
    n, pos, items = int(buf[1:end]), end + 2, []
    while len(items) < max(n, 0):
        e = buf.find(b"\r\n", pos)
        if e < 0:
            return None
        if buf[pos:pos + 1] == b":":
            items.append(int(buf[pos + 1:e]))
            pos = e + 2
            continue
        size = int(buf[pos + 1:e])
        if len(buf) < e + 4 + size:
            return None
        items.append(bytes(buf[e + 2:e + 2 + size]))
        pos = e + 4 + size
    return items


def _resp_parse(buf: bytearray):
    """One RESP array of bulk strings off the front of ``buf``: (its
    parts, bytes used), or None while it is incomplete."""
    end = buf.find(b"\r\n")
    if end < 0:
        return None
    if buf[:1] != b"*":
        raise ValueError("not a RESP array")
    pos, parts = end + 2, []
    for _ in range(int(buf[1:end])):
        end = buf.find(b"\r\n", pos)
        if end < 0:
            return None
        n = int(buf[pos + 1:end])
        if len(buf) < end + 2 + n + 2:
            return None
        parts.append(bytes(buf[end + 2:end + 2 + n]))
        pos = end + 4 + n
    return parts, pos


_GONE = object()   # a fake's reply: the connection ends, unanswered


class _RespServer:
    """RespFake's server, one thread in its own process: a selector over
    the listener and the connections; a BRPOPLPUSH on an empty list parks
    its connection until a push (or its timeout), FIFO."""

    def __init__(self, sock, drop_at_lrem: int):
        import selectors
        from collections import deque

        self.sel = selectors.DefaultSelector()
        self.sock = sock
        self.deque = deque
        self.lists: dict = {}
        self.drop_at_lrem = drop_at_lrem
        self.stats = {"commands": 0, "popped": 0, "connections": 0}
        self.state: dict = {}     # conn -> {"buf", "brpops", "control"}
        self.parked: list = []    # (conn, src, dst, deadline or None)
        self.running = True
        sock.setblocking(False)
        self.sel.register(sock, selectors.EVENT_READ)

    def serve(self) -> None:
        while self.running:
            for key, _ in self.sel.select(0.05):
                if key.fileobj is self.sock:
                    self._accept()
                else:
                    self._read(key.fileobj)
            self._wake_parked(timeouts=True)
        for conn in list(self.state):
            self._drop(conn)
        self.sel.close()
        self.sock.close()

    def _accept(self) -> None:
        import selectors

        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        conn.setblocking(True)
        self.state[conn] = {"buf": bytearray(), "brpops": 0,
                            "control": False}
        self.sel.register(conn, selectors.EVENT_READ)

    def _drop(self, conn) -> None:
        self.state.pop(conn, None)
        self.parked = [p for p in self.parked if p[0] is not conn]
        try:
            self.sel.unregister(conn)
        except (KeyError, ValueError):  # flowcheck: disable=FC04 -- already unregistered; the close below ends it
            pass
        conn.close()

    def _read(self, conn) -> None:
        try:
            chunk = conn.recv(65536)
        except OSError:
            chunk = b""
        if not chunk:
            self._drop(conn)
            return
        self.state[conn]["buf"] += chunk
        self._run(conn)

    def _run(self, conn) -> None:
        """Answer the complete commands a connection has sent, unless it
        is parked on a BRPOPLPUSH."""
        st = self.state.get(conn)
        while st is not None and not any(p[0] is conn for p in self.parked):
            got = _resp_parse(st["buf"])
            if got is None:
                return
            parts, used = got
            del st["buf"][:used]
            reply = self._execute(conn, st, parts)
            if reply is _GONE:
                self._drop(conn)
                return
            if reply is not None:
                try:
                    conn.sendall(reply)
                except OSError:
                    self._drop(conn)
                    return

    def _move(self, src: bytes, dst: bytes):
        dq = self.lists.get(src)
        if not dq:
            return None
        v = dq.pop()
        self.lists.setdefault(dst, self.deque()).appendleft(v)
        self.stats["popped"] += 1
        return v

    def _wake_parked(self, timeouts: bool = False) -> None:
        now = time.monotonic()
        for p in list(self.parked):
            conn, src, dst, deadline = p
            v = self._move(src, dst)
            if v is None and not (timeouts and deadline is not None
                                  and now > deadline):
                continue
            self.parked.remove(p)
            try:
                conn.sendall(b"*-1\r\n" if v is None else _resp_bulk(v))
            except OSError:
                self._drop(conn)
                continue
            self._run(conn)

    def _execute(self, conn, st: dict, parts: list):
        name, args = parts[0].upper(), parts[1:]
        if name == b"FAKECONTROL":      # the test's own connection
            st["control"] = True
            return b"+OK\r\n"
        if name == b"FAKEINFO":
            return _resp_array([self.stats[k] for k in
                                ("commands", "popped", "connections")])
        if name == b"FAKESTOP":
            self.running = False
            return b"+OK\r\n"
        if not st["control"]:
            self.stats["commands"] += 1
            if not st.get("seen"):
                st["seen"] = True
                self.stats["connections"] += 1
        if name == b"LREM" and self.drop_at_lrem \
                and st["brpops"] == self.drop_at_lrem:
            self.drop_at_lrem = 0
            return _GONE
        if name == b"BRPOPLPUSH":
            st["brpops"] += 1
            v = self._move(args[0], args[1])
            if v is not None:
                return _resp_bulk(v)
            timeout = float(args[2])
            self.parked.append((conn, args[0], args[1],
                                time.monotonic() + timeout if timeout
                                else None))
            return None
        if name == b"RPOPLPUSH":
            v = self._move(args[0], args[1])
            return b"$-1\r\n" if v is None else _resp_bulk(v)
        if name in (b"LPUSH", b"RPUSH"):
            dq = self.lists.setdefault(args[0], self.deque())
            if name == b"LPUSH":
                dq.extendleft(args[1:])
            else:
                dq.extend(args[1:])
            n = len(dq)
            self._wake_parked()
            return b":%d\r\n" % n
        if name == b"LREM":
            dq = self.lists.get(args[0], self.deque())
            count, value = int(args[1]), args[2]
            items = list(dq) if count >= 0 else list(dq)[::-1]
            kept, removed = [], 0
            for v in items:
                if v == value and (count == 0 or removed < abs(count)):
                    removed += 1
                else:
                    kept.append(v)
            dq.clear()
            dq.extend(kept if count >= 0 else kept[::-1])
            return b":%d\r\n" % removed
        if name == b"LLEN":
            return b":%d\r\n" % len(self.lists.get(args[0], ()))
        if name == b"LRANGE":
            items = list(self.lists.get(args[0], ()))
            lo, hi = int(args[1]), int(args[2])
            return _resp_array(items[lo:(None if hi == -1 else hi + 1)])
        if name == b"DEL":
            return b":%d\r\n" % int(self.lists.pop(args[0], None)
                                    is not None)
        return b"-ERR unknown command\r\n"


def _resp_fake_main(sock, drop_at_lrem: int) -> None:
    """RespFake's process: serve on the listener the parent bound."""
    _RespServer(sock, drop_at_lrem).serve()


class RespFake:
    """A Redis server in miniature, in a process of its own (so that its
    loop shares no interpreter lock with the pipeline it feeds; the
    listener is bound here and handed down), on a loopback port: lists of bytes and the commands the
    redis input and its tests send (RPOPLPUSH, BRPOPLPUSH with its
    blocking wait, LREM, LPUSH, RPUSH, LRANGE, LLEN, DEL), RESP2 on the
    wire.  ``drop_at_lrem = k`` closes a connection without a reply at
    the LREM that follows its k-th BRPOPLPUSH (once): the worker then
    reconnects.  The test side talks to it over a control connection:
    :meth:`lpush`, :meth:`llen`, :meth:`lrange`, and the counts
    ``commands`` (the commands the other connections sent), ``popped``
    (the BRPOPLPUSH / RPOPLPUSH replies that moved a message) and
    ``connections``."""

    def __init__(self, drop_at_lrem: int = 0):
        listener = socket.create_server(("127.0.0.1", 0))
        self.port = listener.getsockname()[1]
        code = ("import socket, sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke._resp_fake_main("
                "socket.socket(fileno=int(sys.argv[2])), int(sys.argv[3]))")
        try:
            self._proc = subprocess.Popen(
                [sys.executable, "-c", code, str(ROOT),
                 str(listener.fileno()), str(drop_at_lrem)],
                pass_fds=(listener.fileno(),), cwd=str(ROOT))
        finally:
            listener.close()
        self._ctl = socket.create_connection(("127.0.0.1", self.port),
                                             timeout=NET_WAIT)
        self._command("FAKECONTROL")

    @property
    def connect(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _command(self, *parts):
        """Send one command on the control connection and read its reply
        (a status, an error, an integer, or an array)."""
        self._ctl.sendall(_resp_encode(parts))
        buf = bytearray()
        while True:
            end = buf.find(b"\r\n")
            if end >= 0:
                head, kind = bytes(buf[:end]), buf[:1]
                if kind == b"-":
                    raise AssertionError(head.decode())
                if kind == b":":
                    return int(head[1:])
                if kind == b"+":
                    return head[1:]
                items = _resp_items(buf, end)
                if items is not None:
                    return items
            chunk = self._ctl.recv(1 << 20)
            if not chunk:
                raise AssertionError("the RESP fake closed its control "
                                     "connection")
            buf += chunk

    # -- the test's side ---------------------------------------------------
    def lpush(self, key: str, values) -> None:
        """LPUSH each value in turn: the first comes out of BRPOPLPUSH
        first."""
        self._command("LPUSH", key, *values)

    def llen(self, key: str) -> int:
        return self._command("LLEN", key)

    def lrange(self, key: str) -> list:
        return self._command("LRANGE", key, "0", "-1")

    def _info(self) -> dict:
        return dict(zip(("commands", "popped", "connections"),
                        self._command("FAKEINFO")))

    @property
    def commands(self) -> int:
        return self._info()["commands"]

    @property
    def popped(self) -> int:
        return self._info()["popped"]

    @property
    def connections(self) -> int:
        return self._info()["connections"]

    def close(self) -> None:
        """Stop the fake's process (every connection closes with it)."""
        try:
            self._command("FAKESTOP")
        except (OSError, AssertionError):  # flowcheck: disable=FC04 -- the process is gone already; the join below reaps it
            pass
        self._ctl.close()
        try:
            self._proc.wait(NET_WAIT)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(NET_WAIT)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_CRC32C_TABLE: list = []


def crc32c_py(data: bytes) -> int:
    """CRC32C (Castagnoli), table-driven in Python: the broker fake's own
    check of a record batch, apart from the port's native one."""
    if not _CRC32C_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC32C_TABLE.append(c)
    t = _CRC32C_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ t[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def snappy_decompress_py(data: bytes) -> bytes:
    """A raw snappy block decoded in Python (every element type): the
    broker fake's own decoder, apart from the port's native one."""
    ulen, pos, shift = 0, 0, 0
    while True:
        b = data[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            ln = (tag >> 2) + 1
            if ln > 60:
                nb = ln - 60
                ln = int.from_bytes(data[pos:pos + nb], "little") + 1
                pos += nb
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        else:
            nb = 2 if kind == 2 else 4
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + nb], "little")
            pos += nb
        if not 0 < off <= len(out):
            raise AssertionError("snappy: a copy's offset lies outside")
        while ln > 0:   # an overlapping copy repeats its period
            step = min(ln, off)
            out += out[len(out) - off:len(out) - off + step]
            ln -= step
    if len(out) != ulen:
        raise AssertionError("snappy: the block's length disagrees")
    return bytes(out)


def _varint_at(data: bytes, pos: int):
    """A zigzag varint at ``pos``: (value, next position)."""
    v, shift = 0, 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return (v >> 1) ^ -(v & 1), pos


class KafkaFake:
    """A one-partition Kafka broker that leads itself, on a loopback port:
    ApiVersions v0 (Produce 0-8, Metadata 0-9), Metadata v0 / v4 and
    Produce v0 / v3.  Each Produce's record set is kept as sent and
    acknowledged (unless acks = 0); :meth:`records` then checks each set
    (a v2 batch: magic, its CRC32C over the post-CRC bytes, the offset
    deltas; a v0 message: its CRC32), decompresses it (snappy, gzip) and
    returns the values in order.  ``legacy`` closes the connection on
    ApiVersions (a broker older than 0.10) and speaks v0;
    ``fail_produce`` closes it on every Produce (a broker that stays
    down)."""

    def __init__(self, legacy: bool = False, fail_produce: bool = False):
        self.legacy = legacy
        self.fail_produce = fail_produce
        self.sets: list = []      # (Produce version, record set bytes)
        self.requests: dict = {}  # api key -> requests
        self._lock = threading.Lock()
        self._threads: list = []
        self._conns: set = set()
        self._sock = socket.create_server(("127.0.0.1", 0))
        self.port = self._sock.getsockname()[1]
        self._accept = threading.Thread(target=self._serve,
                                        name="kafka-fake", daemon=True)
        self._accept.start()

    @property
    def broker(self) -> str:
        return f"127.0.0.1:{self.port}"

    def close(self) -> None:
        """Stop serving: the listener and every connection close, and
        the fake's threads end."""
        with self._lock:
            conns = list(self._conns)
        # a shutdown wakes the blocked accept (a close alone does not)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:  # flowcheck: disable=FC04 -- not listening any more; the close below ends it
            pass
        self._sock.close()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:  # flowcheck: disable=FC04 -- already disconnected; the close below ends it
                pass
            conn.close()
        self._accept.join(NET_WAIT)
        for t in self._threads:
            t.join(NET_WAIT)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._client, args=(conn,),
                                 name="kafka-fake-client", daemon=True)
            self._threads.append(t)
            t.start()

    @staticmethod
    def _read(rfile, n: int) -> bytes:
        data = rfile.read(n)
        if len(data) != n:
            raise EOFError
        return data

    def _client(self, conn) -> None:
        import struct

        rfile = conn.makefile("rb")
        try:
            while True:
                size = struct.unpack(">i", self._read(rfile, 4))[0]
                req = self._read(rfile, size)
                api, ver, corr, clen = struct.unpack_from(">hhih", req, 0)
                body = req[10 + max(clen, 0):]
                with self._lock:
                    self.requests[api] = self.requests.get(api, 0) + 1
                reply = self._answer(api, ver, body)
                if reply is _GONE:
                    return
                if reply is not None:
                    payload = struct.pack(">i", corr) + reply
                    conn.sendall(struct.pack(">i", len(payload)) + payload)
        except (OSError, EOFError, struct.error):
            return
        finally:
            with self._lock:
                self._conns.discard(conn)
            rfile.close()
            conn.close()

    def _answer(self, api: int, ver: int, body: bytes):
        import struct

        def string(s: bytes) -> bytes:
            return struct.pack(">h", len(s)) + s

        if api == 18:   # ApiVersions
            if self.legacy:
                return _GONE
            ranges = ((0, 0, 8), (3, 0, 9), (18, 0, 3))
            return struct.pack(">hi", 0, len(ranges)) + b"".join(
                struct.pack(">hhh", *r) for r in ranges)
        if api == 3:    # Metadata
            n = struct.unpack_from(">i", body, 0)[0]
            tlen = struct.unpack_from(">h", body, 4)[0]
            topic = body[6:6 + tlen] if n > 0 else b"logs"
            node = struct.pack(">i", 0) + string(b"127.0.0.1") + \
                struct.pack(">i", self.port)
            part = struct.pack(">hiiii", 0, 0, 0, 1, 0) + \
                struct.pack(">ii", 1, 0)
            if ver >= 4:
                return (struct.pack(">ii", 0, 1) + node
                        + struct.pack(">h", -1)            # rack
                        + struct.pack(">h", -1)            # cluster id
                        + struct.pack(">ii", 0, 1)         # controller
                        + struct.pack(">h", 0) + string(topic)
                        + struct.pack(">b", 0)             # internal
                        + struct.pack(">i", 1) + part)
            return (struct.pack(">i", 1) + node + struct.pack(">ih", 1, 0)
                    + string(topic) + struct.pack(">i", 1) + part)
        if api == 0:    # Produce
            if self.fail_produce:
                return _GONE
            pos = 0
            if ver >= 3:
                tid = struct.unpack_from(">h", body, 0)[0]
                pos = 2 + max(tid, 0)
            acks, _ = struct.unpack_from(">hi", body, pos)
            pos += 6
            out = b""
            for _ in range(struct.unpack_from(">i", body, pos)[0]):
                tlen = struct.unpack_from(">h", body, pos + 4)[0]
                topic = body[pos + 6:pos + 6 + tlen]
                pos += 6 + tlen
                nparts = struct.unpack_from(">i", body, pos)[0]
                pos += 4
                parts = b""
                for _ in range(nparts):
                    pid, size = struct.unpack_from(">ii", body, pos)
                    with self._lock:
                        self.sets.append((ver, body[pos + 8:pos + 8 + size]))
                    pos += 8 + size
                    parts += struct.pack(">ihq", pid, 0, 0) + (
                        struct.pack(">q", -1) if ver >= 3 else b"")
                out += string(topic) + struct.pack(">i", nparts) + parts
            if acks == 0:
                return None
            return struct.pack(">i", 1) + out + (
                struct.pack(">i", 0) if ver >= 3 else b"")
        return _GONE

    # -- the check ---------------------------------------------------------
    def records(self) -> tuple:
        """(values in order, a report: sets, batches, records a batch,
        compression codes seen, every checksum valid).  Raises
        AssertionError on a bad checksum, magic or offset delta."""
        import gzip
        import struct
        import zlib

        with self._lock:
            sets = list(self.sets)
        values, batches, codecs = [], 0, set()

        def message_set(data: bytes) -> None:
            pos = 0
            while pos < len(data):
                size = struct.unpack_from(">i", data, pos + 8)[0]
                msg = data[pos + 12:pos + 12 + size]
                crc, magic, attrs = struct.unpack_from(">Ibb", msg, 0)
                if zlib.crc32(msg[4:]) != crc or magic != 0:
                    raise AssertionError("kafka v0: a message's CRC32 or "
                                         "magic is wrong")
                klen = struct.unpack_from(">i", msg, 6)[0]
                vpos = 10 + max(klen, 0)
                vlen = struct.unpack_from(">i", msg, vpos)[0]
                value = msg[vpos + 4:vpos + 4 + vlen]
                codecs.add(attrs & 7)
                if attrs & 7 == 1:
                    message_set(gzip.decompress(value))
                else:
                    values.append(value)
                pos += 12 + size

        for ver, data in sets:
            if ver < 3:
                batches += 1
                message_set(data)
                continue
            pos = 0
            while pos < len(data):
                batches += 1
                blen = struct.unpack_from(">i", data, pos + 8)[0]
                end = pos + 12 + blen
                magic, crc = struct.unpack_from(">bI", data, pos + 16)
                post = data[pos + 21:end]
                if magic != 2 or crc32c_py(post) != crc:
                    raise AssertionError("kafka v2: a batch's magic or "
                                         "CRC32C is wrong")
                attrs, last_delta = struct.unpack_from(">hi", post, 0)
                count = struct.unpack_from(">i", post, 36)[0]
                recs = post[40:]
                codecs.add(attrs & 7)
                if attrs & 7 == 1:
                    recs = gzip.decompress(recs)
                elif attrs & 7 == 2:
                    recs = snappy_decompress_py(recs)
                rpos = 0
                for i in range(count):
                    rlen, rpos = _varint_at(recs, rpos)
                    rend = rpos + rlen
                    _, q = _varint_at(recs, rpos + 1)       # ts delta
                    delta, q = _varint_at(recs, q)
                    klen, q = _varint_at(recs, q)
                    q += max(klen, 0)
                    vlen, q = _varint_at(recs, q)
                    if delta != i:
                        raise AssertionError("kafka v2: offset deltas out "
                                             "of order")
                    values.append(recs[q:q + vlen])
                    rpos = rend
                if last_delta != count - 1:
                    raise AssertionError("kafka v2: lastOffsetDelta is not "
                                         "the record count less one")
                pos = end
        return values, {"sets": len(sets), "batches": batches,
                        "records_per_batch": len(values) / max(batches, 1),
                        "compression": sorted(codecs),
                        "checksums_valid": True}


def resp_loop_rate(resp: "RespFake", lines: list) -> float:
    """Lines/s of the redis worker's loop alone (BRPOPLPUSH, then LREM,
    with the port's RESP client) over ``lines`` against ``resp``, in this
    process with no pipeline running: the bound the redis input's round
    trips set, beside which redis_kafka's rate is read."""
    from flowgger_tpu_torch.utils.resp import RespClient

    resp.lpush("loop", lines)
    cnx = RespClient.from_connect_string(resp.connect, timeout=NET_WAIT)
    try:
        t0 = time.perf_counter()
        for _ in lines:
            cnx.lrem("loop.tmp", 1, cnx.brpoplpush("loop", "loop.tmp", 0))
        return len(lines) / (time.perf_counter() - t0)
    finally:
        cnx.close()


def _need_capnp(name: str, launches: dict) -> None:
    """A rfc5424_tpu → capnp run decoded on the card (K1 p6) and probed
    OC or FO/capnp there."""
    if not (launches.get("decode_rfc5424_p6")
            and (launches.get("encode_capnp_probe_p6")
                 or launches.get("fused_rfc5424_capnp_probe"))):
        raise AssertionError(f"{name}: the run did not decode and probe "
                             f"capnp on the card: {launches}")


def _redis_kafka(seed: int) -> dict:
    """redis_kafka: cell 1's corpus (REDIS_KAFKA_LINES lines, one list
    element each) in a RespFake's list, through the redis input
    (``redis_threads = 1``), ``rfc5424_tpu`` on the card and the Kafka
    sink into a KafkaFake (capnp, snappy, coalesce 1000, acks 1), in
    process; the broker's records, in order, must be the scalar path's
    capnp records (the pool's expectation), every batch's CRC32C valid."""
    from flowgger_tpu_torch import native
    from flowgger_tpu_torch.corpus import capnp_messages, mask_capnp_stamps

    _, data, exp_out, exp_err, _, since, mix = expected(_sinks_job(seed))
    lines = data.split(b"\0")
    want = [mask_capnp_stamps(exp_out[a:b], since - 1.0)
            for a, b in capnp_messages(exp_out)]
    cfg = WORK / "redis_kafka.toml"
    with RespFake() as resp, KafkaFake() as kafka:
        loop_rate = resp_loop_rate(resp, lines[:RESP_LOOP_LINES])
        before = resp.commands
        resp.lpush("logs", lines)
        cfg.write_text(
            f'[input]\ntype = "redis"\nredis_connect = "{resp.connect}"\n'
            'redis_queue_key = "logs"\nredis_threads = 1\n'
            'format = "rfc5424_tpu"\n'
            '[output]\ntype = "kafka"\nformat = "capnp"\n'
            f'kafka_brokers = ["{kafka.broker}"]\nkafka_topic = "logs"\n'
            'kafka_compression = "snappy"\nkafka_coalesce = 1000\n'
            'kafka_acks = 1\n')

        def drive(pipe):
            _wait_for(lambda: resp.popped >= len(lines)
                      and not resp.llen("logs")
                      and not resp.llen("logs.tmp.0"),
                      "the list's every message popped and removed")

        native.reset_calls()
        r = net_run(cfg, drive, ready=lambda pipe: True,
                    wrappers=_OUT_WRAPPERS)
        calls = dict(native.CALLS)
        got, broker = kafka.records()
        commands = resp.commands - before
        requests = dict(kafka.requests)
    got = [mask_capnp_stamps(v, since - 1.0) for v in got]
    errs, econ = econ_split(r["errs"])
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
        raise AssertionError(f"redis_kafka: {len(got)} records against the "
                             f"scalar path's {len(want)}, the first "
                             f"difference at {first}")
    connected = [f"Connected to Redis [{resp.connect}], pulling messages "
                 f"from key [logs]"]
    if not same_stderr("rfc5424", errs, exp_err) or r["stdout"] != connected:
        first = next((i for i, (a, b) in enumerate(zip(errs, exp_err))
                      if a != b), min(len(errs), len(exp_err)))
        raise AssertionError(f"redis_kafka: {len(errs)} stderr lines against "
                             f"the scalar path's {len(exp_err)}, the first "
                             f"difference at {first}; stdout {r['stdout']}")
    _need_capnp("redis_kafka", r["report"]["launches"])
    if calls["fg_crc32c"] != broker["batches"] or not calls[
            "fg_snappy_compress"]:
        raise AssertionError(f"redis_kafka: native calls {calls} for "
                             f"{broker['batches']} batches")
    rep = r["report"]
    emit({"phase": "sinks", "run": "redis_kafka", "lines": len(lines),
          "records": len(got), "mix": mix,
          "lines_per_s": len(lines) / rep["wall_s"],
          "produce_requests": requests.get(0, 0),
          "resp_commands": commands, "resp_round_trips_per_line":
              commands / len(lines),
          "resp_loop_alone_lines_per_s": loop_rate,
          "kafka": broker, "native_calls": calls, **rep,
          "error_lines": len(errs), "scalar_error_lines": len(exp_err),
          "economics_notices": econ, "stdout": r["stdout"],
          "records_identical_in_order": True})
    return rep


def _file_rotate() -> dict:
    """file_rotate: rfc5424_line's input (stdin, ``rfc5424_tpu``) into
    GELF in a file that rotates at ROTATE_SIZE bytes behind a
    ROTATE_BUFFER-byte buffer, in process; the files, oldest to newest,
    must concatenate to rfc5424_line's expectation, with one "reached
    size limit" line a rotation."""
    from flowgger_tpu_torch.tpu import framing, kernels

    n_lines, _, path, _, exp_out, exp_err = EXPECTED["rfc5424_line"]
    base = WORK / "file_rotate.out"
    for old in WORK.glob("file_rotate.*"):
        old.unlink()
    cfg = WORK / "file_rotate.toml"
    cfg.write_text(
        '[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\nframing = "line"\n'
        '[output]\ntype = "file"\nformat = "gelf"\n'
        f'file_path = "{base}"\nfile_rotation_size = {ROTATE_SIZE}\n'
        f'file_rotation_maxfiles = {ROTATE_MAXFILES}\n'
        f'file_buffer_size = {ROTATE_BUFFER}\n')
    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    with launch_shapes() as seen:
        wall, _, errs, _ = run_inproc(cfg, path)
    LATE.update(seen - CHECKED)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    rotated = [base.with_suffix(f".{i}") for i in range(ROTATE_MAXFILES)]
    files = [f for f in reversed(rotated) if f.exists()] + [base]
    got = b"".join(f.read_bytes() for f in files)
    # the sink thread prints a rotation line while the handler prints
    # error lines, and a print writes its text and its newline apart: each
    # rotation line is taken out whole, wherever it landed
    limit = f"File {base} reached size limit {ROTATE_SIZE}, rotating"
    text = "\n".join(errs)
    rotations = text.count(limit)
    errs, econ = econ_split([ln for ln in text.replace(limit, "\n").split("\n")
                             if ln])
    if (got != exp_out or not same_stderr("rfc5424", errs, exp_err[0])
            or rotations != len(files) - 1 or len(files) < 2):
        raise AssertionError(f"file_rotate: {len(files)} files of "
                             f"{len(got)} bytes against the expectation's "
                             f"{len(exp_out)} (equal={got == exp_out}), "
                             f"{rotations} rotations")
    _need_rfc5424("file_rotate", launches)
    if any(framing.DECLINES.values()):
        raise AssertionError(f"file_rotate: device framing declined "
                             f"{dict(framing.DECLINES)}")
    rep = {"launches": launches}
    emit({"phase": "sinks", "run": "file_rotate", "lines": n_lines,
          "files": len(files), "file_bytes": [f.stat().st_size
                                              for f in files],
          "rotation_size": ROTATE_SIZE, "buffer_size": ROTATE_BUFFER,
          "wall_s": wall, "lines_per_s": n_lines / wall,
          "rfc5424_line_lines_per_s": RATES.get("e2e_rfc5424_line"),
          "launches": launches, "economics_notices": econ,
          "launch_shapes": sorted(f"{k} {list(v)}" for k, v in seen),
          "concatenation_identical": True})
    return rep


def phase_sinks(seed: int):
    """The sinks on ``cuda`` (after the transports): ``redis_kafka`` and
    ``file_rotate``, both in process through ``Pipeline.run`` /
    ``Pipeline.shutdown``; a ``sinks`` line each.  Launch shapes the
    kernels phase did not check are checked after, with the others
    (:func:`phase_late_shapes`).  Returns the runs' launch counts
    summed."""
    total = {}
    for rep in (_redis_kafka(seed), _file_rotate()):
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# -- the serving phase: tenancy, templates, the breaker, the queue ----------
SERVING_LINES = 4 * BATCH      # lines a tenant of tenants_tcp
SERVING_TENANTS = (("127.0.0.2", "limited", 91), ("127.0.0.3", "heavy", 92),
                   ("127.0.0.1", "default", 93))
# the limited tenant's admission rate (lines/s; burst: 2 s of it), far
# under what one connection sends, so that regions are shed
SERVING_RATE = 5000
BREAKER_BATCH = BATCH // 4     # breaker_trip's tpu_batch_size: its eight
#                                oracle-bound batches are 32 768 rows of
#                                600-odd bytes, not 131 072
BREAKER_HEAD = 10 * BREAKER_BATCH  # oracle-bound rows (over MAX_LEN)
BREAKER_TAIL = 4 * BREAKER_BATCH   # clean rows after them (cell 1's mix)
QUEUE_EVERY = 4                # queue_drop's queue_pressure = "every:4"
QUEUE_BATCH = BATCH // 4       # queue_drop's tpu_batch_size: ~16 items put
_TENANT_NOTICE = "tenant [limited] over admission rate; shedding"
_BREAKER_LINE = "device-decode breaker"


def _serving_job(name: str, seed: int, lines: int) -> dict:
    return {"family": "serving", "name": name, "lines": lines,
            "seed": seed, "entry": [], "work": str(WORK)}


def serving_jobs(seed: int, lines: int) -> list:
    """The serving phase's inputs and expectations: each tenant's lines,
    the enrichment run's (rfc5424_line's input, mined), and the breaker
    run's."""
    return ([_serving_job(f"serving_{tenant}", seed + off, SERVING_LINES)
             for _, tenant, off in SERVING_TENANTS]
            + [_serving_job("serving_enrich", seed, lines),
               _serving_job("serving_breaker", seed + 94,
                            BREAKER_HEAD + BREAKER_TAIL)])


def oracle_lines(n: int, seed: int) -> list:
    """``n`` valid RFC5424 lines of 600-odd bytes: longer than MAX_LEN,
    so every one takes the scalar oracle."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = [w.encode() for w in ("GET", "POST", "/api/v1/items", "200",
                                  "404", "user", "session", "latency",
                                  "upstream", "retry", "cache", "miss")]
    out = []
    for i in range(n):
        body = b" ".join(words[int(k)] for k in rng.integers(0, len(words),
                                                             110))
        out.append(b"<14>1 2026-10-19T10:%02d:%02d.%03dZ web%d app %d req%d "
                   b"- %s" % (i // 60 % 60, i % 60, i % 1000, i % 7,
                              1000 + i % 50, i, body[:600]))
    return out


def _serving_input(job: dict):
    from flowgger_tpu_torch import corpus

    name, n_lines, seed = job["name"], job["lines"], job["seed"]
    if name == "serving_breaker":
        lines = oracle_lines(BREAKER_HEAD, seed)
        tail, kinds = corpus.make_corpus(BREAKER_TAIL, seed)
        return lines + tail, ["oracle"] * BREAKER_HEAD + kinds, True
    lines, kinds = corpus.make_corpus(n_lines, seed)
    # a tenant's connection ends on a newline; the enrichment run reads
    # rfc5424_line's input (its last record has none)
    return lines, kinds, name != "serving_enrich"


def serving_enricher():
    """The enrichment run's miner as a scalar record hook (the defaults
    of tenant.templates = "on", as the run's config has them)."""
    from flowgger_tpu_torch.tenancy.templates import (TemplateMinerSet,
                                                      make_gelf_enricher)

    return make_gelf_enricher(TemplateMinerSet(enrich=True))


def _need_serving(name: str, launches: dict, need) -> None:
    """A serving run launched each kernel of ``need`` on the card."""
    if not all(launches.get(k) for k in need):
        raise AssertionError(f"{name}: the run launched none of "
                             f"{[k for k in need if not launches.get(k)]} "
                             f"on the card: {launches}")


def _owned(got: list, exps: dict) -> dict:
    """Each tenant's records of ``got`` in output order (a record that two
    tenants' expectations share is left out of both, and returned apart);
    fails on a record no tenant sent."""
    owner = {}
    for tenant, recs in exps.items():
        for rec in recs:
            owner[rec] = tenant if owner.get(rec, tenant) == tenant else None
    stray = [g for g in got if g not in owner]
    if stray:
        raise AssertionError(f"tenants_tcp: {len(stray)} records no tenant "
                             f"sent")
    shared = {rec for rec, t in owner.items() if t is None}
    return {t: [g for g in got if owner[g] == t] for t in exps}, shared


def _tenants_tcp(seed: int) -> dict:
    """tenants_tcp: three tcp connections at once, from 127.0.0.2 (a
    tenant limited to SERVING_RATE lines/s, drop_oldest), 127.0.0.3
    (weight 8, block) and 127.0.0.1 (the catch-all), SERVING_LINES lines
    of cell 1's mix each, into GELF: each tenant's records an in-order
    subsequence of its expectation, the unlimited tenants' all there,
    the limited tenant's shed in whole regions."""
    from collections import Counter

    exps = {tenant: expected(_serving_job(f"serving_{tenant}", seed + off,
                                          SERVING_LINES))
            for _, tenant, off in SERVING_TENANTS}
    tenants = (f'[tenants.limited]\npeers = ["127.0.0.2"]\n'
               f'rate = {SERVING_RATE}\nqueue_policy = "drop_oldest"\n'
               '[tenants.heavy]\npeers = ["127.0.0.3"]\nweight = 8\n'
               'queue_policy = "block"\n')
    cfg = _net_config("tenants_tcp", 'type = "tcp"\n'
                      'listen = "127.0.0.1:0"\n')
    cfg.write_text(cfg.read_text() + tenants)
    full = sum(len(exps[t][2]) for t in ("heavy", "default"))

    def drive(pipe):
        port = pipe.input.bound_port
        barrier = threading.Barrier(len(SERVING_TENANTS))

        def send(src, data):
            barrier.wait(NET_WAIT)
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=NET_WAIT,
                                          source_address=(src, 0)) as s:
                s.sendall(data)

        senders = [threading.Thread(target=send, args=(src, exps[t][1]))
                   for src, t, _ in SERVING_TENANTS]
        for t in senders:
            t.start()
        for t in senders:
            t.join(NET_WAIT)
        _wait_output("tenants_tcp", full)
        if pipe.input.join_handlers(timeout=NET_WAIT):
            raise AssertionError("tenants_tcp: a connection did not end")

    r = net_run(cfg, drive)
    pipe = r["pipe"]
    got = _records(r["out"])
    want = {t: _records(e[2]) for t, e in exps.items()}
    mine, shared = _owned(got, want)
    ok = True
    for t, recs in mine.items():
        ok &= _is_subsequence(recs, want[t])
        if t == "limited":
            ok &= len(recs) < len(want[t])
        else:
            ok &= Counter(recs) == Counter(w for w in want[t]
                                           if w not in shared)
    errs, econ = econ_split(r["errs"])
    notices = [e for e in errs if e.startswith(_TENANT_NOTICE)]
    errs = [e for e in errs if not e.startswith(_TENANT_NOTICE)]
    all_errs = Counter(e for ex in exps.values() for e in ex[3])
    unlimited = sum(len(exps[t][3]) for t in ("heavy", "default"))
    ok &= (not (Counter(errs) - all_errs) and len(errs) >= unlimited
           and len(notices) >= 1)
    limited = pipe.tenants.state("limited")
    launches = r["report"]["launches"]
    _need_serving("tenants_tcp", launches, ("decode_rfc5424_p6",
                                            "frame_sep_spans",
                                            "frame_gather"))
    if not ok or not limited.drops:
        raise AssertionError(
            f"tenants_tcp: records per tenant "
            f"{ {t: len(v) for t, v in mine.items()} } of "
            f"{ {t: len(v) for t, v in want.items()} }, "
            f"{limited.drops} lines shed, {len(errs)} stderr lines, "
            f"launches {launches}")
    rep = r["report"]
    delivered = len(got)
    emit({"phase": "serving", "run": "tenants_tcp",
          "lines_sent": SERVING_LINES * len(SERVING_TENANTS),
          "records_written": delivered,
          "records_per_tenant": {t: len(v) for t, v in mine.items()},
          "limited_rate": SERVING_RATE, "limited_lines_shed": limited.drops,
          "admission_notices": len(notices),
          "records_per_s": delivered / rep["wall_s"],
          "queue": type(pipe.tx).__name__, **rep,
          "economics_notices": econ,
          "in_order_subsequence_a_tenant": True})
    return rep


def _templates_enrich(seed: int, lines: int) -> dict:
    """templates_enrich: rfc5424_line's input with ``tenant.templates =
    "on"`` and ``template_enrich = true`` (the Record path): the port's
    scalar expectation with the same miner, byte for byte; then the same
    input with mining only (the host block path pinned): rfc5424_line's
    expectation, byte for byte, no fused route or device tier launched."""
    from flowgger_tpu_torch.tpu import framing, kernels

    path, _, exp_out, exp_err, _, _, _ = expected(
        _serving_job("serving_enrich", seed, lines))
    reps = {}
    for run, keys, want_out, want_err in (
            ("templates_enrich", 'templates = "on"\ntemplate_enrich = true\n',
             exp_out, exp_err),
            ("templates_mine", 'templates = "on"\n',
             EXPECTED["rfc5424_line"][4], EXPECTED["rfc5424_line"][5][0])):
        cfg = _net_config(run, 'type = "stdin"\nframing = "line"\n')
        cfg.write_text(cfg.read_text() + "[tenant]\n" + keys)
        for k in framing.DECLINES:
            framing.DECLINES[k] = 0
        kernels.reset_launch_counts()
        with launch_shapes() as seen:
            wall, pipe, errs, _ = run_inproc(cfg, path)
        LATE.update(seen - CHECKED)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        errs, econ = econ_split(errs)
        notice = errs[:1] if run == "templates_enrich" else []
        errs = errs[len(notice):]
        out = (WORK / f"{run}.out").read_bytes()
        h = pipe._handler
        miner = h._miners.miner("default")
        host_pinned = not any(k.startswith(("fused_", "encode_gelf"))
                              for k in launches)
        _need_serving(run, launches, ("decode_rfc5424_p6",))
        if (out != want_out or errs != want_err
                or not host_pinned or miner.distinct() < 2
                or (run == "templates_enrich" and not notice)):
            raise AssertionError(
                f"{run}: {len(out)} bytes vs {len(want_out)} (equal="
                f"{out == want_out}), stderr equal={errs == want_err}, "
                f"launches {launches}, {miner.distinct()} templates")
        reps[run] = {"launches": launches}
        emit({"phase": "serving", "run": run, "lines": lines,
              "wall_s": wall, "lines_per_s": lines / wall,
              "rfc5424_line_lines_per_s": RATES.get("e2e_rfc5424_line"),
              "templates": miner.distinct(), "notice": notice,
              "launches": launches, "economics_notices": econ,
              "identical_to_expectation": True})
    total = {}
    for rep in reps.values():
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
    return {"launches": total}


def _breaker_trip(seed: int) -> dict:
    """breaker_trip: BREAKER_HEAD rows over MAX_LEN (every one an oracle
    row), then BREAKER_TAIL rows of cell 1's mix, stdin → rfc5424_tpu →
    GELF with ``tpu_breaker_window = 4`` and ``tpu_breaker_cooldown_ms =
    100`` (``tpu_batch_size = BREAKER_BATCH``): byte-identical to the
    scalar path; exactly one trip; the probes re-open the breaker until
    the clean tail closes it, and a probe batch launched K1."""
    from flowgger_tpu_torch.tpu import breaker as breaker_mod
    from flowgger_tpu_torch.tpu import framing, kernels

    path, _, exp_out, exp_err, _, _, _ = expected(_serving_job(
        "serving_breaker", seed + 94, BREAKER_HEAD + BREAKER_TAIL))
    cfg = _net_config("breaker_trip", 'type = "stdin"\nframing = "line"\n'
                      f"tpu_batch_size = {BREAKER_BATCH}\n"
                      "tpu_breaker_window = 4\n"
                      "tpu_breaker_cooldown_ms = 100\n")
    marks = []   # (state entered, K1 launches then)
    transition = breaker_mod.DecodeBreaker._transition

    def marking(self, new, count_trip=True):
        transition(self, new, count_trip)
        marks.append((new, kernels.LAUNCHES.get("decode_rfc5424_p6", 0)))

    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    breaker_mod.DecodeBreaker._transition = marking
    try:
        with launch_shapes() as seen:
            wall, pipe, errs, _ = run_inproc(cfg, path, breaker=False)
    finally:
        breaker_mod.DecodeBreaker._transition = transition
    LATE.update(seen - CHECKED)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    said = [e for e in errs if e.startswith(_BREAKER_LINE)]
    errs, econ = econ_split([e for e in errs
                             if not e.startswith(_BREAKER_LINE)])
    out = (WORK / "breaker_trip.out").read_bytes()
    br = pipe._handler._breaker
    probe_k1 = sum(b[1] - a[1] for a, b in zip(marks, marks[1:])
                   if a[0] == breaker_mod.HALF_OPEN)
    _need_serving("breaker_trip", {"decode_rfc5424_p6 in a probe": probe_k1},
                  ("decode_rfc5424_p6 in a probe",))
    if (out != exp_out or errs != exp_err or br.trips != 1
            or br.state != breaker_mod.CLOSED or br.probes < 1):
        raise AssertionError(
            f"breaker_trip: {len(out)} bytes vs {len(exp_out)} (equal="
            f"{out == exp_out}), stderr equal={errs == exp_err}, "
            f"{br.trips} trips, ends {br.state}, {br.probes} probes, "
            f"{probe_k1} K1 launches in probes: {said}")
    rows = BREAKER_HEAD + BREAKER_TAIL
    emit({"phase": "serving", "run": "breaker_trip", "lines": rows,
          "oracle_rows": BREAKER_HEAD, "tpu_batch_size": BREAKER_BATCH,
          "wall_s": wall, "lines_per_s": rows / wall, "trips": br.trips,
          "probes": br.probes, "k1_launches_in_probes": probe_k1,
          "transitions": [m[0] for m in marks], "stderr_breaker": said,
          "launches": launches, "economics_notices": econ,
          "identical_to_expectation": True})
    return {"launches": launches}


def _queue_drop(seed: int) -> dict:
    """queue_drop: rfc5424_line's input with ``input.queue_policy =
    "drop_newest"`` and ``[faults] queue_pressure = "every:4"``
    (``tpu_batch_size = QUEUE_BATCH``): every fourth item put on the
    queue (a batch's block) is shed; the output is the expectation less
    exactly those items."""
    from flowgger_tpu_torch.tpu import framing, kernels
    from flowgger_tpu_torch.utils import bounded_queue, faultinject

    n_lines, _, path, _, exp_out, exp_err = EXPECTED["rfc5424_line"]
    cfg = _net_config("queue_drop", 'type = "stdin"\nframing = "line"\n'
                      'queue_policy = "drop_newest"\n'
                      f"tpu_batch_size = {QUEUE_BATCH}\n")
    cfg.write_text(cfg.read_text()
                   + f'[faults]\nqueue_pressure = "every:{QUEUE_EVERY}"\n')
    puts = []   # (item, shed)
    put = bounded_queue.PolicyQueue.put

    def recording(self, item, block=True, timeout=None):
        before = self.dropped
        put(self, item, block, timeout)
        if item is not None:
            puts.append((item, self.dropped > before))

    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    bounded_queue.PolicyQueue.put = recording
    try:
        with launch_shapes() as seen:
            wall, pipe, errs, _ = run_inproc(cfg, path)
    finally:
        bounded_queue.PolicyQueue.put = put
        faultinject.reset()
    LATE.update(seen - CHECKED)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    errs, econ = econ_split(errs)
    out = (WORK / "queue_drop.out").read_bytes()

    def data(item):
        return getattr(item, "data", item)

    shed = [i for i, (_, s) in enumerate(puts) if s]
    kept = b"".join(data(it) for it, s in puts if not s)
    plan = [f"faultinject: active plan {{'queue_pressure': "
            f"'every:{QUEUE_EVERY}'}}"]
    if (b"".join(data(it) for it, _ in puts) != exp_out or out != kept
            or shed != list(range(QUEUE_EVERY - 1, len(puts), QUEUE_EVERY))
            or not shed or pipe.tx.dropped != len(shed)
            or errs != plan + exp_err[0]):
        raise AssertionError(
            f"queue_drop: {len(puts)} items put, shed {shed}, "
            f"{pipe.tx.dropped} counted, output equal to the kept items="
            f"{out == kept}, launches {launches}")
    _need_serving("queue_drop", launches, ("decode_rfc5424_p6",))
    emit({"phase": "serving", "run": "queue_drop", "lines": n_lines,
          "items_put": len(puts), "items_shed": len(shed),
          "records_shed": sum(len(it) for it, s in puts if s),
          "wall_s": wall, "lines_per_s": n_lines / wall,
          "launches": launches, "economics_notices": econ,
          "output_is_expectation_less_the_shed_items": True})
    return {"launches": launches}


def phase_serving(seed: int, lines: int):
    """The serving front on ``cuda`` (after the sinks): ``tenants_tcp``,
    ``templates_enrich`` (and ``templates_mine``), ``breaker_trip`` and
    ``queue_drop``, in process; a ``serving`` line each; and how many
    earlier in-process runs were held to a closed breaker with no trip
    (:func:`breaker_closed`).  Returns the runs' launch counts summed."""
    total = {}
    for rep in (_tenants_tcp(seed), _templates_enrich(seed, lines),
                _breaker_trip(seed), _queue_drop(seed)):
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "serving", "run": "breaker_closed",
          "runs_held_closed": len(BREAKER_CLOSED),
          "runs": sorted(set(BREAKER_CLOSED))})
    return total


def _late_corpus(name: str):
    """(corpus maker, mix name) of the rows a late shape of kernel
    ``name`` is checked on."""
    from flowgger_tpu_torch import corpus

    return {
        "classify_auto_dns": (functools.partial(corpus.make_auto_corpus,
                                                dns=True),
                              "auto mix with dns"),
        "decode_dns": (corpus.make_dns_corpus, "dns mix"),
        "encode_ltsv_out": (corpus.make_ltsv_out_tier_corpus,
                            "→ LTSV tier mix"),
        "encode_rfc5424_out": (corpus.make_tier_corpus,
                               "rfc5424 tier mix"),
        "fused_rfc5424_rfc5424": (corpus.make_tier_corpus,
                                  "rfc5424 tier mix"),
        "encode_capnp": (corpus.make_tier_corpus, "rfc5424 tier mix"),
        "fused_rfc5424_capnp": (corpus.make_tier_corpus,
                                "rfc5424 tier mix"),
        "fused_rfc5424_gelf": (corpus.make_tier_corpus,
                               "rfc5424 tier mix"),
        "encode_rfc3164_rfc5424": (corpus.make_rfc3164_tier_corpus,
                                   "rfc3164 tier mix"),
        "fused_rfc3164_rfc5424": (corpus.make_rfc3164_tier_corpus,
                                  "rfc3164 tier mix"),
        "fused_rfc3164_gelf": (corpus.make_rfc3164_tier_corpus,
                               "rfc3164 tier mix"),
        "fused_rfc5424_ltsv": (corpus.make_ltsv_out_tier_corpus,
                               "→ LTSV tier mix"),
        "decode_rfc5424": (corpus.make_corpus, "rfc5424 mix"),
        "decode_ltsv": (corpus.make_ltsv_corpus, "ltsv mix"),
        "decode_rfc3164": (corpus.make_rfc3164_tier_corpus,
                           "rfc3164 tier mix"),
        "encode_gelf3164": (corpus.make_rfc3164_tier_corpus,
                            "rfc3164 tier mix"),
        "encode_gelf_probe": (corpus.make_tier_corpus,
                              "rfc5424 tier mix"),
        "encode_gelf_assemble": (corpus.make_tier_corpus,
                                 "rfc5424 tier mix"),
        "structural_index_flat": (corpus.make_gelf_tier_corpus,
                                  "gelf tier mix"),
        "structural_index_f": (corpus.make_jsonl_corpus, "jsonl mix"),
        "classify_auto": (corpus.make_auto_corpus, "auto mix"),
        "encode_gelf_gelf": (corpus.make_gelf_tier_corpus,
                             "gelf tier mix"),
        "fused_gelf_gelf": (corpus.make_gelf_tier_corpus,
                            "gelf tier mix"),
    }.get(next((k for k in ("classify_auto_dns", "decode_dns",
                            "encode_ltsv_out", "fused_rfc5424_ltsv",
                            "encode_rfc5424_out", "fused_rfc5424_rfc5424",
                            "encode_capnp", "fused_rfc5424_capnp",
                            "fused_rfc5424_gelf",
                            "encode_rfc3164_rfc5424",
                            "fused_rfc3164_rfc5424",
                            "fused_rfc3164_gelf",
                            "decode_rfc5424", "decode_ltsv",
                            "decode_rfc3164", "encode_gelf3164",
                            "encode_gelf_probe", "encode_gelf_assemble",
                            "structural_index_flat", "structural_index_f",
                            "classify_auto", "encode_gelf_gelf",
                            "fused_gelf_gelf") if name.startswith(k)),
               None), (corpus.make_ltsv_tier_corpus, "ltsv tier mix"))


def phase_late_shapes(seed: int) -> None:
    """The kernels against their plain versions at each shape the e2e runs
    launched them at and the kernels phase had not checked, every row
    real: K1 on rows of the rfc5424 mix, L1 on rows of the ltsv mix, EL
    and FL (probe, and assemble where the run assembled at that shape) on
    rows of the ltsv tier mix, EG and FG likewise on rows of the gelf
    tier mix; from the auto and Record-path runs' legs also D3 and E3 on
    rows of the rfc3164 tier mix, E1 (probe and assemble) on rows of the
    rfc5424 tier mix, K5 (flat on the gelf tier mix, nested on the jsonl
    mix) and AC on rows of the auto mix; from the LTSV-output and dns
    runs DN on rows of the dns mix, OL and FO/ltsv on rows of the → LTSV
    tier mix and AC+dns on rows of the auto mix with the dns leg; a
    ``kernel_shape`` line each."""
    import torch

    from flowgger_tpu_torch.tpu import kernels, pack
    from flowgger_tpu_torch.utils.timeparse import current_year_utc

    # one corpus a mix, made once at the largest shape it serves (the
    # shapes of a mix take prefixes of it)
    shapes = sorted(LATE - CHECKED)
    biggest = {}
    for name, (rows, L) in shapes:
        tag = _late_corpus(name)[1]
        biggest[tag] = max(biggest.get(tag, 0), rows)
    corpora = {}
    packs = {}   # (mix, rows, L) -> the packed rows, shared by kernels
    for name, (rows, L) in shapes:
        if (name, (rows, L)) in CHECKED:
            continue   # an earlier case of this loop checked it
        assemble = "assemble" in name
        make, tag = _late_corpus(name)
        if tag not in corpora:
            corpora[tag] = make(biggest[tag], seed + 7)[0]
        if (tag, rows, L) not in packs:
            packs[(tag, rows, L)] = pack.pack_lines_2d(corpora[tag][:rows],
                                                       L)
        b, ln, *_ = packs[(tag, rows, L)]
        batch = torch.from_numpy(b[:rows]).cuda()
        lens_c = torch.from_numpy(ln[:rows].astype("int32")).cuda()
        if name == "classify_auto_dns":
            row = ac_case(batch, lens_c, rows, dns=True)
        elif name == "decode_dns":
            row, _ = dn_case(batch, lens_c, rows)
        elif name.startswith(("encode_ltsv_out", "fused_rfc5424_ltsv")):
            kind = "ol" if name.startswith("encode") else "fo"
            row = ol_case(kind, batch, lens_c, rows, assemble=assemble)[-1]
        elif name.startswith(("encode_capnp", "fused_rfc5424_capnp")):
            kind = "fo" if name.startswith("fused") else "oc"
            P = int(name.rsplit("_p", 1)[1]) if kind == "oc" else 6
            row = oc_case(kind, batch, lens_c, rows, P=P,
                          assemble=assemble)[-1]
        elif name.rsplit("_", 1)[0] in {v[1] for v in R5_KINDS.values()}:
            kind = next(k for k, v in R5_KINDS.items()
                        if v[1] == name.rsplit("_", 1)[0])
            row = r5_case(kind, batch, lens_c, rows, assemble=assemble)[-1]
        elif name.startswith(("fused_rfc5424_gelf", "fused_rfc3164_gelf")):
            kind = "f1" if "5424" in name else "f3"
            row = route_case(kind, batch, lens_c, rows,
                             assemble=assemble)[-1]
        elif name.startswith("decode_rfc5424"):
            row, _ = decode_case("rfc5424", int(name.rsplit("_p", 1)[1]),
                                 batch, lens_c)
        elif name == "decode_ltsv":
            row, _ = l1_case(batch, lens_c, rows)
        elif name == "decode_rfc3164":
            row, _ = d3_case(batch, lens_c, current_year_utc())
        elif name.startswith("encode_gelf3164"):
            row = route_case("e3", batch, lens_c, rows, assemble=assemble)[-1]
        elif name.startswith(("encode_gelf_probe", "encode_gelf_assemble")):
            P = int(name.rsplit("_p", 1)[1])
            packed = kernels.decode_rfc5424_cuda(batch, lens_c, 4, P)
            row = encode_case(P, batch, lens_c, packed, rows,
                              *(ts_text_of(packed) if assemble else ()))[-1]
        elif name.startswith("structural_index"):
            F = int(name.rsplit("_f", 1)[1])
            kind = "gelf" if "flat" in name else "jsonl"
            row, _ = decode_case(kind, F, batch, lens_c)
            CHECKED.add((name, (rows, L)))
        elif name == "classify_auto":
            row = ac_case(batch, lens_c, rows)
        elif "gelf_gelf" in name:
            kind = ("fg" if name.startswith("fused") else
                    "eg16" if name.endswith("f16") else "eg8")
            row = gelf_route_case(kind, batch, lens_c, rows,
                                  assemble=assemble)[-1]
        else:
            kind = ("fl" if name.startswith("fused") else
                    "el16" if name.endswith("p16") else "el6")
            row = ltsv_route_case(kind, batch, lens_c, rows,
                                  assemble=assemble)[-1]
        emit({"phase": "kernel_shape", **row,
              "where": f"e2e launch shape, {tag} rows"})


def phase_encode_ab(seed: int, n_batches: int = AB_BATCHES, pairs: int = 6):
    """What the device encode tier costs a mix it declines, the rfc5424
    mix (19 % of rows outside the tier), on one card in one process:

    (a) each of ``n_batches`` framed and decoded batches through
        ``device_gelf.fetch_encode`` alone, from a fresh hysteresis
        state: a phase-1 probe and decline (the wide attempt cooled), and
        a phase-1 probe, 16-pair decode and probe, and decline; host
        clock from a synchronized start to the decline;
    (b) the rfc5424 / line configuration over the same ``n_batches``
        × 16 384 lines in process with ``FLOWGGER_DEVICE_ENCODE`` = 1
        (tier on, every batch probed unless cooled) and = 0 (host tier
        only), alternating in ``pairs`` pairs (on-off, off-on, ...) after
        one unrecorded run of each; the runs' outputs must be
        identical."""
    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import make_corpus
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import device_gelf, framing
    from flowgger_tpu_torch.tpu.rfc5424 import decode_rfc5424_submit

    dev = torch.device("cuda")
    lines, _ = make_corpus(n_batches * BATCH, seed + 6)
    encoder, merger = GelfEncoder(Config.from_string("")), NulMerger()
    cost = {"probe_decline": [], "probe_wide_decline": []}
    for b in range(n_batches):
        region = b"\n".join(lines[b * BATCH:(b + 1) * BATCH]) + b"\n"
        packed, _, _ = framing.device_frame_region(region, "line", MAX_LEN,
                                                   BATCH, dev)
        handle = decode_rfc5424_submit(packed[0], packed[1])
        for kind, state in (("probe_decline", {"wide_cooldown": 1}),
                            ("probe_wide_decline", {})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = device_gelf.fetch_encode(handle, packed, encoder, merger,
                                              state)
            cost[kind].append((time.perf_counter() - t0) * 1e3)
            if res is not None or state.get("declined") != 1:
                raise AssertionError(f"encode A/B: batch {b} of the rfc5424 "
                                     f"mix was not declined: {state}")

    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "encode_ab.in"
    path.write_bytes(b"\n".join(lines))
    saved = os.environ.get("FLOWGGER_DEVICE_ENCODE")
    runs, ref = [], None
    # one run of each first, not recorded: the first start in a process
    # pays one-time costs that would land on whichever side ran first
    order = ["1", "0"] + [f for i in range(pairs)
                          for f in (("1", "0") if i % 2 == 0 else ("0", "1"))]
    try:
        for i, flag in enumerate(order):
            os.environ["FLOWGGER_DEVICE_ENCODE"] = flag
            # the split tier alone, as this A/B measured it before the
            # fused route (phase_fuse_ab compares the two)
            cfg = _config("rfc5424_line", f"ab{flag}", fuse="off")
            wall, pipe, errs, _ = run_inproc(cfg, path)
            got = (WORK / f"rfc5424_line_ab{flag}.out").read_bytes()
            if ref is None:
                ref = (got, errs)
            elif (got, errs) != ref:
                raise AssertionError("encode A/B: the runs with the "
                                     "tier on and off differ")
            state = pipe._handler.route_state.get("rfc5424", {})
            if i < 2:
                continue
            runs.append({"device_encode": flag, "wall_s": wall,
                         "lines_per_s": len(lines) / wall,
                         "tier": {k: state.get(k, 0) for k in
                                  ("taken", "declined", "cooled",
                                   "wide")}})
    finally:
        if saved is None:
            os.environ.pop("FLOWGGER_DEVICE_ENCODE", None)
        else:
            os.environ["FLOWGGER_DEVICE_ENCODE"] = saved
    on = [r["lines_per_s"] for r in runs if r["device_encode"] == "1"]
    off = [r["lines_per_s"] for r in runs if r["device_encode"] == "0"]
    ratios = [a / b for a, b in zip(on, off)]
    emit({"phase": "encode_ab", "path": "rfc5424_line", "lines": len(lines),
          "decline_ms_per_batch": {
              k: {"mean": statistics.mean(v), "median": statistics.median(v),
                  "max": max(v)} for k, v in cost.items()},
          "runs": runs, "on_over_off_per_pair": ratios,
          "median_on_over_off": statistics.median(ratios),
          "spread_off": (max(off) - min(off)) / statistics.median(off),
          "spread_on": (max(on) - min(on)) / statistics.median(on)})


def phase_fuse_ab(seed: int, n_batches: int = AB_BATCHES):
    """The fused route against the split path on the four tier mixes
    (rfc5424, rfc3164, ltsv and gelf, ``n_batches`` × 16 384 lines each), in one
    process: a batch handler with ``input.tpu_fuse = "auto"`` (the fused
    route takes every batch) and then ``"off"`` (the split decode and the
    split device tier), each over the same framed regions: one
    unrecorded run of each (the first run in a process pays one-time
    costs, the scalar oracle's zone lookups among them), then auto, off,
    off, auto.  Host-clock walls of device framing and of the block
    encode (``_dispatch``: the route's kernels, stamp text, fetch,
    splice, oracle rows, enqueue), launch counts; every run must write
    the same bytes.  Then the device
    ms, at a flush batch of the mix, of F1 (probe + assemble) against K1
    p6 + E1 probe + E1 assemble, of F3 against D3 + E3 probe + E3
    assemble, of FL against L1 + EL probe + EL assemble (6 pairs) and of
    FG against K5/0 + EG probe + EG assemble (8 fields).  No claim is made
    from them."""
    import queue

    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import (make_gelf_tier_corpus,
                                           make_ltsv_tier_corpus,
                                           make_rfc3164_tier_corpus,
                                           make_tier_corpus)
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import (device_common, device_gelf,
                                        device_gelf_gelf, device_ltsv,
                                        device_rfc3164, framing, kernels)
    from flowgger_tpu_torch.tpu.batch import BatchHandler
    from flowgger_tpu_torch.utils.timeparse import current_year_utc

    dev = torch.device("cuda")
    year = current_year_utc()
    for fmt, make in (("rfc5424", make_tier_corpus),
                      ("rfc3164", make_rfc3164_tier_corpus),
                      ("ltsv", make_ltsv_tier_corpus),
                      ("gelf", make_gelf_tier_corpus)):
        lines, _ = make(n_batches * BATCH, seed + 15)
        regions = [b"\n".join(lines[b * BATCH:(b + 1) * BATCH]) + b"\n"
                   for b in range(n_batches)]
        outs, runs = [], []
        for i, fuse in enumerate(("auto", "off", "auto", "off", "off",
                                  "auto")):
            cfg = Config.from_string(f'[input]\ntpu_fuse = "{fuse}"\n')
            tx = queue.Queue()
            handler = BatchHandler(tx, GelfEncoder(cfg), cfg, NulMerger(),
                                   dev, start_timer=False, fmt=fmt)
            walls = {"frame": 0.0, "block_encode": 0.0}
            kernels.reset_launch_counts()
            with contextlib.redirect_stderr(io.StringIO()), \
                    contextlib.redirect_stdout(io.StringIO()):
                for region in regions:
                    t0 = time.perf_counter()
                    packed, _, _ = framing.device_frame_region(
                        region, "line", MAX_LEN, BATCH, dev)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    handler._dispatch(packed)
                    walls["frame"] += t1 - t0
                    walls["block_encode"] += time.perf_counter() - t1
            outs.append(b"".join(tx.get_nowait().data
                                 for _ in range(tx.qsize())))
            if i < 2:
                continue
            runs.append({
                "fuse": fuse, "wall_s": walls,
                "lines_per_s": n_batches * BATCH / sum(walls.values()),
                "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                "route_state": {k: {kk: vv for kk, vv in v.items()
                                    if kk in _STATE_KEYS}
                                for k, v in handler.route_state.items()}})
        if len(set(outs)) > 1:
            raise AssertionError(f"fuse A/B: {fmt} with the fused route on "
                                 f"and off wrote different bytes")
        for r in runs:
            key = f"fused:{fmt}_gelf" if r["fuse"] == "auto" else fmt
            taken = r["route_state"].get(key, {}).get("taken", 0)
            if taken != n_batches or len(r["route_state"]) != 1:
                raise AssertionError(f"fuse A/B: {fmt} ({r['fuse']}): "
                                     f"{r['route_state']}, not every batch "
                                     f"taken by its one tier")
        block = {f: sum(r["wall_s"]["block_encode"] for r in runs
                        if r["fuse"] == f) for f in ("auto", "off")}

        # device ms at a flush batch of the mix: the fused route's two
        # kernels against the split path's three
        region_b, n = line_flush(make(2 * BATCH, seed + 16)[0])
        packed, _, _ = framing.device_frame_region(region_b, "line", MAX_LEN,
                                                   n, dev)
        b, ln = packed[0], packed[1]
        N = b.shape[0]
        split = {"rfc5424": device_gelf, "rfc3164": device_rfc3164,
                 "ltsv": device_ltsv, "gelf": device_gelf_gelf}[fmt]
        bank_b, table = split.kernel_consts(b"\0")
        bank = device_gelf._bank_on(bank_b, dev)
        OW = split.out_width(MAX_LEN, b"\0")
        base, base_len, small, chan = kernels.fused_gelf_cuda(
            fmt, b, ln, n, bank, table, year=year)
        if fmt == "ltsv":
            sm, _ = device_ltsv.small_fetch(small, N, n)
            txt, tl = device_common.ts_text_block(sm,
                                                  device_ltsv.ts_vals_ltsv)
        elif fmt == "gelf":
            sm, _ = device_gelf_gelf.small_channels(small, n)
            txt, tl = device_common.ts_text_block(
                sm, device_gelf_gelf.ts_vals_gelf)
        else:
            sm = small[:, :n].cpu().numpy()
            txt, tl = device_common.ts_text_block(
                {"ok": sm[0] != 0, "days": sm[1], "sod": sm[2], "off": sm[3],
                 "nanos": sm[4]})
        ts_text = torch.zeros((N, device_common.TS_W), dtype=torch.uint8)
        ts_len = torch.zeros(N, dtype=torch.int32)
        ts_text[:n], ts_len[:n] = torch.from_numpy(txt), torch.from_numpy(tl)
        ts_text, ts_len = ts_text.to(dev), ts_len.to(dev)
        length = base_len.to(torch.int64) + ts_len
        tier = base & (length <= OW)
        gated = torch.where(tier, length, 0)
        row_off = torch.where(tier, torch.cumsum(gated, 0) - gated, -1)
        total = int(gated.sum())
        asm = {"OW": OW, "ts_text": ts_text, "ts_len": ts_len,
               "row_off": row_off, "total": total}
        if fmt == "rfc5424":
            ch = kernels.decode_rfc5424_cuda(b, ln, 4, 6)
            split_fns = {
                "decode_rfc5424_p6": lambda: kernels.decode_rfc5424_cuda(
                    b, ln, 4, 6),
                "encode_gelf_probe_p6": lambda: kernels.encode_gelf_cuda(
                    b, ln, ch, n, bank, table, 4, 6),
                "encode_gelf_assemble_p6": lambda: kernels.encode_gelf_cuda(
                    b, ln, ch, n, bank, table, 4, 6, **asm)}
        elif fmt == "gelf":
            ch = kernels.structural_index_cuda(b, ln, 8, 0)
            split_fns = {
                "structural_index_flat_f8":
                    lambda: kernels.structural_index_cuda(b, ln, 8, 0),
                "encode_gelf_gelf_probe_f8":
                    lambda: kernels.encode_gelf_gelf_cuda(b, ln, ch, n, bank,
                                                          table, 8),
                "encode_gelf_gelf_assemble_f8":
                    lambda: kernels.encode_gelf_gelf_cuda(b, ln, ch, n, bank,
                                                          table, 8, **asm)}
        elif fmt == "ltsv":
            ch = kernels.decode_ltsv_cuda(b, ln, n)
            split_fns = {
                "decode_ltsv": lambda: kernels.decode_ltsv_cuda(b, ln, n),
                "encode_gelf_ltsv_probe_p6":
                    lambda: kernels.encode_gelf_ltsv_cuda(b, ln, ch, n, bank,
                                                          table, 6),
                "encode_gelf_ltsv_assemble_p6":
                    lambda: kernels.encode_gelf_ltsv_cuda(b, ln, ch, n, bank,
                                                          table, 6, **asm)}
        else:
            ch = kernels.decode_rfc3164_cuda(b, ln, year)
            split_fns = {
                "decode_rfc3164": lambda: kernels.decode_rfc3164_cuda(
                    b, ln, year),
                "encode_gelf3164_probe": lambda: kernels.encode_gelf3164_cuda(
                    b, ln, ch, n, bank, table),
                "encode_gelf3164_assemble":
                    lambda: kernels.encode_gelf3164_cuda(b, ln, ch, n, bank,
                                                         table, **asm)}
        # the assemble from the probe's carried channels, timed without
        # the wrapper's contract check (it reads a flag back)
        fused_fns = {
            f"fused_{fmt}_gelf_probe": lambda: kernels.fused_gelf_cuda(
                fmt, b, ln, n, bank, table, year=year),
            f"fused_{fmt}_gelf_assemble": lambda: kernels.fused_assemble_launch(
                fmt, b, ln, n, bank, table, OW, ts_text, ts_len, row_off,
                total, chan)}
        # both paths assemble the same bytes at this batch
        if not torch.equal(kernels.fused_gelf_cuda(fmt, b, ln, n, bank, table,
                                                   year=year, chan=chan,
                                                   tier=base, **asm),
                           list(split_fns.values())[2]()):
            raise AssertionError(f"fuse A/B: {fmt}: the fused and split "
                                 f"assembles differ at the flush batch")
        fused_ms = {k: device_ms(f) for k, f in fused_fns.items()}
        split_ms = {k: device_ms(f) for k, f in split_fns.items()}
        emit({"phase": "fuse_ab", "format": fmt,
              "lines": n_batches * BATCH, "runs": runs,
              "block_encode_auto_over_off": block["auto"] / block["off"],
              "flush_shape": [N, MAX_LEN], "flush_rows": n,
              "tier_rows": int(tier.sum()), "fused_ms": fused_ms,
              "split_ms": split_ms,
              "fused_over_split_ms": sum(fused_ms.values())
              / sum(split_ms.values())})


# sides of the host A/B (phase_host_ab): the native host tier as shipped,
# the same with one worker thread a call, and no native library at all
HOST_AB_SIDES = ("native", "threads1", "plain")


@contextlib.contextmanager
def host_side(side: str):
    """Inside the block the package runs as ``side`` of the host A/B:
    ``native`` as shipped; ``threads1`` with every native call on one
    thread; ``plain`` with the numpy engine, the plain gather and the
    plain timestamp text, so that the native library is never loaded."""
    from flowgger_tpu_torch import native
    from flowgger_tpu_torch.tpu import device_common

    with contextlib.ExitStack() as stack:
        if side == "threads1":
            saved = native._DEFAULT_THREADS
            native._DEFAULT_THREADS = 1
            stack.callback(setattr, native, "_DEFAULT_THREADS", saved)
        elif side == "plain":
            stack.enter_context(numpy_engine())
            stack.enter_context(plain_gather())
            saved = device_common.ts_text_block
            device_common.ts_text_block = device_common._ts_text_block_np
            stack.callback(setattr, device_common, "ts_text_block", saved)
        yield
    if side == "plain" and native._lib is not None:
        raise AssertionError("host A/B: the plain side loaded the native "
                             "library")


def _ab_lines(name: str, seed: int):
    """The A/B's corpora, made once and read back by every side."""
    from flowgger_tpu_torch.corpus import (make_corpus, make_jsonl_corpus,
                                           make_tier_corpus)

    make, off = {"rfc5424": (make_corpus, 1), "jsonl": (make_jsonl_corpus, 1),
                 "tier": (make_tier_corpus, 4)}[name]
    path = WORK / "host_ab" / f"{name}.in"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"\n".join(make(8 * BATCH, seed + off)[0]))
    return path.read_bytes().split(b"\n")


def host_ab_side(seed: int, side: str) -> None:
    """One run of one side of the host A/B, in a process of its own: the
    rfc5424, jsonl and tier-mix (device tier) breakdowns in that order,
    then the digests of what each wrote."""
    import hashlib

    with host_side(side):
        engine = "numpy" if side == "plain" else "native"
        outs = {"rfc5424": phase_breakdown(seed, "rfc5424", engine=engine,
                                           lines=_ab_lines("rfc5424", seed)),
                "jsonl": phase_breakdown(seed, "jsonl",
                                         lines=_ab_lines("jsonl", seed)),
                "tier": phase_breakdown_tier(
                    seed, tiers=("device",),
                    lines=_ab_lines("tier", seed))["device"]}
    emit({"phase": "host_ab_digest", "side": side,
          "sha256": {k: hashlib.sha256(v).hexdigest()
                     for k, v in outs.items()}})


def phase_host_ab(seed: int, rounds: int) -> None:
    """Whether the native host tier slows the host code it does not
    replace: the oracle rows (``finish_block``, scalar decode and encode
    in Python) and the JSON-lines path, whose block encode changes only
    by its gather.  Each side of :data:`HOST_AB_SIDES` runs
    :func:`host_ab_side` in a fresh process, ``rounds`` times, the order
    rotating each round (after one unrecorded run of each side); every
    run must write the same bytes."""
    _ab_lines("rfc5424", seed), _ab_lines("jsonl", seed)
    _ab_lines("tier", seed)
    order = list(HOST_AB_SIDES) + [
        HOST_AB_SIDES[(r + k) % len(HOST_AB_SIDES)]
        for r in range(rounds) for k in range(len(HOST_AB_SIDES))]
    runs, digest = [], None
    for i, side in enumerate(order):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
             str(seed), "--host-ab-side", side],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(f"host A/B: side {side} failed:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        objs = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        got = next(o["sha256"] for o in objs
                   if o.get("phase") == "host_ab_digest")
        if digest is None:
            digest = got
        elif got != digest:
            raise AssertionError(f"host A/B: side {side} wrote other bytes")
        if i < len(HOST_AB_SIDES):
            continue
        run = {"round": (i - len(HOST_AB_SIDES)) // len(HOST_AB_SIDES),
               "side": side}
        for o in objs:
            if o.get("phase") != "breakdown":
                continue
            w = o["wall_s"]
            if o["format"] == "rfc5424_tier":   # the device tier's stages
                oracle = w["oracle"]
                encode = sum(w[k] for k in ("probe", "ts_text",
                                            "assemble_fetch", "splice",
                                            "oracle"))
            else:
                oracle, encode = w["encode_oracle"], w["encode"]
            run[o["format"]] = {"lines_per_s": o["lines_per_s"],
                                "oracle_rows": o["oracle_rows"],
                                "oracle_s": oracle, "encode_s": encode}
        runs.append(run)
        emit({"phase": "host_ab_run", **run})
    summary = {}
    for side in HOST_AB_SIDES:
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {
            f"{k}_{m}": statistics.median(r[k][m] for r in mine)
            for k in ("rfc5424", "jsonl", "rfc5424_tier")
            for m in ("oracle_s", "encode_s", "lines_per_s")}
        summary[side]["runs"] = len(mine)
    emit({"phase": "host_ab", "rounds": rounds, "sides": HOST_AB_SIDES,
          "median": summary})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--lines", type=int, default=RFC5424_LINES,
                    help="lines of the rfc5424 line-framed e2e runs (cut "
                         "from 16 × 16 384 for time when the ltsv paths "
                         "came, from 8 × when the gelf paths came)")
    ap.add_argument("--host-ab", type=int, default=0, metavar="ROUNDS",
                    help="run only the host A/B of the native host tier, "
                         "ROUNDS rounds (phase_host_ab)")
    ap.add_argument("--host-ab-side", choices=HOST_AB_SIDES,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import flowgger_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: flowgger_tpu_torch not importable ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    if args.host_ab_side:
        host_ab_side(args.seed, args.host_ab_side)
        return 0
    seconds = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now

    try:
        return run_phases(args, seconds, lap)
    finally:
        close_expectations()


def run_phases(args, seconds: dict, lap) -> int:
    """The phases of a run, in order (:func:`main`'s body)."""
    import torch

    if not args.host_ab:
        # the scalar expectations of every e2e path, made in worker
        # processes beside the build and kernels phases
        jobs = expectation_jobs(args.seed, args.lines)
        WORK.mkdir(parents=True, exist_ok=True)
        emit({"phase": "expectations", "workers": start_expectations(jobs),
              "jobs": len(jobs), "start_method": "spawn"})
    smi_line = phase_device()
    phase_build()
    lap("device_build")
    if args.host_ab:
        phase_host_ab(args.seed, args.host_ab)
        print(smi_line, flush=True)
        return 0
    rows = phase_kernels(args.seed)
    lap("kernels")
    # the native, breakdown and A/B phases read host-clock rates: the
    # pool is done before them
    wait_expectations()
    lap("expectations")
    phase_native(args.seed)
    lap("native")
    if (phase_breakdown(args.seed, "rfc5424")
            != phase_breakdown(args.seed, "rfc5424", engine="numpy")):
        raise AssertionError("the GELF block encoder's native and numpy "
                             "engines wrote different bytes")
    phase_breakdown(args.seed, "jsonl")
    phase_breakdown(args.seed, "ltsv")
    phase_breakdown(args.seed, "gelf")
    phase_breakdown_tier(args.seed)
    lap("breakdown")
    phase_encode_ab(args.seed)
    lap("encode_ab")
    phase_fuse_ab(args.seed)
    lap("fuse_ab")
    total = {}
    for name in PATHS:
        for k, v in phase_e2e(name, path_lines(name, args.lines), args.seed,
                              CHECKED).items():
            total[k] = total.get(k, 0) + v
        lap(f"e2e_{name}")
    for name in MIXED_PATHS:
        for k, v in phase_e2e_mixed(name, args.seed).items():
            total[k] = total.get(k, 0) + v
        lap(f"e2e_{name}")
    for name in OUT_PATHS:
        for k, v in phase_e2e_out(name, args.seed).items():
            total[k] = total.get(k, 0) + v
        lap(f"e2e_{name}")
    for k, v in phase_overlap_ab(args.seed).items():
        total[k] = total.get(k, 0) + v
    lap("overlap_ab")
    for k, v in phase_transports(args.seed).items():
        total[k] = total.get(k, 0) + v
    lap("transports")
    for k, v in phase_sinks(args.seed).items():
        total[k] = total.get(k, 0) + v
    lap("sinks")
    for k, v in phase_serving(args.seed, args.lines).items():
        total[k] = total.get(k, 0) + v
    lap("serving")
    phase_late_shapes(args.seed)
    lap("late_shapes")
    # expectation_wait: the seconds spent blocked on the pool, in the
    # "expectations" entry and inside the e2e phases' own entries (so not
    # added to the total)
    emit({"phase": "phase_seconds", **seconds,
          "total": sum(seconds.values()),
          "expectation_wait": POOL["wait_s"],
          "expectation_workers": POOL["workers"],
          "expectations_done_s": POOL["done"]})
    for r in rows:
        r["launches"] = total[r["name"]]
    emit({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")} for r in rows]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
