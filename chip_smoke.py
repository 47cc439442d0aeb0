"""Chip smoke run of flowgger_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--lines N]

Phases, each printing JSON lines:

1. device — ``nvidia-smi`` name and power limit, torch's device name,
   the SM clock under a spin kernel;
2. build  — the six CUDA kernels compiled from ``flowgger_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), with a ``kernel_build`` line
   for each entry function: registers, shared memory, stack and spill
   bytes as ``nvcc -Xptxas -v`` reports them (E1's four instantiations
   must be among them);
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
   against the kernels called one by one; and the device GELF encode
   (E1) at 6 and 16 pairs, probe and assemble, on a gathered
   [16384, 512] batch of the tier mix (every row's base tier bit and
   base length, zeros past the real rows, every tier row's bytes), at 6
   pairs on the tier path's flush batch and on 256 rows (its
   end-of-stream batch's shape, 200 of them real), and E1's phase-1
   probes at 6 and 16 pairs on the rfc5424 line path's flush batch and
   the syslen flush batch;
4. breakdown — the host-clock wall of each stage of the RFC5424 and the
   JSON-lines paths over eight full regions each (framing, decode, block
   encode, sink write), and of the tier mix through the device encode
   tier (its block encode split into probe, timestamp text, assemble +
   fetch, splice and oracle rows) and through the host tier; then
   (``encode_ab``) what the tier costs the rfc5424 mix, which it
   declines: one batch's decline alone, and the rfc5424 / line
   configuration in process with the tier on and off, alternating;
5. e2e    — four configurations through the port's entry points on
   ``cuda``: stdin → rfc5424_tpu → GELF (line framing), stdin →
   jsonl_tpu → GELF (line framing), stdin → rfc5424_tpu → GELF (syslen
   framing) and stdin → rfc5424_tpu → GELF over the tier mix (line
   framing).  Each runs once in process through
   ``flowgger_tpu_torch.start`` with every kernel launch count reset
   just before and read just after (the run must launch each kernel of
   its path; the syslen run must decline no region; the tier-mix run
   must have the device encode tier take every batch and fetch fewer
   bytes a tier row than it emits; every run must launch E1 only at
   batch shapes the kernels phase checked, and the rfc5424 runs one
   6-pair probe a probed batch and one assemble a taken batch, the
   16-pair probes being the wide attempts), and once as ``python -m
   flowgger_tpu_torch cfg.toml`` in a subprocess.  Both runs' GELF bytes
   and stderr lines must equal the port's scalar path over the same
   bytes (``corpus.scalar_expectation``).  Each reports the device
   encode tier's batches taken, declined and cooled, its rows, and its
   fetched and emitted bytes a tier row.

Kernel times: ``ms`` is the device time of one launch (calls issued back
to back behind a spin kernel that holds the stream, :func:`device_ms`);
``plain_ms`` is one call of the plain version between two events on an
idle stream (:func:`cuda_ms`), so it also holds the host's time to issue
it, tens of microseconds against its milliseconds.  To time only the
kernels of a tree, call the first three phases from its root:
``python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build();
c.phase_kernels(20261016)"``.

It then prints the kernel table, the card's ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Any failed phase raises
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
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
# INT32 lanes outside the tensor cores: 132 SMs x 64 lanes x 1.98 GHz
# boost (H100 SXM, Hopper architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BATCH = 16384
MAX_LEN = 512
SYSLEN_LINES = 4 * BATCH    # lines of the syslen-framed e2e run
BIG_REGION = 16 << 20       # bytes of K2's many-wave region
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
          "sm_clock_mhz": spin_clock_mhz()})
    return line


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


def phase_build():
    from flowgger_tpu_torch.tpu import kernels

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
            emit({"phase": "kernel_build", "source": source, **r})
    # E1's four instantiations: probe and assemble at 6 and 16 pairs
    missing = {f"encode_gelf_kernel<{p}, {a}>" for p in (6, 16)
               for a in ("false", "true")} - seen
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
    fields (``kind`` jsonl) against its plain version on every channel
    of every row, rejected and padding rows included:
    ``(row, plain channels)``."""
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
        kern = functools.partial(kernels.structural_index_cuda, batch, lens_c,
                                 width, jsonl.NESTED_DEPTH)
        plain = functools.partial(jsonidx.structural_index, batch, lens_c,
                                  width, nested=jsonl.NESTED_DEPTH)
        unpack = functools.partial(jsonidx.unpack_channels, max_fields=width)
        name, C, passes = (f"structural_index_f{width}",
                           jsonidx.n_channels(width), 1)
        source, replaces = ("flowgger_tpu_torch/csrc/structural_index.cu",
                            "flowgger_tpu/tpu/pallas_kernels.py:439")
    ref = plain()
    err = channels_err(name, unpack(kern()), ref)
    n, valid = batch.shape[0], int(lens_c.sum())
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "max_abs_err": err, "ms": device_ms(kern),
        "plain_ms": cuda_ms(plain, iters=5, warmup=1),
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
        "plain_ms": cuda_ms(p4, iters=5, warmup=1),
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
    row, _ = decode_case("rfc5424", lo, fb, fl)
    shapes.append({**row, "where": "rfc5424 line path, flush batch"})
    phase1_probes(fb, fl, kernels.decode_rfc5424_cuda(fb, fl, 4, lo), fn,
                  "rfc5424 line path, flush batch", shapes)

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


# the (kernel name, batch shape) pairs at which E1 was held against its
# plain version; the e2e phase fails if its runs launch E1 at another
E1_CHECKED: set = set()


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
    E1_CHECKED.add((f"encode_gelf_probe_p{P}", (N, L)))

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
        "ms": ms_p, "plain_ms": cuda_ms(p_probe, iters=5, warmup=1),
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
    E1_CHECKED.add((f"encode_gelf_assemble_p{P}", (N, L)))
    n_tier = int(tier.sum())
    tier_valid = int(torch.where(tier, lens_c, 0).sum())
    ts_bytes = int(torch.where(tier, ts_len, 0).sum())
    out.append({
        "name": f"encode_gelf_assemble_p{P}", **common, "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": cuda_ms(p_asm, iters=5, warmup=1),
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
            fb, fl, fn = flush_batch(
                make_tier_corpus(2 * BATCH, seed + 9)[0], "tier path", shapes)
            fp = kernels.decode_rfc5424_cuda(fb, fl, 4, lo)
            for row in encode_case(P, fb, fl, fp, fn, *ts_text_of(fp)):
                shapes.append({**row, "where": "tier path, flush batch"})
            # the smallest batch the tier path takes: the end-of-stream
            # partial frame, one row in a 256-row bucket
            small_n = pack.bucket_rows(1)
            for row in encode_case(P, batch[:small_n], lens_c[:small_n],
                                   packed[:, :small_n].contiguous(), 200,
                                   ts_len[:small_n], ts_text[:small_n]):
                shapes.append({**row, "where": "tier path, end-of-stream "
                                               "batch"})


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
    for r in rows:
        emit({"phase": "kernel", **r})
    for r in shapes:
        emit({"phase": "kernel_shape", **r})
    return rows


def phase_breakdown(seed: int, fmt: str, n_batches: int = 8):
    """Host-clock walls of one path's stages, each ending in a
    synchronize, over ``n_batches`` full line regions: device framing
    (upload, span and gather kernels, span metadata back), decode
    (kernel, fetch, wider rescue), block encode (numpy engine plus the
    scalar oracle rows), and the sink write."""
    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import make_corpus, make_jsonl_corpus
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import framing
    from flowgger_tpu_torch.tpu.batch import _ROUTES

    dev = torch.device("cuda")
    make = make_jsonl_corpus if fmt == "jsonl" else make_corpus
    lines, _ = make(n_batches * BATCH, seed + 1)
    submit, fetch, encode = _ROUTES[fmt]
    encoder, merger = GelfEncoder(Config.from_string("")), NulMerger()
    walls = {"frame": 0.0, "decode": 0.0, "encode": 0.0, "write": 0.0}
    fallback = 0
    WORK.mkdir(parents=True, exist_ok=True)
    with open(WORK / f"breakdown_{fmt}.out", "wb", buffering=0) as sink:
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
                         MAX_LEN, encoder, merger)
            t3 = time.perf_counter()
            sink.write(res.block.data)
            t4 = time.perf_counter()
            walls["frame"] += t1 - t0
            walls["decode"] += t2 - t1
            walls["encode"] += t3 - t2
            walls["write"] += t4 - t3
            fallback += res.fallback_rows
    total = sum(walls.values())
    emit({"phase": "breakdown", "format": fmt, "lines": n_batches * BATCH,
          "wall_s": walls, "share": {k: v / total for k, v in walls.items()},
          "oracle_rows": fallback,
          "lines_per_s": n_batches * BATCH / total})


def phase_breakdown_tier(seed: int, n_batches: int = 8):
    """The tier mix over ``n_batches`` full line regions twice on one
    card: through the device encode tier, its block encode split into
    the probe (phase 1 and wide), the timestamp text, assemble + fetch,
    the constant splice and the oracle rows (``finish_block``); then
    through the host tier (channels fetched, numpy block engine).  Host
    clock, each stage ending in a synchronize or a fetch."""
    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import make_tier_corpus
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import device_gelf, framing
    from flowgger_tpu_torch.tpu.batch import _ROUTES

    dev = torch.device("cuda")
    lines, _ = make_tier_corpus(n_batches * BATCH, seed + 4)
    submit, fetch, encode = _ROUTES["rfc5424"]
    encoder, merger = GelfEncoder(Config.from_string("")), NulMerger()
    WORK.mkdir(parents=True, exist_ok=True)
    outs = {}
    for tier in ("device", "host"):
        walls = {"frame": 0.0, "decode": 0.0, "write": 0.0}
        state, stages, fallback = {}, {}, 0
        with open(WORK / f"breakdown_tier_{tier}.out", "wb",
                  buffering=0) as sink:
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
        emit({"phase": "breakdown", "format": "rfc5424_tier", "tier": tier,
              "lines": n_batches * BATCH, "wall_s": walls,
              "share": {k: v / total for k, v in walls.items()},
              "oracle_rows": fallback, "route_state": state,
              "lines_per_s": n_batches * BATCH / total})
    if outs["device"] != outs["host"]:
        raise AssertionError("the device and host tiers wrote different "
                             "bytes for the tier mix")


# e2e configurations: name -> (input.format, input.framing, the scalar
# expectation's fmt, the kernels its run must launch)
PATHS = {
    "rfc5424_line": ("rfc5424_tpu", "line", "rfc5424",
                     ("frame_sep_spans", "frame_gather", "decode_rfc5424_p6",
                      "decode_rfc5424_p16")),
    "jsonl_line": ("jsonl_tpu", "line", "jsonl",
                   ("frame_sep_spans", "frame_gather", "structural_index_f8",
                    "structural_index_f24")),
    "rfc5424_syslen": ("rfc5424_tpu", "syslen", "rfc5424",
                       ("frame_syslen_spans", "frame_gather",
                        "decode_rfc5424_p6")),
    # the mix the device encode tier takes (corpus.make_tier_corpus): no
    # batch may decline
    "rfc5424_tier": ("rfc5424_tpu", "line", "rfc5424",
                     ("frame_sep_spans", "frame_gather", "decode_rfc5424_p6",
                      "encode_gelf_probe_p6", "encode_gelf_assemble_p6")),
}


def _write_input(name: str, n_lines: int, seed: int):
    from flowgger_tpu_torch.corpus import (make_corpus, make_jsonl_corpus,
                                           make_tier_corpus,
                                           scalar_expectation, syslen_stream)

    fmt, framing, kind, _ = PATHS[name]
    if kind == "jsonl":
        lines, kinds = make_jsonl_corpus(n_lines, seed)
    elif name == "rfc5424_tier":
        lines, kinds = make_tier_corpus(n_lines, seed)
    else:
        lines, kinds = make_corpus(n_lines, seed)
    if framing == "syslen":
        # the last frame is cut short: a short read at EOF
        data = syslen_stream(lines)
    else:
        # the last record has no newline: the end-of-stream partial frame
        data = b"\n".join(lines)
    path = WORK / f"{name}.in"
    path.write_bytes(data)
    exp_out, exp_err = scalar_expectation(data, framing, fmt=kind)
    mix = {k: kinds.count(k) for k in sorted(set(kinds))}
    return path, data, exp_out, exp_err, mix


def _config(name: str, tag: str) -> Path:
    fmt, framing, _, _ = PATHS[name]
    out = WORK / f"{name}_{tag}.out"
    cfg = WORK / f"{name}_{tag}.toml"
    cfg.write_text(
        f'[input]\ntype = "stdin"\nformat = "{fmt}"\nframing = "{framing}"\n'
        f'[output]\ntype = "file"\nformat = "gelf"\nfile_path = "{out}"\n')
    if out.exists():
        out.unlink()
    return cfg


@contextlib.contextmanager
def e1_shapes():
    """Collects the (kernel name, batch shape) of each E1 launch made
    inside the block (the wrapper's count says which entry ran)."""
    from flowgger_tpu_torch.tpu import kernels

    seen = set()
    launch = kernels.encode_gelf_cuda

    def recording(batch, *args, **kw):
        before = dict(kernels.LAUNCHES)
        res = launch(batch, *args, **kw)
        seen.update((k, tuple(batch.shape)) for k, v in
                    kernels.LAUNCHES.items() if v != before.get(k, 0))
        return res

    kernels.encode_gelf_cuda = recording
    try:
        yield seen
    finally:
        kernels.encode_gelf_cuda = launch


def run_inproc(cfg: Path, path: Path):
    """One run through ``flowgger_tpu_torch.start`` on ``cuda`` with
    ``path`` as stdin: (wall seconds, pipeline, stderr lines)."""
    import torch

    import flowgger_tpu_torch

    err_buf = io.StringIO()
    saved_stdin = sys.stdin
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with open(path, "rb") as raw, contextlib.redirect_stderr(err_buf):
            sys.stdin = io.TextIOWrapper(io.BufferedReader(raw))
            pipe = flowgger_tpu_torch.start(str(cfg), device="cuda")
    finally:
        sys.stdin = saved_stdin
    torch.cuda.synchronize()
    return time.perf_counter() - t0, pipe, err_buf.getvalue().splitlines()


def phase_e2e(name: str, n_lines: int, seed: int, e1_checked=None):
    """One configuration in process (counts reset just before, read just
    after) and through the CLI; returns the in-process launch counts.
    With ``e1_checked`` (the kernels phase's :data:`E1_CHECKED`) it
    fails if the run launched E1 at a batch shape not checked there."""
    from flowgger_tpu_torch.tpu import framing, kernels

    WORK.mkdir(parents=True, exist_ok=True)
    path, data, exp_out, exp_err, mix = _write_input(name, n_lines, seed)

    # (a) in process, through the library entry point, counts reset
    cfg = _config(name, "inproc")
    for k in framing.DECLINES:
        framing.DECLINES[k] = 0
    kernels.reset_launch_counts()
    with e1_shapes() as e1_seen:
        wall_in, pipe, errs = run_inproc(cfg, path)
    launches = dict(kernels.LAUNCHES)
    declines = dict(framing.DECLINES)
    tier = dict(pipe._handler.route_state.get("rfc5424", {}))
    got = (WORK / f"{name}_inproc.out").read_bytes()
    if got != exp_out or errs != exp_err:
        raise AssertionError(
            f"{name}: in-process e2e differs from the scalar path: bytes "
            f"{len(got)} vs {len(exp_out)}, equal={got == exp_out}; "
            f"stderr lines {len(errs)} vs {len(exp_err)}")
    missing = [k for k in PATHS[name][3] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: the run launched no {missing} kernel")
    if any(declines.values()):
        raise AssertionError(f"{name}: device framing declined {declines}")
    if e1_checked is not None and e1_seen - e1_checked:
        raise AssertionError(f"{name}: E1 launched at shapes the kernels "
                             f"phase did not check: "
                             f"{sorted(e1_seen - e1_checked)}")
    # the device encode tier: batches taken, declined (over 5 % of rows
    # outside it), skipped in cooldown; bytes fetched and emitted a tier
    # row
    rows = tier.get("tier_rows", 0)
    tier_report = {k: tier.get(k, 0) for k in ("taken", "declined", "cooled",
                                               "wide", "tier_rows")}
    tier_report.update(
        fetch_bytes=tier.get("fetch_bytes", 0),
        fetch_bytes_per_tier_row=tier.get("fetch_bytes", 0) / max(rows, 1),
        emit_bytes_per_tier_row=tier.get("emit_bytes", 0) / max(rows, 1))
    # one 6-pair probe a probed batch (taken or declined; a cooled batch
    # is not probed), one assemble a taken batch; the 16-pair probes are
    # the wide attempts, counted apart
    probed = tier_report["taken"] + tier_report["declined"]
    if PATHS[name][2] == "rfc5424" and (
            launches["encode_gelf_probe_p6"] != probed
            or launches["encode_gelf_assemble_p6"]
            + launches["encode_gelf_assemble_p16"] != tier_report["taken"]):
        raise AssertionError(f"{name}: {launches} E1 launches for "
                             f"{tier_report}: not one probe a probed batch "
                             f"and one assemble a taken batch")
    tier_report["wide_probes"] = launches["encode_gelf_probe_p16"]
    if name == "rfc5424_tier" and (
            tier_report["declined"] or tier_report["cooled"]
            or not tier_report["taken"]
            or tier_report["fetch_bytes_per_tier_row"]
            >= tier_report["emit_bytes_per_tier_row"]):
        raise AssertionError(f"{name}: the device encode tier did not take "
                             f"every batch under the emitted bytes: "
                             f"{tier_report}")

    # (b) the CLI in a subprocess
    cfg = _config(name, "cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    with open(path, "rb") as stdin:
        proc = subprocess.run(
            [sys.executable, "-m", "flowgger_tpu_torch", str(cfg)],
            stdin=stdin, capture_output=True, env=env, cwd=str(ROOT),
            timeout=600)
    wall_cli = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name}: CLI run failed:\n"
                             + proc.stderr.decode()[-4000:])
    got = (WORK / f"{name}_cli.out").read_bytes()
    errs = proc.stderr.decode().splitlines()
    if got != exp_out or errs != exp_err:
        raise AssertionError(
            f"{name}: CLI e2e differs from the scalar path: bytes equal="
            f"{got == exp_out}; stderr lines {len(errs)} vs {len(exp_err)}")
    emit({"phase": "e2e", "path": name, "lines": n_lines,
          "input_bytes": len(data), "output_bytes": len(exp_out),
          "error_lines": len(exp_err), "mix": mix, "launches": launches,
          "framing_declines": declines, "device_encode_tier": tier_report,
          "e1_launch_shapes": sorted(f"{k} {list(v)}" for k, v in e1_seen),
          "inproc_wall_s": wall_in, "inproc_lines_per_s": n_lines / wall_in,
          "cli_wall_s": wall_cli, "cli_lines_per_s": n_lines / wall_cli,
          "identical_to_scalar_path": True})
    return launches


def phase_encode_ab(seed: int, n_batches: int = 8, pairs: int = 6):
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
            cfg = _config("rfc5424_line", f"ab{flag}")
            wall, pipe, errs = run_inproc(cfg, path)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--lines", type=int, default=16 * BATCH,
                    help="lines of each line-framed e2e run")
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
    smi_line = phase_device()
    phase_build()
    rows = phase_kernels(args.seed)
    phase_breakdown(args.seed, "rfc5424")
    phase_breakdown(args.seed, "jsonl")
    phase_breakdown_tier(args.seed)
    phase_encode_ab(args.seed)
    total = {}
    for name in PATHS:
        n = SYSLEN_LINES if name == "rfc5424_syslen" else args.lines
        for k, v in phase_e2e(name, n, args.seed, E1_CHECKED).items():
            total[k] = total.get(k, 0) + v
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
