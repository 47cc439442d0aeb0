"""Chip smoke run of flowgger_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--lines N]

Phases, each printing one JSON line:

1. device — ``nvidia-smi`` name and power limit, torch's device name;
2. build  — the three CUDA kernels compiled from ``flowgger_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes (16 384-line region → spans → [16384, 512]
   batch → RFC5424 channels at 6 and 16 pairs), with CUDA-event times
   and the bound of each; the chained framing → decode entry against
   the kernels called one by one; then the host-clock wall of each stage of the main path over eight
   such regions (framing, decode, block encode, sink write);
4. e2e    — a seeded mixed corpus (default 262 144 lines) through the
   port's entry points on ``cuda``: once in process through
   ``flowgger_tpu_torch.start`` with every kernel launch count reset just
   before and read just after, and once as ``python -m flowgger_tpu_torch
   cfg.toml`` in a subprocess.  Both runs' GELF bytes and stderr error
   lines must equal the port's scalar path over the same bytes
   (``corpus.scalar_expectation``).

It then prints the kernel table, the card's ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Any failed phase raises
and the script exits non-zero; without a CUDA device it exits non-zero
before printing any result.  Scratch files go to ``build/chip_smoke``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of ``iters`` single-call times between CUDA events."""
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


def bound(nbytes: int, nops: int) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over HBM bandwidth and its integer operations
    over the INT32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes_ms": b_ms, "ops_ms": o_ms}


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype == torch.bool:
        a, b = a.to(torch.int64), b.to(torch.int64)
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    emit({"phase": "device", "nvidia_smi": line,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build():
    from flowgger_tpu_torch.tpu import kernels

    t0 = time.perf_counter()
    res = kernels.build()
    wall = time.perf_counter() - t0
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "build_log.txt").write_text("\n".join(
        f"== {k} ({v['seconds']:.2f}s, cached={v['cached']})\n{v['log']}"
        for k, v in res.items()))
    emit({"phase": "build", "wall_s": wall,
          "seconds": {k: v["seconds"] for k, v in res.items()}})


def phase_kernels(seed: int):
    """Each kernel vs its plain version on the card; returns the table
    rows without launch counts (phase 4 fills them in)."""
    import torch

    from flowgger_tpu_torch.corpus import make_corpus
    from flowgger_tpu_torch.tpu import framing, kernels, pack, rfc5424

    dev = torch.device("cuda")
    lines, _ = make_corpus(BATCH, seed)
    region_b = b"\n".join(lines) + b"\n"
    rlen = len(region_b)
    buf = torch.zeros(framing.region_bucket(rlen), dtype=torch.uint8)
    buf[:rlen] = torch.frombuffer(bytearray(region_b), dtype=torch.uint8)
    region = buf.to(dev)
    ncap = pack.bucket_rows(BATCH)
    rows = []

    # K2: spans over one flush region
    def k2():
        return kernels.frame_sep_spans_cuda(region, rlen, 10, True, ncap)

    def p2():
        return framing.frame_sep_spans(region, rlen, 10, True, ncap)

    got, ref = k2(), p2()
    meta = got["meta"].cpu().tolist()
    errs = [max_abs_err(got["starts"], ref["starts"]),
            max_abs_err(got["lens"], ref["lens"]),
            abs(meta[0] - int(ref["n"])), abs(meta[1] - int(ref["consumed"])),
            abs(meta[2] - int(ref["overflow"]))]
    if any(errs) or meta[0] != BATCH:
        raise AssertionError(f"frame_sep_spans disagrees with its plain "
                             f"version: {errs}, n={meta[0]}")
    rows.append({
        "name": "frame_sep_spans", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/frame_sep_spans.cu",
        "replaces": "flowgger_tpu/tpu/pallas_kernels.py:237",
        "max_abs_err": max(errs), "ms": cuda_ms(k2), "plain_ms": cuda_ms(p2),
        # one compare per region byte
        **bound(rlen + 8 * ncap + 16, rlen), "library_ms": None,
        "shape": f"region {rlen} B, ncap {ncap}"})

    # K3: gather to [16384, 512]
    starts, lens = got["starts"], got["lens"]

    def k3():
        return kernels.frame_gather_cuda(region, starts, lens, MAX_LEN)

    def p3():
        return framing.frame_gather(region, starts, lens, MAX_LEN)

    (gb, gl), (pb, pl) = k3(), p3()
    err = max(max_abs_err(gb, pb), max_abs_err(gl, pl))
    if err:
        raise AssertionError(f"frame_gather disagrees: max_abs_err {err}")
    rows.append({
        "name": "frame_gather", "route": "cuda",
        "source": "flowgger_tpu_torch/csrc/frame_gather.cu",
        "replaces": "flowgger_tpu/tpu/pallas_kernels.py:399",
        "max_abs_err": err, "ms": cuda_ms(k3), "plain_ms": cuda_ms(p3),
        # one select per output byte
        **bound(int(gl.sum()) + 8 * ncap + ncap * MAX_LEN + 4 * ncap,
                ncap * MAX_LEN),
        "library_ms": None,
        "shape": f"[{ncap}, {MAX_LEN}]"})

    # K1: decode at 6 pairs (main batch) and 16 pairs (rescue width)
    batch, lens_c = gb, gl
    refs = {}
    for mp in (rfc5424.DEFAULT_MAX_PAIRS, rfc5424.RESCUE_MAX_PAIRS):
        def k1():
            return kernels.decode_rfc5424_cuda(batch, lens_c, 4, mp)

        def p1():
            return rfc5424.decode_rfc5424(batch, lens_c, 4, mp)

        got1 = rfc5424.unpack_channels(k1(), 4, mp)
        ref1 = refs[mp] = p1()
        ok = ref1["ok"]
        if not torch.equal(got1["ok"], ok):
            raise AssertionError(f"decode_rfc5424 p{mp}: ok differs on "
                                 f"{int((got1['ok'] != ok).sum())} rows")
        over = ref1["pair_count"] > rfc5424.DEFAULT_MAX_PAIRS
        if not torch.equal(got1["pair_count"][over], ref1["pair_count"][over]):
            raise AssertionError(f"decode_rfc5424 p{mp}: pair_count differs")
        err = 0.0
        strict = 0.0
        for k, v in ref1.items():
            g = got1[k]
            if g.dtype != v.dtype:
                raise AssertionError(f"decode_rfc5424 p{mp}: {k} dtype")
            err = max(err, max_abs_err(g[ok], v[ok]))
            strict = max(strict, max_abs_err(g, v))
        if err:
            raise AssertionError(f"decode_rfc5424 p{mp}: channels differ on "
                                 f"ok rows (max_abs_err {err})")
        C = rfc5424.n_channels(4, mp)
        rows.append({
            "name": f"decode_rfc5424_p{mp}", "route": "cuda",
            "source": "flowgger_tpu_torch/csrc/decode_rfc5424.cu",
            "replaces": "flowgger_tpu/tpu/rfc5424.py:1095",
            "max_abs_err": err, "max_abs_err_all_rows": strict,
            "ms": cuda_ms(k1), "plain_ms": cuda_ms(p1, iters=10, warmup=1),
            # operations: one per valid byte for each of the six
            # passes the reference's definitions need over a row
            **bound(batch.numel() + 4 * batch.shape[0]
                    + 4 * C * batch.shape[0], 6 * int(lens_c.sum())),
            "library_ms": None,
            "shape": f"[{batch.shape[0]}, {batch.shape[1]}], "
                     f"{int(ok.sum())} ok rows"})

    # the chained entry (spans -> gather -> decode on one stream) gives
    # the same spans and 6-pair channels as the kernels called one by one
    spans_f, ch_f = kernels.fused_frame_decode_rfc5424(
        region, rlen, sep=10, strip_cr=True, ncap=ncap, max_len=MAX_LEN)
    ref6 = refs[rfc5424.DEFAULT_MAX_PAIRS]
    if not (torch.equal(spans_f["starts"], starts)
            and torch.equal(spans_f["lens"], lens)
            and all(torch.equal(ch_f[k], v) for k, v in ref6.items())):
        raise AssertionError("fused_frame_decode_rfc5424 disagrees with the "
                             "kernels called one by one")
    for r in rows:
        emit({"phase": "kernel", **r})
    return rows


def phase_breakdown(seed: int, n_batches: int = 8):
    """Host-clock walls of the main path's stages, each ending in a
    synchronize, over ``n_batches`` full line regions: device framing
    (upload, span and gather kernels, span metadata back), decode (kernel,
    fetch, 16-pair rescue), block encode (numpy engine plus the scalar
    oracle rows), and the sink write."""
    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import make_corpus
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import framing
    from flowgger_tpu_torch.tpu.encode_gelf_block import (
        encode_rfc5424_gelf_block)
    from flowgger_tpu_torch.tpu.rfc5424 import (decode_rfc5424_fetch,
                                                decode_rfc5424_submit)

    dev = torch.device("cuda")
    lines, _ = make_corpus(n_batches * BATCH, seed + 1)
    encoder, merger = GelfEncoder(Config.from_string("")), NulMerger()
    walls = {"frame": 0.0, "decode": 0.0, "encode": 0.0, "write": 0.0}
    fallback = 0
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "breakdown.out", "wb", buffering=0) as sink:
        for b in range(n_batches):
            region = b"\n".join(lines[b * BATCH:(b + 1) * BATCH]) + b"\n"
            t0 = time.perf_counter()
            packed, _ = framing.device_frame_region(region, "line", MAX_LEN,
                                                    BATCH, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = decode_rfc5424_fetch(decode_rfc5424_submit(packed[0],
                                                              packed[1]))
            t2 = time.perf_counter()
            res = encode_rfc5424_gelf_block(packed[2], packed[3], packed[4],
                                            host, packed[5], MAX_LEN,
                                            encoder, merger)
            t3 = time.perf_counter()
            sink.write(res.block.data)
            t4 = time.perf_counter()
            walls["frame"] += t1 - t0
            walls["decode"] += t2 - t1
            walls["encode"] += t3 - t2
            walls["write"] += t4 - t3
            fallback += res.fallback_rows
    total = sum(walls.values())
    emit({"phase": "breakdown", "lines": n_batches * BATCH,
          "wall_s": walls, "share": {k: v / total for k, v in walls.items()},
          "oracle_rows": fallback,
          "lines_per_s": n_batches * BATCH / total})


def _write_inputs(n_lines: int, seed: int, work: Path):
    from flowgger_tpu_torch.corpus import make_corpus, scalar_expectation

    lines, kinds = make_corpus(n_lines, seed)
    # the last record has no newline: the end-of-stream partial frame
    data = b"\n".join(lines)
    (work / "input.log").write_bytes(data)
    exp_out, exp_err = scalar_expectation(data)
    mix = {k: kinds.count(k) for k in sorted(set(kinds))}
    return data, exp_out, exp_err, mix


def _config(work: Path, name: str) -> Path:
    cfg = work / f"{name}.toml"
    cfg.write_text(
        '[input]\ntype = "stdin"\nformat = "rfc5424_tpu"\nframing = "line"\n'
        '[output]\ntype = "file"\nformat = "gelf"\n'
        f'file_path = "{work / (name + ".out")}"\n')
    out = work / f"{name}.out"
    if out.exists():
        out.unlink()
    return cfg


def phase_e2e(n_lines: int, seed: int):
    import torch

    import flowgger_tpu_torch
    from flowgger_tpu_torch.tpu import kernels

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    data, exp_out, exp_err, mix = _write_inputs(n_lines, seed, work)

    # (a) in process, through the library entry point, counts reset
    cfg = _config(work, "inproc")
    err_buf = io.StringIO()
    saved_stdin = sys.stdin
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with open(work / "input.log", "rb") as raw, \
                contextlib.redirect_stderr(err_buf):
            sys.stdin = io.TextIOWrapper(io.BufferedReader(raw))
            flowgger_tpu_torch.start(str(cfg), device="cuda")
    finally:
        sys.stdin = saved_stdin
    torch.cuda.synchronize()
    wall_in = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    got = (work / "inproc.out").read_bytes()
    errs = err_buf.getvalue().splitlines()
    if got != exp_out or errs != exp_err:
        raise AssertionError(
            f"in-process e2e differs from the scalar path: bytes "
            f"{len(got)} vs {len(exp_out)}, equal={got == exp_out}; "
            f"stderr lines {len(errs)} vs {len(exp_err)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")

    # (b) the CLI in a subprocess
    cfg = _config(work, "cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    with open(work / "input.log", "rb") as stdin:
        proc = subprocess.run(
            [sys.executable, "-m", "flowgger_tpu_torch", str(cfg)],
            stdin=stdin, capture_output=True, env=env, cwd=str(ROOT),
            timeout=600)
    wall_cli = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("CLI run failed:\n"
                             + proc.stderr.decode()[-4000:])
    got = (work / "cli.out").read_bytes()
    errs = proc.stderr.decode().splitlines()
    if got != exp_out or errs != exp_err:
        raise AssertionError(
            f"CLI e2e differs from the scalar path: bytes equal="
            f"{got == exp_out}; stderr lines {len(errs)} vs {len(exp_err)}")
    emit({"phase": "e2e", "lines": n_lines, "input_bytes": len(data),
          "output_bytes": len(exp_out), "error_lines": len(exp_err),
          "mix": mix, "launches": launches,
          "inproc_wall_s": wall_in, "inproc_lines_per_s": n_lines / wall_in,
          "cli_wall_s": wall_cli, "cli_lines_per_s": n_lines / wall_cli,
          "identical_to_scalar_path": True})
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--lines", type=int, default=16 * BATCH)
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
    phase_breakdown(args.seed)
    launches = phase_e2e(args.lines, args.seed)
    for r in rows:
        r["launches"] = launches[r["name"]]
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
