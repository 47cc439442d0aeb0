"""The CLI pair the port's LTSV-output and dns tests share: one config and
one input through ``python -m flowgger_tpu_torch --device cpu`` and
``python -m flowgger_tpu`` (JAX on the CPU).

The port runs its whole ladder (on the CPU the plain versions of its
kernels, the host tiers, the oracle); the reference runs its host tier
(``FLOWGGER_DEVICE_ENCODE=0`` and ``tpu_fuse = "off"``: its device
compiles on the CPU are not what these tests hold).  Both children run
on one intra-op thread (the test files' ``_one_thread``)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("flowgger_tpu_torch", "flowgger_tpu")


def argv_env(pkg: str, cfg: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    extra = ("--device", "cpu") if pkg == "flowgger_tpu_torch" else ()
    if pkg == "flowgger_tpu":
        env["FLOWGGER_DEVICE_ENCODE"] = "0"
    return [sys.executable, "-m", pkg, str(cfg), *extra], env


def run(pkg: str, cfg: Path, data: bytes) -> subprocess.CompletedProcess:
    argv, env = argv_env(pkg, cfg)
    return subprocess.run(argv, input=data, capture_output=True, env=env,
                          cwd=str(ROOT), timeout=600)


def cli_pair(tmp_path: Path, data: bytes, in_keys: str, out_keys: str,
             in_tables: str = "", out_tables: str = "",
             fuse: str = "auto", batch_size: int = 256,
             concurrent: bool = False) -> dict:
    """``{pkg: (output file bytes, stdout, stderr lines)}`` of both CLIs
    over ``data``, each exiting 0.  The config: ``[input]`` with stdin,
    ``batch_size``-row batches, no timer flush and ``in_keys``, then
    ``in_tables``,
    then ``[output]`` into a file with ``out_keys``, then
    ``out_tables``.  ``concurrent`` runs the two CLIs at once (for pairs
    whose wall is the processes' start)."""
    cfgs = {}
    for pkg in PACKAGES:
        out = tmp_path / f"{pkg}.out"
        cfg = tmp_path / f"{pkg}.toml"
        cfg.write_text(
            '[input]\ntpu_encode_economics = false\n'
            'type = "stdin"\ntpu_flush_ms = 600000\n'
            f'tpu_batch_size = {batch_size}\n'
            f'tpu_fuse = "{"off" if pkg == "flowgger_tpu" else fuse}"\n'
            + in_keys + in_tables
            + f'[output]\ntype = "file"\nfile_path = "{out}"\n'
            + out_keys + out_tables)
        cfgs[pkg] = (cfg, out)
    procs = {}
    if concurrent:
        running = {}
        for pkg in PACKAGES:
            argv, env = argv_env(pkg, cfgs[pkg][0])
            running[pkg] = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=env, cwd=str(ROOT))
        for pkg, proc in running.items():
            try:
                stdout, stderr = proc.communicate(data, timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            procs[pkg] = (proc.returncode, stdout, stderr)
    else:
        for pkg in PACKAGES:
            proc = run(pkg, cfgs[pkg][0], data)
            procs[pkg] = (proc.returncode, proc.stdout, proc.stderr)
    outs = {}
    for pkg in PACKAGES:
        rc, stdout, stderr = procs[pkg]
        assert rc == 0, (pkg, stderr.decode()[-2000:])
        outs[pkg] = (cfgs[pkg][1].read_bytes(), stdout,
                     stderr.decode().splitlines())
    return outs
