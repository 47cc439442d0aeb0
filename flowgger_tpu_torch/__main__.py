"""CLI entry: ``python -m flowgger_tpu_torch [config.toml] [--device cpu]``.

Parity model: flowgger src/main.rs:9-26 (single positional config path,
default ``flowgger.toml``) and ``python -m flowgger_tpu``, whose banner
it prints so the two CLIs' standard output stays byte-identical.
"""

from __future__ import annotations

import argparse

from . import __version__, start

DEFAULT_CONFIG_FILE = "flowgger.toml"


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="flowgger-tpu-torch",
        description="flowgger-compatible log collector on PyTorch/CUDA",
    )
    parser.add_argument("config_file", nargs="?", default=DEFAULT_CONFIG_FILE,
                        help="Configuration file (default: flowgger.toml)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; the "
                             "CPU runs the kernels' plain versions)")
    parser.add_argument("--version", action="version", version=__version__)
    args = parser.parse_args(argv)
    print(f"Flowgger-TPU {__version__}")
    start(args.config_file, device=args.device)


if __name__ == "__main__":
    main()
