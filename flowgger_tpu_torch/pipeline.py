"""Orchestrator: config → components → queue → run, for the slice of
the JAX package's pipeline that the port runs on the card.

Parity model: flowgger src/flowgger/mod.rs:95-472 and the JAX package's
``pipeline.py``: the same TOML file, the same key names and defaults,
the same output-framing inference.  The port runs ``input.type =
"stdin"`` with ``input.framing = "line" | "nul" | "syslen"`` and
``input.format = "rfc5424_tpu" | "rfc3164_tpu" | "jsonl_tpu" |
"ltsv_tpu" | "gelf_tpu" | "dns_tpu" | "auto_tpu"``, into ``output.format
= "gelf" | "json" | "ltsv" | "rfc5424" | "rfc3164" | "passthrough" |
"capnp"`` with ``output.type = "stdout" | "debug" | "file"``, with any
``[output.gelf_extra]``, ``[output.ltsv_extra]``, ``[output.capnp_extra]``,
``output.syslog_prepend_timestamp`` and ``[input.ltsv_schema]`` (the
configs the block route cannot take run the Record path, as the
reference's do).  An unknown ``output.format`` raises the reference's
ConfigError; any other input or output the port does not run yet raises
ConfigError naming the later slice; nothing quietly takes a scalar
path.

The port runs on ``cuda`` unless the caller asks for the CPU; asking for
``cuda`` where no GPU is present raises.
"""

from __future__ import annotations

import queue
from typing import Optional

import torch

from .config import Config, ConfigError
from .encoders import (CapnpEncoder, GelfEncoder, LTSVEncoder,
                       PassthroughEncoder, RFC3164Encoder, RFC5424Encoder)
from .mergers import LineMerger, NulMerger, SyslenMerger
from .outputs import SHUTDOWN, DebugOutput, FileOutput

# mod.rs:101-109 defaults
DEFAULT_INPUT_FORMAT = "rfc5424"
DEFAULT_INPUT_TYPE = "syslog-tls"
DEFAULT_OUTPUT_FORMAT = "gelf"
DEFAULT_OUTPUT_TYPE = "kafka"
DEFAULT_QUEUE_SIZE = 10_000_000

_LATER = "is not ported yet (flowgger_tpu_torch runs stdin → rfc5424_tpu, " \
    "rfc3164_tpu, jsonl_tpu, ltsv_tpu, gelf_tpu, dns_tpu or auto_tpu → " \
    "stdout, debug or file; it comes in a later slice)"
# input.format → the batch handler's decode route
_FORMATS = {"rfc5424_tpu": "rfc5424", "rfc3164_tpu": "rfc3164",
            "jsonl_tpu": "jsonl", "ltsv_tpu": "ltsv", "gelf_tpu": "gelf",
            "dns_tpu": "dns", "auto_tpu": "auto"}
# output.format → its encoder (the reference's get_encoder; "json" is
# GELF there too)
_ENCODERS = {"gelf": GelfEncoder, "json": GelfEncoder, "ltsv": LTSVEncoder,
             "rfc5424": RFC5424Encoder, "rfc3164": RFC3164Encoder,
             "passthrough": PassthroughEncoder, "capnp": CapnpEncoder}


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller asks for something else; raises when a
    CUDA device is asked for and none is present."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flowgger_tpu_torch runs on a CUDA device and none "
                           "is available (pass --device cpu to run the plain "
                           "PyTorch versions on the CPU)")
    return dev


def get_merger(output_framing: str):
    """Framing-name → merger (mod.rs:453-460)."""
    if output_framing in ("noop", "nop", "none", "capnp"):
        return None
    if output_framing == "line":
        return LineMerger()
    if output_framing == "nul":
        return NulMerger()
    if output_framing == "syslen":
        return SyslenMerger()
    raise ConfigError(f"Invalid framing type: {output_framing}")


def infer_output_framing(output_format: str, output_type: str) -> str:
    """Framing inference when output.framing is absent (mod.rs:444-452)."""
    if output_format == "capnp" or output_type == "kafka":
        return "noop"
    if output_type == "debug" or output_format == "ltsv":
        return "line"
    if output_format == "gelf":
        return "nul"
    return "noop"


class Pipeline:
    """Wired-but-not-yet-running pipeline; ``run()`` blocks on the input
    and drains the queue through the sink before returning."""

    def __init__(self, config: Config, device: Optional[str] = None):
        from .inputs import StdinInput

        input_type = config.lookup_str(
            "input.type", "input.type must be a string", DEFAULT_INPUT_TYPE)
        if input_type != "stdin":
            raise ConfigError(f'input.type = "{input_type}" {_LATER}')
        input_format = config.lookup_str(
            "input.format", "input.format must be a string",
            DEFAULT_INPUT_FORMAT)
        if input_format not in _FORMATS:
            raise ConfigError(f'input.format = "{input_format}" {_LATER}')
        self.fmt = _FORMATS[input_format]
        self.input = StdinInput(config)
        output_format = config.lookup_str(
            "output.format", "output.format must be a string",
            DEFAULT_OUTPUT_FORMAT)
        if output_format not in _ENCODERS:
            # the reference's get_encoder words (mod.rs:429-437)
            raise ConfigError(f"Unknown output format: {output_format}")
        output_type = config.lookup_str(
            "output.type", "output.type must be a string", DEFAULT_OUTPUT_TYPE)
        if output_type in ("stdout", "debug"):
            self.output = DebugOutput(config)
        elif output_type == "file":
            self.output = FileOutput(config)
        else:
            raise ConfigError(f'output.type = "{output_type}" {_LATER}')
        self.encoder = _ENCODERS[output_format](config)
        output_framing = config.lookup_str(
            "output.framing", "output.framing must be a string")
        if output_framing is None:
            output_framing = infer_output_framing(output_format, output_type)
        self.merger = get_merger(output_framing)
        if self.fmt in ("ltsv", "auto"):
            # the decoder's own ConfigErrors (schema, suffixes) at
            # construction, as the reference's pipeline builds it
            from .decoders.ltsv import LTSVDecoder

            LTSVDecoder(config)
        if self.fmt == "auto":
            from .tpu.autodetect import auto_extra_formats

            auto_extra_formats(config)
        queue_size = config.lookup_int(
            "input.queuesize", "input.queuesize must be a size integer",
            DEFAULT_QUEUE_SIZE)
        self.tx: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.config = config
        self.device = resolve_device(device)
        self._handler = None

    def handler_factory(self):
        """ONE batch handler for the input (stdin has one stream)."""
        if self._handler is None:
            from .tpu.batch import BatchHandler

            self._handler = BatchHandler(self.tx, self.encoder, self.config,
                                         self.merger, self.device,
                                         fmt=self.fmt)
        return self._handler

    def run(self) -> None:
        thread = self.output.start(self.tx, self.merger)
        try:
            self.input.accept(self.handler_factory)
            if self._handler is not None:
                # drain every lane (flush fences) and stop the fetcher
                # threads before SHUTDOWN goes on the queue: a fetcher's
                # last emit must not land after the output thread stopped
                self._handler.flush()
                self._handler.close()
        except BaseException:
            # a kernel failure ends the run, but the batches submitted
            # before it still reach the sink, in order
            if self._handler is not None:
                self._handler.drain_after_failure()
            raise
        finally:
            # drain: every queued block reaches the sink before exit
            self.tx.put(SHUTDOWN)
            thread.join()


def start(config_file: str, device: Optional[str] = None) -> Pipeline:
    """Library entry point: run the pipeline of ``config_file`` until its
    input ends.  ``device`` defaults to ``cuda``.  Returns the finished
    pipeline (its batch handler's ``route_state`` holds the device
    encode tier's counts)."""
    try:
        config = Config.from_path(config_file)
    except OSError as e:
        raise ConfigError(f"Unable to read the config file [{config_file}]: {e}")
    pipe = Pipeline(config, device=device)
    pipe.run()
    return pipe
