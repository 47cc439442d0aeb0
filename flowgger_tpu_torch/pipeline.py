"""Orchestrator: config → components → queue → run, for the slice of
the JAX package's pipeline that the port runs.

Parity model: flowgger src/flowgger/mod.rs:95-472 and the JAX package's
``pipeline.py``: the same TOML file, the same key names and defaults,
the same factories and output-framing inference.  The port runs
``input.type = "stdin" | "tcp" | "tcp_co" | "tls" | "tls_co" | "udp" |
"file" | "redis"`` (and the reference's aliases), every
``input.framing`` (line, nul, syslen, capnp) and every
``input.format``: the ``*_tpu`` formats on
the card (``rfc5424_tpu``, ``rfc3164_tpu``, ``jsonl_tpu``, ``ltsv_tpu``,
``gelf_tpu``, ``dns_tpu``, ``auto_tpu``) through ONE batch handler that
every connection, datagram stream and tailed file shares, and the
scalar formats (``rfc5424`` — the default —, ``rfc3164``, ``gelf``,
``ltsv``, ``jsonl``, ``dns``, and ``capnp``, whose records come off the
wire) on the host, through a ``ScalarHandler`` a connection.  Outputs:
``output.format = "gelf" | "json" | "ltsv" | "rfc5424" | "rfc3164" |
"passthrough" | "capnp"`` with ``output.type = "stdout" | "debug" |
"file" | "tls" | "syslog-tls" | "kafka"`` (Kafka is the default type;
the TLS and Kafka sinks start ``tls_threads`` / ``kafka_threads``
workers, and the drain puts one ``SHUTDOWN`` a worker), with any
``[output.gelf_extra]``, ``[output.ltsv_extra]``,
``[output.capnp_extra]``, ``output.syslog_prepend_timestamp`` and
``[input.ltsv_schema]`` (the configs the block route cannot take run the
Record path, as the reference's do).  An unknown input type, input
format, output format or output type raises the reference's ConfigError;
nothing quietly takes a scalar path.

The port runs on ``cuda`` unless the caller asks for the CPU; asking for
``cuda`` where no GPU is present raises.

A failure on any ingest thread — a connection's, a file or redis
worker's, the accept loop's, or one the batch handler's flush timer
keeps — or on a sink thread ends the run: the pipeline keeps the first,
stops the input, emits the batches submitted before it, stops the sinks
and raises it (where the reference restarts its input or sink under a
supervisor).  SIGTERM and SIGINT drain and exit 0 (the reference's
``_drain``, without its fleet, durability, control, SLO and metrics
legs); :meth:`Pipeline.shutdown` is the same drain for an in-process
run.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

import torch

from .config import Config, ConfigError
from .decoders import (DNSDecoder, GelfDecoder, InvalidDecoder, JSONLDecoder,
                       LTSVDecoder, RFC3164Decoder, RFC5424Decoder)
from .encoders import (CapnpEncoder, GelfEncoder, LTSVEncoder,
                       PassthroughEncoder, RFC3164Encoder, RFC5424Encoder)
from .mergers import LineMerger, NulMerger, SyslenMerger
from .outputs import SHUTDOWN, DebugOutput, FileOutput
from .splitters import ScalarHandler
from .tenancy import current_or_default
from .tenancy.admission import AdmissionHandler
from .tenancy.fairqueue import WeightedFairQueue
from .tenancy.registry import TenantRegistry
from .tenancy.templates import TemplateMinerSet, make_gelf_enricher
from .utils import faultinject
from .utils.bounded_queue import POLICIES, PolicyQueue

# mod.rs:101-109 defaults
DEFAULT_INPUT_FORMAT = "rfc5424"
DEFAULT_INPUT_TYPE = "syslog-tls"
DEFAULT_OUTPUT_FORMAT = "gelf"
DEFAULT_OUTPUT_TYPE = "kafka"
DEFAULT_QUEUE_SIZE = 10_000_000

# input.format → the batch handler's decode route
_FORMATS = {"rfc5424_tpu": "rfc5424", "rfc3164_tpu": "rfc3164",
            "jsonl_tpu": "jsonl", "ltsv_tpu": "ltsv", "gelf_tpu": "gelf",
            "dns_tpu": "dns", "auto_tpu": "auto"}
# output.format → its encoder (the reference's get_encoder; "json" is
# GELF there too)
_ENCODERS = {"gelf": GelfEncoder, "json": GelfEncoder, "ltsv": LTSVEncoder,
             "rfc5424": RFC5424Encoder, "rfc3164": RFC3164Encoder,
             "passthrough": PassthroughEncoder, "capnp": CapnpEncoder}


def _later(what: str, slice_: str) -> ConfigError:
    return ConfigError(f"{what} is not supported by the port yet (a later "
                       f"slice: {slice_})")


def _check_durability(config: Config, input_format: str, fmt) -> None:
    """``durability.mode``: the reference's refusals (pipeline.py:237-262,
    durability/manager.py:97-102).  A scalar format prints the
    reference's notice for a mode other than "off" and runs without a
    spill tier ("require" refuses to start); a ``*_tpu`` format checks
    the mode's words, and a spill tier is a later slice."""
    words = 'durability.mode must be "off", "spill" or "require"'
    mode = config.lookup_str("durability.mode", words, "off")
    if fmt is None:
        if mode != "off":
            msg = (f'durability.mode = "{mode}" requires a *_tpu input '
                   f"format (got '{input_format}')")
            if mode == "require":
                raise ConfigError(msg)
            print(f"{msg}; the spill tier is disabled", file=sys.stderr)
        return
    if mode not in ("off", "spill", "require"):
        raise ConfigError(words)
    if mode != "off":
        raise _later(f'durability.mode = "{mode}"',
                     "durability, ROADMAP A8.3")


def _refuse_later_slices(config: Config) -> None:
    """The serving layers still to port: a config that sets them raises,
    naming the slice, rather than run without them."""
    for table, value, slice_ in (
            ("control", config.lookup("control"), "control, ROADMAP A8.6"),
            ("metrics", config.lookup("metrics"),
             "observability, ROADMAP A8.4"),
            ("slo", config.lookup("slo"), "observability, ROADMAP A8.4"),
            ("supervisor", config.lookup("supervisor"),
             "the supervisor, ROADMAP A8.7")):
        if value:
            raise _later(f"[{table}]", slice_)
    inp = config.lookup("input")
    if isinstance(inp, dict):
        fleet = sorted(k for k in inp if k.startswith("tpu_fleet")
                       and (k != "tpu_fleet" or inp[k] is not False))
        if fleet:
            raise _later(f"input.{fleet[0]}", "the fleet, ROADMAP A8.5")


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller asks for something else; raises when a
    CUDA device is asked for and none is present."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flowgger_tpu_torch runs on a CUDA device and none "
                           "is available (pass --device cpu to run the plain "
                           "PyTorch versions on the CPU)")
    return dev


def get_input(input_type: str, config: Config):
    """Input factory (mod.rs:181-193)."""
    if input_type == "redis":
        from .inputs.redis_input import RedisInput

        return RedisInput(config)
    if input_type == "stdin":
        from .inputs import StdinInput

        return StdinInput(config)
    if input_type in ("tcp", "syslog-tcp"):
        from .inputs.tcp_input import TcpInput

        return TcpInput(config)
    if input_type in ("tcp_co", "tcpco", "syslog-tcp_co", "syslog-tcpco"):
        from .inputs.tcp_input import TcpCoInput

        return TcpCoInput(config)
    if input_type in ("tls", "syslog-tls"):
        from .inputs.tls_input import TlsInput

        return TlsInput(config)
    if input_type in ("tls_co", "tlsco", "syslog-tls_co", "syslog-tlsco"):
        from .inputs.tls_input import TlsCoInput

        return TlsCoInput(config)
    if input_type == "udp":
        from .inputs.udp_input import UdpInput

        return UdpInput(config)
    if input_type == "file":
        from .inputs.file_input import FileInput

        return FileInput(config)
    raise ConfigError(f"Invalid input type: {input_type}")


def get_decoder(input_format: str, config: Config):
    """Decoder factory (mod.rs:413-422), with the *_tpu formats: their
    scalar decoder is built too (its config errors are the format's)."""
    base = _FORMATS.get(input_format, input_format)
    if input_format == "capnp":
        return InvalidDecoder(config)
    if base == "gelf":
        return GelfDecoder(config)
    if base == "ltsv":
        return LTSVDecoder(config)
    if base == "jsonl":
        return JSONLDecoder(config)
    if base == "dns":
        return DNSDecoder(config)
    if base in ("rfc5424", "auto"):
        return RFC5424Decoder(config)
    if base == "rfc3164":
        return RFC3164Decoder(config)
    raise ConfigError(f"Unknown input format: {input_format}")


def get_output(output_type: str, config: Config):
    """Output factory (mod.rs:235-243)."""
    if output_type in ("stdout", "debug"):
        return DebugOutput(config)
    if output_type == "file":
        return FileOutput(config)
    if output_type == "kafka":
        from .outputs.kafka_output import KafkaOutput

        return KafkaOutput(config)
    if output_type in ("tls", "syslog-tls"):
        from .outputs.tls_output import TlsOutput

        return TlsOutput(config)
    raise ConfigError(f"Invalid output type: {output_type}")


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
    """Wired-but-not-yet-running pipeline; ``run()`` blocks until the
    input ends (or :meth:`shutdown`, or a failure) and drains the queue
    through the sink before returning."""

    def __init__(self, config: Config, device: Optional[str] = None):
        input_format = config.lookup_str(
            "input.format", "input.format must be a string",
            DEFAULT_INPUT_FORMAT)
        input_type = config.lookup_str(
            "input.type", "input.type must be a string", DEFAULT_INPUT_TYPE)
        self.input = get_input(input_type, config)
        self.decoder = get_decoder(input_format, config)
        # the batch handler's decode route, or None: a scalar format
        self.fmt = _FORMATS.get(input_format)
        output_format = config.lookup_str(
            "output.format", "output.format must be a string",
            DEFAULT_OUTPUT_FORMAT)
        if output_format not in _ENCODERS:
            # the reference's get_encoder words (mod.rs:429-437)
            raise ConfigError(f"Unknown output format: {output_format}")
        self.encoder = _ENCODERS[output_format](config)
        output_type = config.lookup_str(
            "output.type", "output.type must be a string", DEFAULT_OUTPUT_TYPE)
        self.output = get_output(output_type, config)
        output_framing = config.lookup_str(
            "output.framing", "output.framing must be a string")
        if output_framing is None:
            output_framing = infer_output_framing(output_format, output_type)
        self.merger = get_merger(output_framing)
        if self.fmt == "auto":
            # the ltsv leg's schema and suffix errors, and the extra legs'
            from .tpu.autodetect import auto_extra_formats

            LTSVDecoder(config)
            auto_extra_formats(config)
        queue_size = config.lookup_int(
            "input.queuesize", "input.queuesize must be a size integer",
            DEFAULT_QUEUE_SIZE)
        queue_policy = config.lookup_str(
            "input.queue_policy",
            'input.queue_policy must be "block", "drop_newest" or '
            '"drop_oldest"', "block")
        if queue_policy not in POLICIES:
            raise ConfigError(
                'input.queue_policy must be "block", "drop_newest" or '
                '"drop_oldest"')
        # multi-tenant serving: a [tenants] table (or a tenant.default_*
        # rate) builds the tenant registry, swaps the bounded queue for
        # the weighted-fair multi-queue and wraps every connection's
        # handler in token-bucket admission; unconfigured, the pipeline
        # builds the pre-tenancy objects
        self.tenants = TenantRegistry.from_config(
            config, fallback_policy=queue_policy)
        if self.tenants is not None:
            self.tx = WeightedFairQueue(maxsize=queue_size,
                                        registry=self.tenants)
        else:
            self.tx = PolicyQueue(maxsize=queue_size, policy=queue_policy)
        _check_durability(config, input_format, self.fmt)
        # template mining for a scalar pipeline (the batch handler builds
        # its own miner set)
        self._scalar_miners = (TemplateMinerSet.from_config(config)
                               if self.fmt is None else None)
        faultinject.configure_from(config)
        _refuse_later_slices(config)
        self.config = config
        self.device = resolve_device(device)
        self._handler = None
        self._handler_lock = threading.Lock()
        # the run's first failure on any ingest thread, and the wake-up
        # of run(): set when the input has ended, or a failure was kept
        self._failure: Optional[BaseException] = None
        self._fail_lock = threading.Lock()
        self._wake = threading.Event()
        self._ending = False
        self._running = False
        self._finished = threading.Event()

    def handler_factory(self, peer=None):
        """One connection's handler.  A ``*_tpu`` format hands every
        connection the SAME batch handler, built once (batches then fill
        across connections; each connection frames its own stream
        through a session of its own).  A scalar format gets a new
        ``ScalarHandler`` a call.  ``peer`` is the transport's source
        (the peer IP for tcp / tls / udp, the path for a file input,
        None for stdin and redis): with tenancy configured it selects
        the tenant whose admission buckets the connection charges."""
        handler = self._base_handler()
        if self.tenants is not None:
            return AdmissionHandler(handler, self.tenants.resolve(peer))
        return handler

    def _base_handler(self):
        if self.fmt is None:
            handler = ScalarHandler(self.tx, self.decoder, self.encoder)
            handler.record_hook = self._scalar_record_hook()
            return handler
        with self._handler_lock:
            if self._handler is None:
                from .tpu.batch import BatchHandler

                handler = BatchHandler(self.tx, self.encoder, self.config,
                                       self.merger, self.device,
                                       fmt=self.fmt)
                handler.on_failure = self._fail
                self._handler = handler
            return self._handler

    def _scalar_record_hook(self):
        """Template mining (and, into GELF, enrichment) for a scalar
        pipeline (the reference's ``_scalar_record_hook``)."""
        miners = self._scalar_miners
        if miners is None:
            return None
        if miners.enrich and type(self.encoder) is GelfEncoder:
            return make_gelf_enricher(miners)

        def mine(record, tenant=None):
            miners.observe_msg(tenant or current_or_default(),
                               record.msg or "")

        return mine

    # -- failure and shutdown ------------------------------------------------
    def _fail(self, exc: BaseException) -> None:
        """Keep the run's first failure (from any thread) and stop the
        input; run() then ends the run and raises it."""
        with self._fail_lock:
            first = self._failure is None
            if first:
                self._failure = exc
        if first:
            self._wake.set()
            self.input.stop()

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop a running pipeline from another thread: the input stops
        (listeners close, workers stop), and run() drains as at the
        input's end.  Waits up to ``timeout`` seconds for run() to
        return (it raises a failure, if one ended the run)."""
        self.input.stop()
        if self._running:
            self._finished.wait(timeout)

    def _accept(self) -> None:
        """The input's accept loop, on its own thread."""
        try:
            self.input.accept(self.handler_factory)
        except BaseException as e:  # flowcheck: disable=FC04 -- kept; run() raises it
            self._fail(e)
        finally:
            self._wake.set()

    def _drain(self) -> None:
        """The reference's ``_drain`` (pipeline.py:420) without its fleet,
        durability, control, SLO and metrics legs: wait (at most 2 s) for
        the connection threads, flush and close the shared handler (the
        flush fences every lane, so every batch reaches the queue in
        order), then wait for the sink to consume the queue.  Connection
        threads still alive after the wait stay daemonized, silently (the
        reference counts them in a metric; the port emits no metrics)."""
        # from here on the queue's sheds happen during the drain
        self.tx.mark_draining()
        self.input.join_handlers(timeout=2.0)
        if self._handler is not None:
            self._handler.flush()
            self._handler.close()
        self._await_queue_drain()

    def _await_queue_drain(self, deadline_s: float = 30.0) -> None:
        """Block until the sink has consumed and ``task_done``'d every
        enqueued item; a sink that cannot drain within ``deadline_s`` is
        reported, not waited on forever."""
        import time

        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            if self.tx.unfinished_tasks == 0 or self._failure is not None:
                # drained, or a sink failed: nothing drains it any more
                return
            time.sleep(0.01)
        print(f"drain: queue barrier timed out after {deadline_s:.0f}s "
              f"({self.tx.unfinished_tasks} item(s) still in flight)",
              file=sys.stderr)

    def _end(self, sinks: list) -> Optional[BaseException]:
        """Drain, or after a failure emit what was submitted before it;
        then stop the sink threads (one ``SHUTDOWN`` each).  Returns the
        failure that ended the run (a sink's too, kept while it drained
        or at its last flush)."""
        self._ending = True
        if self._failure is None:
            try:
                self._drain()
            except BaseException as e:  # flowcheck: disable=FC04 -- kept; the caller raises it
                self._fail(e)
        failure = self._failure
        if failure is not None and self._handler is not None:
            self._handler.drain_after_failure()
        for _ in sinks:
            self.tx.put(SHUTDOWN)
        for t in sinks:
            t.join(timeout=30)
        stragglers = [t for t in sinks if t.is_alive()]
        if stragglers:
            names = ", ".join(t.name for t in stragglers)
            print(f"drain: {len(stragglers)} output thread(s) still alive "
                  f"after 30s, abandoning: [{names}]", file=sys.stderr)
        return self._failure

    def _install_signal_handlers(self, sinks: list):
        """SIGTERM and SIGINT drain and exit 0 (the reference's
        ``_install_signal_handlers``, pipeline.py:565, without its SIGUSR2
        profiler).  Only the main thread can install them; returns the
        callable that puts the previous handlers back."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def handle(signum, frame):
            print(f"Received signal {signum}, draining and exiting",
                  file=sys.stderr)
            if self._ending:
                # the run is draining already; it exits when it is done
                return
            # the input stops first: workers blocked on a server (redis's
            # BRPOPLPUSH) return, and the drain's join waits for them
            self.input.stop()
            failure = self._end(sinks)
            if failure is not None:
                import traceback

                traceback.print_exception(failure)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1 if failure is not None else 0)

        saved = {s: signal.signal(s, handle)
                 for s in (signal.SIGTERM, signal.SIGINT)}

        def restore():
            for s, h in saved.items():
                signal.signal(s, h)

        return restore

    def run(self) -> None:
        self._running = True
        self.output.on_failure = self._fail
        sinks = self.output.start(self.tx, self.merger)
        restore = self._install_signal_handlers(sinks)
        self.input.on_failure = self._fail
        accept = threading.Thread(target=self._accept, name="input-accept",
                                  daemon=True)
        try:
            accept.start()
            # the main thread waits here, holding no lock, so a signal's
            # drain can take every lock it needs
            self._wake.wait()
            failure = self._end(sinks)
            # the accept loop has returned (or, stdin blocked in a read
            # after a failure, is left to the process's exit)
            accept.join(timeout=2.0)
        finally:
            restore()
            self._finished.set()
        if failure is not None:
            raise failure


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
