"""Kafka producer output with message coalescing.

Parity model: flowgger src/flowgger/output/kafka_output.rs:13-212 and
the JAX package's ``outputs/kafka_output.py`` (without its durability
acks, which the port does not have).
``output.kafka_brokers`` (required list), ``kafka_topic`` (required),
``kafka_acks`` -1/0/1, ``kafka_timeout`` ms, ``kafka_threads``,
``kafka_coalesce`` (buffer N messages then send_all), ``kafka_compression``
none/gzip/snappy (snappy via the from-scratch codec in utils/snappy.py;
requires a broker speaking record batches v2, negotiated automatically).
An unresponsive broker terminates the process (exit 1), matching the
reference's contract ("Kafka not responsive: [...]" on stdout first);
output framing is ignored with a warning, and an ``EncodedBlock`` goes
out as one message a record (``iter_unframed``).  Transport: utils/kafka_wire.py, a from-scratch minimal
protocol client.
"""

from __future__ import annotations

import sys

from . import Output, SHUTDOWN
from ..block import EncodedBlock
from ..config import Config, ConfigError
from ..utils.kafka_wire import KafkaError, KafkaProducer
from ..utils.retry import RetryExhausted, RetryPolicy, retry_config_kwargs

KAFKA_DEFAULT_ACKS = 0
KAFKA_DEFAULT_COALESCE = 1
KAFKA_DEFAULT_COMPRESSION = "none"
KAFKA_DEFAULT_THREADS = 1
KAFKA_DEFAULT_TIMEOUT = 60_000
KAFKA_DEFAULT_RETRY_INIT = 250
KAFKA_DEFAULT_RETRY_MAX = 10_000
KAFKA_DEFAULT_RETRY_ATTEMPTS = 3


class KafkaOutput(Output):
    def __init__(self, config: Config):
        self.acks = config.lookup_int(
            "output.kafka_acks", "output.kafka_acks must be a 16-bit integer",
            KAFKA_DEFAULT_ACKS)
        if self.acks not in (-1, 0, 1):
            raise ConfigError("Unsupported value for kafka_acks")
        brokers = config.lookup("output.kafka_brokers")
        if brokers is None:
            raise ConfigError("output.kafka_brokers is required")
        if not isinstance(brokers, list) or not all(isinstance(b, str) for b in brokers):
            raise ConfigError("output.kafka_brokers must be a list of strings")
        self.brokers = brokers
        topic = config.lookup("output.kafka_topic")
        if topic is None or not isinstance(topic, str):
            raise ConfigError("output.kafka_topic must be a string")
        self.topic = topic
        self.timeout_ms = config.lookup_int(
            "output.kafka_timeout", "output.kafka_timeout must be a 64-bit integer",
            KAFKA_DEFAULT_TIMEOUT)
        self.threads = config.lookup_int(
            "output.kafka_threads", "output.kafka_threads must be a 32-bit integer",
            KAFKA_DEFAULT_THREADS)
        self.coalesce = config.lookup_int(
            "output.kafka_coalesce", "output.kafka_coalesce must be a size integer",
            KAFKA_DEFAULT_COALESCE)
        compression = config.lookup_str(
            "output.kafka_compression",
            # sic: the reference's panic message has this typo
            # (kafka_output.rs:169 "output.kafka_compresion must be a string")
            "output.kafka_compresion must be a string",
            KAFKA_DEFAULT_COMPRESSION).lower()
        if compression not in ("none", "gzip", "snappy"):
            raise ConfigError("Unsupported compression method")
        self.compression = compression
        # retry-before-dying: the reference exits the process on the
        # first unresponsive broker; here each connect/send gets
        # output.kafka_retry_attempts tries with jittered exponential
        # backoff first, and only exhaustion keeps the exit contract
        self._retry_kw = retry_config_kwargs(
            config, "output.kafka",
            init_ms=KAFKA_DEFAULT_RETRY_INIT,
            max_ms=KAFKA_DEFAULT_RETRY_MAX,
            max_attempts=KAFKA_DEFAULT_RETRY_ATTEMPTS)
        self.exit_on_failure = True  # tests disable to keep pytest alive

    def _send_retrying(self, policy, producer, batch) -> None:
        """send_all with backoff; raises RetryExhausted when the broker
        stays unresponsive through the whole retry budget."""
        def send():
            producer.send_all(self.topic, batch)

        policy.run(send, retry_on=(KafkaError,),
                   on_error=lambda e: print(
                       f"Kafka send failed, retrying: [{e}]",
                       file=sys.stderr))
        policy.note_success()

    def _worker(self, arx, merger):
        policy = RetryPolicy(metric="sink_reconnects", **self._retry_kw)

        def connect():
            producer = KafkaProducer(self.brokers, self.acks, self.timeout_ms,
                                     self.compression)
            producer.refresh_metadata(self.topic)
            return producer

        try:
            producer = policy.run(
                connect, retry_on=(KafkaError, OSError),
                on_error=lambda e: print(
                    f"Unable to connect to Kafka, retrying: [{e}]",
                    file=sys.stderr))
        except RetryExhausted as e:
            print(f"Unable to connect to Kafka: [{e}]")
            return self._die()
        policy.note_success()
        queue_buf = []
        while True:
            item = arx.get()
            if item is SHUTDOWN:
                try:
                    self._send_retrying(policy, producer, queue_buf)
                except RetryExhausted as e:
                    print(f"Kafka not responsive: [{e}]")
                    arx.task_done()
                    return self._die()
                arx.task_done()
                return None
            if isinstance(item, EncodedBlock):
                queue_buf.extend(item.iter_unframed())
            else:
                queue_buf.append(item)
            if len(queue_buf) >= max(1, self.coalesce):
                try:
                    self._send_retrying(policy, producer, queue_buf)
                except RetryExhausted as e:
                    print(f"Kafka not responsive: [{e}]")
                    arx.task_done()
                    return self._die()
                queue_buf = []
            arx.task_done()

    def _die(self):
        if self.exit_on_failure:
            import os

            os._exit(1)

    def start(self, arx, merger):
        if merger is not None:
            print("Output framing is ignored with the Kafka output", file=sys.stderr)
        return [self.spawn(lambda: self._worker(arx, merger), "kafka-output")
                for _ in range(self.threads)]
