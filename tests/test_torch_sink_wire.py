"""The port's sink wire formats and sink helpers against the JAX
package's, on the same inputs: CRC32C (the native host tier's copy),
the snappy codec, Kafka record batches v2 (none, snappy, gzip) and the
v0 message set, the RESP client against ``chip_smoke.RespFake``, the
rotating file and its buffered writer under a pinned clock, and every
bad ``kafka_*``, ``tls_*``, ``file_*`` and ``redis_*`` key's
ConfigError text."""

import os
import random

import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from flowgger_tpu import native as jnative
from flowgger_tpu.config import Config as JConfig
from flowgger_tpu.config import ConfigError as JConfigError
from flowgger_tpu.utils import kafka_wire as jkw
from flowgger_tpu.utils import resp as jresp
from flowgger_tpu.utils import rotating_file as jrf
from flowgger_tpu.utils import snappy as jsnappy
from flowgger_tpu_torch import native as tnative
from flowgger_tpu_torch.config import Config as TConfig
from flowgger_tpu_torch.config import ConfigError as TConfigError
from flowgger_tpu_torch.corpus import make_corpus
from flowgger_tpu_torch.utils import kafka_wire as tkw
from flowgger_tpu_torch.utils import resp as tresp
from flowgger_tpu_torch.utils import rotating_file as trf
from flowgger_tpu_torch.utils import snappy as tsnappy


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """No tensors here, but the file keeps the port's rule: one intra-op
    thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LINES = make_corpus(600, 20)[0]


# -- CRC32C and snappy -------------------------------------------------------

def test_crc32c_known_vector():
    assert tnative.crc32c(b"123456789") == 0xE3069283
    assert tnative.crc32c(b"") == 0
    assert chip_smoke.crc32c_py(b"123456789") == 0xE3069283


@settings(max_examples=120, deadline=None)
@given(data=st.binary(max_size=3000), init=st.integers(0, 2 ** 32 - 1))
def test_crc32c_matches_the_reference(data, init):
    assert tnative.crc32c(data, init) == jnative.crc32c(data, init)


def _snappy_inputs():
    rng = random.Random(5)
    text = b"\n".join(LINES)
    return [b"", b"a", b"abcd" * 3, bytes(rng.getrandbits(8)
                                           for _ in range(70_000)),
            b"x" * 200_000, text, text[:65_536], text[:65_537]]


def test_snappy_matches_the_reference_native_codec():
    """The port's compressed bytes are the reference's native codec's,
    byte for byte, and every block round-trips through the port, the
    reference and the broker fake's Python decoder."""
    lib = jnative._load()
    assert lib is not None and hasattr(lib, "fg_snappy_compress"), \
        "the reference's native library did not load"
    for data in _snappy_inputs():
        block = tsnappy.compress(data)
        assert block == jsnappy.compress(data)
        assert tsnappy.decompress(block) == data
        assert jsnappy.decompress(block) == data
        assert chip_smoke.snappy_decompress_py(block) == data
    assert len(tsnappy.compress(b"x" * 200_000)) < 20_000


def test_snappy_refuses_a_malformed_block():
    with pytest.raises(tsnappy.SnappyError):
        tsnappy.decompress(b"\x05\x01\x00")   # a copy before any output
    with pytest.raises(tsnappy.SnappyError):
        tsnappy.decompress(b"\x80")


# -- Kafka record batches and message sets ------------------------------------

@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_record_batch_bytes_match(compression):
    values = LINES[:300]
    got = tkw._record_batch(values, compression, now_ms=1760000000123)
    assert got == jkw._record_batch(values, compression,
                                    now_ms=1760000000123)
    with chip_smoke.KafkaFake() as fake:
        fake.sets.append((3, got))
        records, rep = fake.records()
    assert records == values and rep["checksums_valid"]


def test_record_batch_gzip_records_match():
    """A gzip member carries its mtime, so the records are compared
    after the broker fake checked and decompressed each batch."""
    values = LINES[:200]
    with chip_smoke.KafkaFake() as fake:
        fake.sets += [(3, tkw._record_batch(values, "gzip", now_ms=7)),
                      (3, jkw._record_batch(values, "gzip", now_ms=7))]
        records, rep = fake.records()
    assert records == values + values and rep["compression"] == [1]


@pytest.mark.parametrize("compression", ["none", "gzip"])
def test_message_set_matches(compression):
    values = LINES[:150]
    got = tkw._message_set(values, compression)
    want = jkw._message_set(values, compression)
    if compression == "none":
        assert got == want
    with chip_smoke.KafkaFake() as fake:
        fake.sets += [(0, got), (0, want)]
        records, _ = fake.records()
    assert records == values + values


# -- RESP -------------------------------------------------------------------

def _resp_script(mod, connect: str) -> list:
    cnx = mod.RespClient.from_connect_string(connect, timeout=10)
    try:
        return [cnx.lpush("q", b"one"), cnx.lpush("q", b"two"),
                cnx.lrange("q", 0, -1), cnx.rpoplpush("q", "q.tmp.0"),
                cnx.brpoplpush("q", "q.tmp.0", 0), cnx.lrange("q.tmp.0",
                                                              0, -1),
                cnx.lrem("q.tmp.0", 1, b"one"), cnx.rpoplpush("q", "x"),
                cnx.brpoplpush("q", "x", 1), cnx.delete("q.tmp.0"),
                cnx.delete("q.tmp.0")]
    finally:
        cnx.close()


def test_resp_client_matches_the_reference_against_the_fake():
    with chip_smoke.RespFake() as fake:
        got = _resp_script(tresp, fake.connect)
        want = _resp_script(jresp, fake.connect)
        assert got == want == [1, 2, [b"two", b"one"], b"one", b"two",
                               [b"two", b"one"], 1, None, None, 1, 0]
        assert fake.commands == 22


def test_resp_shutdown_wakes_a_blocked_brpoplpush():
    import threading

    with chip_smoke.RespFake() as fake:
        cnx = tresp.RespClient.from_connect_string(fake.connect)
        err = []

        def block():
            try:
                cnx.brpoplpush("empty", "tmp", 0)
            except (tresp.RespError, OSError) as e:
                err.append(e)

        t = threading.Thread(target=block, daemon=True)
        t.start()
        t.join(0.3)
        assert t.is_alive()
        cnx.shutdown()
        t.join(10)
        cnx.close()
        assert not t.is_alive() and err


# -- the rotating file ----------------------------------------------------------

def _files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


ROTATIONS = {
    # name: (RotatingFile kwargs, [(advance the clock by s, payload)],
    #        BufferedWriter capacity or 0)
    "size": (dict(max_size=10, max_time=0, max_files=3, time_format="[year]"),
             [(0, b"123456789\n"), (0, b"abcdef\n")], 0),
    "shift_chain": (dict(max_size=4, max_time=0, max_files=2,
                         time_format="[year]"),
                    [(0, b"aaaa"), (0, b"bbbb"), (0, b"cccc"), (0, b"dddd")],
                    0),
    "time": (dict(max_size=0, max_time=1, max_files=2,
                  time_format="[hour][minute][second]"),
             [(0, b"first\n"), (61, b"second\n"), (30, b"third\n")], 0),
    "time_name": (dict(max_size=0, max_time=5, max_files=2,
                       time_format="[year][month][day]T[hour][minute]"
                                   "[second]Z"), [(0, b"x")], 0),
    "time_and_size": (dict(max_size=8, max_time=5, max_files=2,
                           time_format="[minute][second]"),
                      [(0, b"12345"), (1, b"6789"), (301, b"ab"),
                       (1, b"cdefghij")], 0),
    "buffered_size": (dict(max_size=16, max_time=0, max_files=4,
                           time_format="[year]"),
                      [(0, b"abc"), (0, b"defgh"), (0, b"i"),
                       (0, b"0123456789abcdef"), (0, b"xyz")], 8),
}


def _rotate(mod, d, kwargs, writes, capacity, capsys):
    clock = {"now": 1_000_000_000.0}
    rf = mod.RotatingFile(str(d / "out.log"), now_fn=lambda: clock["now"],
                          **kwargs)
    rf.open()
    w = mod.BufferedWriter(rf, capacity) if capacity else rf
    for advance, payload in writes:
        clock["now"] += advance
        w.write(payload)
    w.close()
    return _files(d), capsys.readouterr().err.replace(str(d), "<dir>")


@pytest.mark.parametrize("case", sorted(ROTATIONS))
def test_rotating_file_matches_the_reference(tmp_path, capsys, case):
    kwargs, writes, capacity = ROTATIONS[case]
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = _rotate(trf, tmp_path / "port", kwargs, writes, capacity, capsys)
    want = _rotate(jrf, tmp_path / "ref", kwargs, writes, capacity, capsys)
    assert got == want
    assert b"".join(got[0].values()) or case == "time_name"


def test_buffered_writer_matches_the_reference(tmp_path):
    seen = {}
    for name, mod in (("port", trf), ("ref", jrf)):
        path = tmp_path / f"{name}.log"
        bw = mod.BufferedWriter(mod.RotatingFile.open_file(str(path)), 8)
        sizes = []
        for chunk in (b"abc", b"defgh", b"i", b"0123456789", b"z"):
            bw.write(chunk)
            sizes.append(path.stat().st_size)
        bw.close()
        seen[name] = (sizes, path.read_bytes())
    assert seen["port"] == seen["ref"]
    assert seen["port"] == ([0, 0, 8, 19, 19], b"abcdefghi0123456789z")


# -- configuration errors --------------------------------------------------------

_KAFKA = '[output]\nkafka_brokers = ["127.0.0.1:9"]\nkafka_topic = "t"\n'
_TLS = '[output]\nconnect = ["127.0.0.1:9"]\n'
_FILE = '[output]\nfile_path = "/nonexistent/x"\n'
_REDIS = '[input]\n'
BAD = {
    "kafka_acks_range": ("kafka", _KAFKA + "kafka_acks = 2\n"),
    "kafka_acks_type": ("kafka", _KAFKA + 'kafka_acks = "all"\n'),
    "kafka_brokers_missing": ("kafka", '[output]\nkafka_topic = "t"\n'),
    "kafka_brokers_type": ("kafka", '[output]\nkafka_brokers = "b"\n'
                           'kafka_topic = "t"\n'),
    "kafka_brokers_items": ("kafka", '[output]\nkafka_brokers = [1]\n'
                            'kafka_topic = "t"\n'),
    "kafka_topic_missing": ("kafka", '[output]\nkafka_brokers = ["b"]\n'),
    "kafka_topic_type": ("kafka", '[output]\nkafka_brokers = ["b"]\n'
                         'kafka_topic = 3\n'),
    "kafka_timeout": ("kafka", _KAFKA + 'kafka_timeout = "x"\n'),
    "kafka_threads": ("kafka", _KAFKA + 'kafka_threads = "x"\n'),
    "kafka_coalesce": ("kafka", _KAFKA + 'kafka_coalesce = "x"\n'),
    "kafka_compression_type": ("kafka", _KAFKA + "kafka_compression = 1\n"),
    "kafka_compression_name": ("kafka", _KAFKA
                               + 'kafka_compression = "lz4"\n'),
    "kafka_retry_init": ("kafka", _KAFKA + 'kafka_retry_init = "x"\n'),
    "kafka_retry_max": ("kafka", _KAFKA + "kafka_retry_init = 500\n"
                        "kafka_retry_max = 100\n"),
    "kafka_retry_attempts": ("kafka", _KAFKA
                             + 'kafka_retry_attempts = "x"\n'),
    "tls_connect_missing": ("tls", "[output]\n"),
    "tls_connect_type": ("tls", '[output]\nconnect = "a:1"\n'),
    "tls_threads": ("tls", _TLS + 'tls_threads = "x"\n'),
    "tls_cert_type": ("tls", _TLS + "tls_cert = 1\n"),
    "tls_key_type": ("tls", _TLS + "tls_key = 1\n"),
    "tls_ciphers_type": ("tls", _TLS + "tls_ciphers = 1\n"),
    "tls_verify_peer": ("tls", _TLS + 'tls_verify_peer = "yes"\n'),
    "tls_ca_file_type": ("tls", _TLS + "tls_ca_file = 1\n"),
    "tls_timeout": ("tls", _TLS + 'timeout = "x"\n'),
    "tls_async": ("tls", _TLS + 'tls_async = "x"\n'),
    "tls_delay_init": ("tls", _TLS + 'tls_recovery_delay_init = "x"\n'),
    "tls_delay_max": ("tls", _TLS + 'tls_recovery_delay_max = "x"\n'),
    "tls_probe_time": ("tls", _TLS + 'tls_recovery_probe_time = "x"\n'),
    "tls_delay_order": ("tls", _TLS + "tls_recovery_delay_init = 50\n"
                        "tls_recovery_delay_max = 10\n"),
    "tls_ca_file_missing": ("tls", _TLS + "tls_verify_peer = true\n"
                            'tls_ca_file = "/nonexistent/ca.pem"\n'),
    "tls_cert_missing": ("tls", _TLS + 'tls_cert = "/nonexistent/c.pem"\n'),
    "tls_ciphers_bogus": ("tls", _TLS + 'tls_ciphers = "NOT-A-CIPHER"\n'),
    "file_path_missing": ("file", "[output]\n"),
    "file_path_type": ("file", "[output]\nfile_path = 3\n"),
    "file_buffer_size": ("file", _FILE + 'file_buffer_size = "x"\n'),
    "file_rotation_size": ("file", _FILE + 'file_rotation_size = "x"\n'),
    "file_rotation_time": ("file", _FILE + 'file_rotation_time = "x"\n'),
    "file_rotation_maxfiles": ("file", _FILE
                               + 'file_rotation_maxfiles = "x"\n'),
    "file_rotation_timeformat": ("file", _FILE
                                 + "file_rotation_timeformat = 1\n"),
    "redis_connect": ("redis", _REDIS + "redis_connect = 1\n"),
    "redis_queue_key": ("redis", _REDIS + "redis_queue_key = 1\n"),
    "redis_threads": ("redis", _REDIS + 'redis_threads = "x"\n'),
    "redis_retry_init": ("redis", _REDIS + 'redis_retry_init = "x"\n'),
    "redis_retry_max": ("redis", _REDIS + "redis_retry_init = 500\n"
                        "redis_retry_max = 100\n"),
}


def _build(pkg: str, kind: str, text: str):
    import importlib

    mod, cls = {"kafka": ("outputs.kafka_output", "KafkaOutput"),
                "tls": ("outputs.tls_output", "TlsOutput"),
                "file": ("outputs.file_output", "FileOutput"),
                "redis": ("inputs.redis_input", "RedisInput")}[kind]
    module = importlib.import_module(f"{pkg}.{mod}")
    config = (TConfig if pkg == "flowgger_tpu_torch" else JConfig
              ).from_string(text)
    return getattr(module, cls)(config)


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_config_raises_the_references_words(case):
    kind, text = BAD[case]
    with pytest.raises(JConfigError) as ref:
        _build("flowgger_tpu", kind, text)
    with pytest.raises(TConfigError) as port:
        _build("flowgger_tpu_torch", kind, text)
    assert str(port.value) == str(ref.value)


def test_time_format_warning_and_default_match(capsys):
    text = _FILE + 'file_rotation_timeformat = "%Y%m%d"\n'
    port = _build("flowgger_tpu_torch", "file", text)
    said = capsys.readouterr().err
    ref = _build("flowgger_tpu", "file", text)
    assert said == capsys.readouterr().err and "WARNING" in said
    assert port.time_format == ref.time_format == \
        "[year][month][day]T[hour][minute][second]Z"
    assert os.path.basename(port.path) == "x"
