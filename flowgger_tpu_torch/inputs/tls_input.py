"""TLS input: TCP + TLS handshake per connection.

Parity model: flowgger src/flowgger/input/tls/{mod,tls_input}.rs.
Config keys: input.listen (default 0.0.0.0:6514), input.tls_cert /
input.tls_key (default flowgger.pem), input.tls_ciphers,
input.tls_compatibility_level ("default"/"any"/"intermediate" → TLS1.0+,
"modern" → TLS1.2+), input.tls_verify_peer (+ input.tls_ca_file),
input.tls_compression (Python's ssl always disables TLS compression; a
``true`` here warns and proceeds, as the JAX package does), input.timeout,
input.framing/framed.  The reference's custom ffdhe DH parameters
(tls/mod.rs:41-49) have no ssl-module equivalent; ECDHE suites cover
forward secrecy.  The accept loop, the connection threads and the
coroutine tier are the TCP input's (:mod:`.tcp_input`).
"""

from __future__ import annotations

import socket
import ssl
import sys

from ..config import Config, ConfigError
from .tcp_input import SocketStream, TcpCoInput, TcpInput

DEFAULT_CERT = "flowgger.pem"
DEFAULT_KEY = "flowgger.pem"
DEFAULT_LISTEN = "0.0.0.0:6514"
DEFAULT_TIMEOUT = 3600
DEFAULT_FRAMING = "line"
DEFAULT_COMPATIBILITY = "default"
DEFAULT_VERIFY_PEER = False
TLS_VERIFY_DEPTH = 6
DEFAULT_CIPHERS = (
    "ECDHE-ECDSA-AES128-GCM-SHA256:ECDHE-RSA-AES128-GCM-SHA256:"
    "ECDHE-ECDSA-CHACHA20-POLY1305:ECDHE-RSA-CHACHA20-POLY1305:"
    "ECDHE-ECDSA-AES256-GCM-SHA384:ECDHE-RSA-AES256-GCM-SHA384:"
    "AES128-GCM-SHA256:AES256-GCM-SHA384:AES128-SHA256:AES256-SHA256"
)


def tls_config_parse(config: Config):
    """The server side's TLS context, framing, listen address and idle
    timeout (tls/mod.rs)."""
    listen = config.lookup_str(
        "input.listen", "input.listen must be an ip:port string", DEFAULT_LISTEN)
    timeout = config.lookup_int(
        "input.timeout", "input.timeout must be an unsigned integer", DEFAULT_TIMEOUT)
    framed = config.lookup_bool(
        "input.framed", "input.framed must be a boolean", False)
    framing = "syslen" if framed else DEFAULT_FRAMING
    framing = config.lookup_str(
        "input.framing",
        'input.framing must be a string set to "line", "nul" or "syslen"',
        framing)
    cert = config.lookup_str(
        "input.tls_cert", "input.tls_cert must be a path to a .pem file", DEFAULT_CERT)
    key = config.lookup_str(
        "input.tls_key", "input.tls_key must be a path to a .pem file", DEFAULT_KEY)
    ciphers = config.lookup_str(
        "input.tls_ciphers", "input.tls_ciphers must be a string with a cipher suite",
        DEFAULT_CIPHERS)
    compat = config.lookup_str(
        "input.tls_compatibility_level",
        "input.tls_compatibility_level must be a string with the compatibility level",
        DEFAULT_COMPATIBILITY)
    verify_peer = config.lookup_bool(
        "input.tls_verify_peer", "input.tls_verify_peer must be a boolean",
        DEFAULT_VERIFY_PEER)
    ca_file = config.lookup_str(
        "input.tls_ca_file", "input.tls_ca_file must be a path to a file")
    compression = config.lookup_bool(
        "input.tls_compression", "input.tls_compression must be a boolean", False)

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    if compat.lower() in ("default", "any", "intermediate"):
        ctx.minimum_version = ssl.TLSVersion.TLSv1
    elif compat.lower() == "modern":
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    else:
        raise ConfigError(
            "Unsupported TLS compatibility level. Supported levels are: default, any, intermediate and modern"
        )
    try:
        ctx.load_cert_chain(certfile=cert, keyfile=key)
    except (OSError, ssl.SSLError) as e:
        raise ConfigError(f"Unable to load the TLS certificate/key [{cert}]: {e}")
    try:
        ctx.set_ciphers(ciphers)
    except ssl.SSLError:
        raise ConfigError("Unsupported TLS cipher suite")
    if verify_peer:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.verify_flags |= ssl.VERIFY_X509_STRICT
        if ca_file is not None:
            ctx.load_verify_locations(cafile=ca_file)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if compression:
        print("WARNING: TLS compression is not supported by the ssl module; "
              "continuing without it", file=sys.stderr)
    return ctx, framing, listen, timeout


def _configure_tls(inp, config: Config):
    """The TLS inputs' ``_configure``: the context goes on ``inp.ctx``."""
    inp.ctx, framing, listen, timeout = tls_config_parse(config)
    return framing, listen, timeout


class TlsInput(TcpInput):
    label = "TLS"
    _configure = _configure_tls

    def _handle_client(self, client: socket.socket, peer_ip=None):
        try:
            tls_sock = self.ctx.wrap_socket(client, server_side=True)
        except (ssl.SSLError, OSError) as e:
            print(f"TLS handshake failed: {e}", file=sys.stderr)
            try:
                client.close()
            except OSError:  # flowcheck: disable=FC04 -- handshake already logged; close is best-effort
                pass
            return
        super()._handle_client(tls_sock, peer_ip)


class TlsCoInput(TcpCoInput):
    """Coroutine tier over asyncio TLS (tlsco_input.rs:25-47)."""

    label = "TLS"
    _configure = _configure_tls

    @property
    def ssl_context(self):
        return self.ctx


__all__ = ["TlsInput", "TlsCoInput", "SocketStream", "tls_config_parse"]
