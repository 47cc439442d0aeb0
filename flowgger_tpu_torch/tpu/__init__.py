"""The batched decode tier of the port: device framing, the RFC5424
decode kernel, and the host block encoder behind them.

Correctness contract (the JAX package's): rows the kernel marks ``ok``
decode identically to the scalar oracle; anything structurally unusual
sets a per-row flag and is re-decoded by the scalar path, so the
pipeline's observable output — per-line error messages included — is
byte-identical with the reference's semantics.
"""
