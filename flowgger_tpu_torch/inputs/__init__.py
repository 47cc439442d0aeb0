"""Inputs (transports): drive the splitter → handler pipeline.

Parity model: flowgger src/flowgger/input/ — trait
``Input { accept(tx, decoder, encoder) }`` (input/mod.rs:33-40), taking a
handler factory instead of decoder+encoder.  This slice ports stdin.
"""

from __future__ import annotations


class Input:
    def accept(self, handler_factory) -> None:
        """Run the transport until it ends; ``handler_factory()`` returns
        the handler the splitter feeds."""
        raise NotImplementedError


from .stdin_input import StdinInput  # noqa: E402

__all__ = ["Input", "StdinInput"]
