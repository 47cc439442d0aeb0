"""Stdout output: print each framed message.

Parity model: flowgger src/flowgger/output/debug_output.rs:17-36
(lossy UTF-8, no added newline beyond the merger's framing, flush per
message).
"""

from __future__ import annotations

import sys

from . import Output, SHUTDOWN, stream_bytes


class DebugOutput(Output):
    def __init__(self, config=None):
        pass

    def start(self, arx, merger):
        def run():
            while True:
                item = arx.get()
                if item is SHUTDOWN:
                    arx.task_done()
                    return
                data = stream_bytes(item, merger)
                sys.stdout.write(data.decode("utf-8", errors="replace"))
                sys.stdout.flush()
                arx.task_done()

        return [self.spawn(run, "debug-output")]
