"""File output: append every framed message to ``output.file_path``.

Parity model: flowgger src/flowgger/output/file_output.rs:50-218, without
buffering or rotation: ``file_buffer_size`` and the ``file_rotation_*``
keys come in a later slice, and a config that sets them is refused
rather than silently written unrotated.
"""

from __future__ import annotations

from . import Output, SHUTDOWN, stream_bytes
from ..config import Config, ConfigError



class FileOutput(Output):
    def __init__(self, config: Config):
        path = config.lookup("output.file_path")
        if path is None:
            raise ConfigError("output.file_path is missing")
        if not isinstance(path, str):
            raise ConfigError("output.file_path must be a string")
        later = {
            "output.file_buffer_size":
                config.lookup("output.file_buffer_size"),
            "output.file_rotation_size":
                config.lookup("output.file_rotation_size"),
            "output.file_rotation_time":
                config.lookup("output.file_rotation_time"),
            "output.file_rotation_maxfiles":
                config.lookup("output.file_rotation_maxfiles"),
            "output.file_rotation_timeformat":
                config.lookup("output.file_rotation_timeformat"),
        }
        for key, value in later.items():
            if value is not None:
                raise ConfigError(
                    f"{key} is not ported yet (file buffering and rotation "
                    "come in a later slice of flowgger_tpu_torch)")
        self.path = path

    def start(self, arx, merger):
        fd = open(self.path, "ab", buffering=0)

        def run():
            with fd:
                while True:
                    item = arx.get()
                    if item is SHUTDOWN:
                        arx.task_done()
                        return
                    fd.write(stream_bytes(item, merger))
                    arx.task_done()

        return self.spawn(run, "file-output")
