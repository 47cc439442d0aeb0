"""File output with optional buffering and size / time rotation.

Parity model: flowgger src/flowgger/output/file_output.rs:50-218 and the
JAX package's ``outputs/file_output.py``.  Config keys:
``output.file_path`` (required), ``file_buffer_size`` (0 = off),
``file_rotation_size`` (0 = off), ``file_rotation_time`` (minutes, 0 =
off), ``file_rotation_maxfiles`` (default 50),
``file_rotation_timeformat`` (default
``[year][month][day]T[hour][minute][second]Z``).  With rotation on, an
``EncodedBlock`` is written a message at a time, so the rotation
triggers fall where the reference's per-message writes put them.

The port has no supervisor, so it keeps none of the JAX package's
retention of a failed write for a restarted sink: a write error ends
the run non-zero (README deviation).
"""

from __future__ import annotations

import sys

from . import Output, SHUTDOWN, stream_bytes
from ..block import EncodedBlock
from ..config import Config, ConfigError
from ..encoders import validate_time_format_input
from ..utils.rotating_file import BufferedWriter, RotatingFile

FILE_DEFAULT_BUFFER_SIZE = 0
FILE_DEFAULT_TIME_FORMAT = "[year][month][day]T[hour][minute][second]Z"
FILE_DEFAULT_ROTATION_SIZE = 0
FILE_DEFAULT_ROTATION_TIME = 0
FILE_DEFAULT_ROTATION_MAXFILES = 50


class FileOutput(Output):
    def __init__(self, config: Config):
        path = config.lookup("output.file_path")
        if path is None:
            raise ConfigError("output.file_path is missing")
        if not isinstance(path, str):
            raise ConfigError("output.file_path must be a string")
        self.path = path
        self.buffer_size = config.lookup_int(
            "output.file_buffer_size",
            "output.file_buffer_size should be an integer",
            FILE_DEFAULT_BUFFER_SIZE,
        )
        self.rotation_size = config.lookup_int(
            "output.file_rotation_size",
            "output.file_rotation_size should be an integer",
            FILE_DEFAULT_ROTATION_SIZE,
        )
        self.rotation_time = config.lookup_int(
            "output.file_rotation_time",
            "output.file_rotation_time should be an integer",
            FILE_DEFAULT_ROTATION_TIME,
        )
        self.rotation_maxfiles = config.lookup_int(
            "output.file_rotation_maxfiles",
            "output.file_rotation_maxfiles should be an integer",
            FILE_DEFAULT_ROTATION_MAXFILES,
        )
        time_format = config.lookup_str(
            "output.file_rotation_timeformat",
            "output.file_rotation_timeformat should be a string",
            FILE_DEFAULT_TIME_FORMAT,
        )
        self.time_format = validate_time_format_input(
            "file_rotation_timeformat", time_format, FILE_DEFAULT_TIME_FORMAT
        )

    def open_writer(self):
        """The writer: a RotatingFile when rotation is on, else the file
        opened for append, behind a BufferedWriter when buffering is on.
        Prints the reference's line and raises RuntimeError when the
        file cannot be opened."""
        rotating = RotatingFile(
            self.path, self.rotation_size, self.rotation_time,
            self.rotation_maxfiles, self.time_format,
        )
        try:
            if rotating.is_enabled():
                rotating.open()
                writer = rotating
            else:
                writer = RotatingFile.open_file(self.path)
        except OSError as e:
            what = "rotating file" if rotating.is_enabled() else "file"
            print(f"Unable to open {what} {self.path}: {e}", file=sys.stderr)
            raise RuntimeError(f"Cannot open file to {self.path}")
        if self.buffer_size > 0:
            writer = BufferedWriter(writer, self.buffer_size)
        return writer

    def start(self, arx, merger):
        writer = self.open_writer()
        rotating = self.rotation_size > 0 or self.rotation_time > 0

        def run():
            try:
                while True:
                    item = arx.get()
                    if item is SHUTDOWN:
                        writer.flush()
                        arx.task_done()
                        return
                    try:
                        if isinstance(item, EncodedBlock) and rotating:
                            # the reference's per-message rotation
                            # trigger (rotating_file.rs:346-363)
                            for framed in item.iter_framed():
                                writer.write(framed)
                        else:
                            writer.write(stream_bytes(item, merger))
                    finally:
                        arx.task_done()
            finally:
                writer.close()

        return [self.spawn(run, "file-output")]
