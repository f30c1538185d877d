# Copy of durable_replace from murmura_tpu/utils/checkpoint.py.
"""Crash-safe file replacement (the one durability path the telemetry
writer commits its manifest through)."""

import os
from pathlib import Path


def durable_replace(directory, name: str, data: bytes) -> None:
    """Write ``directory/name`` via a temp file so a crash at ANY point
    leaves either the old complete file or the new complete file: the temp
    file's data is fsync'd before the rename and the directory entry after
    it (os.replace alone does not survive a host crash)."""
    directory = Path(directory)
    tmp = directory / (name + ".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        # os.write may write short: loop until every byte is down.
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, directory / name)
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
