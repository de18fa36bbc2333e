"""Crash-safe npz persistence (the subset of the JAX package's ``io.py``
the serving states need, without its pandas model I/O)."""

from __future__ import annotations

import errno
import os
import uuid
from pathlib import Path

import numpy as np


def fsync_dir(directory) -> None:
    """fsync a directory so a just-renamed entry survives power loss.

    ``rename()`` alone updates the directory in the page cache; the
    directory inode must be flushed too.  Filesystems whose directories
    refuse ``fsync`` degrade to a no-op (the rename stays atomic against
    process death, just not against power loss).
    """
    fd = os.open(str(directory), os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError as exc:  # pragma: no cover - odd filesystems
        if exc.errno not in (errno.EINVAL, errno.ENOTSUP, errno.EBADF):
            raise
    finally:
        os.close(fd)


def atomic_savez(path, **arrays) -> Path:
    """Write ``arrays`` to ``path`` as an ``.npz``, atomically.

    Writes a uniquely-named dot-prefixed temp sibling (pid + random
    suffix, so concurrent writers cannot clobber each other), fsyncs
    it, renames it into place and fsyncs the directory: readers never
    observe a half-written file.
    """
    path = Path(path)
    tmp = path.with_name(
        f".{path.name}.{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp.npz"
    )
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        tmp.replace(path)
        fsync_dir(path.parent)
    except BaseException:
        if tmp.exists():
            tmp.unlink()
        raise
    return path
