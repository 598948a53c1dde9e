"""Engine snapshot and restore (the port's counterpart of
``opsagent_tpu/serving/snapshot``).

A snapshot packages an engine's weights in the JAX package's leaf layout,
the built kernel libraries and the paged-KV plan into a directory that a
new engine restores from (``Engine.from_snapshot``, ``serve-engine
--restore-snapshot``) without a checkpoint parse and without ``nvcc``.
The format is the JAX package's: each package verifies the other's
snapshots, and a single-device JAX snapshot restores in the port.

``manifest`` is stdlib only; ``writer`` and ``restore`` are imported by the
Engine methods when called.
"""

from .manifest import (
    FORMAT_VERSION,
    MANIFEST_NAME,
    SnapshotError,
    fingerprint,
    read_manifest,
    verify_snapshot,
)

__all__ = [
    "FORMAT_VERSION",
    "MANIFEST_NAME",
    "SnapshotError",
    "fingerprint",
    "read_manifest",
    "verify_snapshot",
]
