"""File backends of the port's datasets.

Counterpart of ``edtr_tpu/data/file_backend.py``: ``HardDiskBackend`` is
the only backend any config uses; ``PetrelBackend`` (S3) is declared for
config compatibility and raises unless the petrel SDK is present.
"""

from __future__ import annotations

from typing import Optional


class HardDiskBackend:
    """Read bytes from local disk (``None`` when the file cannot be read)."""

    def get(self, filepath: str) -> Optional[bytes]:
        try:
            with open(filepath, "rb") as f:
                return f.read()
        except OSError:
            return None


class PetrelBackend:
    """S3 backend via the petrel-oss SDK (config-compat stub)."""

    def __init__(self, *args, **kwargs):
        try:
            from petrel_client import client  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "PetrelBackend requires the petrel_client SDK (not available "
                "in this environment); use HardDiskBackend."
            ) from e
        self._client = client.Client(*args, **kwargs)

    def get(self, filepath: str) -> Optional[bytes]:  # pragma: no cover
        return memoryview(self._client.get(filepath)).tobytes()
