"""IO backends (mirrors ``refid_tpu/data/file_client.py``; upstream
``basicsr/utils/file_client.py``).

``disk`` is what every shipped option file asks for (``io_backend: type:
disk``).  ``lmdb`` and ``memcached`` read through their client packages,
imported only when such a backend is built; without the package the
constructor raises ``ImportError`` saying which one is missing.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["FileClient"]


class _DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(filepath, "r") as f:
            return f.read()


class _LmdbBackend:
    """One read-only lmdb environment per client key; values are the bytes
    stored under the ASCII key (``lmdb_util.LmdbMaker``'s layout)."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("lmdb backend requested but the lmdb package is not "
                              "installed in this environment") from e
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError(f"{len(client_keys)} client keys for {len(db_paths)} lmdb paths")
        self._clients = {k: lmdb.open(p, readonly=readonly, lock=lock, readahead=readahead)
                         for k, p in zip(client_keys, db_paths)}

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        with self._clients[client_key].begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class _MemcachedBackend:
    """Memcached through the ``mc`` client package."""

    def __init__(self, server_list_cfg: str, client_cfg: str):
        try:
            import mc
        except ImportError as e:
            raise ImportError("memcached backend requested but the 'mc' client package "
                              "is not installed in this environment") from e
        self._mc = mc
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg, client_cfg)
        self._mc_buffer = mc.pyvector()

    def get(self, filepath: str) -> bytes:
        self._client.Get(str(filepath), self._mc_buffer)
        return self._mc.ConvertBuffer(self._mc_buffer)


class FileClient:
    """Bytes from a path or key, through the named backend."""

    _backends = {"disk": _DiskBackend, "lmdb": _LmdbBackend,
                 "memcached": _MemcachedBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(f"backend {backend!r} not supported; "
                             f"available: {sorted(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: Optional[str] = None) -> bytes:
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key or "default")
        return self.client.get(filepath)

    def get_text(self, filepath: str) -> str:
        return self.client.get_text(filepath)
