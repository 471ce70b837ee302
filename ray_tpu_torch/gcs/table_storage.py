"""Pluggable GCS table storage.

Reference: src/ray/gcs/store_client/ (InMemoryStoreClient,
RedisStoreClient) under gcs_table_storage.h — named tables of
key -> bytes rows behind one interface, so the GCS survives a restart
when backed by durable storage (the reference's external Redis; here
stdlib sqlite3 in WAL mode).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Dict, List, Optional

# table names mirror gcs_table_storage.h's table set
NODE_TABLE = "node"
ACTOR_TABLE = "actor"
PG_TABLE = "placement_group"
JOB_TABLE = "job"
KV_TABLE = "internal_kv"


class GcsTableStorage:
    """key -> bytes rows in named tables."""

    def put(self, table: str, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, table: str, key: bytes) -> None:
        raise NotImplementedError

    def keys(self, table: str) -> List[bytes]:
        raise NotImplementedError

    def all(self, table: str) -> Dict[bytes, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryTableStorage(GcsTableStorage):
    """reference: store_client/in_memory_store_client.h"""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[bytes, bytes]] = {}

    def put(self, table: str, key: bytes, value: bytes) -> None:
        with self._lock:
            self._tables.setdefault(table, {})[key] = value

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table: str, key: bytes) -> None:
        with self._lock:
            self._tables.get(table, {}).pop(key, None)

    def keys(self, table: str) -> List[bytes]:
        with self._lock:
            return list(self._tables.get(table, {}))

    def all(self, table: str) -> Dict[bytes, bytes]:
        with self._lock:
            return dict(self._tables.get(table, {}))


class SqliteTableStorage(GcsTableStorage):
    """Durable backend: one sqlite file, one SQL table per GCS table,
    WAL journaling so concurrent readers never block the writer (the
    role Redis plays for the reference GCS)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._created: set = set()

    def _table(self, table: str) -> str:
        if not table.replace("_", "").isalnum():
            raise ValueError(f"bad table name {table!r}")
        name = f"gcs_{table}"
        if name not in self._created:
            with self._lock:
                self._conn.execute(
                    f"CREATE TABLE IF NOT EXISTS {name} "
                    "(key BLOB PRIMARY KEY, value BLOB)")
                self._conn.commit()
            self._created.add(name)
        return name

    def put(self, table: str, key: bytes, value: bytes) -> None:
        name = self._table(table)
        with self._lock:
            self._conn.execute(
                f"INSERT INTO {name} (key, value) VALUES (?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
                (key, value))
            self._conn.commit()

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        name = self._table(table)
        with self._lock:
            row = self._conn.execute(
                f"SELECT value FROM {name} WHERE key = ?", (key,)
            ).fetchone()
        return row[0] if row else None

    def delete(self, table: str, key: bytes) -> None:
        name = self._table(table)
        with self._lock:
            self._conn.execute(f"DELETE FROM {name} WHERE key = ?",
                               (key,))
            self._conn.commit()

    def keys(self, table: str) -> List[bytes]:
        name = self._table(table)
        with self._lock:
            rows = self._conn.execute(f"SELECT key FROM {name}").fetchall()
        return [r[0] for r in rows]

    def all(self, table: str) -> Dict[bytes, bytes]:
        name = self._table(table)
        with self._lock:
            rows = self._conn.execute(
                f"SELECT key, value FROM {name}").fetchall()
        return {k: v for k, v in rows}

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def open_table_storage(path: Optional[str]) -> GcsTableStorage:
    """path=None -> in-memory (state dies with the GCS process);
    otherwise sqlite-backed durability."""
    if path:
        return SqliteTableStorage(path)
    return InMemoryTableStorage()
