"""S3-style workflow storage backend.

Reference: python/ray/workflow/storage/s3.py (aioboto3 against a
bucket/prefix) alongside the filesystem backend. This backend speaks
the boto3 S3 client surface — ``put_object`` / ``get_object`` /
``list_objects_v2`` / ``delete_object`` / ``head_object`` — through an
injected client, so it runs against real S3 (pass a ``boto3`` client),
any S3-compatible object store (MinIO et al.), or the in-process
:class:`FakeS3Client` used by the test suite (this image has no boto3
and no egress; the seam is what parity requires).

``Storage.update`` needs cross-client atomicity that base S3 lacks; it
is implemented with a conditional-put lock object (``If-None-Match:
*``, supported by S3 since 2024 and by the fake) with TTL takeover for
crashed holders.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

try:
    import cloudpickle as pickle
except ImportError:  # pragma: no cover
    import pickle

from ray_tpu_torch.workflow.storage import Storage


class _ClientError(Exception):
    """Stand-in for botocore.exceptions.ClientError when botocore is
    absent; carries the same ``response['Error']['Code']`` shape."""

    def __init__(self, code: str):
        super().__init__(code)
        self.response = {"Error": {"Code": code}}


def _error_code(exc: Exception) -> str:
    response = getattr(exc, "response", None)
    if isinstance(response, dict):
        return str(response.get("Error", {}).get("Code", ""))
    return ""


class FakeS3Client:
    """In-memory boto3-shaped S3 client: enough of the surface for
    S3Storage, with real If-None-Match conditional-put semantics so the
    lock protocol is exercised honestly. Thread-safe."""

    def __init__(self, page_size: int = 1000):
        self._buckets: Dict[str, Dict[str, bytes]] = {}
        self._lock = threading.Lock()
        self._page_size = page_size  # small in tests: exercises paging

    def _bucket(self, name: str) -> Dict[str, bytes]:
        return self._buckets.setdefault(name, {})

    def put_object(self, Bucket: str, Key: str, Body: bytes,
                   IfNoneMatch: Optional[str] = None, **_):
        with self._lock:
            bucket = self._bucket(Bucket)
            if IfNoneMatch == "*" and Key in bucket:
                raise _ClientError("PreconditionFailed")
            bucket[Key] = bytes(Body)
        return {}

    def get_object(self, Bucket: str, Key: str, **_):
        import io

        with self._lock:
            bucket = self._bucket(Bucket)
            if Key not in bucket:
                raise _ClientError("NoSuchKey")
            return {"Body": io.BytesIO(bucket[Key])}

    def head_object(self, Bucket: str, Key: str, **_):
        with self._lock:
            if Key not in self._bucket(Bucket):
                raise _ClientError("404")
            return {"ContentLength": len(self._bucket(Bucket)[Key])}

    def delete_object(self, Bucket: str, Key: str, **_):
        with self._lock:
            self._bucket(Bucket).pop(Key, None)
        return {}

    def list_objects_v2(self, Bucket: str, Prefix: str = "",
                        ContinuationToken: Optional[str] = None, **_):
        with self._lock:
            keys = sorted(k for k in self._bucket(Bucket)
                          if k.startswith(Prefix))
        start = int(ContinuationToken) if ContinuationToken else 0
        page = keys[start:start + self._page_size]
        truncated = start + self._page_size < len(keys)
        out = {"Contents": [{"Key": k} for k in page],
               "IsTruncated": truncated}
        if truncated:
            out["NextContinuationToken"] = str(start + self._page_size)
        return out


class S3Storage(Storage):
    """Workflow storage over an S3 bucket/prefix.

    client: a boto3-compatible S3 client (injected — real boto3, an
    S3-compatible store's client, or FakeS3Client).
    """

    LOCK_TTL_S = 30.0

    def __init__(self, client, bucket: str, prefix: str = "workflows"):
        self.client = client
        self.bucket = bucket
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    # ------------------------------------------------------------ Storage
    def put(self, key: str, value: Any) -> None:
        self.client.put_object(Bucket=self.bucket, Key=self._key(key),
                               Body=pickle.dumps(value))

    def get(self, key: str, default: Any = None) -> Any:
        try:
            obj = self.client.get_object(Bucket=self.bucket,
                                         Key=self._key(key))
        except Exception as e:  # noqa: BLE001 — keyed miss only
            if _error_code(e) in ("NoSuchKey", "404"):
                return default
            raise
        return pickle.loads(obj["Body"].read())

    def exists(self, key: str) -> bool:
        try:
            self.client.head_object(Bucket=self.bucket,
                                    Key=self._key(key))
            return True
        except Exception as e:  # noqa: BLE001
            if _error_code(e) in ("NoSuchKey", "404", "NotFound"):
                return False
            raise

    def _list_all(self, prefix: str) -> List[str]:
        """Every key under the prefix, following pagination — real S3
        truncates at 1000 keys per page."""
        keys: List[str] = []
        token = None
        while True:
            kwargs = {"Bucket": self.bucket, "Prefix": prefix}
            if token:
                kwargs["ContinuationToken"] = token
            listing = self.client.list_objects_v2(**kwargs)
            keys.extend(i["Key"] for i in listing.get("Contents", []))
            if not listing.get("IsTruncated"):
                return keys
            token = listing.get("NextContinuationToken")
            if not token:
                return keys

    def delete_prefix(self, prefix: str) -> None:
        """Directory semantics like FilesystemStorage: the key itself
        plus everything under '<key>/' — NOT bare string-prefix
        matching, which would let delete('wf1') destroy 'wf10'."""
        full = self._key(prefix).rstrip("/")
        for key in self._list_all(full):
            if key == full or key.startswith(full + "/"):
                self.client.delete_object(Bucket=self.bucket, Key=key)

    def list_prefix(self, prefix: str) -> List[str]:
        """Immediate children under the prefix (directory-listing
        semantics, matching FilesystemStorage.list_prefix)."""
        full = self._key(prefix).rstrip("/") + "/"
        children = set()
        for key in self._list_all(full):
            rest = key[len(full):]
            if rest:
                children.add(rest.split("/", 1)[0])
        return sorted(children)

    def update(self, key: str, fn) -> Any:
        """Atomic read-modify-write via a conditional-put lock object:
        the writer that creates ``<key>.lock`` with If-None-Match:*
        wins; losers poll. A lock older than LOCK_TTL_S is presumed
        crashed and TAKEN OVER by overwrite-with-token + read-back:
        every contender writes its unique token and only the one whose
        token survives a settle window holds the lock — an
        unconditional delete here would let two waiters both "free" the
        lock (the second deleting the first winner's fresh lock) and
        run the critical section concurrently."""
        import uuid

        lock_key = self._key(key) + ".lock"
        token = uuid.uuid4().hex
        deadline = time.monotonic() + 60.0

        def lock_body() -> bytes:
            return f"{time.time()}|{token}".encode()

        while True:
            try:
                self.client.put_object(
                    Bucket=self.bucket, Key=lock_key,
                    Body=lock_body(), IfNoneMatch="*")
                break
            except Exception as e:  # noqa: BLE001 — contended lock
                if _error_code(e) not in ("PreconditionFailed", "412"):
                    raise
                took_over = False
                try:
                    obj = self.client.get_object(Bucket=self.bucket,
                                                 Key=lock_key)
                    held_since = float(
                        obj["Body"].read().split(b"|")[0])
                    if time.time() - held_since > self.LOCK_TTL_S:
                        # stale: overwrite with MY token, settle, and
                        # read back — exactly one contender survives
                        self.client.put_object(Bucket=self.bucket,
                                               Key=lock_key,
                                               Body=lock_body())
                        time.sleep(0.05)
                        obj = self.client.get_object(
                            Bucket=self.bucket, Key=lock_key)
                        took_over = obj["Body"].read().split(
                            b"|")[-1].decode() == token
                except Exception:  # noqa: BLE001 — holder released
                    continue
                if took_over:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"workflow storage lock {lock_key} held past "
                        "deadline") from None
                time.sleep(0.05)
        try:
            value = fn(self.get(key))
            self.put(key, value)
            return value
        finally:
            self.client.delete_object(Bucket=self.bucket, Key=lock_key)


def storage_from_url(url: str) -> Storage:
    """``s3://bucket/prefix`` -> S3Storage over a real boto3 client
    (raises a clear error when boto3 is absent); anything else ->
    FilesystemStorage on that path."""
    from ray_tpu_torch.workflow.storage import FilesystemStorage

    if url.startswith("s3://"):
        rest = url[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "s3:// workflow storage needs boto3; install it or "
                "inject an S3-compatible client via "
                "S3Storage(client, bucket, prefix)") from e
        return S3Storage(boto3.client("s3"), bucket, prefix)
    return FilesystemStorage(url)
