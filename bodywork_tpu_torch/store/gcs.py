"""GCS artefact-store backend (optional; the port's copy of
``bodywork_tpu.store.gcs``). ``google.cloud`` is imported only when a
``GCSStore`` is constructed, so a machine without it never imports it on
the day loop.

The GKE-deployed pipeline can use a GCS bucket exactly as the reference uses
S3 (SURVEY.md C7). Requires ``google-cloud-storage``, which is not a hard
dependency — the backend raises a clear error at construction if missing, and
the rest of the framework runs on :class:`FilesystemStore`.

Listings iterate the client's paged iterator to exhaustion, so prefixes
with more than one page of blobs (1000/page on real GCS) are handled; the
contract suite drives this against a paginating fake. Transient service
errors (429/5xx classes) are retried at THIS layer through the shared
policy (:mod:`bodywork_tpu_torch.utils.retry`): exponential backoff with FULL
jitter — the previous fixed delays synchronized across the bounded
``get_many`` thread pool into a thundering herd on a struggling service
— and cumulative sleep capped by a per-op deadline budget. The real
client retries some idempotent calls internally, but its policy is
invisible to tests and does not cover iteration of an already-started
listing — an explicit, test-exercised policy beats an assumed one.
Retries are exported as ``bodywork_tpu_store_retries_total{backend,op}``.
"""
from __future__ import annotations

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, CasConflict
from bodywork_tpu_torch.utils.retry import RetryPolicy, _chain, call_with_retry

#: exception class names the GCS client raises for a failed
#: ``if_generation_match`` precondition (name-matched like the transient
#: taxonomy, so the optional dependency's classes need not be importable)
_PRECONDITION_FAILED_NAMES = frozenset(
    {"PreconditionFailed", "FailedPrecondition"}
)


def _is_precondition_failure(exc: BaseException) -> bool:
    # same cause-chain walk as the transient taxonomy (utils.retry)
    return any(
        type(e).__name__ in _PRECONDITION_FAILED_NAMES
        or getattr(e, "code", None) == 412  # HTTP Precondition Failed
        for e in _chain(exc)
    )


class GCSStore(ArtefactStore):
    backend_label = "gcs"
    #: ops already run under the shared retry policy here, so a wrapping
    #: ResilientStore adds only the breaker, not a second retry loop
    self_retrying = True

    #: transient-retry policy knobs (attempts include the first try);
    #: materialised per call as a utils.retry.RetryPolicy
    RETRY_ATTEMPTS = 3
    RETRY_BASE_DELAY_S = 0.1
    RETRY_MAX_DELAY_S = 2.0
    #: per-op deadline budget: backoff sleeps stop once an op has spent
    #: this long in total, so retry sleep can never eat a caller's
    #: completion deadline
    RETRY_DEADLINE_S = 30.0
    #: bounded fan-out for ``get_many`` — enough to overlap the ~67-200 ms
    #: per-object round-trip without stampeding the service
    GET_MANY_MAX_THREADS = 8

    def __init__(self, bucket: str, prefix: str = ""):
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "GCSStore requires the 'google-cloud-storage' package; "
                "use FilesystemStore (the default) or install it"
            ) from e
        self._client = storage.Client()
        self._bucket = self._client.bucket(bucket)
        self._prefix = prefix.strip("/")

    def _retry_policy(self) -> RetryPolicy:
        return RetryPolicy(
            attempts=self.RETRY_ATTEMPTS,
            base_delay_s=self.RETRY_BASE_DELAY_S,
            max_delay_s=self.RETRY_MAX_DELAY_S,
            deadline_s=self.RETRY_DEADLINE_S,
        )

    def _with_retries(self, op, op_name: str = "op"):
        """Run ``op`` (a thunk that fully materialises its result — paged
        iteration included, so a mid-listing drop retries the WHOLE
        listing, never splices two inconsistent pages) under the shared
        retry policy (transient-only, full jitter, deadline budget)."""

        def on_retry(exc, attempt, sleep_s):
            from bodywork_tpu_torch.obs import get_registry

            get_registry().counter(
                "bodywork_tpu_store_retries_total",
                "Artefact-store op retries by backend and op",
            ).inc(backend=self.backend_label, op=op_name)

        return call_with_retry(op, self._retry_policy(), on_retry=on_retry)

    @classmethod
    def from_url(cls, url: str) -> "GCSStore":
        assert url.startswith("gs://"), url
        bucket, _, prefix = url[len("gs://"):].partition("/")
        return cls(bucket, prefix)

    def _blob_name(self, key: str) -> str:
        self.validate_key(key)
        return f"{self._prefix}/{key}" if self._prefix else key

    def exists(self, key: str) -> bool:
        name = self._blob_name(key)
        return self._with_retries(
            lambda: self._bucket.blob(name).exists(), "exists"
        )

    def put_bytes(self, key: str, data: bytes) -> None:
        name = self._blob_name(key)
        self._with_retries(
            lambda: self._bucket.blob(name).upload_from_string(data),
            "put_bytes",
        )

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        """CAS via GCS's native conditional write: ``if_generation_match``
        pinned to the expected generation (0 = create-only, exactly the
        ``expected_token=None`` contract). A precondition failure maps to
        :class:`CasConflict`; it is NOT transient, so the retry loop
        propagates it immediately rather than burning attempts on a race
        already lost — EXCEPT when our own earlier attempt may have
        committed before its response was dropped (upload applied
        server-side, transient error on the reply, retry now sees the
        bumped generation): the post-check below re-reads the object and
        treats current-content-equals-our-payload as the success it is,
        so a promotion that actually landed is never misreported as a
        lost race (which would leave the caller's follow-up record
        updates unapplied)."""
        name = self._blob_name(key)
        match = 0 if expected_token is None else expected_token

        def _put():
            blob = self._bucket.blob(name)
            blob.upload_from_string(data, if_generation_match=match)
            return blob.generation

        def _verify_own_write():
            # fetch + download inside ONE retried thunk: the flaky
            # network that dropped the upload's response is exactly the
            # network likely to blip the verification read, and a
            # transient here must not convert a LANDED write into a
            # reported conflict
            blob = self._bucket.get_blob(name)
            if blob is not None and blob.download_as_bytes() == data:
                return blob.generation
            return None

        try:
            return self._with_retries(_put, "put_bytes_if_match")
        except Exception as exc:
            if _is_precondition_failure(exc):
                try:
                    generation = self._with_retries(
                        _verify_own_write, "put_bytes_if_match"
                    )
                    if generation is not None:
                        return generation
                except Exception:  # noqa: BLE001 — post-check best-effort
                    pass  # cannot verify: report the conflict below
                raise CasConflict(
                    f"conditional write of {key!r} lost: generation "
                    f"{match} no longer current"
                ) from exc
            raise

    def get_bytes(self, key: str) -> bytes:
        name = self._blob_name(key)

        def _get():
            blob = self._bucket.blob(name)
            if not blob.exists():
                raise ArtefactNotFound(key)
            return blob.download_as_bytes()

        return self._with_retries(_get, "get_bytes")

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        # Each object read is an independent round-trip, so a bounded
        # thread pool overlaps them; every per-key fetch keeps the SAME
        # retry policy as a single get_bytes (the thunk each worker runs
        # IS get_bytes, wrapper and all). Results return in input order;
        # the first missing key raises, like the sequential default.
        if len(keys) <= 1:
            return {key: self.get_bytes(key) for key in keys}
        from concurrent.futures import ThreadPoolExecutor

        workers = min(self.GET_MANY_MAX_THREADS, len(keys))
        with ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="gcs-get-many"
        ) as pool:
            blobs = list(pool.map(self.get_bytes, keys))
        return dict(zip(keys, blobs))

    def list_keys(self, prefix: str = "") -> list[str]:
        # a prefix is not a key (may legitimately be empty) — no validation
        full = f"{self._prefix}/{prefix}" if self._prefix else prefix
        strip = len(self._prefix) + 1 if self._prefix else 0
        return self._with_retries(lambda: sorted(
            b.name[strip:]
            for b in self._client.list_blobs(self._bucket, prefix=full)
        ), "list_keys")

    def delete(self, key: str) -> None:
        name = self._blob_name(key)
        # Absence-on-retry means success ONLY if a delete RPC was actually
        # issued: the earlier attempt's delete may have applied server-side
        # before its response was lost. A transient error BEFORE the
        # existence check (e.g. a 503 from exists() itself) proves nothing
        # about the blob — retrying into absence there must still raise
        # ArtefactNotFound for a key that never existed.
        state = {"delete_attempted": False}

        def _delete():
            blob = self._bucket.blob(name)
            if not blob.exists():
                if state["delete_attempted"]:
                    return  # our own delete (probably) landed: success
                raise ArtefactNotFound(key)
            state["delete_attempted"] = True
            blob.delete()

        self._with_retries(_delete, "delete")

    def version_token(self, key: str):
        # GCS object generation changes on every overwrite; invalid keys
        # report "no token" like the filesystem backend (contract: token
        # queries never raise)
        try:
            blob = self._with_retries(
                lambda: self._bucket.get_blob(self._blob_name(key)),
                "version_token",
            )
        except ValueError:
            return None
        return None if blob is None else blob.generation

    def version_tokens(self, keys: list[str]) -> dict[str, object]:
        # One paged listing per key *directory* returns every blob's
        # generation — O(#directories) requests instead of one get_blob
        # round-trip per key, without ever listing unrelated bucket
        # contents (keys from different prefixes must not degrade to a
        # whole-bucket listing).
        wanted = {}
        for k in keys:
            try:
                wanted[self._blob_name(k)] = k
            except ValueError:
                continue  # contract: token queries never raise; no token
        if not wanted:
            return {}
        dirs = {name.rsplit("/", 1)[0] + "/" if "/" in name else "" for name in wanted}
        out = {}
        for d in sorted(dirs):

            def _scan(d=d):
                found = {}
                for blob in self._client.list_blobs(self._bucket, prefix=d):
                    key = wanted.get(blob.name)
                    if key is not None and blob.generation is not None:
                        found[key] = blob.generation
                return found

            out.update(self._with_retries(_scan, "version_tokens"))
        return out
