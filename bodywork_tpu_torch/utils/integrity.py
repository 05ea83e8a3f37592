"""Embedded content digests for CAS-mutated JSON documents (a copy of
``bodywork_tpu.utils.integrity``).

Every JSON document mutated in place (registry records, the alias
document) embeds a ``doc_digest`` field: the sha256 of the document's
canonical serialization with the digest field removed. A flipped byte
that leaves the JSON parseable and schema-valid still reads as corrupt.

Canonical form: ``json.dumps(doc, sort_keys=True, separators=(",", ":"))``
over the digest-less document, whatever indent it was stored with. A
document without the field (written before digests existed) verifies as
None, which readers accept.
"""
from __future__ import annotations

import hashlib
import json

DOC_DIGEST_FIELD = "doc_digest"

__all__ = ["DOC_DIGEST_FIELD", "doc_digest", "sha256_digest", "stamp_doc", "verify_doc"]


def sha256_digest(data: bytes) -> str:
    """The raw-byte content digest every evidence source shares (registry
    lineage digests among them): ``"sha256:<hex>"``."""
    return "sha256:" + hashlib.sha256(data).hexdigest()


def doc_digest(doc: dict) -> str:
    """sha256 over the canonical serialization of ``doc`` without its
    digest field."""
    payload = {k: v for k, v in doc.items() if k != DOC_DIGEST_FIELD}
    data = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return "sha256:" + hashlib.sha256(data.encode("utf-8")).hexdigest()


def stamp_doc(doc: dict) -> dict:
    """``doc`` with its ``doc_digest`` field set (in place)."""
    doc[DOC_DIGEST_FIELD] = doc_digest(doc)
    return doc


def verify_doc(doc: dict) -> bool | None:
    """True when the embedded digest matches the content, False when it
    does not (corruption), None when no digest is embedded."""
    recorded = doc.get(DOC_DIGEST_FIELD)
    if recorded is None:
        return None
    return recorded == doc_digest(doc)
