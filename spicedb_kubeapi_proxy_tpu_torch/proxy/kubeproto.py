"""Kubernetes protobuf envelope handling: schema-light wire surgery.

The kube protobuf wire format is a 4-byte magic prefix (``k8s\\x00``)
followed by a ``runtime.Unknown`` message whose ``raw`` field holds the
serialized object (reference negotiates this alongside JSON,
the Go proxy's pkg/authz/responsefilterer.go:242-313).

Filtering a *List or Table response only needs a handful of API-stable
protobuf field numbers — no generated schemas:

- ``runtime.Unknown``: typeMeta=1 (apiVersion=1, kind=2), raw=2,
  contentEncoding=3, contentType=4
- every ``XList`` message: metadata(ListMeta)=1, repeated items=2
- every item's ``metadata(ObjectMeta)``=1, within it name=1, namespace=3
- ``meta.k8s.io/v1 Table``: metadata=1, columnDefinitions=2, rows=3;
  ``TableRow``: cells=1, conditions=2, object(RawExtension)=3;
  ``runtime.RawExtension``: raw=1. A row's object bytes are either a
  nested magic-prefixed ``runtime.Unknown`` (how kube encodes nested
  RawExtensions under proto negotiation) or a bare
  ``PartialObjectMetadata`` — both resolve through the same
  ObjectMeta-at-field-1 shape (reference filters Table rows after full
  decode, pkg/authz/responsefilterer.go:349-374; here the kept rows stay
  byte-identical)

These numbers are frozen by the kube API compatibility contract (all
generated.proto files), so splitting the repeated ``items`` field and
peeking each item's ObjectMeta is exact, and every byte we keep is
byte-identical to what the apiserver sent — the same passthrough property
the JSON/watch paths maintain (pkg/authz/frames.go:13-68).

WATCH streams (reference negotiates the streaming serializer per content
type, responsefilterer.go:557-626) add one more frozen layer: each frame
is a 4-byte big-endian length followed by a RAW-serialized (no magic, no
Unknown envelope) ``meta.k8s.io/v1 WatchEvent`` — type=1 (string),
object(RawExtension)=2 — whose ``object.raw`` bytes hold the event's
object with the FULL magic-prefixed Unknown envelope. The watch join
needs only (event type, namespace, name) per frame; kept frames pass
through byte-identically, length prefix and all.
"""

from __future__ import annotations

from typing import Iterator, Optional

MAGIC = b"k8s\x00"
CONTENT_TYPE = "application/vnd.kubernetes.protobuf"
# the streaming variant the apiserver stamps on proto watch responses
WATCH_CONTENT_TYPE = CONTENT_TYPE + ";stream=watch"


class ProtoError(ValueError):
    pass


def _read_varint(b: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if i >= len(b):
            raise ProtoError("truncated varint")
        byte = b[i]
        i += 1
        out |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise ProtoError("varint too long")


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def fields(b: bytes) -> Iterator[tuple[int, int, bytes, bytes]]:
    """Yield (field_no, wire_type, full_chunk, payload) over a message.
    ``full_chunk`` is the exact byte span including the tag, so callers
    can copy or drop whole fields byte-identically."""
    i = 0
    n = len(b)
    while i < n:
        start = i
        tag, i = _read_varint(b, i)
        field_no, wire_type = tag >> 3, tag & 7
        if wire_type == 0:  # varint
            _, i = _read_varint(b, i)
            payload = b[start:i]
        elif wire_type == 1:  # fixed64
            i += 8
            payload = b[start:i]
        elif wire_type == 2:  # length-delimited
            ln, j = _read_varint(b, i)
            if j + ln > n:
                raise ProtoError("truncated length-delimited field")
            payload = b[j:j + ln]
            i = j + ln
        elif wire_type == 5:  # fixed32
            i += 4
            payload = b[start:i]
        else:
            raise ProtoError(f"unsupported wire type {wire_type}")
        if i > n:
            raise ProtoError("truncated field")
        yield field_no, wire_type, b[start:i], payload


def _field(b: bytes, field_no: int) -> Optional[bytes]:
    """Payload of the first length-delimited occurrence of a field."""
    for fno, wt, _, payload in fields(b):
        if fno == field_no and wt == 2:
            return payload
    return None


def _ld_field(field_no: int, payload: bytes) -> bytes:
    return _encode_varint((field_no << 3) | 2) \
        + _encode_varint(len(payload)) + payload


def decode_unknown(body: bytes) -> tuple[str, str, bytes]:
    """-> (apiVersion, kind, raw) from a magic-prefixed runtime.Unknown."""
    if not body.startswith(MAGIC):
        raise ProtoError("missing k8s protobuf magic prefix")
    msg = body[len(MAGIC):]
    api_version, kind, raw = "", "", b""
    for fno, wt, _, payload in fields(msg):
        if fno == 1 and wt == 2:  # typeMeta
            tm_api = _field(payload, 1)
            tm_kind = _field(payload, 2)
            api_version = (tm_api or b"").decode("utf-8", "replace")
            kind = (tm_kind or b"").decode("utf-8", "replace")
        elif fno == 2 and wt == 2:  # raw
            raw = payload
    return api_version, kind, raw


def replace_unknown_raw(body: bytes, new_raw: bytes) -> bytes:
    """Re-emit the envelope with ``raw`` replaced; every other field is
    copied byte-identically in its original position."""
    msg = body[len(MAGIC):]
    out = bytearray(MAGIC)
    replaced = False
    for fno, wt, chunk, _ in fields(msg):
        if fno == 2 and wt == 2 and not replaced:
            out += _ld_field(2, new_raw)
            replaced = True
        elif fno == 2 and wt == 2:
            continue  # drop duplicate raw fields
        else:
            out += chunk
    if not replaced:
        out += _ld_field(2, new_raw)
    return bytes(out)


def item_meta(item: bytes) -> tuple[str, str]:
    """(namespace, name) from an item's ObjectMeta (field 1; name=1,
    namespace=3)."""
    meta = _field(item, 1)
    if meta is None:
        return "", ""
    name = _field(meta, 1)
    namespace = _field(meta, 3)
    return ((namespace or b"").decode("utf-8", "replace"),
            (name or b"").decode("utf-8", "replace"))


def table_row_meta(row: bytes) -> tuple[str, str]:
    """(namespace, name) for a TableRow via its ``object`` RawExtension.
    Raises ProtoError when the row carries no keyable object (e.g. the
    client sent ``includeObject=None``) — the filterer turns that into a
    clean 4xx rather than passing unjudgeable rows through."""
    ext = _field(row, 3)  # optional RawExtension object
    if ext is None:
        raise ProtoError(
            "table row has no object to authorize against (request "
            "includeObject=Metadata, the kube default)")
    raw_obj = _field(ext, 1)  # RawExtension.raw
    if raw_obj is None:
        raise ProtoError("table row object has no raw bytes")
    if raw_obj.startswith(MAGIC):
        _, _, raw_obj = decode_unknown(raw_obj)
    ns, name = item_meta(raw_obj)
    if not name:
        raise ProtoError("table row object has no metadata.name")
    return ns, name


# -- encoders (in-memory upstream fidelity + tests) --------------------------


def encode_unknown(api_version: str, kind: str, raw: bytes) -> bytes:
    """Magic-prefixed ``runtime.Unknown`` envelope — the inverse of
    :func:`decode_unknown` (the in-memory upstream uses it to serve
    protobuf the way a real apiserver would)."""
    tm = _ld_field(1, api_version.encode()) + _ld_field(2, kind.encode())
    return MAGIC + _ld_field(1, tm) + _ld_field(2, raw)


def encode_object_meta_only(name: str, namespace: str = "") -> bytes:
    """A message whose field 1 is an ObjectMeta carrying name/namespace —
    the minimal shape every keying path here reads."""
    meta = b""
    if name:
        meta += _ld_field(1, name.encode())
    if namespace:
        meta += _ld_field(3, namespace.encode())
    return _ld_field(1, meta)


def encode_watch_frame(event_type: str, object_bytes: bytes) -> bytes:
    """One length-prefixed raw-serialized WatchEvent frame (the shape
    :func:`watch_frame_key` reads): type=1, object RawExtension=2 whose
    raw=1 holds ``object_bytes`` (normally an :func:`encode_unknown`
    envelope)."""
    we = _ld_field(1, event_type.encode()) \
        + _ld_field(2, _ld_field(1, object_bytes))
    return len(we).to_bytes(4, "big") + we


def decode_watch_event(body: bytes) -> tuple[str, bytes]:
    """(event type, object bytes) from a raw-serialized WatchEvent (the
    frame body AFTER the 4-byte length prefix). ``object bytes`` are the
    RawExtension's raw field — normally a magic-prefixed Unknown."""
    typ = ""
    raw = b""
    for fno, wt, _, payload in fields(body):
        if fno == 1 and wt == 2:
            typ = payload.decode("utf-8", "replace")
        elif fno == 2 and wt == 2:
            raw = _field(payload, 1) or b""
    return typ, raw


def watch_frame_key(frame: bytes) -> Optional[tuple[str, str]]:
    """(namespace, name) of the object a length-prefixed proto watch frame
    carries, or None for frames every consumer may see (BOOKMARKs). The
    frame bytes are never altered — the caller passes kept frames through
    verbatim (reference frame-capturing reader, pkg/authz/frames.go).

    Raises ProtoError for frames carrying no keyable object (an ERROR
    frame's Status, a Table row without an object) — the watch join must
    not silently pass unjudgeable objects."""
    if len(frame) < 4:
        raise ProtoError("proto watch frame shorter than its length prefix")
    body = frame[4:]
    typ, raw = decode_watch_event(body)
    if typ == "BOOKMARK":
        return None  # progress marker, carries only a resourceVersion
    kind = ""
    if raw.startswith(MAGIC):
        _, kind, raw = decode_unknown(raw)
    if typ == "ERROR" or kind == "Status":
        # a terminal Status (watch expiry etc.): no object to judge,
        # every consumer is entitled to see it
        return None
    if kind == "Table":
        for fno, wt, _, payload in fields(raw):
            if fno == 3 and wt == 2:  # first row keys the event
                return table_row_meta(payload)
        raise ProtoError("Table watch event has no rows")
    ns, name = item_meta(raw)
    if not name:
        raise ProtoError("watch event object has no metadata.name")
    return ns, name


def filter_table_raw(raw: bytes, allows) -> bytes:
    """Drop Table ``rows`` (repeated field 3) whose row object fails
    ``allows(namespace, name)``; metadata, columnDefinitions, and kept
    rows are copied byte-identically in order."""
    out = bytearray()
    for fno, wt, chunk, payload in fields(raw):
        if fno == 3 and wt == 2:
            ns, name = table_row_meta(payload)
            if not allows(ns, name):
                continue
        out += chunk
    return bytes(out)


def filter_list_raw(raw: bytes, allows) -> bytes:
    """Drop ``items`` (repeated field 2) whose ObjectMeta fails
    ``allows(namespace, name)``; all other fields and kept items are
    copied byte-identically in order."""
    out = bytearray()
    for fno, wt, chunk, payload in fields(raw):
        if fno == 2 and wt == 2:
            ns, name = item_meta(payload)
            if not allows(ns, name):
                continue
        out += chunk
    return bytes(out)
