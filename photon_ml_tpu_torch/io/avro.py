"""Self-contained Avro: binary codec + object container file read/write.

Port of ``photon_ml_tpu/io/avro.py:45-894`` (the module imports no JAX, but
the port keeps its own copy): schema parsing, the binary encoder/decoder,
``compile_reader``/``compile_writer``, container read/write with the
``null`` and ``deflate`` codecs, ``list_avro_parts`` and
``expand_part_paths``. Files written here decode in the JAX package and
vice versa: both speak the Avro 1.x subset the reference's schemas use
(primitives, record, enum, array, map, union, fixed).

The records path carries the JAX package's degraded-ingest protocol
(``:667``, ``:799-894``): ``read_container`` fires ``io.shard_open`` before
a shard is opened, and ``read_shard`` fires ``io.avro_read`` per attempt,
retries transient failures and, with an ingest policy, quarantines a shard
that stays unreadable or decodes corrupt. ``check_container_framing``
(``:750``) is the probe the native columnar path (``io/native_avro.py``)
runs on a shard it declined, to tell a corrupt shard from an unsupported
schema.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Iterable, Optional

from photon_ml_tpu_torch.utils.faults import fault_point
from photon_ml_tpu_torch.utils.retry import (
    RetryExhaustedError,
    call_with_retry,
)

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
DEFAULT_SYNC_INTERVAL = 16_000  # records per block (approximate)

PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes",
              "string"}


# ---------------------------------------------------------------------------
# Schema handling
# ---------------------------------------------------------------------------


def parse_schema(schema: Any) -> Any:
    """Normalize a schema (JSON string or python structure) and resolve
    named-type references into a lookup-friendly form."""
    if isinstance(schema, str):
        if schema in PRIMITIVES:  # "null" would json-parse to None
            return schema
        try:
            schema = json.loads(schema)
        except json.JSONDecodeError:
            # bare named-type reference like "NameTermValueAvro"
            schema = schema.strip('"')
    return schema


def _names_index(schema: Any, index: Optional[dict] = None) -> dict:
    """Collect named types (records/enums/fixed) for reference resolution."""
    if index is None:
        index = {}
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            name = schema["name"]
            ns = schema.get("namespace")
            full = f"{ns}.{name}" if ns and "." not in name else name
            index[full] = schema
            index[name] = schema
        if t == "record":
            for f in schema.get("fields", []):
                _names_index(f["type"], index)
        elif t == "array":
            _names_index(schema["items"], index)
        elif t == "map":
            _names_index(schema["values"], index)
    elif isinstance(schema, list):
        for s in schema:
            _names_index(s, index)
    return index


# ---------------------------------------------------------------------------
# Binary encoder / decoder
# ---------------------------------------------------------------------------


class BinaryEncoder:
    def __init__(self, out: io.BytesIO):
        self.out = out

    def write_long(self, n: int) -> None:
        n = (n << 1) ^ (n >> 63)  # zig-zag
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                self.out.write(bytes((b | 0x80,)))
            else:
                self.out.write(bytes((b,)))
                break

    def write_int(self, n: int) -> None:
        self.write_long(n)

    def write_boolean(self, b: bool) -> None:
        self.out.write(b"\x01" if b else b"\x00")

    def write_float(self, x: float) -> None:
        self.out.write(struct.pack("<f", x))

    def write_double(self, x: float) -> None:
        self.out.write(struct.pack("<d", x))

    def write_bytes(self, b: bytes) -> None:
        self.write_long(len(b))
        self.out.write(b)

    def write_string(self, s: str) -> None:
        self.write_bytes(s.encode("utf-8"))


class BinaryDecoder:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # un-zig-zag

    def read_boolean(self) -> bool:
        b = self.buf[self.pos]
        self.pos += 1
        return b != 0

    def read_float(self) -> float:
        v = struct.unpack_from("<f", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_double(self) -> float:
        v = struct.unpack_from("<d", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def read_bytes(self) -> bytes:
        n = self.read_long()
        if n < 0 or self.pos + n > len(self.buf):
            # corrupt length: a negative n would move pos BACKWARD (an
            # infinite-loop hazard for callers iterating the buffer)
            raise ValueError(f"invalid byte-string length {n} at "
                             f"position {self.pos}")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.buf)


# ---------------------------------------------------------------------------
# Schema dispatch
# ---------------------------------------------------------------------------


def _schema_type(schema: Any) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def _union_branch(schema: list, datum: Any, names: dict) -> int:
    """Pick the union branch for a datum (null-vs-value covers the reference
    schemas; beyond that, match by python type / record fields)."""
    for i, s in enumerate(schema):
        if isinstance(s, str) and s not in PRIMITIVES:
            s = names.get(s, s)  # resolve named-type reference
        t = _schema_type(s)
        if datum is None and t == "null":
            return i
        if datum is not None and t != "null":
            if t == "string" and isinstance(datum, str):
                return i
            if t in ("int", "long") and isinstance(datum, int) \
                    and not isinstance(datum, bool):
                return i
            if t in ("float", "double") and isinstance(datum, (int, float)) \
                    and not isinstance(datum, bool):
                return i
            if t == "boolean" and isinstance(datum, bool):
                return i
            if t == "bytes" and isinstance(datum, bytes):
                return i
            if t in ("record", "map") and isinstance(datum, dict):
                return i
            if t == "array" and isinstance(datum, (list, tuple)):
                return i
            if t == "enum" and isinstance(datum, str):
                return i
    # fallback: first non-null branch for non-null datum
    for i, s in enumerate(schema):
        if _schema_type(s if not isinstance(s, str) else s) != "null":
            if datum is not None:
                return i
    return 0


# ---------------------------------------------------------------------------
# Compiled readers: resolve the schema ONCE into a tree of closures
# ---------------------------------------------------------------------------


def compile_reader(schema: Any, names: dict) -> Any:
    """Schema → specialized decode closure tree.

    The dispatch on the schema node is made once per file, not once per
    datum (the millions of fields of an ingestion-scale file). Named-type
    references resolve late through the memo so self/forward references
    (e.g. FeatureAvro used before its inline definition is reached in
    traversal order) work.
    """
    memo: dict[str, Any] = {}

    def build(s):
        if isinstance(s, str) and s not in PRIMITIVES:
            name = s

            # reference memo lives under "ref:" so an inline record whose
            # FULLNAME equals this short name can never shadow the
            # names-table resolution
            def named(dec, _n=name):
                r = memo.get("ref:" + _n)
                if r is None:
                    r = build(names[_n])
                    memo["ref:" + _n] = r
                return r(dec)

            return named
        t = _schema_type(s)
        if t == "null":
            return lambda dec: None
        if t == "boolean":
            return BinaryDecoder.read_boolean
        if t in ("int", "long"):
            return BinaryDecoder.read_long
        if t == "float":
            return BinaryDecoder.read_float
        if t == "double":
            return BinaryDecoder.read_double
        if t == "bytes":
            return BinaryDecoder.read_bytes
        if t == "string":
            return BinaryDecoder.read_string
        if t == "union":
            branches = s  # _schema_type says "union" only for list nodes
            readers = tuple(build(b) for b in branches)

            def r_union(dec):
                return readers[dec.read_long()](dec)

            return r_union
        if t == "record":
            # memo key = namespace-qualified fullname: two inline records
            # sharing a short name across namespaces are DIFFERENT types
            # (short-name references still resolve through `names`)
            nm = s.get("name")
            ns = s.get("namespace")
            full = (f"{ns}.{nm}" if ns and nm and "." not in nm else nm)
            if full and full in memo:
                return memo[full]
            if full:
                # placeholder for self-references while fields build
                def forward(dec, _n=full):
                    return memo[_n](dec)

                memo[full] = forward
            field_readers = tuple((f["name"], build(f["type"]))
                                  for f in s["fields"])

            def r_record(dec):
                return {n: rd(dec) for n, rd in field_readers}

            if full:
                memo[full] = r_record
            return r_record
        if t == "array":
            item = build(s["items"])

            def r_array(dec):
                out = []
                append = out.append
                while True:
                    count = dec.read_long()
                    if count == 0:
                        break
                    if count < 0:
                        dec.read_long()
                        count = -count
                    for _ in range(count):
                        append(item(dec))
                return out

            return r_array
        if t == "map":
            value = build(s["values"])

            def r_map(dec):
                out = {}
                while True:
                    count = dec.read_long()
                    if count == 0:
                        break
                    if count < 0:
                        dec.read_long()
                        count = -count
                    for _ in range(count):
                        # explicit ordering: Python evaluates the RHS of a
                        # subscript assignment BEFORE the key expression
                        k = dec.read_string()
                        out[k] = value(dec)
                return out

            return r_map
        if t == "enum":
            symbols = tuple(s["symbols"])
            return lambda dec: symbols[dec.read_long()]
        if t == "fixed":
            size = s["size"]

            def r_fixed(dec):
                v = dec.buf[dec.pos:dec.pos + size]
                dec.pos += size
                return v

            return r_fixed
        raise ValueError(f"unsupported schema type {t!r}")

    return build(schema)


def compile_writer(schema: Any, names: dict) -> Any:
    """Schema → specialized encode closure tree (write-side analog of
    :func:`compile_reader`; used by ``write_container`` so score/model
    output files aren't bottlenecked on per-datum schema dispatch)."""
    memo: dict[str, Any] = {}

    def build(s):
        if isinstance(s, str) and s not in PRIMITIVES:
            name = s

            def named(enc, datum, _n=name):
                w = memo.get("ref:" + _n)
                if w is None:
                    w = build(names[_n])
                    memo["ref:" + _n] = w
                return w(enc, datum)

            return named
        t = _schema_type(s)
        if t == "null":
            return lambda enc, datum: None
        if t == "boolean":
            return lambda enc, datum: enc.write_boolean(bool(datum))
        if t in ("int", "long"):
            return lambda enc, datum: enc.write_long(int(datum))
        if t == "float":
            return lambda enc, datum: enc.write_float(float(datum))
        if t == "double":
            return lambda enc, datum: enc.write_double(float(datum))
        if t == "bytes":
            return lambda enc, datum: enc.write_bytes(bytes(datum))
        if t == "string":
            return lambda enc, datum: enc.write_string(str(datum))
        if t == "union":
            branches = s  # _schema_type says "union" only for list nodes
            writers = tuple(build(b) for b in branches)
            kinds = [_schema_type(names.get(b, b) if isinstance(b, str)
                                  else b) for b in branches]
            if len(branches) == 2 and kinds.count("null") == 1:
                # the reference schemas' dominant shape: [null, X] — skip
                # the per-datum type-matching walk entirely
                ni = kinds.index("null")
                oi = 1 - ni

                def w_union2(enc, datum):
                    if datum is None:
                        enc.write_long(ni)
                    else:
                        enc.write_long(oi)
                        writers[oi](enc, datum)

                return w_union2

            def w_union(enc, datum):
                i = _union_branch(branches, datum, names)
                enc.write_long(i)
                writers[i](enc, datum)

            return w_union
        if t == "record":
            nm = s.get("name")
            ns = s.get("namespace")
            full = (f"{ns}.{nm}" if ns and nm and "." not in nm else nm)
            if full and full in memo:
                return memo[full]
            if full:
                def forward(enc, datum, _n=full):
                    return memo[_n](enc, datum)

                memo[full] = forward
            field_writers = tuple(
                (f["name"], f.get("default"), "default" in f,
                 build(f["type"]))
                for f in s["fields"])

            def w_record(enc, datum):
                for name, default, has_default, wr in field_writers:
                    if name in datum:
                        wr(enc, datum[name])
                    elif has_default:
                        wr(enc, default)
                    else:
                        raise ValueError(
                            f"missing field {name!r} with no default")

            if full:
                memo[full] = w_record
            return w_record
        if t == "array":
            item = build(s["items"])

            def w_array(enc, datum):
                items = list(datum)
                if items:
                    enc.write_long(len(items))
                    for x in items:
                        item(enc, x)
                enc.write_long(0)

            return w_array
        if t == "map":
            value = build(s["values"])

            def w_map(enc, datum):
                if datum:
                    enc.write_long(len(datum))
                    for k, v in datum.items():
                        enc.write_string(str(k))
                        value(enc, v)
                enc.write_long(0)

            return w_map
        if t == "enum":
            index_of = {sym: i for i, sym in enumerate(s["symbols"])}
            return lambda enc, datum: enc.write_long(index_of[datum])
        if t == "fixed":
            return lambda enc, datum: enc.out.write(bytes(datum))
        raise ValueError(f"unsupported schema type {t!r}")

    return build(schema)


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------


def write_container_header(fh, schema: Any, codec: str,
                           sync: bytes) -> None:
    """Container file header: MAGIC + meta map (schema JSON, codec) +
    sync marker — THE framing definition shared by every writer."""
    fh.write(MAGIC)
    header = io.BytesIO()
    enc = BinaryEncoder(header)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    enc.write_long(len(meta))
    for k, v in meta.items():
        enc.write_string(k)
        enc.write_bytes(v)
    enc.write_long(0)
    fh.write(header.getvalue())
    fh.write(sync)


def write_container(path: str, schema: Any, records: Iterable[dict],
                    codec: str = "deflate",
                    sync_interval: int = DEFAULT_SYNC_INTERVAL) -> None:
    """Write an Avro object container file (spec: header + data blocks)."""
    schema = parse_schema(schema)
    names = _names_index(schema)
    writer = compile_writer(schema, names)
    sync = os.urandom(SYNC_SIZE)

    with open(path, "wb") as fh:
        write_container_header(fh, schema, codec, sync)

        block = io.BytesIO()
        benc = BinaryEncoder(block)
        count = 0

        def flush():
            nonlocal block, benc, count
            if count == 0:
                return
            raw = block.getvalue()
            if codec == "deflate":
                raw = zlib.compress(raw)[2:-1]  # raw deflate, no zlib header
            head = io.BytesIO()
            henc = BinaryEncoder(head)
            henc.write_long(count)
            henc.write_long(len(raw))
            fh.write(head.getvalue())
            fh.write(raw)
            fh.write(sync)
            block = io.BytesIO()
            benc = BinaryEncoder(block)
            count = 0

        for rec in records:
            writer(benc, rec)
            count += 1
            if count >= sync_interval:
                flush()
        flush()


def read_container(path: str) -> tuple[Any, list[Any]]:
    """Read an Avro object container file → (schema, records)."""
    fault_point("io.shard_open", tag=os.path.basename(path))
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    dec = BinaryDecoder(buf, 4)
    meta = {}
    while True:
        count = dec.read_long()
        if count == 0:
            break
        if count < 0:
            dec.read_long()
            count = -count
        for _ in range(count):
            k = dec.read_string()
            v = dec.read_bytes()
            meta[k] = v
    schema = parse_schema(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    names = _names_index(schema)
    reader = compile_reader(schema, names)
    sync = buf[dec.pos:dec.pos + SYNC_SIZE]
    dec.pos += SYNC_SIZE

    records: list[Any] = []
    append = records.append
    while dec.pos < len(buf):
        count = dec.read_long()
        size = dec.read_long()
        # Corrupt varints must raise, never mis-frame: a negative size
        # would walk dec.pos BACKWARDS (non-terminating loop), a size past
        # EOF would silently clamp the payload slice, and a negative count
        # would silently skip the block (the decode contract of
        # avro/AvroUtils.scala:54 — clean raise, never wrong data).
        if count < 0 or size < 0 or dec.pos + size > len(buf):
            raise ValueError(
                f"{path}: corrupt block header (count={count}, "
                f"size={size}, {len(buf) - dec.pos} bytes left)")
        data = buf[dec.pos:dec.pos + size]
        dec.pos += size
        if codec == "deflate":
            try:
                data = zlib.decompress(data, -15)
            except zlib.error as e:
                # corruption is ONE exception type (ValueError) to every
                # consumer — the shard-quarantine layer dispatches on it
                raise ValueError(
                    f"{path}: corrupt deflate block: {e}") from e
        elif codec != "null":
            raise ValueError(f"unsupported codec {codec!r}")
        if count > len(data) and count > 1_000_000:
            # every record decodes >= 0 bytes, so for non-degenerate
            # schemas count can't exceed the DECOMPRESSED payload size;
            # the extra million-record allowance keeps legal
            # zero-byte-record containers readable while a hostile 2^61
            # count can no longer spin the decode loop into an OOM
            raise ValueError(
                f"{path}: implausible block count {count} for "
                f"{len(data)}-byte payload")
        bdec = BinaryDecoder(data)
        try:
            for _ in range(count):
                append(reader(bdec))
        except (IndexError, struct.error, UnicodeDecodeError,
                KeyError) as e:
            # flipped bytes inside a null-codec block surface as varint/
            # utf-8/overrun errors mid-record: normalize to the one
            # corruption exception type
            raise ValueError(
                f"{path}: corrupt record data in block: {e!r}") from e
        if bdec.pos != len(data):
            raise ValueError(
                f"{path}: block decoded {bdec.pos} of {len(data)} bytes "
                f"for {count} records (corrupt count or payload)")
        if buf[dec.pos:dec.pos + SYNC_SIZE] != sync:
            # a plain raise, not an assert: -O must not disable framing
            # validation
            raise ValueError(f"{path}: sync marker mismatch (corrupt block)")
        dec.pos += SYNC_SIZE
    return schema, records


def check_container_framing(path: str) -> None:
    """Validate a container's FRAME structure — magic, header metadata,
    block varints, payload bounds, deflate integrity, sync markers —
    without decoding a single record. Raises the same
    ``ValueError``/``OSError`` taxonomy as :func:`read_container` on a
    corrupt/truncated file and returns None on a well-framed one.

    This is the cheap corrupt-vs-unsupported probe of degraded ingest on
    the native path: when the native decoder declines a shard, framing
    errors mean quarantine (the shard is damaged), while a well-framed
    shard means the schema is outside the decoder's subset (the input
    goes to the records reader, which also owns the rare
    frames-ok-but-corrupt-record-bytes case)."""
    fault_point("io.shard_open", tag=os.path.basename(path))
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    dec = BinaryDecoder(buf, 4)
    meta = {}
    try:
        while True:
            count = dec.read_long()
            if count == 0:
                break
            if count < 0:
                dec.read_long()
                count = -count
            for _ in range(count):
                k = dec.read_string()
                meta[k] = dec.read_bytes()
        parse_schema(meta["avro.schema"].decode())
    except (IndexError, KeyError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: corrupt container header: {e!r}") from e
    codec = meta.get("avro.codec", b"null").decode()
    if dec.pos + SYNC_SIZE > len(buf):
        raise ValueError(f"{path}: truncated before sync marker")
    sync = buf[dec.pos:dec.pos + SYNC_SIZE]
    dec.pos += SYNC_SIZE
    while dec.pos < len(buf):
        try:
            count = dec.read_long()
            size = dec.read_long()
        except IndexError as e:
            raise ValueError(
                f"{path}: truncated block header") from e
        if count < 0 or size < 0 or dec.pos + size > len(buf):
            raise ValueError(
                f"{path}: corrupt block header (count={count}, "
                f"size={size}, {len(buf) - dec.pos} bytes left)")
        if codec == "deflate":
            try:
                zlib.decompress(buf[dec.pos:dec.pos + size], -15)
            except zlib.error as e:
                raise ValueError(
                    f"{path}: corrupt deflate block: {e}") from e
        dec.pos += size
        if buf[dec.pos:dec.pos + SYNC_SIZE] != sync:
            raise ValueError(
                f"{path}: sync marker mismatch (corrupt block)")
        dec.pos += SYNC_SIZE


def read_shard(path: str, policy=None):
    """One part file under the degraded-ingest protocol: ``io.avro_read``
    fires per attempt (``corrupt``/``partial`` mutate the shard on disk),
    transient failures retry, and a shard that stays unreadable or decodes
    corrupt (``ValueError``, not retried) is quarantined through
    ``policy`` and ``None`` returned; without a policy the error
    raises."""
    def attempt():
        fault_point("io.avro_read", tag=os.path.basename(path), path=path)
        return read_container(path)

    try:
        result = call_with_retry(attempt, site="io.avro_read")
    except (RetryExhaustedError, ValueError, FileNotFoundError) as e:
        if policy is None:
            raise
        policy.quarantine(path, stage=("decode" if isinstance(e, ValueError)
                                       else "open"), error=e)
        return None
    if policy is not None:
        policy.record_ok(path)
    return result


def read_records(path: str) -> list[Any]:
    """Records from a container file or a directory of part files —
    whichever ``path`` is."""
    if os.path.isdir(path):
        return read_directory(path)[1]
    return read_shard(path)[1]


def list_avro_parts(path: str) -> list[str]:
    """The ``*.avro`` part files of a directory, sorted — THE definition of
    which files a partitioned layout contains (every reader, interpreted or
    columnar, must share it or they can load different datasets)."""
    return [os.path.join(path, name) for name in sorted(os.listdir(path))
            if name.endswith(".avro")]


def expand_part_paths(paths) -> list[str]:
    """File-or-directory inputs → sorted list of avro part files — THE
    shared expansion for every caller that splits work by part file (the
    multi-process drivers must all agree on the file set)."""
    out: list[str] = []
    for p in sorted(paths):
        if os.path.isdir(p):
            out.extend(list_avro_parts(p))
        else:
            out.append(p)
    return sorted(out)


def read_directory(path: str) -> tuple[Any, list[Any]]:
    """Read all ``*.avro`` files under a directory (the reference's
    partitioned-output layout: part-*.avro shards)."""
    schema = None
    records: list[Any] = []
    for part in list_avro_parts(path):
        s, recs = read_shard(part)
        schema = schema or s
        records.extend(recs)
    return schema, records
