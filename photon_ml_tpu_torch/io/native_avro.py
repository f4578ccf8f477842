"""Columnar Avro ingestion through the port's native decoder.

Port of ``photon_ml_tpu/io/native_avro.py``: the opcodes,
``compile_program`` (``:85``), ``_bind`` (``:155``), ``_read_blocks``
(``:172``, with its ``io.shard_open`` fault point), ``read_columnar``
(``:238``) and ``arena_strings`` (``:361``). A supported record schema is
compiled into the flat field "program" that ``csrc/host/avro_columnar.cpp``
executes over the concatenated decompressed block bytes, and numpy
columns come back — no per-record Python dicts. Covered: a top-level
record whose fields are primitives, ``[null, primitive]`` unions,
``map<string,string>``, ``array<record-of-primitives>``
(FeatureAvro / NameTermValueAvro) or ``array<primitive>``. For anything
else, and for a container whose framing does not check out,
``read_columnar`` returns None and the caller reads the input through
the records path (``io/avro.py``), as the JAX package does.

Returned columns per field:

- scalar: ``{"values": f64[n], "nulls": u8[n]}``
- string: ``{"arena": u8[...], "offsets": u32[n+1], "nulls": u8[n]}``
- map<string,string>: ``{"lengths": i32[n], "key_codes": i32[total],
  "key_uniq": str[...], "val_codes", "val_uniq"}``
- array<record>: ``{"lengths": i32[n], "subs": {subfield:
  {"values"} or {"codes": i32[total], "uniq": str[...]}}}``
- array<primitive>: ``{"lengths": i32[n], "values": f64[total]}``

Strings inside maps and feature arrays come back interned: per-entry
int32 codes plus a unique-string table decoded once.

The library is built on first use by ``io/native_loader.py``; a build
failure raises there, it never turns into a decline.
"""

from __future__ import annotations

import ctypes
import os
import zlib
from typing import Any, Optional

import numpy as np

from photon_ml_tpu_torch.io.avro import (
    MAGIC,
    PRIMITIVES,
    SYNC_SIZE,
    BinaryDecoder,
    _names_index,
    _schema_type,
    parse_schema,
)
from photon_ml_tpu_torch.io.native_loader import get_host_lib
from photon_ml_tpu_torch.utils.faults import fault_point

OP_LONG, OP_FLOAT, OP_DOUBLE, OP_BOOL, OP_STRING, OP_NULL = 1, 2, 3, 4, 5, 6
OP_MAP_SS, OP_ARR_REC, OP_ARR_DOUBLE = 7, 8, 9
OP_ARR_FLOAT, OP_ARR_LONG, OP_BYTES_SKIP, OP_ENUM = 10, 11, 12, 13
OP_UNION_PRIM = 14

_SCALAR_OPS = {"int": OP_LONG, "long": OP_LONG, "float": OP_FLOAT,
               "double": OP_DOUBLE, "boolean": OP_BOOL, "string": OP_STRING,
               "null": OP_NULL, "bytes": OP_BYTES_SKIP}
_ARR_PRIM = {"double": OP_ARR_DOUBLE, "float": OP_ARR_FLOAT,
             "int": OP_ARR_LONG, "long": OP_ARR_LONG}

_bound: Optional[ctypes.CDLL] = None


def _resolve(s, names):
    if isinstance(s, str) and s not in PRIMITIVES:
        return names[s]
    return s


def _nullable_of(s, names):
    """union [null, X] (either order) → (X, null_branch); else (s, -1)."""
    if isinstance(s, list):
        if len(s) != 2:
            return None
        kinds = [_schema_type(_resolve(b, names)) for b in s]
        if kinds.count("null") != 1:
            return None
        ni = kinds.index("null")
        return s[1 - ni], ni
    return s, -1


def compile_program(schema: Any, names: dict) -> Optional[tuple]:
    """Schema → (program int64 array, field descriptors) or None when the
    shape is outside the decoder's subset."""
    schema = _resolve(parse_schema(schema), names)
    if _schema_type(schema) != "record":
        return None
    prog: list[int] = [len(schema["fields"])]
    descs = []
    for f in schema["fields"]:
        nb = _nullable_of(f["type"], names)
        if nb is None:
            # multi-branch union: supported when every branch is a scalar
            # primitive (the branch-tagged OP_UNION_PRIM path, e.g. the
            # yahoo fixture's response union)
            branches = f["type"]
            if not isinstance(branches, list):
                return None
            bops = []
            for b in branches:
                bt = _schema_type(_resolve(b, names))
                if bt not in _SCALAR_OPS or bt == "bytes":
                    return None
                bops.append(_SCALAR_OPS[bt])
            prog.extend([OP_UNION_PRIM, -1, len(bops)])
            for bop in bops:
                prog.extend([bop, -1])
            descs.append((f["name"], OP_UNION_PRIM, [], []))
            continue
        inner, null_branch = nb
        inner = _resolve(inner, names)
        t = _schema_type(inner)
        subs: list[tuple[str, int]] = []
        if t in _SCALAR_OPS:
            op = _SCALAR_OPS[t]
        elif t == "enum":
            op = OP_ENUM
        elif t == "map":
            v = _resolve(inner["values"], names)
            if _schema_type(v) != "string":
                return None
            op = OP_MAP_SS
        elif t == "array":
            item = _resolve(inner["items"], names)
            it = _schema_type(item)
            if it in _ARR_PRIM:
                op = _ARR_PRIM[it]
            elif it == "record":
                op = OP_ARR_REC
                for sf in item["fields"]:
                    snb = _nullable_of(sf["type"], names)
                    if snb is None:
                        return None
                    sinner, s_null = snb
                    sinner = _resolve(sinner, names)
                    st = _schema_type(sinner)
                    if st not in _SCALAR_OPS:
                        return None
                    subs.append((sf["name"], _SCALAR_OPS[st], s_null))
            else:
                return None
        else:
            return None
        prog.extend([op, null_branch, len(subs)])
        for _, sop, s_null in subs:
            prog.extend([sop, s_null])
        descs.append((f["name"], op, [s[0] for s in subs],
                      [s[1] for s in subs]))
    return np.asarray(prog, dtype=np.int64), descs


def _bind(lib) -> None:
    global _bound
    if _bound is lib:
        return
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.photon_avro_count.restype = ctypes.c_int
    lib.photon_avro_count.argtypes = [
        u8, ctypes.c_int64, ctypes.c_int64, i64, ctypes.c_int64,
        ctypes.c_int64, i64]
    lib.photon_avro_fill.restype = ctypes.c_int
    lib.photon_avro_fill.argtypes = [
        u8, ctypes.c_int64, ctypes.c_int64, i64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)]
    _bound = lib


def _read_blocks(path: str) -> Optional[tuple]:
    """Container header walk → (schema, concatenated block bytes, count).

    Any truncation (header metadata, block varints, payload) declines
    with None; the records reader raises the diagnostic."""
    # the records reader's open site: both decode paths meet the same
    # injected open failures
    fault_point("io.shard_open", tag=os.path.basename(path))
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != MAGIC:
        return None
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
        schema = parse_schema(meta["avro.schema"].decode())
        codec = meta.get("avro.codec", b"null").decode()
    except (IndexError, KeyError, ValueError, UnicodeDecodeError):
        # truncated or corrupt header (bad varint/length/utf-8/schema
        # json): decline the fast path
        return None
    if codec not in ("null", "deflate"):
        return None
    if dec.pos + SYNC_SIZE > len(buf):
        return None
    sync = buf[dec.pos:dec.pos + SYNC_SIZE]
    dec.pos += SYNC_SIZE
    chunks = []
    total = 0
    while dec.pos < len(buf):
        try:
            count = dec.read_long()
            size = dec.read_long()
        except IndexError:
            # truncated mid-varint: decline the fast path
            return None
        # validate like the records reader's read_container: a truncated
        # or corrupted file must decline, not silently mis-decode
        if count < 0 or size < 0 or dec.pos + size + SYNC_SIZE > len(buf):
            return None
        data = buf[dec.pos:dec.pos + size]
        if buf[dec.pos + size:dec.pos + size + SYNC_SIZE] != sync:
            return None
        dec.pos += size + SYNC_SIZE
        if codec == "deflate":
            try:
                data = zlib.decompress(data, -15)
            except zlib.error:
                # corrupt payload: decline; the records reader raises
                # the real diagnostic
                return None
        chunks.append(data)
        total += count
    return schema, b"".join(chunks), total


def read_columnar(path: str) -> Optional[tuple[Any, int, dict]]:
    """(schema, n_records, columns) via the native decoder, or None when
    the schema, the codec or the framing is outside the decoder's subset
    (the caller reads the input through the records path)."""
    lib = get_host_lib()
    header = _read_blocks(path)
    if header is None:
        return None
    schema, data, n = header
    names = _names_index(schema)
    compiled = compile_program(schema, names)
    if compiled is None:
        return None
    prog, descs = compiled
    _bind(lib)
    max_subs = max(max((len(d[2]) for d in descs), default=0), 1)
    data_arr = np.frombuffer(data, dtype=np.uint8)
    if data_arr.size == 0:
        data_arr = np.zeros(1, np.uint8)

    sstride = 7 + 2 * max_subs
    sizes = np.zeros(len(descs) * sstride, np.int64)
    rc = lib.photon_avro_count(data_arr, len(data), n, prog, len(prog),
                               max_subs, sizes)
    if rc == 1:
        # data the program can't walk (e.g. a non-numeric string in a
        # scalar union the records path keeps as a str): decline
        return None
    if rc != 0:
        raise ValueError(f"native avro count failed rc={rc} for {path!r}")

    columns: dict[str, dict] = {}
    pstride = 9 + 4 * max_subs
    ptrs = (ctypes.c_void_p * (len(descs) * pstride))()

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    scratch = []  # backing arrays that outlive the fill call
    for i, (name, op, sub_names, sub_ops) in enumerate(descs):
        row = sizes[i * sstride:(i + 1) * sstride]
        col: dict[str, Any] = {"op": op}
        base = i * pstride
        if op in (OP_LONG, OP_FLOAT, OP_DOUBLE, OP_BOOL, OP_ENUM,
                  OP_UNION_PRIM):
            col["values"] = np.zeros(n, np.float64)
            col["nulls"] = np.zeros(n, np.uint8)
            ptrs[base + 0] = vp(col["values"])
            ptrs[base + 1] = vp(col["nulls"])
        elif op == OP_STRING:
            col["arena"] = np.zeros(max(int(row[1]), 1), np.uint8)
            col["offsets"] = np.zeros(n + 1, np.uint32)
            col["nulls"] = np.zeros(n, np.uint8)
            ptrs[base + 1] = vp(col["nulls"])
            ptrs[base + 2] = vp(col["arena"])
            ptrs[base + 3] = vp(col["offsets"])
        elif op == OP_MAP_SS:
            total = int(row[0])
            col["lengths"] = np.zeros(n, np.int32)
            col["key_codes"] = np.zeros(total, np.int32)
            col["val_codes"] = np.zeros(total, np.int32)
            k_arena = np.zeros(max(int(row[3]), 1), np.uint8)
            k_offs = np.zeros(int(row[2]) + 1, np.uint32)
            v_arena = np.zeros(max(int(row[5]), 1), np.uint8)
            v_offs = np.zeros(int(row[4]) + 1, np.uint32)
            scratch.append((k_arena, k_offs, v_arena, v_offs))
            col["_key_table"] = (k_arena, k_offs)
            col["_val_table"] = (v_arena, v_offs)
            ptrs[base + 4] = vp(col["lengths"])
            ptrs[base + 5] = vp(col["key_codes"])
            ptrs[base + 6] = vp(k_arena)
            ptrs[base + 7] = vp(k_offs)
            ptrs[base + 8] = vp(col["val_codes"])
            ptrs[base + 9] = vp(v_arena)
            ptrs[base + 10] = vp(v_offs)
        elif op in (OP_ARR_DOUBLE, OP_ARR_FLOAT, OP_ARR_LONG):
            total = int(row[0])
            col["lengths"] = np.zeros(n, np.int32)
            col["values"] = np.zeros(total, np.float64)
            ptrs[base + 0] = vp(col["values"])
            ptrs[base + 4] = vp(col["lengths"])
        elif op == OP_ARR_REC:
            total = int(row[0])
            col["lengths"] = np.zeros(n, np.int32)
            ptrs[base + 4] = vp(col["lengths"])
            subs: dict[str, dict] = {}
            for s, sname in enumerate(sub_names):
                sub: dict[str, Any] = {"op": sub_ops[s]}
                nuniq = int(row[7 + 2 * s])
                ubytes = int(row[7 + 2 * s + 1])
                sub["values"] = np.zeros(total, np.float64)
                sub["codes"] = np.zeros(total, np.int32)
                u_arena = np.zeros(max(ubytes, 1), np.uint8)
                u_offs = np.zeros(nuniq + 1, np.uint32)
                scratch.append((u_arena, u_offs))
                sub["_uniq_table"] = (u_arena, u_offs)
                sbase = base + 9 + 4 * s
                ptrs[sbase + 0] = vp(sub["values"])
                ptrs[sbase + 1] = vp(sub["codes"])
                ptrs[sbase + 2] = vp(u_arena)
                ptrs[sbase + 3] = vp(u_offs)
                subs[sname] = sub
            col["subs"] = subs
        columns[name] = col

    rc = lib.photon_avro_fill(data_arr, len(data), n, prog, len(prog),
                              max_subs, ptrs)
    if rc != 0:
        raise ValueError(f"native avro fill failed rc={rc} for {path!r}")

    # decode unique tables ONCE (a few thousand strings, not per-entry)
    for name, col in columns.items():
        if "_key_table" in col:
            col["key_uniq"] = arena_strings(*col.pop("_key_table"))
            col["val_uniq"] = arena_strings(*col.pop("_val_table"))
        for sub in col.get("subs", {}).values():
            if "_uniq_table" in sub:
                sub["uniq"] = arena_strings(*sub.pop("_uniq_table"))
    return schema, n, columns


def arena_strings(arena: np.ndarray, offsets: np.ndarray,
                  dedup: bool = True) -> np.ndarray:
    """Offsets+arena → object array of python strings.

    ``dedup`` caches decoded runs (unique tables and repeated values);
    pass False for near-unique columns like uids, where a one-entry-per-
    row cache is pure overhead."""
    n = len(offsets) - 1
    if n <= 0:
        return np.zeros(0, dtype=object)
    b = arena.tobytes()
    lengths = np.diff(offsets.astype(np.int64))
    out = np.empty(n, dtype=object)
    pos = 0
    if not dedup:
        for i in range(n):
            ln = int(lengths[i])
            out[i] = b[pos:pos + ln].decode("utf-8")
            pos += ln
        return out
    cache: dict[bytes, str] = {}
    for i in range(n):
        ln = int(lengths[i])
        raw = b[pos:pos + ln]
        pos += ln
        s = cache.get(raw)
        if s is None:
            s = raw.decode("utf-8")
            cache[raw] = s
        out[i] = s
    return out
