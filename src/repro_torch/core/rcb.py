"""Runtime Control Blocks — the paper's "Control as Data" representation.

An RCB is *not* executable code: it is a binary data structure holding a
linear sequence of low-level operations (register-write analogues, DMA
triggers, compute dispatches, fences) that encode the complete execution
semantics of an ML workload. A generic engine (core/executor.py) runs RCBs
through the RHAL vtable without knowing anything about the model.

Faithfulness to the paper:
  * RCBs are hardware-independent; tensor references are *symbolic* IDs
    resolved by the Runtime Binding Layer at load time (never raw pointers).
  * Each RCB has a Header (type / size / dependency info) and an Operation
    Payload (structured op sequence).
  * RCBs serialize to a flat binary format with CRC-32 integrity (the same
    IEEE 0x04C11DB7 polynomial the paper uses on its network messages), so
    a model really is provisioned as *data* over the wire.

TPU adaptation (see DESIGN.md §2): the op vocabulary is re-based on the XLA
execution model — buffer ops, fused-compute dispatches and collectives
replace AIE CSR writes — while the encoding stays linear and symbolic.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import struct
import zlib
from typing import Any, Iterable, Optional

MAGIC = b"RCB1"
MAGIC_V2 = b"RCB2"
PROG_MAGIC = b"AEGP"
PROG_VERSION = 2          # current wire version; v1 decode kept for compat


class Op(enum.IntEnum):
    """Operation vocabulary (linear, hardware-agnostic)."""
    NOP = 0
    # --- buffer table / "register" ops ------------------------------------
    ALLOC = 1            # dst, attrs: shape,dtype — scratch allocation
    FREE = 2             # dst
    BIND_CONST = 3       # dst, attrs: value — small immediate constant
    # --- DMA ops (RHAL initiate_dma/wait_dma) ------------------------------
    DMA_H2D = 10         # dst, src(file id in RIMFS)
    DMA_D2H = 11         # dst(host id), src
    DMA_D2D = 12         # dst, src
    # --- compute dispatches (RHAL dispatch_compute) ------------------------
    GEMM = 20            # dst, a, b, attrs: transpose flags, acc dtype
    CONV2D = 21          # dst, x, w, attrs: stride, padding
    DENSE = 22           # dst, x, w, b?
    ADD = 23             # dst, a, b
    RELU = 24            # dst, x
    SOFTMAX = 25         # dst, x
    MAXPOOL = 26         # dst, x, attrs: window, stride, padding
    AVGPOOL_GLOBAL = 27  # dst, x
    SCALE_SHIFT = 28     # dst, x, scale, shift  (folded batchnorm)
    QUANTIZE = 29        # dst, x, attrs: scale (fp -> int8)
    DEQUANT = 30         # dst, x, attrs: scale (int32/int8 -> fp)
    RESHAPE = 31         # dst, x, attrs: shape
    GEMM_I8 = 32         # dst, a(int8), b(int8) -> int32 accum
    CONV2D_I8 = 33       # dst, x(int8), w(int8), attrs -> int32 accum
    PASSTHROUGH = 34     # dst, x — identity (paper's transfer microbenchmark)
    SCALE_SHIFT_RELU = 35  # dst, x, scale, shift — fused (core/opt.py F1)
    ADD_RELU = 36        # dst, a, b — fused (core/opt.py F2)
    # --- LM block glue (per-layer RCTC lowering, DESIGN.md §13) -------------
    RMSNORM = 37         # dst, x, w, attrs: eps
    ROPE = 38            # dst, x(B,S,H,D), positions(B,S), attrs: theta
    SILU_MUL = 39        # dst, gate, x — silu(gate) * x (swiglu / z-gate)
    # --- graph artifacts (compiled ADF-graph analogue) ----------------------
    GRAPH_EXEC = 40      # dsts, srcs, attrs: artifact id (jitted step fn)
    # --- linked kernel dispatches (kernels/registry.py handlers) ------------
    ATTENTION = 41       # dst, q, k, v, attrs: causal, impl
    MATMUL_INT8 = 42     # dst, x(int8), w(int8), scale, attrs: out_dtype
    SSM_SCAN = 43        # dst, da, bx, c, attrs: impl
    WKV6 = 44            # dst, r, k, v, lw, u, attrs: impl
    # --- distribution -------------------------------------------------------
    COLLECTIVE = 50      # dst, src, attrs: kind, axis
    # --- synchronization (RHAL fence/poll) ----------------------------------
    FENCE = 60           #
    POLL = 61            # src, attrs: expected completion flag
    HALT = 62            #


@dataclasses.dataclass(frozen=True)
class RCBOp:
    op: Op
    dsts: tuple = ()          # symbolic tensor ids (str)
    srcs: tuple = ()
    attrs: dict = dataclasses.field(default_factory=dict)

    def encode(self) -> bytes:
        meta = json.dumps(
            {"d": list(self.dsts), "s": list(self.srcs), "a": self.attrs},
            separators=(",", ":")).encode()
        return struct.pack("<HI", int(self.op), len(meta)) + meta

    @staticmethod
    def decode(buf: memoryview, off: int) -> tuple["RCBOp", int]:
        op, n = struct.unpack_from("<HI", buf, off)
        off += 6
        meta = json.loads(bytes(buf[off:off + n]).decode())
        off += n
        return RCBOp(Op(op), tuple(meta["d"]), tuple(meta["s"]),
                     meta["a"]), off


@dataclasses.dataclass(frozen=True)
class TensorDesc:
    """Symbol-table entry: logical tensor -> physical requirements.

    ``kind``: weight (RIMFS-backed) | input | output | scratch.
    ``axes``: logical axis names consumed by RBL's sharding resolution.
    """
    name: str
    shape: tuple
    dtype: str
    kind: str
    axes: tuple = ()

    def encode(self) -> bytes:
        meta = json.dumps({"n": self.name, "sh": list(self.shape),
                           "dt": self.dtype, "k": self.kind,
                           "ax": list(self.axes)},
                          separators=(",", ":")).encode()
        return struct.pack("<I", len(meta)) + meta

    @staticmethod
    def decode(buf: memoryview, off: int) -> tuple["TensorDesc", int]:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        m = json.loads(bytes(buf[off:off + n]).decode())
        off += n
        return TensorDesc(m["n"], tuple(m["sh"]), m["dt"], m["k"],
                          tuple(m["ax"] or ())), off


# ---------------------------------------------------------------------------
# Binary-v2 encoding: interned symbol table + packed op records.
#
# v1 serializes per-op metadata as JSON — a per-op parse cost on every load.
# v2 (DESIGN.md §3) interns every string once in a program-level symbol
# table; ops, tensor descriptors and attrs then reference u32 indices and
# pack through fixed structs, so decode is pure struct unpacking.  CRC-32
# integrity is unchanged: per-block CRCs plus a whole-program CRC (which
# covers the symbol table, so a corrupted symtab is rejected before parse).
# ---------------------------------------------------------------------------

_ST_OP2 = struct.Struct("<HBBI")        # opcode, n_dsts, n_srcs, attr_idx
_ST_U32 = struct.Struct("<I")
_ST_U16 = struct.Struct("<H")
_ST_F64 = struct.Struct("<d")
_ST_BLK2 = struct.Struct("<4sIIHI")     # magic, block_id, plen, n_ops, type
_ST_PROG = struct.Struct("<4sHIHII")
# decode fast paths: u32-array structs per element count, and direct
# constructors that skip the frozen-dataclass __setattr__ round trip
_U32S = [struct.Struct(f"<{n}I") for n in range(17)]
_U16S_CACHE: dict = {}
_OP_OF = Op._value2member_map_


def _u32s(n: int) -> struct.Struct:
    return _U32S[n] if n < 17 else struct.Struct(f"<{n}I")


def _u16s(n: int) -> struct.Struct:
    s = _U16S_CACHE.get(n)
    if s is None:
        s = _U16S_CACHE[n] = struct.Struct(f"<{n}H")
    return s




class _SymTab:
    """Order-preserving string interner (encode side), plus an attr-dict
    pool: identical attr dicts (stride/padding packs repeat across layers)
    serialize ONCE and ops reference them by u32 index."""

    def __init__(self):
        self.index: dict[str, int] = {}
        self.strings: list[str] = []
        self.attr_index: dict[bytes, int] = {}
        self.attr_blobs: list[bytes] = []

    def add(self, s: str) -> int:
        i = self.index.get(s)
        if i is None:
            i = self.index[s] = len(self.strings)
            self.strings.append(s)
        return i

    def add_attrs(self, attrs: dict) -> int:
        out = [bytes((len(attrs),))]
        for k, v in attrs.items():
            out.append(_ST_U32.pack(self.add(k)))
            _enc_value(out, v, self)
        blob = b"".join(out)
        i = self.attr_index.get(blob)
        if i is None:
            i = self.attr_index[blob] = len(self.attr_blobs)
            self.attr_blobs.append(blob)
        return i

    def encode(self) -> bytes:
        """Lengths-array layout: one struct unpack recovers every string
        boundary, so decode is a single pass over a flat utf-8 blob."""
        raws = [s.encode() for s in self.strings]
        n = len(raws)
        out = [_ST_U32.pack(n), _u16s(n).pack(*(len(r) for r in raws))]
        out += raws
        out.append(_ST_U32.pack(len(self.attr_blobs)))
        out += self.attr_blobs
        return b"".join(out)


def _decode_symtab(data, buf: memoryview,
                   off: int) -> tuple[list, list, int]:
    (n,) = _ST_U32.unpack_from(data, off)
    off += 4
    lens = _u16s(n).unpack_from(data, off)
    off += 2 * n
    syms = []
    append = syms.append
    total = sum(lens)
    blob = str(data[off:off + total], "utf-8")
    if len(blob) == total:              # pure-ASCII: char slicing is valid
        p = 0
        for ln in lens:
            append(blob[p:p + ln])
            p += ln
        off += total
    else:
        for ln in lens:
            append(data[off:off + ln].decode())
            off += ln
    (n_attrs,) = _ST_U32.unpack_from(data, off)
    off += 4
    pool = []
    for _ in range(n_attrs):
        na = data[off]
        off += 1
        attrs = {}
        for _ in range(na):
            (k,) = _ST_U32.unpack_from(data, off)
            attrs[syms[k]], off = _dec_value(data, off + 4, syms)
        pool.append(attrs)
    return syms, pool, off


def _enc_varint(out: list, n: int) -> None:
    u = (n << 1) ^ -1 if n < 0 else (n << 1)       # zigzag, arbitrary width
    while u > 0x7F:
        out.append(bytes((0x80 | (u & 0x7F),)))
        u >>= 7
    out.append(bytes((u,)))


def _dec_varint(buf, off: int) -> tuple[int, int]:
    u, shift = 0, 0
    while True:
        b = buf[off]
        off += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (~(u >> 1) if u & 1 else (u >> 1)), off


def _enc_value(out: list, v, st: _SymTab) -> None:
    """Tag-based attr value encoding. Tuples canonicalize to lists — the
    same canonicalization v1's JSON round-trip applies."""
    if v is None:
        out.append(b"\x00")
    elif v is False:
        out.append(b"\x01")
    elif v is True:
        out.append(b"\x02")
    elif isinstance(v, int):
        out.append(b"\x03")
        _enc_varint(out, v)
    elif isinstance(v, float):
        out.append(b"\x04")
        out.append(_ST_F64.pack(v))
    elif isinstance(v, str):
        out.append(b"\x05")
        out.append(_ST_U32.pack(st.add(v)))
    elif isinstance(v, (list, tuple)):
        out.append(b"\x06")
        out.append(_ST_U32.pack(len(v)))
        for item in v:
            _enc_value(out, item, st)
    elif isinstance(v, dict):
        out.append(b"\x07")
        out.append(_ST_U32.pack(len(v)))
        for k, item in v.items():
            out.append(_ST_U32.pack(st.add(k)))
            _enc_value(out, item, st)
    else:
        raise TypeError(f"unencodable attr value {v!r}")


def _dec_value(buf, off: int, syms: list):
    tag = buf[off]
    off += 1
    if tag == 0:
        return None, off
    if tag == 1:
        return False, off
    if tag == 2:
        return True, off
    if tag == 3:
        return _dec_varint(buf, off)
    if tag == 4:
        return _ST_F64.unpack_from(buf, off)[0], off + 8
    if tag == 5:
        return syms[_ST_U32.unpack_from(buf, off)[0]], off + 4
    if tag == 6:
        (n,) = _ST_U32.unpack_from(buf, off)
        off += 4
        items = []
        for _ in range(n):
            v, off = _dec_value(buf, off, syms)
            items.append(v)
        return items, off
    if tag == 7:
        (n,) = _ST_U32.unpack_from(buf, off)
        off += 4
        d = {}
        for _ in range(n):
            (k,) = _ST_U32.unpack_from(buf, off)
            off += 4
            d[syms[k]], off = _dec_value(buf, off, syms)
        return d, off
    raise ValueError(f"bad value tag {tag}")


def _enc_op_v2(op: "RCBOp", st: _SymTab) -> bytes:
    out = [_ST_OP2.pack(int(op.op), len(op.dsts), len(op.srcs),
                        st.add_attrs(op.attrs))]
    for ref in op.dsts:
        out.append(_ST_U32.pack(st.add(ref)))
    for ref in op.srcs:
        out.append(_ST_U32.pack(st.add(ref)))
    return b"".join(out)


def _enc_tensors_v2(tensors: dict, st: _SymTab) -> bytes:
    """Struct-of-arrays tensor section: all fixed fields in one u32 array,
    all dims in a second — the decode side recovers every descriptor with
    TWO struct calls total instead of two per tensor."""
    fixed: list[int] = []
    dims: list[int] = []
    axes_out: list[bytes] = []
    for t in tensors.values():
        fixed += (st.add(t.name), st.add(t.dtype), st.add(t.kind),
                  len(t.shape), len(t.axes))
        dims += list(t.shape)
        for ax in t.axes:
            _enc_value(axes_out, ax, st)
    return b"".join([_u32s(len(fixed)).pack(*fixed),
                     _ST_U32.pack(len(dims)),
                     _u32s(len(dims)).pack(*dims)] + axes_out)


def _dec_tensors_v2(data, off: int, n_t: int,
                    syms: list) -> tuple[dict, int]:
    fixed = _u32s(5 * n_t).unpack_from(data, off)
    off += 20 * n_t
    (n_dims,) = _ST_U32.unpack_from(data, off)
    off += 4
    dims = _u32s(n_dims).unpack_from(data, off)
    off += 4 * n_dims
    tensors: dict = {}
    p = 0                                  # cursor into dims
    f = 0                                  # cursor into fixed
    for _ in range(n_t):
        ni, di, ki, ndim, naxes = fixed[f:f + 5]
        f += 5
        if naxes:
            axes = []
            for _ in range(naxes):
                v, off = _dec_value(data, off, syms)
                axes.append(v)
            axes = tuple(axes)
        else:
            axes = ()
        t = TensorDesc.__new__(TensorDesc)
        d = t.__dict__
        name = d["name"] = syms[ni]
        d["shape"] = dims[p:p + ndim]
        d["dtype"] = syms[di]
        d["kind"] = syms[ki]
        d["axes"] = axes
        p += ndim
        tensors[name] = t
    return tensors, off


def _enc_block_v2(blk: "RCB", st: _SymTab) -> bytes:
    payload = b"".join(_enc_op_v2(op, st) for op in blk.ops)
    deps = [_ST_U16.pack(len(blk.deps))]
    deps += [_ST_U32.pack(d) for d in blk.deps]
    header = _ST_BLK2.pack(MAGIC_V2, blk.block_id, len(payload),
                           len(blk.ops), st.add(blk.block_type)) \
        + b"".join(deps)
    crc = zlib.crc32(header + payload) & 0xFFFFFFFF
    return header + payload + _ST_U32.pack(crc)


def _dec_block_v2(data, buf: memoryview, off: int, syms: list,
                  pool: list) -> tuple["RCB", int]:
    magic, block_id, plen, n_ops, type_idx = _ST_BLK2.unpack_from(data, off)
    if magic != MAGIC_V2:
        raise ValueError(f"bad RCB v2 magic {magic!r}")
    p = off + _ST_BLK2.size
    (n_deps,) = _ST_U16.unpack_from(data, p)
    p += 2
    deps = _u32s(n_deps).unpack_from(data, p)
    p += 4 * n_deps
    body_end = p + plen
    (crc,) = _ST_U32.unpack_from(data, body_end)
    if crc != (zlib.crc32(buf[off:body_end]) & 0xFFFFFFFF):
        raise ValueError(f"RCB {block_id}: CRC mismatch")
    ops = []
    append = ops.append
    unpack_op = _ST_OP2.unpack_from
    op_of = _OP_OF
    getsym = syms.__getitem__
    for _ in range(n_ops):
        opcode, n_d, n_s, ai = unpack_op(data, p)
        p += 8
        n_refs = n_d + n_s
        refs = _u32s(n_refs).unpack_from(data, p)
        p += 4 * n_refs
        o = RCBOp.__new__(RCBOp)
        d = o.__dict__
        d["op"] = op_of[opcode]
        d["dsts"] = tuple(map(getsym, refs[:n_d]))
        d["srcs"] = tuple(map(getsym, refs[n_d:]))
        # pooled dicts are shared between ops with identical attrs —
        # decoded programs are immutable data (DESIGN.md §3)
        d["attrs"] = pool[ai]
        append(o)
    blk = RCB.__new__(RCB)
    blk.__dict__.update(block_id=block_id, block_type=syms[type_idx],
                        deps=deps, ops=tuple(ops))
    return blk, body_end + 4


@dataclasses.dataclass(frozen=True)
class RCB:
    """Header + operation payload."""
    block_id: int
    block_type: str                 # "layer" | "transfer" | "control" | ...
    deps: tuple = ()                # block ids this RCB waits on
    ops: tuple = ()                 # tuple[RCBOp]

    def encode(self) -> bytes:
        payload = b"".join(op.encode() for op in self.ops)
        hdr_meta = json.dumps({"t": self.block_type, "deps": list(self.deps)},
                              separators=(",", ":")).encode()
        header = struct.pack("<4sIIHI", MAGIC, self.block_id, len(payload),
                             len(self.ops), len(hdr_meta)) + hdr_meta
        crc = zlib.crc32(header + payload) & 0xFFFFFFFF
        return header + payload + struct.pack("<I", crc)

    @staticmethod
    def decode(buf: memoryview, off: int = 0) -> tuple["RCB", int]:
        magic, block_id, plen, n_ops, hlen = struct.unpack_from(
            "<4sIIHI", buf, off)
        if magic != MAGIC:
            raise ValueError(f"bad RCB magic {magic!r}")
        hdr_end = off + 18 + hlen
        body_end = hdr_end + plen
        # integrity FIRST — nothing inside the block is parsed before the
        # CRC over header+payload checks out (torn/corrupt provisioning).
        (crc,) = struct.unpack_from("<I", buf, body_end)
        actual = zlib.crc32(bytes(buf[off:body_end])) & 0xFFFFFFFF
        if crc != actual:
            raise ValueError(f"RCB {block_id}: CRC mismatch "
                             f"({crc:#x} != {actual:#x})")
        meta = json.loads(bytes(buf[off + 18:hdr_end]).decode())
        ops = []
        o = hdr_end
        for _ in range(n_ops):
            op, o = RCBOp.decode(buf, o)
            ops.append(op)
        return RCB(block_id, meta["t"], tuple(meta["deps"]),
                   tuple(ops)), body_end + 4


@dataclasses.dataclass
class RCBProgram:
    """A full workload: symbol table + ordered RCBs + artifact registry.

    ``artifacts`` maps GRAPH_EXEC ids to python callables (the "compiled ADF
    graph" analogues — jitted step functions). They are not serialized; on
    deserialization the binding layer re-attaches them by name, exactly like
    the paper re-attaches precompiled AIE kernels referenced from RCBs.
    """
    name: str
    tensors: dict           # name -> TensorDesc
    blocks: list            # list[RCB]
    artifacts: dict = dataclasses.field(default_factory=dict)

    def crc(self) -> int:
        """Whole-program CRC-32 over the canonical v2 encoding, lazily
        computed and cached — the identity key for compile caches (two
        programs with the same CRC stage to the same executable, so e.g.
        the batch-bucket cache in core/executor.py is shared across
        re-binds of the same program). Artifacts are not covered (they are
        not serialized), but artifact-bearing programs are excluded from
        batch staging by ``linker.batch_analysis`` anyway."""
        c = getattr(self, "_crc", None)
        if c is None:
            # the v2 encoding already ends with the whole-program CRC —
            # reuse it rather than re-hashing (and NEVER hash the full
            # encoding including its trailer: crc32(body || crc32(body))
            # is the same constant for every message)
            (c,) = struct.unpack("<I", self.encode()[-4:])
            self._crc = c
        return c

    # ------------------------------------------------------------- binary io
    def encode(self, version: int = PROG_VERSION) -> bytes:
        """Serialize.  v2 (default): interned symtab + packed op records.
        v1 kept for cross-version tests and the encode/decode benchmark."""
        if version == 1:
            return self._encode_v1()
        if version != 2:
            raise ValueError(f"unknown RCBProgram version {version}")
        st = _SymTab()
        # ops/tensors are encoded first so the symtab they intern into is
        # complete before it is itself serialized
        tensec = _enc_tensors_v2(self.tensors, st)
        blocks = b"".join(_enc_block_v2(b, st) for b in self.blocks)
        symtab = st.encode()
        name = self.name.encode()
        hdr = _ST_PROG.pack(PROG_MAGIC, 2, len(name), len(self.tensors),
                            len(self.blocks), len(symtab))
        body = hdr + name + symtab + tensec + blocks
        return body + _ST_U32.pack(zlib.crc32(body) & 0xFFFFFFFF)

    def _encode_v1(self) -> bytes:
        tensec = b"".join(t.encode() for t in self.tensors.values())
        blocks = b"".join(b.encode() for b in self.blocks)
        name = self.name.encode()
        hdr = struct.pack("<4sHIHII", PROG_MAGIC, 1, len(name),
                          len(self.tensors), len(self.blocks), len(tensec))
        body = hdr + name + tensec + blocks
        return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)

    @staticmethod
    def decode(data: bytes) -> "RCBProgram":
        """Version-sniffing decode: v1 and v2 wire formats both accepted.

        Integrity FIRST, for both versions: the whole-program CRC (which
        covers the v2 symbol table) is verified before any section parses.
        """
        buf = memoryview(data)
        magic, ver, nlen, n_t, n_b, seclen = struct.unpack_from(
            "<4sHIHII", buf)
        if magic != PROG_MAGIC:
            raise ValueError(f"bad program magic {magic!r}")
        (crc,) = struct.unpack_from("<I", buf, len(data) - 4)
        if crc != (zlib.crc32(data[:-4]) & 0xFFFFFFFF):
            raise ValueError("RCBProgram CRC mismatch")
        off = struct.calcsize("<4sHIHII")
        name = bytes(buf[off:off + nlen]).decode()
        off += nlen
        tensors = {}
        blocks = []
        if ver == 1:
            for _ in range(n_t):
                t, off = TensorDesc.decode(buf, off)
                tensors[t.name] = t
            for _ in range(n_b):
                b, off = RCB.decode(buf, off)
                blocks.append(b)
        elif ver == 2:
            syms, pool, off = _decode_symtab(data, buf, off)
            tensors, off = _dec_tensors_v2(data, off, n_t, syms)
            for _ in range(n_b):
                b, off = _dec_block_v2(data, buf, off, syms, pool)
                blocks.append(b)
        else:
            raise ValueError(f"unknown RCBProgram version {ver}")
        return RCBProgram(name, tensors, blocks)

    # ------------------------------------------------------------- utilities
    def ops(self) -> Iterable[RCBOp]:
        for b in self.blocks:
            for op in b.ops:
                yield op

    def validate(self) -> None:
        """Static checks: every symbolic ref has a descriptor; deps exist."""
        ids = {b.block_id for b in self.blocks}
        for b in self.blocks:
            for d in b.deps:
                if d not in ids:
                    raise ValueError(f"RCB {b.block_id}: missing dep {d}")
        for op in self.ops():
            for ref in (*op.dsts, *op.srcs):
                if ref not in self.tensors:
                    raise ValueError(f"unbound symbolic ref {ref!r}")
