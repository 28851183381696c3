"""Pure-Python LZ4 decompressor (frame + block formats).

Counterpart of ``warpsense_tpu/io/lz4.py`` (the same decoder).

Ouster rosbags are routinely recorded with ``rosbag record --lz4``; the
reference reads them through ROS's ``roslz4`` C extension (standard LZ4
FRAME format, magic 0x184D2204).  Python's standard library has no LZ4
module, so ``io/rosbag.py`` uses this decoder for lz4 chunks — decode speed is
host-side IO, far off the pipeline's device hot path.

Scope: decompression only, both block-independent and block-linked
frames (matches may reference the full decoded history — valid for
either mode).  Block/content checksums (xxHash32) are skipped, not
verified.
"""
from __future__ import annotations

_MAGIC = 0x184D2204


def decompress_block(src: bytes, dst: bytearray) -> None:
    """Decode one raw LZ4 block, APPENDING to ``dst`` (matches may
    reference bytes already in ``dst`` — the linked-block window)."""
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if i + lit > n:
                raise ValueError("corrupt lz4 block: truncated literals")
            dst += src[i:i + lit]
            i += lit
        if i >= n:        # last sequence has no match
            break
        # match
        if i + 2 > n:
            raise ValueError("corrupt lz4 block: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt lz4 block: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt lz4 block: offset beyond history")
        if offset >= mlen:
            dst += dst[start:start + mlen]
        else:
            # overlapping copy (RLE-style): byte-accurate repetition
            for k in range(mlen):
                dst.append(dst[start + k])


def decompress(data: bytes) -> bytes:
    """Decode a standard LZ4 FRAME (possibly several, concatenated)."""
    view = memoryview(data)
    out = bytearray()
    pos = 0
    while pos + 4 <= len(view):
        magic = int.from_bytes(view[pos:pos + 4], "little")
        pos += 4
        if magic != _MAGIC:
            if (magic & 0xFFFFFFF0) == 0x184D2A50:
                # skippable frame: 4-byte size then payload
                size = int.from_bytes(view[pos:pos + 4], "little")
                pos += 4 + size
                continue
            raise ValueError(f"not an lz4 frame (magic {magic:#x})")
        flg = view[pos]
        pos += 2                                   # FLG + BD
        if (flg >> 6) != 1:
            raise ValueError("unsupported lz4 frame version")
        block_checksum = bool(flg & 0x10)
        if flg & 0x08:                             # content size
            pos += 8
        if flg & 0x01:                             # dict id
            pos += 4
        pos += 1                                   # header checksum (HC)
        while True:
            bsize = int.from_bytes(view[pos:pos + 4], "little")
            pos += 4
            if bsize == 0:                         # EndMark
                break
            uncompressed = bool(bsize & 0x80000000)
            bsize &= 0x7FFFFFFF
            block = bytes(view[pos:pos + bsize])
            pos += bsize
            if block_checksum:
                pos += 4
            if uncompressed:
                out += block
            else:
                decompress_block(block, out)
        if flg & 0x04:                             # content checksum
            pos += 4
    return bytes(out)
