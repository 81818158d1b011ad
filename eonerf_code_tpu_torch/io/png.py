"""PNG reading and writing on the standard library (``zlib``, ``struct``)
and numpy.

The reader takes 8-bit grayscale, RGB and RGBA images, non-interlaced,
with any of the five row filters (an encoder may choose a filter per row),
and returns the array ``np.asarray(PIL.Image.open(path))`` gives: (h, w)
uint8 for grayscale, (h, w, 3) or (h, w, 4) otherwise. Anything else
(another bit depth, a palette, grayscale with alpha, interlacing, a
corrupt chunk) raises ``ValueError``. Ancillary chunks are skipped.

The writer stores every row unfiltered; it is for generated scenes.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit only)
CHANNELS = {0: 1, 2: 3, 6: 4}
_TYPE_OF = {1: 0, 3: 2, 4: 6}


def _chunks(data):
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(body) != length or crc_at + 4 > len(data):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in {kind!r} chunk")
        yield kind, body
        pos = crc_at + 4


def _unfilter_sequential(kind, cur, prev, bpp):
    """Average (3) and Paeth (4) rows: each byte depends on the one
    ``bpp`` to its left, so they are undone byte by byte."""
    out, prev = bytearray(cur.tobytes()), prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw, h, stride, bpp):
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG: {rows.size} bytes of image data, {h * (stride + 1)} expected")
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = cur
        elif kind == 1:   # Sub: a running sum, modulo 256, along each channel
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            out[y] = cur + prev
        elif kind in (3, 4):
            out[y] = _unfilter_sequential(kind, cur, prev, bpp)
        else:
            raise ValueError(f"PNG: unknown row filter {kind} in row {y}")
        prev = out[y]
    return out


def read_png(path):
    """Decode the PNG at ``path`` to a uint8 array (see the module's
    docstring for what it reads)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, ended = None, [], False
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            ended = True
            break
        elif kind[0:1].isupper():   # a critical chunk: PLTE, or one unknown
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if header is None or not ended:
        raise ValueError(f"{path}: missing IHDR or IEND")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}; only 8-bit "
                         "grayscale (0), RGB (2) and RGBA (6) are read")
    if comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: compression {comp}, filter method {filt}, interlace "
                         f"{interlace}; only 0, 0, 0 are read")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    c = CHANNELS[ctype]
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[:, :, 0] if c == 1 else img


def write_png(path, img):
    """Write a uint8 (h, w), (h, w, 1), (h, w, 3) or (h, w, 4) array as an
    8-bit grayscale, RGB or RGBA PNG, every row unfiltered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _TYPE_OF:
        raise ValueError(f"write_png takes (h, w[, 1|3|4]) arrays, not {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _TYPE_OF[c], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))
