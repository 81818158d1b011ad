"""Minimal, dependency-free GeoTIFF reader/writer.

Covers the raster shapes the satellite-NeRF pipeline touches (reference uses
rasterio for all of these): uint8/uint16/int16/float32/float64 rasters,
striped or tiled layout, contiguous or planar, no/deflate/LZW/PackBits
compression, horizontal-differencing predictor, and the GeoTIFF tags needed
for georeferencing (pixel scale + tiepoint or 4x4 model transform, EPSG code
via GeoKeyDirectory, GDAL nodata).

The writer emits uncompressed striped rasters with the same profile fields
the reference writes through rasterio (dtype/count/nodata/crs/transform —
e.g. datasets/satellite.py:596-608).
"""

import math
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

# --- tag ids ---
T_WIDTH, T_HEIGHT, T_BPS, T_COMPRESSION, T_PHOTOMETRIC = 256, 257, 258, 259, 262
T_STRIP_OFFSETS, T_ORIENTATION, T_SPP, T_ROWS_PER_STRIP, T_STRIP_COUNTS = 273, 274, 277, 278, 279
T_PLANAR, T_PREDICTOR = 284, 317
T_TILE_W, T_TILE_H, T_TILE_OFFSETS, T_TILE_COUNTS = 322, 323, 324, 325
T_SAMPLE_FORMAT = 339
T_PIXEL_SCALE, T_TIEPOINT, T_MODEL_TRANSFORM = 33550, 33922, 34264
T_GEO_DIR, T_GEO_DOUBLE, T_GEO_ASCII = 34735, 34736, 34737
T_GDAL_NODATA = 42113

_TYPE_FMT = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d"}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}


class Affine(tuple):
    """2x3 affine geo-transform, rasterio-style ordering (a, b, c, d, e, f):
    x = a*col + b*row + c ; y = d*col + e*row + f."""

    def __new__(cls, a, b, c, d, e, f):
        return super().__new__(cls, (float(a), float(b), float(c), float(d), float(e), float(f)))

    a = property(lambda s: s[0])
    b = property(lambda s: s[1])
    c = property(lambda s: s[2])
    d = property(lambda s: s[3])
    e = property(lambda s: s[4])
    f = property(lambda s: s[5])

    def __mul__(self, colrow):
        col, row = colrow
        return (self[0] * col + self[1] * row + self[2],
                self[3] * col + self[4] * row + self[5])


@dataclass(frozen=True)
class CRS:
    """Tiny CRS wrapper: EPSG code only (all rasters here are UTM/WGS84)."""

    epsg: int

    @staticmethod
    def from_utm_zone(zone, south=False):
        return CRS((32700 if south else 32600) + int(zone))

    def utm_zone(self):
        if 32601 <= self.epsg <= 32660:
            return self.epsg - 32600, False
        if 32701 <= self.epsg <= 32760:
            return self.epsg - 32700, True
        return None, None

    def __str__(self):
        return f"EPSG:{self.epsg}"


def _lzw_decode(data):
    """TIFF-variant LZW (MSB-first codes, ClearCode 256, EOI 257)."""
    out = bytearray()
    table = None
    code_size = 9
    prev = None
    buf = 0
    nbits = 0
    next_code = 258
    CLEAR, EOI = 256, 257
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= code_size:
            nbits -= code_size
            code = (buf >> nbits) & ((1 << code_size) - 1)
            if code == CLEAR:
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                next_code = 258
                code_size = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if table is None:
                raise ValueError("LZW stream does not start with a clear code")
            if prev is None:
                entry = table[code]
            elif code < next_code:
                entry = table[code]
                table.append(prev + entry[:1])
                next_code += 1
            elif code == next_code:
                entry = prev + prev[:1]
                table.append(entry)
                next_code += 1
            else:
                raise ValueError("corrupt LZW stream")
            out += entry
            prev = entry
            # TIFF early-change convention: grow one code early
            if next_code >= (1 << code_size) - 1 and code_size < 12:
                code_size += 1
    return bytes(out)


def _packbits_decode(data):
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decompress(data, compression):
    if compression == 1:
        return data
    if compression in (8, 32946):
        return zlib.decompress(data)
    if compression == 5:
        return _lzw_decode(data)
    if compression == 32773:
        return _packbits_decode(data)
    raise NotImplementedError(f"TIFF compression {compression} not supported")


class GeoTiffFile:
    """Read-only handle over a (Geo)TIFF, rasterio-like surface."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            self._raw = f.read()
        self._parse()

    # -- context manager --
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _parse(self):
        raw = self._raw
        bom = raw[:2]
        if bom == b"II":
            self._e = "<"
        elif bom == b"MM":
            self._e = ">"
        else:
            raise ValueError(f"{self.path}: not a TIFF")
        magic = struct.unpack(self._e + "H", raw[2:4])[0]
        if magic != 42:
            raise NotImplementedError("BigTIFF not supported")
        (ifd_off,) = struct.unpack(self._e + "I", raw[4:8])
        self.tags = self._read_ifd(ifd_off)

        t = self.tags
        self.width = int(t[T_WIDTH][0])
        self.height = int(t[T_HEIGHT][0])
        self.count = int(t.get(T_SPP, [1])[0])
        bps = t.get(T_BPS, [8])
        fmt = t.get(T_SAMPLE_FORMAT, [1])
        self._dtype = self._np_dtype(int(bps[0]), int(fmt[0]))
        self.dtypes = [self._dtype.name] * self.count
        self._compression = int(t.get(T_COMPRESSION, [1])[0])
        self._predictor = int(t.get(T_PREDICTOR, [1])[0])
        self._planar = int(t.get(T_PLANAR, [1])[0])

        self.nodata = None
        if T_GDAL_NODATA in t:
            s = t[T_GDAL_NODATA]
            try:
                self.nodata = float(s.rstrip("\x00").strip())
            except ValueError:
                self.nodata = float("nan")

        self.transform = self._geo_transform()
        self.crs = self._geo_crs()
        self.res = (abs(self.transform.a), abs(self.transform.e))

    def _np_dtype(self, bits, sample_format):
        kind = {1: "u", 2: "i", 3: "f"}.get(sample_format, "u")
        return np.dtype(f"{self._e}{kind}{bits // 8}")

    def _read_ifd(self, off):
        raw, e = self._raw, self._e
        (n,) = struct.unpack(e + "H", raw[off:off + 2])
        tags = {}
        for i in range(n):
            ent = raw[off + 2 + 12 * i: off + 14 + 12 * i]
            tag, typ, cnt = struct.unpack(e + "HHI", ent[:8])
            if typ not in _TYPE_FMT:
                continue
            size = _TYPE_SIZE[typ] * cnt
            if size <= 4:
                data = ent[8:8 + size]
            else:
                (ptr,) = struct.unpack(e + "I", ent[8:12])
                data = raw[ptr:ptr + size]
            if typ == 2:
                tags[tag] = data.decode("latin-1")
            elif typ in (5, 10):
                vals = struct.unpack(e + ("Ii"[typ == 10] * 2 * cnt), data)
                tags[tag] = [vals[2 * j] / max(vals[2 * j + 1], 1) for j in range(cnt)]
            else:
                tags[tag] = list(struct.unpack(e + _TYPE_FMT[typ] * cnt, data))
        return tags

    def _geo_transform(self):
        t = self.tags
        if T_MODEL_TRANSFORM in t and len(t[T_MODEL_TRANSFORM]) >= 16:
            m = t[T_MODEL_TRANSFORM]
            return Affine(m[0], m[1], m[3], m[4], m[5], m[7])
        if T_PIXEL_SCALE in t and T_TIEPOINT in t:
            sx, sy = t[T_PIXEL_SCALE][0], t[T_PIXEL_SCALE][1]
            i, j, _, x, y, _ = t[T_TIEPOINT][:6]
            return Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
        return Affine(1.0, 0.0, 0.0, 0.0, -1.0, float(self.height))

    def _geo_crs(self):
        if T_GEO_DIR not in self.tags:
            return None
        d = self.tags[T_GEO_DIR]
        keys = {}
        for i in range(d[3]):
            kid, loc, cnt, val = d[4 + 4 * i: 8 + 4 * i]
            if loc == 0:
                keys[kid] = val
        if 3072 in keys and keys[3072] not in (0, 32767):
            return CRS(int(keys[3072]))
        if 2048 in keys and keys[2048] not in (0, 32767):
            return CRS(int(keys[2048]))
        return None

    @property
    def bounds(self):
        x0, y0 = self.transform * (0, 0)
        x1, y1 = self.transform * (self.width, self.height)
        left, right = min(x0, x1), max(x0, x1)
        bottom, top = min(y0, y1), max(y0, y1)

        class _B(tuple):
            left = property(lambda s: s[0])
            bottom = property(lambda s: s[1])
            right = property(lambda s: s[2])
            top = property(lambda s: s[3])

        return _B((left, bottom, right, top))

    @property
    def profile(self):
        return {
            "driver": "GTiff",
            "dtype": self._dtype.newbyteorder("=").name,
            "count": self.count,
            "height": self.height,
            "width": self.width,
            "crs": self.crs,
            "transform": self.transform,
            "nodata": self.nodata,
        }

    def _apply_predictor(self, arr):
        if self._predictor == 2:
            np.cumsum(arr, axis=-2 if arr.ndim == 3 and self._planar == 1 else -1, dtype=arr.dtype, out=arr)
        return arr

    def read(self, band=None):
        """Return (count, h, w) array, or (h, w) if a 1-based band is given."""
        full = self._read_all()
        if band is not None:
            return full[band - 1]
        return full

    def _read_all(self):
        t = self.tags
        h, w, c = self.height, self.width, self.count
        dt = self._dtype
        if T_TILE_OFFSETS in t:
            arr = self._read_tiled()
        else:
            offsets = t[T_STRIP_OFFSETS]
            counts = t[T_STRIP_COUNTS]
            rps = int(t.get(T_ROWS_PER_STRIP, [h])[0])
            if self._planar == 2:
                strips_per_band = (h + rps - 1) // rps
                out = np.empty((c, h, w), dt)
                for b in range(c):
                    rows = []
                    for s in range(strips_per_band):
                        k = b * strips_per_band + s
                        data = _decompress(self._raw[offsets[k]:offsets[k] + counts[k]], self._compression)
                        nrows = min(rps, h - s * rps)
                        chunk = np.frombuffer(data, dt, nrows * w).reshape(nrows, w).copy()
                        if self._predictor == 2:
                            np.cumsum(chunk, axis=1, dtype=dt, out=chunk)
                        rows.append(chunk)
                    out[b] = np.concatenate(rows, 0)
                arr = out
            else:
                rows = []
                for k, (off, cnt) in enumerate(zip(offsets, counts)):
                    data = _decompress(self._raw[off:off + cnt], self._compression)
                    nrows = min(rps, h - k * rps)
                    chunk = np.frombuffer(data, dt, nrows * w * c).reshape(nrows, w, c).copy()
                    if self._predictor == 2:
                        np.cumsum(chunk, axis=1, dtype=dt, out=chunk)
                    rows.append(chunk)
                arr = np.concatenate(rows, 0).transpose(2, 0, 1)
        return np.ascontiguousarray(arr.astype(dt.newbyteorder("=")))

    def _read_tiled(self):
        t = self.tags
        h, w, c = self.height, self.width, self.count
        tw, th = int(t[T_TILE_W][0]), int(t[T_TILE_H][0])
        offsets, counts = t[T_TILE_OFFSETS], t[T_TILE_COUNTS]
        dt = self._dtype
        tiles_x = (w + tw - 1) // tw
        tiles_y = (h + th - 1) // th
        bands = c if self._planar == 2 else 1
        samples = 1 if self._planar == 2 else c
        out = np.empty((c, h, w), dt)
        k = 0
        for b in range(bands):
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    data = _decompress(self._raw[offsets[k]:offsets[k] + counts[k]], self._compression)
                    tile = np.frombuffer(data, dt, th * tw * samples).reshape(th, tw, samples).copy()
                    if self._predictor == 2:
                        np.cumsum(tile, axis=1, dtype=dt, out=tile)
                    y0, x0 = ty * th, tx * tw
                    ys, xs = min(th, h - y0), min(tw, w - x0)
                    if self._planar == 2:
                        out[b, y0:y0 + ys, x0:x0 + xs] = tile[:ys, :xs, 0]
                    else:
                        out[:, y0:y0 + ys, x0:x0 + xs] = tile[:ys, :xs].transpose(2, 0, 1)
                    k += 1
        return out


def open_geotiff(path):
    return GeoTiffFile(path)


def read_geotiff(path, band=None):
    return GeoTiffFile(path).read(band)


_DT_TO_TIFF = {
    "uint8": (8, 1), "uint16": (16, 1), "int16": (16, 2), "int32": (32, 2),
    "uint32": (32, 1), "float32": (32, 3), "float64": (64, 3),
}


def write_geotiff(path, array, crs=None, transform=None, nodata=None, profile=None):
    """Write a (count, h, w) or (h, w) array as an uncompressed GeoTIFF.

    Accepts either explicit crs/transform/nodata or a rasterio-like
    ``profile`` dict (keys crs/transform/nodata are honored; dtype taken from
    the array).
    """
    if profile:
        crs = profile.get("crs", crs)
        transform = profile.get("transform", transform)
        nodata = profile.get("nodata", nodata)
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    count, h, w = arr.shape
    dtname = arr.dtype.name
    if dtname not in _DT_TO_TIFF:
        arr = arr.astype(np.float32)
        dtname = "float32"
    bits, sfmt = _DT_TO_TIFF[dtname]
    arr = np.ascontiguousarray(arr.transpose(1, 2, 0))  # interleave -> (h, w, c)
    pix = arr.astype(arr.dtype.newbyteorder("<")).tobytes()

    entries = []  # (tag, type, count, values or bytes)

    def add(tag, typ, vals):
        entries.append((tag, typ, vals))

    add(T_WIDTH, 4, [w])
    add(T_HEIGHT, 4, [h])
    add(T_BPS, 3, [bits] * count)
    add(T_COMPRESSION, 3, [1])
    add(T_PHOTOMETRIC, 3, [2 if count == 3 else 1])
    add(T_SPP, 3, [count])
    add(T_ROWS_PER_STRIP, 4, [h])
    add(T_PLANAR, 3, [1])
    add(T_SAMPLE_FORMAT, 3, [sfmt] * count)
    if transform is not None:
        a, b_, c_, d_, e_, f_ = transform
        if b_ == 0 and d_ == 0:
            add(T_PIXEL_SCALE, 12, [abs(a), abs(e_), 0.0])
            add(T_TIEPOINT, 12, [0.0, 0.0, 0.0, c_, f_, 0.0])
        else:
            m = [a, b_, 0, c_, d_, e_, 0, f_, 0, 0, 0, 0, 0, 0, 0, 1]
            add(T_MODEL_TRANSFORM, 12, [float(v) for v in m])
    if crs is not None:
        epsg = crs.epsg if isinstance(crs, CRS) else int(str(crs).split(":")[-1])
        model = 1 if epsg >= 20000 else 2
        keys = [1, 1, 0, 3,
                1024, 0, 1, model,   # GTModelType
                1025, 0, 1, 1,       # GTRasterType = PixelIsArea
                (3072 if model == 1 else 2048), 0, 1, epsg]
        add(T_GEO_DIR, 3, keys)
    if nodata is not None:
        s = ("nan" if (isinstance(nodata, float) and math.isnan(nodata)) else repr(float(nodata)))
        add(T_GDAL_NODATA, 2, (s + "\x00").encode("ascii"))

    # layout: header(8) + IFD + out-of-line tag data + pixel data
    entries.sort(key=lambda x: x[0])
    n = len(entries) + 1  # + strip offsets/counts handled below
    # we add strip offset/counts as entries too:
    ifd_size = 2 + 12 * (len(entries) + 2) + 4
    data_off = 8 + ifd_size
    blobs = []

    def pack_vals(typ, vals):
        if typ == 2:
            return vals  # already bytes
        return struct.pack("<" + _TYPE_FMT[typ] * len(vals), *vals)

    packed = []
    for tag, typ, vals in entries:
        data = pack_vals(typ, vals)
        cnt = len(vals) if typ != 2 else len(vals)
        packed.append((tag, typ, cnt, data))
    # strip tags (single strip)
    packed.append((T_STRIP_COUNTS, 4, 1, struct.pack("<I", len(pix))))
    packed.append((T_STRIP_OFFSETS, 4, 1, None))  # patched after layout
    packed.sort(key=lambda x: x[0])

    # assign out-of-line offsets
    out_chunks = []
    cur = data_off
    ifd_entries = []
    for tag, typ, cnt, data in packed:
        if tag == T_STRIP_OFFSETS:
            ifd_entries.append((tag, typ, cnt, None))
            continue
        if len(data) <= 4:
            ifd_entries.append((tag, typ, cnt, data.ljust(4, b"\x00")))
        else:
            if cur % 2:
                out_chunks.append(b"\x00")
                cur += 1
            ifd_entries.append((tag, typ, cnt, struct.pack("<I", cur)))
            out_chunks.append(data)
            cur += len(data)
    if cur % 2:
        out_chunks.append(b"\x00")
        cur += 1
    strip_off = cur
    ifd_entries = [(t, ty, c_, (struct.pack("<I", strip_off) if t == T_STRIP_OFFSETS else d))
                   for (t, ty, c_, d) in ifd_entries]

    buf = bytearray()
    buf += b"II" + struct.pack("<HI", 42, 8)
    buf += struct.pack("<H", len(ifd_entries))
    for tag, typ, cnt, d in ifd_entries:
        buf += struct.pack("<HHI", tag, typ, cnt) + d
    buf += struct.pack("<I", 0)  # no next IFD
    assert len(buf) == data_off, (len(buf), data_off)
    for chnk in out_chunks:
        buf += chnk
    buf += pix

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(buf))
