"""OpenEXR 2.0 scanline codec (pure NumPy + zlib).

TPU-native replacement for the reference's vendored tinyexr
(src/ext/tinyexr.{h,cc}, consumed by SampleWriter at rlUtil.h:81-95): reads
and writes single-part scanline EXRs with HALF/FLOAT channels and NONE/ZIP/
ZIPS compression — the exact surface the testsuite needs (Arnold's driver_exr
writes half RGBA zip; goldens at testsuite/mtoa/NNNN/ref/ref.exr).

Host-side I/O only; pixel data crosses into JAX land as plain numpy arrays.

Copied verbatim from rlshaders_tpu/io/exr.py: importing any
module of rlshaders_tpu imports jax, which the torch port must not need.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
PIXEL_UINT = 0
PIXEL_HALF = 1
PIXEL_FLOAT = 2
COMPRESS_NONE = 0
COMPRESS_RLE = 1
COMPRESS_ZIPS = 2  # 1 scanline per chunk
COMPRESS_ZIP = 3   # 16 scanlines per chunk

_DTYPE = {PIXEL_HALF: np.float16, PIXEL_FLOAT: np.float32, PIXEL_UINT: np.uint32}
_SIZE = {PIXEL_HALF: 2, PIXEL_FLOAT: 4, PIXEL_UINT: 4}


def _unpredict(data: np.ndarray) -> np.ndarray:
    """Inverse of the EXR 'predictor' delta coding (mod-256 prefix sum)."""
    d = data.astype(np.int64)
    d[1:] -= 128
    return np.mod(np.cumsum(d), 256).astype(np.uint8)


def _predict(data: np.ndarray) -> np.ndarray:
    d = data.astype(np.int16)
    out = np.empty_like(d)
    out[0] = d[0]
    out[1:] = d[1:] - d[:-1] + 128
    return out.astype(np.uint8)


def _deinterleave(data: np.ndarray) -> np.ndarray:
    n = data.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out


def _interleave(data: np.ndarray) -> np.ndarray:
    n = data.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = data[0::2]
    out[half:] = data[1::2]
    return out


def _zip_decode(raw: bytes, expected: int) -> bytes:
    if len(raw) == expected:
        return raw  # stored uncompressed (compressed was bigger)
    data = np.frombuffer(zlib.decompress(raw), np.uint8).copy()
    return _deinterleave(_unpredict(data)).tobytes()


def _zip_encode(raw: bytes) -> bytes:
    data = _predict(_interleave(np.frombuffer(raw, np.uint8).copy()))
    comp = zlib.compress(data.tobytes(), 6)
    return comp if len(comp) < len(raw) else raw


def _read_attr_str(f) -> str:
    out = b""
    while True:
        c = f.read(1)
        if c == b"\x00" or c == b"":
            return out.decode("latin-1")
        out += c


def read(path: str):
    """Read a single-part scanline EXR.

    Returns (channels: dict[name -> (H, W) float32 array], header: dict).
    """
    with open(path, "rb") as f:
        magic, = struct.unpack("<i", f.read(4))
        if magic != MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        version = struct.unpack("<i", f.read(4))[0]
        if version & 0x200:
            raise NotImplementedError("multi-part EXR not supported")
        if version & 0x800:
            raise NotImplementedError("deep EXR not supported")

        header: dict = {}
        channels: list[tuple[str, int]] = []
        while True:
            name = _read_attr_str(f)
            if not name:
                break
            atype = _read_attr_str(f)
            size, = struct.unpack("<i", f.read(4))
            data = f.read(size)
            if name == "channels":
                pos = 0
                while data[pos] != 0:
                    end = data.index(0, pos)
                    cname = data[pos:end].decode("latin-1")
                    ptype, = struct.unpack_from("<i", data, end + 1)
                    channels.append((cname, ptype))
                    pos = end + 1 + 16
            elif name == "compression":
                header["compression"] = data[0]
            elif name == "dataWindow":
                header["dataWindow"] = struct.unpack("<4i", data)
            elif name == "displayWindow":
                header["displayWindow"] = struct.unpack("<4i", data)
            elif name == "lineOrder":
                header["lineOrder"] = data[0]
            else:
                header[name] = (atype, data)

        xmin, ymin, xmax, ymax = header["dataWindow"]
        width = xmax - xmin + 1
        height = ymax - ymin + 1
        comp = header.get("compression", COMPRESS_NONE)
        if comp not in (COMPRESS_NONE, COMPRESS_ZIPS, COMPRESS_ZIP):
            raise NotImplementedError(f"compression {comp} not supported")
        lines_per_chunk = 16 if comp == COMPRESS_ZIP else 1
        n_chunks = (height + lines_per_chunk - 1) // lines_per_chunk

        f.read(8 * n_chunks)  # offset table (we read sequentially)

        bytes_per_pixel = sum(_SIZE[t] for _, t in channels)
        out = {
            cname: np.empty((height, width), np.float32) for cname, _ in channels
        }
        for _ in range(n_chunks):
            y, nbytes = struct.unpack("<ii", f.read(8))
            raw = f.read(nbytes)
            y0 = y - ymin
            n_lines = min(lines_per_chunk, height - y0)
            expected = n_lines * width * bytes_per_pixel
            if comp == COMPRESS_NONE:
                data = raw
            else:
                data = _zip_decode(raw, expected)
            pos = 0
            for line in range(n_lines):
                for cname, ptype in channels:
                    n = width * _SIZE[ptype]
                    row = np.frombuffer(data[pos : pos + n], _DTYPE[ptype])
                    out[cname][y0 + line] = row.astype(np.float32)
                    pos += n
        return out, header


def read_rgb(path: str) -> np.ndarray:
    """Read R,G,B channels as an (H, W, 3) float32 array sized to the
    DISPLAY window (autocropped files are zero-padded back into place, the
    way Arnold's driver_exr `autocrop on` expects viewers to composite)."""
    ch, hdr = read(path)
    if not all(k in ch for k in ("R", "G", "B")):
        raise KeyError(f"{path}: no RGB channels, found {list(ch)}")
    img = np.stack([ch[k] for k in ("R", "G", "B")], axis=-1)
    dxmin, dymin, dxmax, dymax = hdr.get("displayWindow", hdr["dataWindow"])
    xmin, ymin, xmax, ymax = hdr["dataWindow"]
    if (xmin, ymin, xmax, ymax) == (dxmin, dymin, dxmax, dymax):
        return img
    full = np.zeros((dymax - dymin + 1, dxmax - dxmin + 1, 3), np.float32)
    full[ymin - dymin : ymax - dymin + 1, xmin - dxmin : xmax - dxmin + 1] = img
    return full


def _attr(name: str, atype: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + atype.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def write(
    path: str,
    channels: dict[str, np.ndarray],
    half: bool = True,
    compression: int = COMPRESS_ZIP,
):
    """Write a single-part scanline EXR. Channels are (H, W) float arrays."""
    names = sorted(channels)  # EXR requires alphabetical channel order
    h, w = channels[names[0]].shape
    ptype = PIXEL_HALF if half else PIXEL_FLOAT
    dtype = _DTYPE[ptype]

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    chlist += b"\x00"

    hdr = b""
    hdr += _attr("channels", "chlist", chlist)
    hdr += _attr("compression", "compression", bytes([compression]))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    hdr += _attr("dataWindow", "box2i", box)
    hdr += _attr("displayWindow", "box2i", box)
    hdr += _attr("lineOrder", "lineOrder", b"\x00")
    hdr += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    hdr += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    hdr += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    hdr += b"\x00"

    lines_per_chunk = 16 if compression == COMPRESS_ZIP else 1
    n_chunks = (h + lines_per_chunk - 1) // lines_per_chunk

    planes = {n: np.asarray(channels[n], np.float32).astype(dtype) for n in names}

    chunks = []
    for ci in range(n_chunks):
        y0 = ci * lines_per_chunk
        n_lines = min(lines_per_chunk, h - y0)
        rows = []
        for line in range(n_lines):
            for n in names:
                rows.append(planes[n][y0 + line].tobytes())
        raw = b"".join(rows)
        if compression == COMPRESS_NONE:
            data = raw
        else:
            data = _zip_encode(raw)
        chunks.append((y0, data))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        f.write(hdr)
        offset_pos = f.tell()
        table_size = 8 * n_chunks
        offset = offset_pos + table_size
        offsets = []
        for y0, data in chunks:
            offsets.append(offset)
            offset += 8 + len(data)
        f.write(struct.pack(f"<{n_chunks}q", *offsets))
        for y0, data in chunks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def write_rgb(path: str, img: np.ndarray, half: bool = True):
    """Write an (H, W, 3|4) array as R,G,B[,A] channels."""
    img = np.asarray(img)
    ch = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    if img.shape[-1] > 3:
        ch["A"] = img[..., 3]
    write(path, ch, half=half)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error, the testsuite pass gate metric
    (reference testsuite/runtest.py:220-244, threshold 0.005)."""
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))
