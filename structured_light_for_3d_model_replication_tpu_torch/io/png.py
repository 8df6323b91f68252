"""PNG read and write with the standard library's zlib and numpy only.

The frame loader prefers cv2, then PIL; a host with neither still reads a
capture folder of PNG frames through ``read_pngs``. It takes 8-bit non-interlaced images of colour type 0 (gray),
2 (RGB), 4 (gray + alpha) and 6 (RGBA) with any of the five row filters:
an image whose rows are all None or all Sub is undone in one numpy pass,
rows filtered only with None, Sub or Up a row at a time, and any image
with Average or Paeth rows (what libpng's and PIL's adaptive filtering
write) in one vector step a diagonal of pixels. ``write_png`` writes 8-bit
gray or RGB, each row with the filter libpng's default heuristic picks.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["pixels", "read_png", "read_pngs", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter_rows(rows: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """One image's rows: all None or all Sub in one numpy pass, else rows
    filtered with None, Sub or Up a row at a time."""
    kinds = rows[:, 0]
    if (kinds == 1).all():   # every row Sub (``write_png``'s default): one cumulative sum
        return np.cumsum(rows[:, 1:].reshape(h, -1, bpp), axis=1,
                         dtype=np.uint8).reshape(h, stride)
    if (kinds == 0).all():
        return rows[:, 1:].copy()
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            out[r] = line
        elif kind == 1:
            out[r] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[r] = line + prev
        prev = out[r]
    return out


def _unfilter_diagonals(rows: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """N images of one shape, any mix of the five filters: u8 [N, h,
    stride + 1] filtered rows -> [N, h, stride].

    Pixel (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), all on earlier
    anti-diagonals, so diagonal t = y + x is one vector step over every
    image: W + H - 1 steps in all. The pixels lie in a zero-padded [h+1,
    W+1] grid, flattened, with the images' bytes innermost: pixel (y, x) at
    (y + 1)(W + 1) + x + 1, so a diagonal is a slice of step W, and its
    left, upper and upper-left neighbours are the slices 1, W + 1 and W + 2
    before it (the pad reads as 0 at the image's edges)."""
    n, w = rows.shape[0], stride // bpp
    lanes = n * bpp
    kinds = np.repeat(rows[:, :, 0].T.astype(np.intp), bpp, axis=1)   # [h, lanes]
    filt = np.zeros((h + 1, w + 1, lanes), np.int16)
    filt[1:, 1:] = rows[:, :, 1:].reshape(n, h, w, bpp).transpose(1, 2, 0, 3).reshape(
        h, w, lanes)
    filt = filt.reshape(-1, lanes)
    d = np.zeros_like(filt)
    for t in range(w + h - 1):
        y0, y1 = max(0, t - w + 1), min(h, t + 1)
        i0 = (y0 + 1) * w + t + 2
        i1 = i0 + (y1 - y0 - 1) * w + 1
        a = d[i0 - 1:i1 - 1:w]
        b = d[i0 - w - 1:i1 - w - 1:w]
        c = d[i0 - w - 2:i1 - w - 2:w]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[y0:y1], (0, a, b, (a + b) >> 1, paeth))
        d[i0:i1:w] = (filt[i0:i1:w] + pred) & 0xFF
    out = d.reshape(h + 1, w + 1, n, bpp)[1:, 1:].transpose(2, 0, 1, 3)
    return out.astype(np.uint8).reshape(n, h, stride)


def _inflate(path: str) -> tuple[np.ndarray, int]:
    """A PNG file -> its filtered rows u8 [H, W * channels + 1], channels."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise IOError(f"not a PNG file: {path}")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise IOError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise IOError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are read here "
                      f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise IOError(f"{path}: truncated image data")
    rows = raw.reshape(h, w * ch + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {int(rows[:, 0].max())} is not one of 0..4")
    return rows, ch


def pixels(img: np.ndarray, gray: bool = True) -> np.ndarray:
    """Unfiltered u8 [H, W, channels] -> [H, W] luminance (``gray``, PIL's
    ``L`` weights) or [H, W, 3] RGB; alpha is dropped."""
    ch = img.shape[-1]
    if ch in (2, 4):
        img = img[..., :ch - 1]
    if img.shape[-1] == 1:
        return img[..., 0] if gray else np.repeat(img, 3, axis=-1)
    if not gray:
        return np.ascontiguousarray(img)
    rgb = img.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def read_pngs(paths: list[str], io_workers: int | None = None) -> list[np.ndarray]:
    """PNG files -> their unfiltered pixels, u8 [H, W, channels] each (see
    ``pixels``). Files are inflated on ``io_workers`` threads; the images
    that need the diagonal sweep (Average or Paeth rows) and share a shape
    are undone in one sweep together."""
    if io_workers and io_workers > 1 and len(paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=io_workers) as pool:
            inflated = list(pool.map(_inflate, paths))
    else:
        inflated = [_inflate(p) for p in paths]
    out: list = [None] * len(paths)
    groups: dict[tuple, list[int]] = {}
    for i, (rows, ch) in enumerate(inflated):
        h, stride = rows.shape[0], rows.shape[1] - 1
        if rows[:, 0].max(initial=0) <= 2:
            out[i] = _unfilter_rows(rows, h, stride, ch).reshape(h, -1, ch)
        else:
            groups.setdefault(rows.shape + (ch,), []).append(i)
    for (h, width, ch), idx in groups.items():
        imgs = _unfilter_diagonals(np.stack([inflated[i][0] for i in idx]), h, width - 1, ch)
        for i, img in zip(idx, imgs):
            out[i] = img.reshape(h, -1, ch)
    return out


def read_png(path: str, gray: bool = True) -> np.ndarray:
    """A PNG file -> u8 [H, W] (``gray``: luminance, PIL's ``L`` weights)
    or [H, W, 3] RGB. Alpha is dropped."""
    return pixels(read_pngs([path])[0], gray)


def _filtered(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The five PNG filters of every row: int16 [5, H, stride] residuals."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])


def write_png(path: str, img: np.ndarray, level: int = 1) -> np.ndarray:
    """Write u8 [H, W] (gray) or [H, W, 3] (RGB) as an 8-bit PNG, deflated
    at zlib ``level``, each row with the filter whose residuals, read as
    signed bytes, have the least sum of magnitudes (libpng's default
    heuristic; the first such filter on a tie). Returns the rows' filter
    types (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[-1] == 3:
        ctype, ch = 2, 3
    else:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3] u8, got {img.shape}")
    h, w = img.shape[:2]
    res = (_filtered(img.reshape(h, w * ch), ch) & 0xFF).astype(np.uint8)
    kinds = np.abs(res.view(np.int8).astype(np.int32)).sum(axis=2).argmin(axis=0)
    body = res[kinds, np.arange(h)]
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], body], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(chunk(b"IEND", b""))
    return kinds.astype(np.uint8)
