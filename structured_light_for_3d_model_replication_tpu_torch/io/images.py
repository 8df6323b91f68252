"""Capture-stack image IO + the packed bit-plane codec (``frames.slbp``).

A scan folder holds numbered frames ("01.png".."46.png"): white, black, then
a (pattern, inverse) pair per Gray-code bit. ``load_stack`` reads them into
one uint8 [F, H, W] array in the JAX package's order: the native stack
decoder (``io/native.py``, all frames on a thread pool) when it is built,
else cv2, else PIL, else the port's own PNG reader (``io/png.py``, which
undoes a stack's frames together); ``save_stack`` writes such a folder of
PNGs (cv2, else PIL, else ``io/png.py``, as the JAX package writes them).

Packed format (the same container the JAX package reads and writes): the
white and black frames verbatim, and each of the P = (F-2)//2 pattern pairs
collapsed to its comparison bit ``pattern > inverse``, packed 8 planes a
byte, LSB first — plane p in byte p//8 at bit p%8 of a u8 [ceil(P/8), H, W]
array. Decode reads exactly these bits, so decoding the planes is
bit-identical to decoding the raw stack. The container is magic + a JSON
header + raw sections, deterministic byte for byte, and needs numpy only.
"""
from __future__ import annotations

import glob
import json
import os
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["list_frame_files", "load_stack", "save_stack", "save_image", "load_gray",
           "load_color",
           "PackedStack", "pack_stack", "unpack_stack", "save_packed_stack",
           "load_packed_stack", "probe_packed", "packed_file", "is_packed_source",
           "count_frames",
           "pack_scan_folder", "PACKED_NAME"]

_EXTS = (".bmp", ".png", ".jpg", ".jpeg", ".ppm", ".pgm")
PACKED_EXT = ".slbp"
PACKED_NAME = "frames" + PACKED_EXT
_PACKED_MAGIC = b"SLBP1\n"


def _own_png_reader() -> bool:
    """Neither cv2 nor PIL imports: PNGs go through ``io/png.py``."""
    for mod in ("cv2", "PIL"):
        try:
            __import__(mod)
            return False
        except ImportError:
            pass
    return True


def _imread(path: str, gray: bool) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            if not path.lower().endswith(".png"):
                raise
            from structured_light_for_3d_model_replication_tpu_torch.io import png

            return png.read_png(path, gray=gray)
        return np.asarray(Image.open(path).convert("L" if gray else "RGB"))
    img = cv2.imread(path, 0 if gray else 1)
    if img is None:
        raise IOError(f"unreadable image: {path}")
    return img if gray else img[:, :, ::-1]  # BGR -> RGB at the IO boundary


def _imwrite(path: str, img: np.ndarray) -> None:
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            if not path.lower().endswith(".png"):
                raise
            from structured_light_for_3d_model_replication_tpu_torch.io import png

            png.write_png(path, img)
            return
        Image.fromarray(img).save(path)
        return
    if not cv2.imwrite(path, img if img.ndim == 2 else img[:, :, ::-1]):
        raise IOError(f"failed to write {path}")


def save_image(path: str, img: np.ndarray) -> None:
    """Write one image; color images are RGB (the IO-boundary convention)."""
    _imwrite(path, np.asarray(img, np.uint8))


def load_gray(path: str) -> np.ndarray:
    return _imread(path, gray=True)


def load_color(path: str) -> np.ndarray:
    """Returns RGB uint8 [H, W, 3]."""
    return _imread(path, gray=False)


def list_frame_files(source) -> list[str]:
    """A scan source (folder or explicit file list) -> sorted frame files.

    A folder holding a packed container resolves to just that file; else
    the first extension (.bmp, .png, …) with any match wins.
    """
    if isinstance(source, (list, tuple)):
        return list(source)
    if not os.path.isdir(source):
        raise FileNotFoundError(f"scan folder not found: {source}")
    packed = os.path.join(source, PACKED_NAME)
    if os.path.isfile(packed):
        return [packed]
    for ext in _EXTS:
        files = sorted(glob.glob(os.path.join(source, f"*{ext}")))
        if files:
            return files
    raise FileNotFoundError(f"no frames ({'/'.join(_EXTS)}) in {source}")


def load_stack(source, expected: int | None = None, io_workers: int | None = None):
    """Load a capture folder/list -> (frames u8 [F,H,W], texture u8 [H,W,3]).

    ``expected``: the capture contract's frame count; a source with fewer
    frames raises ValueError before any frame is decoded. The texture is
    the white frame in color. A packed container unpacks (lossless for
    decode). PNG frames go through the native stack decoder
    when it is built (byte-exact on gray PNGs; on color PNGs its BT.601
    gray may differ from cv2's by one level, as in the JAX package). Else
    ``io_workers`` > 1 decodes the frames on a thread pool; the arrays are
    identical either way.
    """
    from structured_light_for_3d_model_replication_tpu_torch.io import native

    files = list_frame_files(source)
    if len(files) == 1 and files[0].endswith(PACKED_EXT):
        ps = load_packed_stack(files[0])
        if expected is not None and ps.n_frames < expected:
            raise ValueError(f"{source}: expected >= {expected} frames, found {ps.n_frames}")
        return unpack_stack(ps)
    if expected is not None and len(files) < expected:
        raise ValueError(f"{source}: expected >= {expected} frames, found {len(files)}")
    if len(files) < 4:
        raise ValueError(f"{source}: need at least 4 frames, found {len(files)}")
    probe = native.probe_png(files[0])
    stack = None if probe is None else native.load_gray_stack(files, probe[0], probe[1])
    if stack is not None:
        return stack, load_color(files[0])
    if all(f.lower().endswith(".png") for f in files) and _own_png_reader():
        from structured_light_for_3d_model_replication_tpu_torch.io import png

        raw = png.read_pngs(files, io_workers)
        imgs = [png.pixels(img) for img in raw]
        for f, img in zip(files, imgs):
            if img.shape != imgs[0].shape:
                raise ValueError(f"{f}: frame size {img.shape} != {imgs[0].shape}")
        return np.stack(imgs), png.pixels(raw[0], gray=False)
    first = load_gray(files[0])
    frames = np.empty((len(files),) + first.shape, np.uint8)
    frames[0] = first

    def load_into(i: int) -> None:
        img = load_gray(files[i])
        if img.shape != first.shape:
            raise ValueError(f"{files[i]}: frame size {img.shape} != {first.shape}")
        frames[i] = img

    rest = range(1, len(files))
    if io_workers and io_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=io_workers) as pool:
            list(pool.map(load_into, rest))  # re-raises the first error
    else:
        for i in rest:
            load_into(i)
    return frames, load_color(files[0])


def save_stack(folder: str, frames: np.ndarray, ext: str = "png") -> list[str]:
    """Write frames u8 [F, H, W] as numbered images (01.png, 02.png, ...),
    the capture folder layout ``load_stack`` reads."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, frame in enumerate(frames):
        p = os.path.join(folder, f"{i + 1:02d}.{ext}")
        _imwrite(p, np.asarray(frame, np.uint8))
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# Packed bit-plane codec (format in the module docstring)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PackedStack:
    """A Gray-code capture stack collapsed to what decode reads: ``planes``
    u8 [ceil(n_pairs/8), H, W] and the verbatim ``white``/``black`` frames.
    A trailing unpaired frame is not stored; it unpacks as zeros."""

    planes: np.ndarray
    white: np.ndarray
    black: np.ndarray
    n_frames: int
    texture: np.ndarray | None = None

    @property
    def n_pairs(self) -> int:
        return (self.n_frames - 2) // 2

    @property
    def shape(self) -> tuple[int, int, int]:
        """The raw stack's [F, H, W]."""
        return (self.n_frames,) + self.white.shape

    @property
    def nbytes(self) -> int:
        """Wire size: the bytes a device upload of this stack moves."""
        return self.planes.nbytes + self.white.nbytes + self.black.nbytes


def pack_stack(frames: np.ndarray, texture: np.ndarray | None = None) -> PackedStack:
    """Pack a raw [F, H, W] u8 stack to bit-planes (lossless for decode)."""
    frames = np.asarray(frames, np.uint8)
    if frames.ndim != 3 or frames.shape[0] < 4:
        raise ValueError(f"pack_stack: need [F>=4, H, W] u8, got {frames.shape}")
    n_pairs = (frames.shape[0] - 2) // 2
    bits = frames[2:2 + 2 * n_pairs:2] > frames[3:3 + 2 * n_pairs:2]
    planes = np.packbits(bits, axis=0, bitorder="little")
    return PackedStack(planes=planes, white=frames[0].copy(),
                       black=frames[1].copy(), n_frames=int(frames.shape[0]),
                       texture=None if texture is None
                       else np.asarray(texture, np.uint8))


def unpack_stack(ps: PackedStack):
    """Inverse of :func:`pack_stack` up to binarization -> (frames u8
    [F, H, W], texture u8 [H, W, 3]). Pattern frames come back as 255*bit,
    inverse frames as 255*(1-bit), so every ``pattern > inverse`` decode
    compare gives the raw stack's answer. Texture falls back to the white
    frame replicated to RGB."""
    n_pairs = ps.n_pairs
    out = np.zeros((ps.n_frames,) + ps.white.shape, np.uint8)
    out[0] = ps.white
    out[1] = ps.black
    if n_pairs:
        bits = np.unpackbits(ps.planes, axis=0, count=n_pairs,
                             bitorder="little")
        out[2:2 + 2 * n_pairs:2] = bits * np.uint8(255)
        out[3:3 + 2 * n_pairs:2] = (1 - bits) * np.uint8(255)
    texture = ps.texture
    if texture is None:
        texture = np.repeat(ps.white[:, :, None], 3, axis=2)
    return out, texture


def packed_file(source) -> str | None:
    """The packed-container path of a source, or None for a raw source."""
    if isinstance(source, (list, tuple)):
        if len(source) == 1 and str(source[0]).endswith(PACKED_EXT):
            return str(source[0])
        return None
    if source.endswith(PACKED_EXT) and os.path.isfile(source):
        return source
    p = os.path.join(source, PACKED_NAME)
    return p if os.path.isfile(p) else None


def is_packed_source(source) -> bool:
    """True where ``source`` resolves to a packed container."""
    return packed_file(source) is not None


def count_frames(source) -> int:
    """Logical frame count of a source (header only for packed containers)."""
    p = packed_file(source)
    if p is not None:
        hdr = probe_packed(p)
        if hdr is None:
            raise IOError(f"corrupt packed container: {p}")
        return int(hdr["n_frames"])
    return len(list_frame_files(source))


def probe_packed(path: str) -> dict | None:
    """Read just the header of a packed container; None if not one."""
    try:
        with open(path, "rb") as f:
            if f.read(len(_PACKED_MAGIC)) != _PACKED_MAGIC:
                return None
            (hlen,) = struct.unpack("<Q", f.read(8))
            if hlen > 1 << 20:
                return None
            return json.loads(f.read(hlen).decode("utf-8"))
    except (OSError, ValueError, struct.error):
        return None


def save_packed_stack(target: str, ps: PackedStack) -> str:
    """Write a packed container to ``target`` (a .slbp path, or a folder ->
    ``<folder>/frames.slbp``); atomic rename, deterministic bytes."""
    path = target if target.endswith(PACKED_EXT) \
        else os.path.join(target, PACKED_NAME)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = ps.white.shape
    header = {
        "height": int(h),
        "n_frames": int(ps.n_frames),
        "n_planes": int(ps.planes.shape[0]),
        "texture": ps.texture is not None,
        "version": 1,
        "width": int(w),
    }
    blob = json.dumps(header, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_PACKED_MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for sec in (ps.white, ps.black, ps.planes) + (
                () if ps.texture is None else (ps.texture,)):
            f.write(np.ascontiguousarray(sec, np.uint8).tobytes())
    os.replace(tmp, path)
    return path


def load_packed_stack(source) -> PackedStack:
    """Load a packed container from a .slbp path or a folder holding one."""
    path = packed_file(source)
    if path is None:
        raise FileNotFoundError(f"no packed container at {source}")
    with open(path, "rb") as f:
        if f.read(len(_PACKED_MAGIC)) != _PACKED_MAGIC:
            raise IOError(f"bad magic in {path}")
        (hlen,) = struct.unpack("<Q", f.read(8))
        hdr = json.loads(f.read(hlen).decode("utf-8"))
        h, w = int(hdr["height"]), int(hdr["width"])

        def section(shape):
            count = int(np.prod(shape))
            raw = f.read(count)
            if len(raw) != count:
                raise IOError(f"truncated packed container: {path}")
            return np.frombuffer(raw, np.uint8).reshape(shape).copy()

        white = section((h, w))
        black = section((h, w))
        planes = section((int(hdr["n_planes"]), h, w))
        texture = section((h, w, 3)) if hdr.get("texture") else None
    return PackedStack(planes=planes, white=white, black=black,
                       n_frames=int(hdr["n_frames"]), texture=texture)


def pack_scan_folder(folder: str, keep_raw: bool = False) -> str:
    """Pack a captured raw-frame folder in place -> the .slbp path.

    The capture path's ``acquire.pack_frames`` calls it once a view's
    frames have landed: the white frame's color read becomes the
    container's texture, and unless ``keep_raw`` the per-frame images are
    removed, so ``list_frame_files`` resolves to the container alone. The
    bytes equal the JAX package's for the same folder."""
    files = list_frame_files(folder)
    if len(files) == 1 and files[0].endswith(PACKED_EXT):
        return files[0]  # already packed
    frames, texture = load_stack(folder)
    path = save_packed_stack(folder, pack_stack(frames, texture=texture))
    if not keep_raw:
        for p in files:
            try:
                os.remove(p)
            except OSError:
                pass
    return path
