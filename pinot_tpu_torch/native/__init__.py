"""Chunked compression of raw forward indexes, with a native codec library.

The port's copy of the reference package's chunk codecs (its
native/__init__.py and packer.cpp): a raw single-value forward index is
cut into ``CHUNK_BYTES`` chunks, each compressed alone with zlib, zstd
or lz4, written as ``<col>.fwdz.bin`` (the chunks one after another)
and ``<col>.fwdz.off.npy`` (their byte offsets), the same bytes in both
packages, so a segment either one writes loads in the other.

``packer.cpp`` is compiled with the system ``g++`` at first use into
``pinot_tpu_torch/_build/`` (never beside its source), each codec only
where its library links (``codec_probe``). A codec compiled out, or no
toolchain at all, falls back to Python: zlib from the standard library,
zstd through the ``zstandard`` package where it is installed, lz4 through
a pure-Python block codec (literal-only when it compresses). Decoding
stays on the host, at load, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

import numpy as np

log = logging.getLogger("pinot_tpu_torch.native")

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "packer.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

CHUNK_BYTES = 1 << 18  # 256 KiB uncompressed per chunk
CHUNK_CODECS = ("zlib", "zstd", "lz4")

_lock = threading.Lock()
_lib = None
_lib_tried = False
_probed: dict | None = None

# per codec: link flags and a program that links only where it is present
# (liblz4 often ships only its versioned .so and no header: packer.cpp
# declares the stable ABI itself, so lz4 is probed link-only)
_LZ4_MAIN = ('extern "C" int LZ4_compressBound(int);\n'
             "int main(){return LZ4_compressBound(1) > 0 ? 0 : 1;}")
_PROBES = {
    "zlib": [(["-lz"], "#include <zlib.h>\nint main(){return 0;}")],
    "zstd": [(["-lzstd"], "#include <zstd.h>\nint main(){return 0;}")],
    "lz4": [(["-l:liblz4.so.1"], _LZ4_MAIN), (["-llz4"], _LZ4_MAIN)],
}
_NO_DEFINE = {"zlib": "PINOT_NO_ZLIB", "zstd": "PINOT_NO_ZSTD",
              "lz4": "PINOT_NO_LZ4"}


def _links(flags, text) -> bool:
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "probe.cpp")
        with open(src, "w") as f:
            f.write(text)
        try:
            subprocess.run(["g++", "-o", os.path.join(td, "probe"), src]
                           + flags, check=True, capture_output=True,
                           timeout=60)
            return True
        except Exception:  # noqa: BLE001 — a feature probe
            return False


def codec_probe() -> dict:
    """codec -> the link flags its native form builds with, or None
    where its library does not link here (probed once a process)."""
    global _probed
    if _probed is None:
        out = {}
        for codec, tries in _PROBES.items():
            out[codec] = next((flags for flags, text in tries
                               if _links(flags, text)), None)
        _probed = out
    return _probed


def _lib_path(extra: list) -> str:
    """The library's path under ``BUILD_DIR``, keyed by its source and
    its build flags (a changed source or codec set builds anew)."""
    digest = hashlib.sha256()
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(extra).encode())
    return os.path.join(BUILD_DIR,
                        f"libpinot_packer-{digest.hexdigest()[:16]}.so")


def _build_flags() -> list:
    extra = []
    for codec, flags in codec_probe().items():
        extra += flags if flags is not None else [f"-D{_NO_DEFINE[codec]}"]
    return extra


def _compile(path: str, extra: list) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a pid-suffixed temp, then os.replace: processes racing through a
    # fresh checkout never load a half-written library
    tmp = f"{path}.{os.getpid()}"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
                       + extra, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except Exception as e:  # noqa: BLE001 — the Python codecs serve
        log.warning("codec library build failed (%s) with %s", e, extra)
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return False


_CHUNK_ARGS = [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
               ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
               ctypes.POINTER(ctypes.c_int64)]


def _load():
    """ctypes handle on the codec library, or None (the Python codecs).
    ``PINOT_TPU_NO_NATIVE=1`` forces the Python codecs, checked per call,
    as in the reference."""
    global _lib, _lib_tried
    if os.environ.get("PINOT_TPU_NO_NATIVE", "") not in ("", "0"):
        return None
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            extra = _build_flags()
            path = _lib_path(extra)
            if not os.path.exists(path) and not _compile(path, extra):
                return None
            lib = ctypes.CDLL(path)
            for fn in ("inflate_chunks", "zstd_decompress_chunks",
                       "lz4_decompress_chunks"):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = _CHUNK_ARGS
                    getattr(lib, fn).restype = ctypes.c_int
            if hasattr(lib, "zstd_compress_chunk"):
                lib.zstd_compress_chunk.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.c_int]
                lib.zstd_compress_chunk.restype = ctypes.c_int64
                lib.zstd_bound.argtypes = [ctypes.c_int64]
                lib.zstd_bound.restype = ctypes.c_int64
            if hasattr(lib, "lz4_compress_chunk"):
                lib.lz4_compress_chunk.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
                lib.lz4_compress_chunk.restype = ctypes.c_int64
                lib.lz4_bound.argtypes = [ctypes.c_int64]
                lib.lz4_bound.restype = ctypes.c_int64
            _lib = lib
        except Exception as e:  # noqa: BLE001
            log.warning("codec library load failed (%s); Python codecs", e)
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def library_path() -> str | None:
    """Where the loaded codec library lives, or None."""
    lib = _load()
    return None if lib is None else lib._name


def _has_zstandard() -> bool:
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return False
    return True


def available_codecs() -> dict:
    """codec -> how this build writes and reads it: "native", "python"
    (zlib's standard library, zstandard, the pure-Python lz4), or None
    where it cannot (zstd without its library or package)."""
    lib = _load()
    out = {"zlib": "native" if lib is not None
           and hasattr(lib, "inflate_chunks") else "python"}
    out["zstd"] = "native" if lib is not None and hasattr(
        lib, "zstd_compress_chunk") else "python" if _has_zstandard() \
        else None
    out["lz4"] = "native" if lib is not None and hasattr(
        lib, "lz4_compress_chunk") else "python"
    return out


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _lz4_compress_py(src: bytes) -> bytes:
    """One literal-only LZ4 block (a valid block with no match): what the
    build writes where the native library is absent."""
    out = bytearray()
    n = len(src)
    token_lit = min(n, 15)
    out.append(token_lit << 4)
    if token_lit == 15:
        rem = n - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += src
    return bytes(out)


def _lz4_decompress_py(src: bytes, expected: int) -> bytes:
    """A pure-Python LZ4 block decoder."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i: i + lit]
        i += lit
        if i >= n:
            break  # the last sequence carries no match
        off = src[i] | (src[i + 1] << 8)
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - off
        if start < 0:
            raise ValueError("corrupt LZ4 block (offset before start)")
        for _ in range(ml):   # byte-wise: a match may overlap itself
            out.append(out[start])
            start += 1
    if len(out) != expected:
        raise ValueError(
            f"corrupt LZ4 block ({len(out)} bytes, expected {expected})")
    return bytes(out)


def _compress_chunk(raw: bytes, codec: str, lib) -> bytes:
    if codec == "zlib":
        import zlib

        return zlib.compress(raw, 6)
    if codec == "zstd":
        if _has_zstandard():
            import zstandard

            return zstandard.ZstdCompressor(level=3).compress(raw)
        if lib is not None and hasattr(lib, "zstd_compress_chunk"):
            cap = int(lib.zstd_bound(len(raw)))
            dst = np.empty(max(cap, 64), dtype=np.uint8)
            src = np.frombuffer(raw, dtype=np.uint8)
            n = lib.zstd_compress_chunk(
                _ptr(src, ctypes.c_uint8), ctypes.c_int64(len(raw)),
                _ptr(dst, ctypes.c_uint8), ctypes.c_int64(len(dst)),
                ctypes.c_int(3))
            if n < 0:
                raise ValueError("zstd compression failed")
            return dst[:n].tobytes()
        raise RuntimeError(
            "zstd codec needs the zstandard package or the native library")
    if codec == "lz4":
        if lib is not None and hasattr(lib, "lz4_compress_chunk"):
            cap = int(lib.lz4_bound(len(raw))) if raw else 64
            dst = np.empty(max(cap, 64), dtype=np.uint8)
            src = np.frombuffer(raw, dtype=np.uint8) if raw \
                else np.empty(0, dtype=np.uint8)
            n = lib.lz4_compress_chunk(
                _ptr(src, ctypes.c_uint8), ctypes.c_int64(len(raw)),
                _ptr(dst, ctypes.c_uint8), ctypes.c_int64(len(dst)))
            if n > 0:
                return dst[:n].tobytes()
        return _lz4_compress_py(raw)
    raise ValueError(f"unknown chunk codec {codec!r} (use {CHUNK_CODECS})")


def compress_chunks(data: np.ndarray,
                    codec: str = "zlib") -> tuple[np.ndarray, np.ndarray]:
    """Raw little-endian bytes -> (the compressed chunks one after
    another, their offsets[n_chunks + 1])."""
    lib = _load()
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1).tobytes()
    pieces = [raw[i: i + CHUNK_BYTES]
              for i in range(0, len(raw), CHUNK_BYTES)] or [b""]
    chunks = [_compress_chunk(p, codec, lib) for p in pieces]
    offsets = np.zeros(len(chunks) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    return np.frombuffer(b"".join(chunks), dtype=np.uint8), offsets


_NATIVE_DECOMPRESS = {"zlib": "inflate_chunks",
                      "zstd": "zstd_decompress_chunks",
                      "lz4": "lz4_decompress_chunks"}


def _decompress_chunk_py(buf: bytes, codec: str, expected: int) -> bytes:
    if codec == "zlib":
        import zlib

        return zlib.decompress(buf)
    if codec == "zstd":
        if not _has_zstandard():
            raise RuntimeError(
                "loading a zstd-compressed segment needs the zstandard "
                "package or the native library")
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            buf, max_output_size=max(expected, 1))
    if codec == "lz4":
        return _lz4_decompress_py(buf, expected)
    raise ValueError(f"unknown chunk codec {codec!r} (use {CHUNK_CODECS})")


def decompress_chunks(blob: np.ndarray, offsets: np.ndarray,
                      total_bytes: int, codec: str = "zlib") -> np.ndarray:
    """(compressed chunks, offsets) -> the uncompressed uint8 array of
    ``total_bytes``; a corrupt or truncated blob raises ValueError."""
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_chunks = len(offsets) - 1
    out = np.empty(total_bytes, dtype=np.uint8)
    if total_bytes == 0:
        return out
    fn_name = _NATIVE_DECOMPRESS.get(codec)
    if fn_name is None:
        raise ValueError(f"unknown chunk codec {codec!r} (use {CHUNK_CODECS})")
    if n_chunks < 1 or offsets[0] != 0 or offsets[-1] > len(blob) \
            or (np.diff(offsets) < 0).any() \
            or n_chunks * CHUNK_BYTES < total_bytes:
        raise ValueError(f"corrupt compressed forward index ({codec}: "
                         f"offsets do not fit a {len(blob)}-byte blob)")
    dst_off = np.minimum(
        np.arange(n_chunks + 1, dtype=np.int64) * CHUNK_BYTES, total_bytes)
    lib = _load()
    if lib is not None and hasattr(lib, fn_name):
        rc = getattr(lib, fn_name)(
            _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            ctypes.c_int64(n_chunks), _ptr(out, ctypes.c_uint8),
            _ptr(dst_off, ctypes.c_int64))
        if rc != 0:
            raise ValueError(
                f"corrupt compressed forward index ({codec} rc={rc})")
        return out
    buf = blob.tobytes()
    pos = 0
    for c in range(n_chunks):
        expected = int(dst_off[c + 1] - dst_off[c])
        try:
            chunk = _decompress_chunk_py(
                buf[offsets[c]: offsets[c + 1]], codec, expected)
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"corrupt compressed forward index ({codec}: {e})") from e
        except Exception as e:  # noqa: BLE001 — zlib.error, ZstdError
            if isinstance(e, RuntimeError):
                raise
            raise ValueError(
                f"corrupt compressed forward index ({codec}: {e})") from e
        if len(chunk) != expected:
            raise ValueError(f"corrupt compressed forward index ({codec}: "
                             f"chunk {c} is {len(chunk)} bytes, expected "
                             f"{expected})")
        out[pos: pos + len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
        pos += len(chunk)
    return out
