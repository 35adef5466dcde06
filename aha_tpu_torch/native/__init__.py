"""ctypes bindings for the native libav decoder: the port's copy of
``aha_tpu/native/__init__.py`` over its own copy of the C++ source
(``aha_tpu_torch/csrc/decoder.cc``).

The library is built at first use with ``g++`` and ``pkg-config libavformat
libavcodec libavutil libswscale`` into ``build/aha_tpu_torch/`` beside the
package (one build per source hash; written to a temporary name and renamed,
so processes that build at once do not clash). Where it cannot be built (no
compiler, no libav headers) or ``AHA_NATIVE_DECODER=off``, ``available()`` is
False and ``data.media.decode_video`` keeps its cv2 path, whose frame
selection and letterbox the native path reproduces.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "decoder.cc"
BUILD_DIR = _PKG.parent / "build" / "aha_tpu_torch"
LIBS = ("libavformat", "libavcodec", "libavutil", "libswscale")

_lock = threading.Lock()
_lib = None
_tried = False
build_error: str | None = None     # why the library is not there, when it is not


def _build() -> pathlib.Path:
    src = SOURCE.read_bytes()
    out = BUILD_DIR / f"libaha_decoder_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = subprocess.run(["pkg-config", "--cflags", "--libs", *LIBS], check=True,
                           capture_output=True, text=True, timeout=60).stdout.split()
    # the libraries' own directory, so that the loader finds them where it would not look
    flags += [f"-Wl,-rpath,{f[2:]}" for f in flags if f.startswith("-L")]
    libdir = subprocess.run(["pkg-config", "--variable=libdir", LIBS[0]], capture_output=True,
                            text=True, timeout=60).stdout.strip()
    if libdir:
        flags.append(f"-Wl,-rpath,{libdir}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", str(tmp),
                    str(SOURCE), *flags], check=True, capture_output=True, text=True,
                   timeout=300)
    os.replace(tmp, out)
    return out


def _missing(path) -> str:
    """The shared libraries the loader cannot find for ``path`` (ldd), if any."""
    if path is None:
        return ""
    try:
        out = subprocess.run(["ldd", str(path)], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    gone = [line.split()[0] for line in out.splitlines() if "not found" in line]
    return f"; ldd finds no {', '.join(gone)}" if gone else ""


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = None
        try:
            path = _build()
            lib = ctypes.CDLL(str(path))
        except subprocess.CalledProcessError as e:
            build_error = (e.stderr or str(e)).strip().splitlines()[-1:] or [str(e)]
            build_error = build_error[0]
            return None
        except (OSError, FileNotFoundError, subprocess.SubprocessError) as e:
            build_error = str(e) + _missing(path)
            return None
        lib.aha_open.restype = ctypes.c_void_p
        lib.aha_open.argtypes = [ctypes.c_char_p]
        lib.aha_info.restype = ctypes.c_int
        lib.aha_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.aha_decode.restype = ctypes.c_int
        lib.aha_decode.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.aha_close.restype = None
        lib.aha_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """The library is built (or builds now) and not switched off
    (``AHA_NATIVE_DECODER=off``, read at every call)."""
    if os.environ.get("AHA_NATIVE_DECODER", "auto") == "off":
        return False
    return _load() is not None


class NativeVideo:
    """Streaming decoder handle: probe + incremental chunked decode."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native decoder unavailable: {build_error}")
        self._lib = lib
        self._ctx = lib.aha_open(path.encode())
        if not self._ctx:
            raise IOError(f"cannot open video {path}")
        fps, dur = ctypes.c_double(), ctypes.c_double()
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.aha_info(self._ctx, ctypes.byref(fps), ctypes.byref(dur), ctypes.byref(w),
                     ctypes.byref(h))
        self.fps, self.duration = fps.value, dur.value
        self.width, self.height = w.value, h.value

    def decode(self, *, output_fps: float, output_size: int,
               max_frames: int) -> tuple[np.ndarray, list[int]]:
        """Decode the next ``max_frames`` resampled frames (call again for the
        next chunk)."""
        out = np.zeros((max_frames, output_size, output_size, 3), np.uint8)
        idx = np.zeros((max_frames,), np.int32)
        n = self._lib.aha_decode(self._ctx, float(output_fps), int(output_size),
                                 int(max_frames), out.ctypes.data_as(ctypes.c_void_p),
                                 idx.ctypes.data_as(ctypes.c_void_p))
        if n < 0:
            raise IOError(f"decode error {n}")
        return out[:n], [int(i) for i in idx[:n]]

    def close(self):
        if self._ctx:
            self._lib.aha_close(self._ctx)
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def decode_video_native(path: str, *, output_fps: float, output_size: int = 384,
                        max_frames: int | None = None) -> tuple[np.ndarray, list[int]]:
    """The whole video, with ``data.media.decode_video``'s return contract."""
    with NativeVideo(path) as v:
        total = math.floor(v.duration * output_fps) if v.duration > 0 else 1 << 20
        if max_frames is not None:
            total = min(total, max_frames)
        return v.decode(output_fps=output_fps, output_size=output_size, max_frames=total)
