"""AVI video muxer — replaces the reference's avifil32.dll P/Invoke layer.

The reference's only native boundary is the third-party AviFile wrapper
(aviFileWrapper_src/Avi.cs:175-389, ~25 ``DllImport("avifil32.dll")`` entry
points) used by ``Game1.compileVideo`` to stitch per-frame bitmaps into an
AVI at 30 fps (Game1.cs:192-210, VideoStream.AddFrame,
VideoStream.cs:344-365).  avifil32 is Windows-only; this module writes the
RIFF/AVI container directly, with two codecs:

- ``"DIB "`` (default): uncompressed bottom-up BGR24, bit-equivalent to
  what ``AVIStreamWrite`` received from the locked bitmaps.
- ``"MJPG"``: frames JPEG-encoded via PIL (optional dependency) — small
  files, playable everywhere.

A C++ implementation of the same muxer lives in ``native/`` (built via
ctypes) for the zero-copy high-throughput path; this pure-Python one is the
always-available fallback and the semantic reference.
"""

from __future__ import annotations

import io as _io
import struct
from typing import List, Optional

import numpy as np


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


def _jpeg(arr: np.ndarray, quality: int) -> bytes:
    """JPEG-encode one (H, W, 3) uint8 frame for the MJPG codec."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            'the MJPG codec needs PIL (Pillow) to encode JPEG frames; '
            'use codec="DIB " (uncompressed) without it') from e
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class AviWriter:
    """Streaming AVI writer (AviManager + VideoStream analog).

    Usage::

        with AviWriter(path, fps=30) as w:
            for frame in frames:          # (H, W, 3) uint8 RGB
                w.add_frame(frame)
    """

    def __init__(self, path: str, fps: float = 30.0, codec: str = "DIB ",
                 quality: int = 90):
        if codec not in ("MJPG", "DIB "):
            raise ValueError(f"unsupported codec {codec!r}")
        self.path = path
        self.fps = fps
        self.codec = codec
        self.quality = quality
        self._frames: List[bytes] = []
        self._wh: Optional[tuple] = None
        self._audio: Optional[tuple] = None

    def set_audio(self, samples, sample_rate: int = 44100) -> None:
        """Attach a PCM audio track (the AudioStream/AddAudioStream analog,
        AudioStream.cs:22-124, AviManager.AddAudioStream).

        ``samples``: (N,) mono or (N, channels) — int16, or float in
        [-1, 1] (converted).  Written as an ``auds`` stream with a
        PCMWAVEFORMAT header (Avi.cs PCMWAVEFORMAT) next to the video
        stream; one ``01wb`` data chunk, indexed in idx1."""
        arr = np.asarray(samples)
        if arr.dtype != np.int16:
            arr = (np.clip(arr, -1.0, 1.0) * 32767.0).astype(np.int16)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2:
            raise ValueError("samples must be (N,) or (N, channels)")
        self._audio = (np.ascontiguousarray(arr.astype("<i2")),
                       int(sample_rate))

    # -- frame ingestion ----------------------------------------------------
    def add_frame(self, frame) -> None:
        """Append an (H, W, 3) RGB frame (uint8 or float [0, 1])."""
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3), got {arr.shape}")
        h, w = arr.shape[:2]
        if self._wh is None:
            self._wh = (w, h)
        elif self._wh != (w, h):
            raise ValueError("frame size changed mid-stream")
        if self.codec == "MJPG":
            self._frames.append(_jpeg(arr, self.quality))
        else:
            # Bottom-up BGR24 rows padded to 4 bytes (the DIB layout
            # VideoStream.AddFrame fed to AVIStreamWrite).
            bgr = arr[::-1, :, ::-1]
            stride = (w * 3 + 3) & ~3
            if stride != w * 3:
                padded = np.zeros((h, stride), np.uint8)
                padded[:, : w * 3] = bgr.reshape(h, -1)
                self._frames.append(padded.tobytes())
            else:
                self._frames.append(bgr.tobytes())

    # -- container ----------------------------------------------------------
    def close(self) -> None:
        if self._wh is None:
            raise ValueError("no frames written")
        w, h = self._wh
        n = len(self._frames)
        rate = int(round(self.fps * 1000))
        scale = 1000
        uncompressed = self.codec == "DIB "
        frame_size = ((w * 3 + 3) & ~3) * h if uncompressed else max(
            len(f) for f in self._frames
        )

        # avih: MainAVIHeader (AVIFILEINFO analog, Avi.cs:120-139).
        n_streams = 2 if self._audio is not None else 1
        avih = struct.pack(
            "<14I",
            int(1_000_000 / self.fps),  # dwMicroSecPerFrame
            frame_size * int(self.fps),  # dwMaxBytesPerSec
            0,  # dwPaddingGranularity
            0x10,  # dwFlags: AVIF_HASINDEX
            n,  # dwTotalFrames
            0,  # dwInitialFrames
            n_streams,  # dwStreams
            frame_size,  # dwSuggestedBufferSize
            w, h, 0, 0, 0, 0,
        )
        # strh: AVISTREAMINFO analog (Avi.cs:76-96).
        strh = struct.pack(
            "<4s4sIHHIIIIIIII4i",
            _fourcc("vids"), _fourcc(self.codec), 0, 0, 0, 0,
            scale, rate, 0, n, frame_size, 0xFFFFFFFF, 0,
            0, 0, w, h,
        )
        # strf: BITMAPINFOHEADER (Avi.cs:50-62).
        compression = 0 if uncompressed else struct.unpack("<I", _fourcc("MJPG"))[0]
        strf = struct.pack(
            "<IiiHHIIiiII",
            40, w, h, 1, 24, compression, frame_size, 0, 0, 0, 0,
        )

        def chunk(cc, payload):
            pad = b"\x00" if len(payload) % 2 else b""
            return _fourcc(cc) + struct.pack("<I", len(payload)) + payload + pad

        def lst(cc, payload):
            body = _fourcc(cc) + payload
            return _fourcc("LIST") + struct.pack("<I", len(body)) + body

        strl = lst("strl", chunk("strh", strh) + chunk("strf", strf))
        hdrl_body = chunk("avih", avih) + strl

        audio_bytes = b""
        if self._audio is not None:
            # auds stream: AVISTREAMINFO + PCMWAVEFORMAT
            # (AviManager.AddAudioStream / Avi.cs PCMWAVEFORMAT).
            pcm, srate = self._audio
            nch = pcm.shape[1]
            block_align = 2 * nch
            avg_bps = srate * block_align
            audio_bytes = pcm.tobytes()
            strh_a = struct.pack(
                "<4s4sIHHIIIIIIII4i",
                _fourcc("auds"), b"\x00" * 4, 0, 0, 0, 0,
                block_align,  # dwScale
                avg_bps,  # dwRate
                0,
                pcm.shape[0],  # dwLength in samples
                avg_bps,  # dwSuggestedBufferSize
                0xFFFFFFFF,
                block_align,  # dwSampleSize
                0, 0, 0, 0,
            )
            strf_a = struct.pack(
                "<HHIIH", 1, nch, srate, avg_bps, block_align
            ) + struct.pack("<H", 16)  # wBitsPerSample
            hdrl_body += lst("strl", chunk("strh", strh_a)
                             + chunk("strf", strf_a))
        hdrl = lst("hdrl", hdrl_body)

        # movi chunks + idx1 index (AVIF_HASINDEX).
        movi_body = b""
        index = b""
        offset = 4  # offsets are relative to the start of 'movi'
        cc = "00db" if uncompressed else "00dc"
        for f in self._frames:
            c = chunk(cc, f)
            index += _fourcc(cc) + struct.pack("<III", 0x10, offset, len(f))
            movi_body += c
            offset += len(c)
        if audio_bytes:
            c = chunk("01wb", audio_bytes)
            index += _fourcc("01wb") + struct.pack(
                "<III", 0x10, offset, len(audio_bytes))
            movi_body += c
            offset += len(c)
        movi = lst("movi", movi_body)
        idx1 = chunk("idx1", index)

        riff_body = _fourcc("AVI ") + hdrl + movi + idx1
        with open(self.path, "wb") as fh:
            fh.write(_fourcc("RIFF") + struct.pack("<I", len(riff_body)) + riff_body)
        self._frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None and self._wh is not None:
            self.close()


_NATIVE_LIB = None
_NATIVE_TRIED = False


def _native_lib():
    """Load (building on demand) native/libavimux.so, or None.

    The C++ muxer is the streaming replacement for the avifil32.dll
    interop (native/avimux.cc); this Python module stays the always-
    available fallback and the semantic reference.
    """
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    import ctypes
    import os
    import subprocess

    root = os.path.join(os.path.dirname(__file__), "..", "..", "native")
    root = os.path.abspath(root)
    so = os.path.join(root, "libavimux.so")
    src = os.path.join(root, "avimux.cc")
    if not os.path.exists(so) and os.path.exists(src):
        try:
            subprocess.run(
                ["g++", "-O2", "-Wall", "-fPIC", "-shared", src, "-o", so],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.avimux_open.restype = ctypes.c_void_p
    lib.avimux_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_double, ctypes.c_int]
    lib.avimux_add_frame_rgb.restype = ctypes.c_int
    lib.avimux_add_frame_rgb.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.avimux_add_frame_jpeg.restype = ctypes.c_int
    lib.avimux_add_frame_jpeg.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint32]
    lib.avimux_close.restype = ctypes.c_int
    lib.avimux_close.argtypes = [ctypes.c_void_p]
    lib.avimux_abort.restype = None
    lib.avimux_abort.argtypes = [ctypes.c_void_p]
    _NATIVE_LIB = lib
    return lib


class NativeAviWriter:
    """Streaming AVI writer backed by native/libavimux.so.

    Same interface as :class:`AviWriter` but constant-memory: frames go
    straight to disk (the C++ side converts RGB to the container's
    bottom-up BGR for "DIB "; "MJPG" frames are JPEG-encoded here and
    passed through).  Frame size is fixed at construction.
    """

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0,
                 codec: str = "DIB ", quality: int = 90):
        if codec not in ("MJPG", "DIB "):
            raise ValueError(f"unsupported codec {codec!r}")
        lib = _native_lib()
        if lib is None:
            raise RuntimeError("libavimux.so unavailable (g++ missing?)")
        self._lib = lib
        self.codec = codec
        self.quality = quality
        self._wh = (width, height)
        self._h = lib.avimux_open(path.encode(), width, height,
                                  float(fps), 0 if codec == "DIB " else 1)
        if not self._h:
            raise OSError(f"avimux_open failed for {path!r}")

    def add_frame(self, frame) -> None:
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.shape[:2][::-1] != self._wh or arr.shape[2] != 3:
            raise ValueError(f"expected {self._wh[::-1] + (3,)}, got {arr.shape}")
        if self.codec == "DIB ":
            rc = self._lib.avimux_add_frame_rgb(
                self._h, np.ascontiguousarray(arr).tobytes()
            )
        else:
            data = _jpeg(arr, self.quality)
            rc = self._lib.avimux_add_frame_jpeg(self._h, data, len(data))
        if rc != 0:
            raise OSError(f"avimux add_frame failed ({rc})")

    def close(self) -> None:
        if self._h:
            rc = self._lib.avimux_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"avimux_close failed ({rc})")

    def abort(self) -> None:
        if self._h:
            self._lib.avimux_abort(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self.abort()


def open_avi(path: str, width: int, height: int, fps: float = 30.0,
             codec: str = "DIB ", quality: int = 90):
    """Best AVI writer available: native streaming muxer, else pure Python."""
    try:
        return NativeAviWriter(path, width, height, fps=fps, codec=codec,
                               quality=quality)
    except (RuntimeError, OSError):
        return AviWriter(path, fps=fps, codec=codec, quality=quality)


def compile_video(frame_paths, out_path: str, fps: float = 30.0,
                  codec: str = "DIB ") -> None:
    """Stitch image files into an AVI (Game1.compileVideo, Game1.cs:192-210)."""
    from raytpu.io.image import read_image

    with AviWriter(out_path, fps=fps, codec=codec) as w:
        for p in frame_paths:
            w.add_frame(read_image(p))
