"""io: AVI muxers (pure-Python + native C++), image round-trip.

The reference's video path is Game1.compileVideo -> AviManager/VideoStream
-> avifil32.dll (Avi.cs:175-389).  Both our muxers write the same RIFF/AVI
container; the native one streams.  The strongest check: for identical
frames the two containers must be byte-identical (the native muxer patches
the exact fields the Python one computes up front).
"""

import os
import shutil
import struct

import numpy as np
import pytest

from raytpu.io.avi import AviWriter, NativeAviWriter, _native_lib
from raytpu.io.image import read_image, write_image


def _frames(n=3, h=17, w=23, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _parse_avi(path):
    """Minimal RIFF walk: header fields + decoded '00db' DIB frames."""
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    # avih starts right after 'LIST<sz>hdrlavih<sz>'
    i = data.index(b"avih") + 8
    total_frames = struct.unpack_from("<I", data, i + 16)[0]
    streams = struct.unpack_from("<I", data, i + 24)[0]
    width = struct.unpack_from("<I", data, i + 32)[0]
    height = struct.unpack_from("<I", data, i + 36)[0]
    frames = []
    j = data.index(b"movi") + 4
    while j < len(data) - 8:
        cc = data[j:j + 4]
        sz = struct.unpack_from("<I", data, j + 4)[0]
        if cc == b"idx1":
            break
        if cc in (b"00db", b"00dc"):
            frames.append(data[j + 8:j + 8 + sz])
        j += 8 + sz + (sz % 2)
    return dict(total_frames=total_frames, streams=streams, width=width,
                height=height, frames=frames)


def _dib_to_rgb(buf, w, h):
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(buf, np.uint8).reshape(h, stride)[:, : w * 3]
    return rows.reshape(h, w, 3)[::-1, :, ::-1]


class TestPythonAvi:
    def test_dib_round_trip(self, tmp_path):
        frames = _frames()
        p = str(tmp_path / "t.avi")
        with AviWriter(p, fps=30, codec="DIB ") as w:
            for f in frames:
                w.add_frame(f)
        meta = _parse_avi(p)
        assert meta["total_frames"] == len(frames)
        assert (meta["width"], meta["height"]) == (23, 17)
        for got, want in zip(meta["frames"], frames):
            np.testing.assert_array_equal(_dib_to_rgb(got, 23, 17), want)

    def test_mjpg_frames_are_jpeg(self, tmp_path):
        p = str(tmp_path / "t.avi")
        with AviWriter(p, fps=30, codec="MJPG") as w:
            for f in _frames():
                w.add_frame(f)
        meta = _parse_avi(p)
        assert all(f[:2] == b"\xff\xd8" for f in meta["frames"])  # JPEG SOI

    def test_float_frames_quantized(self, tmp_path):
        p = str(tmp_path / "t.avi")
        with AviWriter(p, fps=30, codec="DIB ") as w:
            w.add_frame(np.full((8, 8, 3), 0.5, np.float32))
        got = _dib_to_rgb(_parse_avi(p)["frames"][0], 8, 8)
        assert np.unique(got).tolist() == [128]


needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None and _native_lib() is None,
    reason="no g++ and no prebuilt libavimux.so",
)


@needs_gxx
class TestNativeAvi:
    def test_builds_and_loads(self):
        assert _native_lib() is not None

    @pytest.mark.parametrize("codec", ["DIB ", "MJPG"])
    def test_byte_identical_to_python(self, tmp_path, codec):
        frames = _frames(n=4)
        p1 = str(tmp_path / "py.avi")
        p2 = str(tmp_path / "cc.avi")
        with AviWriter(p1, fps=30, codec=codec) as w:
            for f in frames:
                w.add_frame(f)
        with NativeAviWriter(p2, 23, 17, fps=30, codec=codec) as w:
            for f in frames:
                w.add_frame(f)
        assert open(p1, "rb").read() == open(p2, "rb").read()

    def test_streaming_dib_round_trip(self, tmp_path):
        frames = _frames(n=5, h=32, w=32, seed=7)
        p = str(tmp_path / "t.avi")
        with NativeAviWriter(p, 32, 32, fps=24, codec="DIB ") as w:
            for f in frames:
                w.add_frame(f)
        meta = _parse_avi(p)
        assert meta["total_frames"] == 5
        for got, want in zip(meta["frames"], frames):
            np.testing.assert_array_equal(_dib_to_rgb(got, 32, 32), want)

    def test_abort_on_exception(self, tmp_path):
        p = str(tmp_path / "t.avi")
        with pytest.raises(ValueError):
            with NativeAviWriter(p, 8, 8, fps=30, codec="DIB ") as w:
                w.add_frame(np.zeros((8, 8, 3), np.uint8))
                raise ValueError("boom")
        # Aborted file exists but is not finalized; no crash on cleanup.
        assert os.path.exists(p)


class TestImageIO:
    def test_png_round_trip(self, tmp_path):
        img = np.random.default_rng(0).random((9, 11, 3)).astype(np.float32)
        p = str(tmp_path / "t.png")
        write_image(p, img)
        back = read_image(p)
        assert back.shape == (9, 11, 3)
        q = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(back, q)


class TestAviAudio:
    """PCM audio track (AudioStream.cs / AviManager.AddAudioStream analog)."""

    def test_audio_track_round_trip(self, tmp_path):
        p = str(tmp_path / "a.avi")
        t = np.arange(4410) / 44100.0
        tone = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
        with AviWriter(p, fps=30, codec="DIB ") as w:
            for f in _frames(2):
                w.add_frame(f)
            w.set_audio(tone, sample_rate=44100)

        data = open(p, "rb").read()
        info = _parse_avi(p)
        assert info["streams"] == 2
        # auds strh: fccType at the second strl.
        i = data.index(b"auds")
        strh = data[i:i + 56]
        scale, rate = struct.unpack_from("<II", strh, 20)
        assert scale == 2 and rate == 44100 * 2  # mono 16-bit PCM
        # strf PCMWAVEFORMAT follows.
        j = data.index(b"strf", i) + 8
        tag, nch, srate, avg, align, bits = struct.unpack_from("<HHIIHH",
                                                               data, j)
        assert (tag, nch, srate, align, bits) == (1, 1, 44100, 2, 16)
        assert avg == 44100 * 2
        # 01wb data chunk round-trips the int16 samples.
        k = data.index(b"01wb") + 8
        sz = struct.unpack_from("<I", data, k - 4)[0]
        pcm = np.frombuffer(data[k:k + sz], "<i2")
        expect = (np.clip(tone, -1, 1) * 32767.0).astype(np.int16)
        np.testing.assert_array_equal(pcm, expect)
        # ...and it is indexed in idx1.
        idx = data.index(b"idx1")
        assert b"01wb" in data[idx:]

    def test_stereo_int16(self, tmp_path):
        p = str(tmp_path / "s.avi")
        pcm = np.stack([np.arange(100, dtype=np.int16),
                        -np.arange(100, dtype=np.int16)], axis=1)
        with AviWriter(p, fps=30, codec="DIB ") as w:
            w.add_frame(_frames(1)[0])
            w.set_audio(pcm, sample_rate=8000)
        data = open(p, "rb").read()
        j = data.index(b"strf", data.index(b"auds")) + 8
        tag, nch, srate, avg, align, bits = struct.unpack_from("<HHIIHH",
                                                               data, j)
        assert (nch, srate, align) == (2, 8000, 4)
        k = data.index(b"01wb") + 8
        sz = struct.unpack_from("<I", data, k - 4)[0]
        got = np.frombuffer(data[k:k + sz], "<i2").reshape(-1, 2)
        np.testing.assert_array_equal(got, pcm)


class TestPngCodec:
    """PNG through the standard library (io/image.py), no PIL."""

    @pytest.mark.parametrize("shape", [(17, 23, 3), (1, 1, 3), (9, 4)])
    def test_roundtrip(self, tmp_path, shape):
        from raytpu.io.image import decode_png, encode_png

        rng = np.random.default_rng(3)
        img = rng.integers(0, 256, size=shape, dtype=np.uint8)
        back = decode_png(encode_png(img))
        want = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        np.testing.assert_array_equal(back, want)

    def test_filtered_rows_decode(self):
        """Scanlines with the Sub, Up, Average and Paeth filters (what
        other encoders write) decode exactly."""
        import zlib

        from raytpu.io.image import decode_png

        rng = np.random.default_rng(4)
        img = rng.integers(0, 256, size=(4, 5, 3)).astype(np.int32)
        flat = img.reshape(4, 15)
        raw = []
        prev = np.zeros(15, np.int32)
        for y, ftype in enumerate((1, 2, 3, 4)):
            cur = flat[y]
            enc = np.zeros(15, np.int32)
            for x in range(15):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                if ftype == 1:
                    pred = a
                elif ftype == 2:
                    pred = b
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                enc[x] = (cur[x] - pred) & 0xFF
            raw.append(bytes([ftype]) + enc.astype(np.uint8).tobytes())
            prev = cur

        def chunk(tag, data):
            return (struct.pack(">I", len(data)) + tag + data
                    + struct.pack(">I", zlib.crc32(tag + data)))

        blob = (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(raw)))
                + chunk(b"IEND", b""))
        np.testing.assert_array_equal(decode_png(blob), img.astype(np.uint8))


class TestCheckpoint:
    """io/checkpoint.py: np.savez of the flattened pytree."""

    def _state(self, scale=1.0):
        import jax.numpy as jnp
        import optax

        params = {"a": jnp.arange(6.0).reshape(2, 3) * scale,
                  "b": jnp.ones((4,), jnp.float32) * scale}
        return params, optax.adam(1e-2).init(params)

    def test_save_restore_roundtrip(self, tmp_path):
        import jax

        from raytpu.io.checkpoint import FitCheckpointer

        ck = FitCheckpointer(str(tmp_path))
        assert ck.restore_latest(self._state()) is None
        ck.save(3, self._state(2.0))
        step, state = ck.restore_latest(self._state())
        assert step == 3
        want = jax.tree.leaves(self._state(2.0))
        got = jax.tree.leaves(state)
        assert jax.tree.structure(state) == jax.tree.structure(
            self._state())
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype

    def test_keeps_newest(self, tmp_path):
        from raytpu.io.checkpoint import FitCheckpointer

        ck = FitCheckpointer(str(tmp_path), keep=2)
        for step in (1, 2, 5):
            ck.save(step, self._state(float(step)))
        assert sorted(os.listdir(tmp_path)) == ["step_00000002.npz",
                                                "step_00000005.npz"]
        assert ck.restore_latest(self._state())[0] == 5

    def test_tree_mismatch_raises(self, tmp_path):
        from raytpu.io.checkpoint import FitCheckpointer

        ck = FitCheckpointer(str(tmp_path))
        ck.save(1, self._state())
        with pytest.raises(ValueError, match="tree structure"):
            ck.restore_latest({"a": np.zeros((2, 3))})
