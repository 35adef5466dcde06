"""The port's native libav decoder (aha_tpu_torch/native, its own copy of the
C++ source built with g++ into build/aha_tpu_torch/) against the JAX
package's (aha_tpu/native) on the same clip: frames bit for bit and the same
source indices at several rates, sizes and frame caps, the probe, chunked
decoding, and ``media.decode_video`` taking the native path where it is
built and cv2 for the corruption path and under ``AHA_NATIVE_DECODER=off``.
Skips where libav (or the compiler) is absent."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from aha_tpu import native as jnative

from aha_tpu_torch import native
from aha_tpu_torch.data import media

needs_native = pytest.mark.skipif(not (native.available() and jnative.available()),
                                  reason="libav or g++ absent: no native decoder built")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("nat") / "test.mp4"
    fps, n, size = 10.0, 40, (128, 96)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    rng = np.random.default_rng(0)
    for i in range(n):
        frame = np.zeros((size[1], size[0], 3), np.uint8)
        frame[:, :, 0] = (i * 6) % 256       # B ramp encodes frame index
        frame[10:30, 10:50] = (0, 255, 0)
        frame[40:60, 60:100] = rng.integers(0, 255, (20, 40, 3))
        out.write(frame)
    out.release()
    return str(path)


@needs_native
@pytest.mark.parametrize("fps,size,max_frames", [(2.0, 64, None), (5.0, 32, None),
                                                 (10.0, 48, 7), (3.0, 96, None)])
def test_frames_equal_jax_native(video, fps, size, max_frames):
    got, gi = native.decode_video_native(video, output_fps=fps, output_size=size,
                                         max_frames=max_frames)
    want, wi = jnative.decode_video_native(video, output_fps=fps, output_size=size,
                                           max_frames=max_frames)
    assert gi == wi and len(gi) > 0
    np.testing.assert_array_equal(got, want)


@needs_native
def test_probe_matches_jax(video):
    with native.NativeVideo(video) as v, jnative.NativeVideo(video) as w:
        assert (v.fps, v.duration, v.width, v.height) == (w.fps, w.duration, w.width, w.height)
        assert v.fps == pytest.approx(10.0, rel=0.01) and (v.width, v.height) == (128, 96)


@needs_native
def test_chunked_decode(video):
    full, idx_full = native.decode_video_native(video, output_fps=5.0, output_size=64)
    with native.NativeVideo(video) as v:
        a, ia = v.decode(output_fps=5.0, output_size=64, max_frames=7)
        b, ib = v.decode(output_fps=5.0, output_size=64, max_frames=100)
    np.testing.assert_array_equal(np.concatenate([a, b]), full)
    assert ia + ib == idx_full


@needs_native
def test_media_takes_the_native_path(video, monkeypatch):
    """decode_video: the native frames where the decoder is built; cv2 under
    AHA_NATIVE_DECODER=off and on the corruption path (the same frames
    selected, pixels within the interpolators' difference)."""
    nat, ni = media.decode_video(video, output_fps=2.0, output_size=64)
    ref, ri = native.decode_video_native(video, output_fps=2.0, output_size=64)
    assert ni == ri
    np.testing.assert_array_equal(nat, ref)
    monkeypatch.setenv("AHA_NATIVE_DECODER", "off")
    assert not native.available()
    cv, ci = media.decode_video(video, output_fps=2.0, output_size=64)
    assert ci == ni and np.abs(cv.astype(int) - nat.astype(int)).mean() < 8.0
    monkeypatch.delenv("AHA_NATIVE_DECODER")
    _, di = media.decode_video(video, output_fps=2.0, output_size=64,
                               dropout_intervals=[(100.0, 101.0, "blur")],
                               rng=np.random.default_rng(0))
    assert di == ni


def test_build_is_the_port_own():
    """The library is built from the port's source into build/aha_tpu_torch/,
    never from native/ or its make."""
    assert native.SOURCE.parent.name == "csrc" and native.SOURCE.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "aha_tpu_torch")
    if native.available():
        assert any(native.BUILD_DIR.glob("libaha_decoder_*.so"))
    else:
        assert native.build_error
