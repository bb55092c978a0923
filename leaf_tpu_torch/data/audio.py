"""Audio IO: file and in-memory waveform loading with cropped reads,
tile-padding, and the robust fallback chain.

A copy of ``leaf_tpu.data.audio`` (numpy only), kept in the port so that
the port imports nothing of the JAX package. Capability parity with reference utilities/data/utils.py:88-166
(``load_audio`` / ``load_audio_bytes``): optional random-offset cropped
reads, min-duration tile-padding, cropped-read RuntimeError → full-read
fallback → None on catastrophic failure.

Backends: soundfile when available (the reference's choice — ">3x faster
than torchaudio sox_io", utils.py:107); otherwise scipy.io.wavfile for WAV
and the stdlib ``wave`` module as a last resort. FLAC/OGG require soundfile.
"""

from __future__ import annotations

import io
import random
from typing import Optional

import numpy as np

try:
    import soundfile as _sf
    HAS_SOUNDFILE = True
except ImportError:  # environment without libsndfile
    _sf = None
    HAS_SOUNDFILE = False

if not HAS_SOUNDFILE:
    # import once at module load — scipy.io's first import costs ~0.6 s,
    # which must not land inside the first load_audio call of every worker
    from scipy.io import wavfile as _scipy_wavfile


def _read_wav_scipy(f, frames: int = -1, start: int = 0,
                    dtype: str = "float32"):
    sr, data = _scipy_wavfile.read(f)
    if dtype == "int16":
        if data.dtype != np.int16:  # rare non-16-bit WAV: quantize
            data = _to_int16(_pcm_to_float(data))
    else:
        data = _pcm_to_float(data)
    if frames != -1:
        data = data[start:start + frames]
    elif start:
        data = data[start:]
    return data, sr


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def _to_int16(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


def _read(f, frames: int = -1, start: int = 0, dtype: str = "float32"):
    """Dispatch to soundfile or the scipy WAV fallback. dtype='int16'
    decodes to raw PCM int16 (libsndfile converts natively)."""
    if HAS_SOUNDFILE:
        x, sr = _sf.read(f, frames=frames, start=start,
                         dtype="int16" if dtype == "int16" else "float64")
        return x, sr
    return _read_wav_scipy(f, frames=frames, start=start, dtype=dtype)


def _tile_pad(x: np.ndarray, min_samples: Optional[int]) -> np.ndarray:
    """Repeat short clips up to min_samples (reference: utils.py:112-116)."""
    if min_samples is not None and len(x) < min_samples:
        tile_size = (min_samples // x.shape[0]) + 1
        x = np.tile(x, tile_size)[:min_samples]
    return x


def load_audio(f, sr: int, min_duration: Optional[float] = 5.0,
               read_cropped: bool = False, frames_to_read: int = -1,
               audio_size: Optional[int] = None,
               dtype: str = "float32") -> np.ndarray:
    """Read a mono waveform (T,). Reference: utils.py:88-116.

    dtype='float32' (default) matches the reference exactly;
    dtype='int16' keeps the decoder's raw PCM — 4× smaller in host RAM and
    on the host→device wire; dividing by 32768 on device reproduces the
    float path bit-for-bit for mono 16-bit sources (stereo mixes round to
    the nearest LSB; see leaf_tpu_torch.training.steps.waveform_from_wire).
    """
    min_samples = int(sr * min_duration) if min_duration is not None else None
    if read_cropped:
        assert audio_size
        assert frames_to_read != -1
        if frames_to_read >= audio_size:
            start_idx = 0
        else:
            start_idx = random.randint(0, audio_size - frames_to_read - 1)
        x, clip_sr = _read(f, frames=frames_to_read, start=start_idx,
                           dtype=dtype)
        min_samples = frames_to_read
    else:
        x, clip_sr = _read(f, dtype=dtype)
    if dtype == "int16":
        x = np.asarray(x)
        if x.ndim > 1:  # stereo → mono (average) without leaving int16
            # nearest-int rounding: plain astype truncates toward zero,
            # which would bias the mix vs the float path by up to 1 LSB
            x = np.rint(x.mean(axis=-1, dtype=np.float32))
            x = np.clip(x, -32768, 32767).astype(np.int16)
    else:
        x = np.asarray(x, dtype=np.float32)
        if x.ndim > 1:  # stereo → mono (average), matching sf.read usage
            x = x.mean(axis=-1)
    assert clip_sr == sr, f"sample rate mismatch: file {clip_sr} != cfg {sr}"
    return _tile_pad(x, min_samples)


def load_audio_bytes(buffer: bytes, sr: int,
                     min_duration: Optional[float] = 5.0,
                     read_cropped: bool = False, frames_to_read: int = -1,
                     audio_size: Optional[int] = None) -> Optional[np.ndarray]:
    """In-memory variant with the reference's fallback chain
    (utils.py:119-166): cropped read → RuntimeError → full read + slice →
    None on catastrophic failure."""
    min_samples = int(sr * min_duration) if min_duration is not None else None
    x = None
    if read_cropped:
        assert audio_size
        assert frames_to_read != -1
        if frames_to_read >= audio_size:
            with io.BytesIO(buffer) as buf:
                x, clip_sr = _read(buf)
        else:
            start_idx = random.randint(0, audio_size - frames_to_read - 1)
            load_full = False
            with io.BytesIO(buffer) as buf:
                try:
                    x, clip_sr = _read(buf, frames=frames_to_read,
                                       start=start_idx)
                except (RuntimeError, ValueError):
                    load_full = True
            if load_full:
                with io.BytesIO(buffer) as buf:
                    try:
                        x, clip_sr = _read(buf)
                        x = x[start_idx:start_idx + frames_to_read]
                    except (RuntimeError, ValueError):
                        return None
        min_samples = frames_to_read
    else:
        with io.BytesIO(buffer) as buf:
            try:
                x, clip_sr = _read(buf)
            except (RuntimeError, ValueError):
                return None
    x = np.asarray(x, dtype=np.float32)
    if x.ndim > 1:
        x = x.mean(axis=-1)
    assert clip_sr == sr
    return _tile_pad(x, min_samples)


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Test/fixture helper: write float32 mono (T,) as 16-bit WAV."""
    if HAS_SOUNDFILE:
        _sf.write(path, x, sr)
        return
    from scipy.io import wavfile
    xi = np.clip(x, -1.0, 1.0)
    wavfile.write(path, sr, (xi * 32767.0).astype(np.int16))
