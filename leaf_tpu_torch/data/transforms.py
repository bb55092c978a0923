"""Waveform transforms — pure numpy, per-sample, host-side.

A copy of ``leaf_tpu.data.transforms``, kept in the port so that the port
imports nothing of the JAX package: the same draws from the stdlib
``random`` and ``np.random`` in the same order. Capability parity with reference utilities/data/raw_transforms.py: the
combinators (Compose/UseWithProb/OneOf, reference:70-113), crop/pad
(RandomCrop/CenterCrop/PadToSize wrap|constant, reference:120-183),
TimeMasking (186-203), ClipValue (206-214), RandomGain + PeakNormalization
(re-implemented from torch_audiomentations semantics, reference:299-345),
AddGaussianNoise (314-331), background-noise SNR mixing
(BackgroundNoiseGenerator/AddRandomNoise, reference:240-296), SpecAugment
(26-67), and the pipeline factories get_raw_transforms_v2 /
simple_supervised_transforms / leaf_supervised_transforms (347-416).

Signals are numpy float32 ``(T,)`` (the reference carries torch ``(1, T)``).
RandomReverb (reference:217-237, sox via WavAugment) was already disabled as
too slow in the reference (371) and is omitted; raise if requested.
"""

from __future__ import annotations

import bisect
import glob
import os
import random
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = [
    "Compose", "UseWithProb", "OneOf",
    "RandomCrop", "CenterCrop", "PadToSize",
    "TimeMasking", "ClipValue", "RandomGain", "PeakNormalization",
    "AddGaussianNoise", "BackgroundNoiseGenerator", "AddRandomNoise",
    "SpecAugment", "spec_augment",
    "get_raw_transforms_v2", "simple_supervised_transforms",
    "leaf_supervised_transforms", "leaf_host_crop_transforms",
]


# ---------------------------------------------------------------- combinators

class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x, trg=None):
        if trg is None:
            for t in self.transforms:
                x = t(x)
            return x
        for t in self.transforms:
            x, trg = t(x, trg)
        return x, trg


class UseWithProb:
    def __init__(self, transform: Callable, prob: float = 0.5):
        self.transform = transform
        self.prob = prob

    def __call__(self, x, trg=None):
        if trg is None:
            if random.random() < self.prob:
                x = self.transform(x)
            return x
        if random.random() < self.prob:
            x, trg = self.transform(x, trg)
        return x, trg


class OneOf:
    def __init__(self, transforms: Sequence[Callable],
                 p: Optional[Sequence[float]] = None):
        self.transforms = list(transforms)
        self.p = p
        # Draw by inverse-CDF on a cached cumulative: np.random.choice(p=…)
        # costs ~20 µs/call, which was ~2/3 of the host loader's whole
        # per-item time at the flagship shape.
        if p is not None:
            cum = np.cumsum(np.asarray(p, np.float64))
            if abs(cum[-1] - 1.0) > 1e-6:
                raise ValueError(f"OneOf probabilities sum to {cum[-1]}")
            self._cum = cum.tolist()
        else:
            self._cum = None

    def __call__(self, x, trg=None):
        r = random.random()
        if self._cum is None:
            idx = int(r * len(self.transforms))
        else:
            # clamp: float64 cumsum can land just below 1.0 and r can
            # fall in the residual gap
            idx = bisect.bisect_left(self._cum, r)
        idx = min(idx, len(self.transforms) - 1)
        transform = self.transforms[idx]
        if trg is None:
            return transform(x)
        return transform(x, trg)


# ----------------------------------------------------------------- crops/pads

class RandomCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        start = random.randint(0, signal.shape[-1] - self.size)
        return signal[..., start:start + self.size]


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        if signal.shape[-1] > self.size:
            start = (signal.shape[-1] - self.size) // 2
            return signal[..., start:start + self.size]
        return signal


class PadToSize:
    """Center-pad short signals to ``size``. mode='constant' pads with the
    signal min (reference:152-155); 'wrap' tiles circularly (the reference's
    torch path uses replicate-pad as an approximation of np.wrap,
    reference:178-181 — we keep the true wrap semantics of its numpy
    original, PadToSize_NP reference:143-158)."""

    def __init__(self, size: int, mode: str = "constant"):
        assert mode in ("constant", "wrap")
        self.size = size
        self.mode = mode

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        if signal.shape[-1] < self.size:
            padding = self.size - signal.shape[-1]
            offset = padding // 2
            pad_width = (offset, padding - offset)
            if self.mode == "constant":
                signal = np.pad(signal, pad_width, "constant",
                                constant_values=float(signal.min()))
            else:
                signal = np.pad(signal, pad_width, "wrap")
        return signal


# ------------------------------------------------------------------- augments

class TimeMasking:
    def __init__(self, time_perc: float = 0.2, num_masks: int = 2):
        self.time_perc = time_perc
        self.num_masks = num_masks

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = x.copy()
        num_masks = random.randint(1, self.num_masks)
        for _ in range(num_masks):
            timesteps = x.shape[-1]
            time_percentage = random.uniform(0.0, self.time_perc)
            num_frames = int(time_percentage * timesteps)
            t0 = int(np.random.uniform(0.0, timesteps - num_frames))
            x[..., t0:t0 + num_frames] = 0.0
        return x


class ClipValue:
    def __init__(self, max_clip_val: float = 0.1):
        self.clamp_factor = max_clip_val

    def __call__(self, x: np.ndarray) -> np.ndarray:
        factor = random.uniform(0.0, self.clamp_factor)
        return np.clip(x, float(x.min()) * factor, float(x.max()) * factor)


class RandomGain:
    """Random gain in dB ~ U[min, max], applied with probability ``prob`` —
    torch_audiomentations.Gain semantics (reference:299-311)."""

    def __init__(self, min_gain_in_db: float = -18.0,
                 max_gain_in_db: float = 6.0, prob: float = 0.5,
                 sr: int = 16000):
        self.min_gain_in_db = min_gain_in_db
        self.max_gain_in_db = max_gain_in_db
        self.prob = prob

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if random.random() >= self.prob:
            return x
        gain_db = random.uniform(self.min_gain_in_db, self.max_gain_in_db)
        return x * np.float32(10.0 ** (gain_db / 20.0))


class PeakNormalization:
    """Divide by the abs peak ONLY when it exceeds 1 —
    torch_audiomentations.PeakNormalization(apply_to='only_too_loud_sounds')
    (reference:334-345)."""

    def __init__(self, sr: int = 16000):
        pass

    def __call__(self, x: np.ndarray) -> np.ndarray:
        peak = float(np.max(np.abs(x))) if x.size else 0.0
        if peak > 1.0:
            return (x / peak).astype(x.dtype)
        return x


class RandomReverb:
    """Present for API parity only. The reference implements reverb via
    sox/WavAugment and then disables it as "TOO SLOW" in every pipeline
    (reference: raw_transforms.py:217-237, 371). A batched reverb belongs
    on the device as an FIR conv; not implemented."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "RandomReverb is disabled (the reference never enables it; "
            "its sox-based implementation was 'TOO SLOW', "
            "raw_transforms.py:371)")


class AddGaussianNoise:
    """x + a·N(0,1), a ~ U[min_amplitude, max_amplitude]
    (reference:314-331). Can leave [-1,1]; normalize after."""

    def __init__(self, min_amplitude: float = 0.001,
                 max_amplitude: float = 0.015):
        assert 0.0 < min_amplitude <= max_amplitude
        self.min_amplitude = min_amplitude
        self.max_amplitude = max_amplitude

    def __call__(self, x: np.ndarray) -> np.ndarray:
        noise = np.random.randn(*x.shape).astype(np.float32)
        amplitude = random.uniform(self.min_amplitude, self.max_amplitude)
        return x + np.float32(amplitude) * noise


class BackgroundNoiseGenerator:
    """Serve random fixed-length noise clips from a directory of audio files
    (reference:240-277). Accepts .flac/.wav/.ogg."""

    def __init__(self, noise_path: str, in_memory: bool = False,
                 sr: int = 16000, min_duration: float = 2.0,
                 num_samples: int = 16000):
        from leaf_tpu_torch.data.audio import load_audio
        assert os.path.exists(noise_path)
        self._load_audio = load_audio
        patterns = ["*.flac", "*.wav", "*.ogg",
                    os.path.join("*", "*.flac"), os.path.join("*", "*.wav")]
        self.files: List[str] = []
        for pat in patterns:
            self.files.extend(glob.glob(os.path.join(noise_path, pat)))
            if self.files:
                break
        self.in_memory = in_memory
        self.sr = sr
        self.min_duration = min_duration
        self.num_samples = num_samples
        self.tfs = Compose([PadToSize(num_samples, "wrap"),
                            RandomCrop(num_samples)])
        if self.in_memory:
            self.audios = [self._load_audio(f, sr, min_duration)
                           for f in self.files]

    def __call__(self) -> np.ndarray:
        idx = random.randint(0, len(self.files) - 1)
        if self.in_memory:
            audio = self.audios[idx]
        else:
            audio = self._load_audio(self.files[idx], self.sr,
                                     self.min_duration)
        return self.tfs(audio)


class AddRandomNoise:
    """SNR-weighted background mixing: coeff = r/(1+r), r = 10^(snr/10)
    (reference:280-296)."""

    def __init__(self, noise_generator: BackgroundNoiseGenerator,
                 snr_range=(10, 25)):
        self.noise_generator = noise_generator
        self.snr_range = snr_range

    def __call__(self, x: np.ndarray) -> np.ndarray:
        snr = np.random.uniform(self.snr_range[0], self.snr_range[1] + 1)
        r = np.exp(snr * np.log(10) / 10)
        coeff = np.float32(r / (1.0 + r))
        noise = self.noise_generator()
        assert noise.size == x.size, \
            "Noise and signal shapes are incompatible"
        return coeff * x + (np.float32(1.0) - coeff) * noise.reshape(x.shape)


# --------------------------------------------------------------- spec augment

def spec_augment(spec: np.ndarray, num_mask: int = 2,
                 freq_masking: float = 0.15, time_masking: float = 0.20,
                 value: float = 0.0) -> np.ndarray:
    """2-D (freq, time) masking (reference:26-50)."""
    spec = spec.copy()
    num_mask = random.randint(1, num_mask)
    for _ in range(num_mask):
        all_freqs, all_frames = spec.shape
        freq_pct = random.uniform(0.0, freq_masking)
        nf = int(freq_pct * all_freqs)
        f0 = int(np.random.uniform(0.0, all_freqs - nf))
        spec[f0:f0 + nf, :] = value
        time_pct = random.uniform(0.0, time_masking)
        nt = int(time_pct * all_frames)
        t0 = int(np.random.uniform(0.0, all_frames - nt))
        spec[:, t0:t0 + nt] = value
    return spec


class SpecAugment:
    def __init__(self, num_mask: int = 2, freq_masking: float = 0.15,
                 time_masking: float = 0.20):
        self.num_mask = num_mask
        self.freq_masking = freq_masking
        self.time_masking = time_masking

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return spec_augment(image, self.num_mask, self.freq_masking,
                            self.time_masking, float(image.min()))


# ----------------------------------------------------------------- pipelines

def get_raw_transforms_v2(train: bool, size: int, wrap_pad_prob: float = 0.5,
                          sample_rate: int = 16000, min_duration: float = 2,
                          max_clip_value: float = 0.2,
                          background_noise_path: Optional[str] = None,
                          center_crop_val: bool = False) -> Compose:
    """reference:347-381."""
    if train:
        tfs: List[Callable] = [
            OneOf([PadToSize(size, "wrap"), PadToSize(size, "constant")],
                  p=[wrap_pad_prob, 1 - wrap_pad_prob]),
            RandomCrop(size),
        ]
        if background_noise_path:
            noise_gen = BackgroundNoiseGenerator(
                background_noise_path, sr=sample_rate,
                min_duration=min_duration, num_samples=size)
            tfs.append(UseWithProb(AddRandomNoise(noise_gen), prob=0.5))
        tfs.append(RandomGain(sr=sample_rate))
        tfs.append(PeakNormalization(sr=sample_rate))
        tfs.append(TimeMasking(time_perc=0.1, num_masks=3))
        return Compose(tfs)
    tfs = [PadToSize(size, "wrap")]
    if center_crop_val:
        tfs.append(CenterCrop(size))
    return Compose(tfs)


def simple_supervised_transforms(is_train: bool, size: int,
                                 sample_rate: int = 8000) -> Compose:
    """reference:384-395."""
    if is_train:
        tfs = [
            OneOf([PadToSize(size, "wrap"), PadToSize(size, "constant")],
                  p=[0.5, 0.5]),
            RandomCrop(size),
            UseWithProb(RandomGain(sr=sample_rate), prob=0.5),
            UseWithProb(AddGaussianNoise(), prob=0.5),
            PeakNormalization(sr=sample_rate),
            TimeMasking(time_perc=0.1, num_masks=3),
        ]
    else:
        tfs = [PadToSize(size, "wrap"), CenterCrop(size),
               PeakNormalization(sr=sample_rate)]
    return Compose(tfs)


def leaf_host_crop_transforms(is_train: bool, size: int) -> Compose:
    """Host-side HALF of the LEAF pipeline: only the shape-changing ops
    (pad + crop). The elementwise augments (gain / noise / peak-norm) run
    on device inside the train step — see
    leaf_tpu_torch.data.device_augment.leaf_device_augment. Together these equal
    ``leaf_supervised_transforms`` in distribution while lifting the host
    loader's per-sample Python cost ~10×."""
    if is_train:
        return Compose([
            OneOf([PadToSize(size, "wrap"), PadToSize(size, "constant")],
                  p=[0.5, 0.5]),
            RandomCrop(size),
        ])
    return Compose([PadToSize(size, "wrap"), CenterCrop(size)])


def leaf_supervised_transforms(is_train: bool, size: int,
                               sample_rate: int = 16000) -> Compose:
    """The default pipeline used by the trainers (reference:398-416)."""
    if is_train:
        tfs = [
            OneOf([PadToSize(size, "wrap"), PadToSize(size, "constant")],
                  p=[0.5, 0.5]),
            RandomCrop(size),
            UseWithProb(RandomGain(sr=sample_rate), prob=0.5),
            UseWithProb(AddGaussianNoise(), prob=0.5),
            PeakNormalization(sr=sample_rate),
        ]
    else:
        tfs = [PadToSize(size, "wrap"), CenterCrop(size),
               PeakNormalization(sr=sample_rate)]
    return Compose(tfs)
