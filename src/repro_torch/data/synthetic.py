"""Deterministic synthetic data pipelines (the reference's
``data/synthetic.py``).

Every stream draws from numpy's ``default_rng(seed)`` in the reference's
order, so the same seed gives the reference's integers and noise bit for
bit; batches land on the requested device through ``device.to_device``
(pinned memory, non-blocking: no device sync).

* ``token_stream`` — Zipf-ish unigram mixture with a first-order Markov
  kicker: the next token's distribution depends on the previous token's
  residue class, so an LM can beat the unigram entropy floor.
* ``latent_stream`` — class-conditioned Gaussian blobs with per-class
  spatial frequency patterns in (H, W, C) latent space (DiT training), as
  (x_t, t, labels, noise) of the DDPM forward process.
* ``video_latents`` — temporally-correlated latent sequences with a moving
  foreground and a static background.
* ``audio_stream`` — HuBERT-style masked-prediction batches.

``token_stream`` and ``audio_stream`` take ``shard=(index, count)``: the
global batch is drawn as the reference draws it and a data rank keeps its
``count``-th part of the rows (``batch`` stays the global batch), so the
ranks' parts make up the reference's batch.

The CPU-side draw is the reference's: ``token_stream`` builds a cumsum over
(batch, vocab) per position, so at a 151,936-token vocabulary a batch of
256 positions takes about a second of host time; draw such batches ahead of
a timed window.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.diffusion.schedule import add_noise, linear_schedule


def rows_of(batch: int, shard: Optional[Tuple[int, int]]) -> slice:
    """The rows of a global batch that ``shard = (index, count)`` keeps
    (all of them for None); ``count`` must divide ``batch``."""
    if shard is None:
        return slice(None)
    i, n = shard
    if batch % n:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{n} data ranks")
    return slice(i * batch // n, (i + 1) * batch // n)


def token_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                 num_classes: int = 8, device: DeviceLike = "cuda",
                 shard: Optional[Tuple[int, int]] = None
                 ) -> Iterator[Dict]:
    dev = resolve_device(device)
    rows = rows_of(batch, shard)
    rng = np.random.default_rng(seed)
    # class-conditional unigram tables (Zipf base re-shuffled per class)
    base = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    tables = np.stack([rng.permutation(base) for _ in range(num_classes)])
    tables /= tables.sum(-1, keepdims=True)
    while True:
        out = np.empty((batch, seq), np.int32)
        prev = rng.integers(0, vocab, size=batch)
        for t in range(seq):
            cls = prev % num_classes
            u = rng.random(batch)
            cdf = np.cumsum(tables[cls], axis=-1)
            nxt = (u[:, None] < cdf).argmax(-1)
            out[:, t] = nxt
            prev = nxt
        yield {"tokens": to_device(out[rows], dev)}


def latent_stream(batch: int, image_size: int, channels: int, *,
                  num_classes: int = 10, seed: int = 0,
                  num_train_steps: int = 1000,
                  device: DeviceLike = "cuda") -> Iterator[Dict]:
    """DiT training batches: (x_t, t, labels, noise) per DDPM forward."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sched = linear_schedule(num_train_steps, device=dev)
    yy, xx = np.meshgrid(np.arange(image_size), np.arange(image_size),
                         indexing="ij")
    while True:
        labels = rng.integers(0, num_classes, size=batch)
        freq = (labels % 4 + 1)[:, None, None, None]
        phase = (labels // 4)[:, None, None, None] * 0.7
        grid = np.sin(2 * np.pi * freq * xx[None, ..., None]
                      / image_size + phase) \
            * np.cos(2 * np.pi * freq * yy[None, ..., None] / image_size)
        x0 = grid + 0.1 * rng.standard_normal(
            (batch, image_size, image_size, channels))
        t = rng.integers(0, num_train_steps, size=batch)
        noise = rng.standard_normal(x0.shape)
        noise_d = to_device(noise.astype(np.float32), dev)
        t_d = to_device(t.astype(np.int32), dev)
        x_t = add_noise(sched, to_device(x0.astype(np.float32), dev),
                        noise_d, t_d)
        yield {"latents": x_t, "t": t_d,
               "labels": to_device(labels.astype(np.int32), dev),
               "noise": noise_d}


def video_latents(batch: int, frames: int, image_size: int, channels: int,
                  *, motion_amplitude: float = 1.0, seed: int = 0,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """(B, T, H, W, C) latents: static textured background + a small moving
    square whose speed scales with motion_amplitude."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bg = rng.standard_normal((batch, 1, image_size, image_size, channels))
    out = np.repeat(bg, frames, axis=1).astype(np.float32)
    sq = max(2, image_size // 4)
    for b in range(batch):
        cx = rng.integers(0, image_size - sq)
        cy = rng.integers(0, image_size - sq)
        vx = motion_amplitude * rng.uniform(0.5, 1.5)
        vy = motion_amplitude * rng.uniform(-1.0, 1.0)
        patch = 2.0 * rng.standard_normal((sq, sq, channels))
        for t in range(frames):
            x0 = int(cx + vx * t) % (image_size - sq + 1)
            y0 = int(cy + vy * t) % (image_size - sq + 1)
            out[b, t, y0:y0 + sq, x0:x0 + sq] = patch
    return to_device(out, dev)


def audio_stream(batch: int, seq: int, frontend_dim: int, vocab: int, *,
                 seed: int = 0, mask_prob: float = 0.2,
                 device: DeviceLike = "cuda",
                 shard: Optional[Tuple[int, int]] = None) -> Iterator[Dict]:
    """HuBERT-style masked-prediction batches over stub conv features."""
    dev = resolve_device(device)
    rows = rows_of(batch, shard)
    rng = np.random.default_rng(seed)
    proto = rng.standard_normal((vocab, frontend_dim)).astype(np.float32)
    while True:
        targets = rng.integers(0, vocab, size=(batch, seq))
        feats = proto[targets] + 0.3 * rng.standard_normal(
            (batch, seq, frontend_dim)).astype(np.float32)
        mask = rng.random((batch, seq)) < mask_prob
        feats = np.where(mask[..., None], 0.0, feats)
        yield {"features": to_device(feats[rows].astype(np.float32), dev),
               "targets": to_device(targets[rows].astype(np.int32), dev),
               "mask_indices": to_device(mask[rows], dev)}
