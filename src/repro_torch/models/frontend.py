"""Modality frontend STUBS (a copy of ``repro/models/frontend.py``, which
the port does not import): the ``[audio]`` / ``[vlm]`` archs specify the
transformer backbone only, and prefill takes precomputed frame / patch
embeddings (``batch["embeddings"]`` of ``models/model.prefill_fn``).

These stubs stand in for EnCodec (musicgen) and the VQ-VAE image tokenizer
(chameleon): deterministic featurizers that map raw-ish inputs to
(B, S, d_model) embeddings / discrete codes so examples and tests can
exercise the full path without the (out-of-scope) codec weights.  numpy
only, with the reference's featurisers and seeds, so their outputs are the
reference's bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import ModelConfig


class AudioFrontendStub:
    """EnCodec-like: raw waveform -> frame embeddings + codebook tokens."""

    def __init__(self, cfg: ModelConfig, frame_rate: int = 50, sr: int = 16_000):
        self.cfg = cfg
        self.hop = sr // frame_rate

    def encode(self, waveform: np.ndarray, seed: int = 0):
        """waveform: (B, T) float.  Returns (embeddings (B,S,D), tokens (B,S))."""
        b, t = waveform.shape
        s = max(1, t // self.hop)
        frames = waveform[:, : s * self.hop].reshape(b, s, self.hop)
        # deterministic featurizer: fixed random projection of frame stats
        rng = np.random.default_rng(seed)
        proj = rng.standard_normal((3, self.cfg.d_model)).astype(np.float32)
        feats = np.stack([frames.mean(-1), frames.std(-1),
                          np.abs(frames).max(-1)], axis=-1)
        emb = feats.astype(np.float32) @ proj
        tokens = (np.abs(frames).mean(-1) * 1e3).astype(np.int64) % self.cfg.vocab_size
        return emb, tokens.astype(np.int32)


class VQFrontendStub:
    """VQ-VAE-like: image -> patch embeddings + discrete codes (early fusion)."""

    def __init__(self, cfg: ModelConfig, patch: int = 16):
        self.cfg = cfg
        self.patch = patch

    def encode(self, images: np.ndarray, seed: int = 0):
        """images: (B, H, W, C) float.  Returns (embeddings (B,S,D), codes (B,S))."""
        b, h, w, c = images.shape
        p = self.patch
        gh, gw = h // p, w // p
        patches = images[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, c)
        feats = patches.mean(axis=(2, 4)).reshape(b, gh * gw, c)
        rng = np.random.default_rng(seed)
        proj = rng.standard_normal((c, self.cfg.d_model)).astype(np.float32)
        emb = feats.astype(np.float32) @ proj
        codes = (feats.sum(-1) * 1e3).astype(np.int64) % self.cfg.vocab_size
        return emb, codes.astype(np.int32)
