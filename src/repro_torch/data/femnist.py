"""Synthetic FEMNIST: writer-non-IID 28x28 glyph classification.

The container is offline, so the LEAF FEMNIST download is replaced by a
procedural generator with the same *structure*:

  * 47 classes (EMNIST-balanced character set size);
  * one client == one "writer"; each writer draws every glyph with its own
    style (affine warp + elastic deformation + stroke gain + noise), so the
    non-IID-ness is style-driven exactly like handwriting;
  * per-client class histograms drawn from a Dirichlet, 200-350 train
    samples per satellite (paper section 5).

Class prototypes are smooth random stroke fields built from a low-frequency
cosine basis — distinct, learnable, and fully deterministic from the seed.
Absolute accuracies differ from real FEMNIST; EXPERIMENTS.md validates the
paper's *relative* claims on this stand-in (see DESIGN.md section 5).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import FederatedDataset

N_CLASSES = 47
IMG = 28


def _class_prototypes(rng: np.random.Generator, n_classes: int = N_CLASSES
                      ) -> np.ndarray:
    """(C, 28, 28) smooth stroke-like prototypes from a cosine basis."""
    f = 4  # low-frequency band
    yy, xx = np.meshgrid(np.arange(IMG), np.arange(IMG), indexing="ij")
    basis = []
    for i in range(f):
        for j in range(f):
            basis.append(np.cos(np.pi * (i + 0.5) * yy / IMG)
                         * np.cos(np.pi * (j + 0.5) * xx / IMG))
    basis = np.stack(basis)                      # (f*f, 28, 28)
    # Correlated coefficients: classes share a common low-rank structure so
    # they are *confusable* (like letters sharing strokes), which keeps the
    # task from saturating within a handful of FL rounds.
    common = rng.normal(size=(4, f * f)) * 2.0
    mix = rng.normal(size=(n_classes, 4)) / np.sqrt(4)
    coef = mix @ common + rng.normal(size=(n_classes, f * f)) * 0.9
    proto = np.einsum("cb,bhw->chw", coef, basis)
    # Soft-threshold into stroke-like images in [0, 1].
    proto = np.tanh(np.maximum(proto - 0.3, 0.0) * 2.0)
    return proto.astype(np.float32)


def _writer_warp(rng: np.random.Generator):
    """Sample one writer's style: affine + elastic field + gain."""
    angle = rng.uniform(-0.45, 0.45)
    scale = rng.uniform(0.8, 1.25)
    shear = rng.uniform(-0.3, 0.3)
    tx, ty = rng.uniform(-3.0, 3.0, size=2)
    gain = rng.uniform(0.6, 1.3)
    # Smooth elastic field from 3 random low-freq cosines per axis.
    ew = rng.normal(size=(2, 3)) * 2.0
    ph = rng.uniform(0, 2 * np.pi, size=(2, 3))
    fr = rng.uniform(0.5, 1.5, size=(2, 3))
    return angle, scale, shear, tx, ty, gain, ew, ph, fr


def _render(proto: np.ndarray, style, rng: np.random.Generator) -> np.ndarray:
    """Apply a writer style + per-sample jitter to one prototype image."""
    angle, scale, shear, tx, ty, gain, ew, ph, fr = style
    a = angle + rng.normal() * 0.1
    s = scale * (1 + rng.normal() * 0.06)
    c0 = (IMG - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(IMG), np.arange(IMG), indexing="ij")
    y = (yy - c0) / s
    x = (xx - c0) / s
    xs = x + shear * y
    ca, sa = np.cos(a), np.sin(a)
    xr = ca * xs - sa * y + c0 - tx
    yr = sa * xs + ca * y + c0 - ty
    # Elastic deformation.
    for i in range(3):
        yr = yr + ew[0, i] * np.sin(fr[0, i] * np.pi * xx / IMG + ph[0, i])
        xr = xr + ew[1, i] * np.sin(fr[1, i] * np.pi * yy / IMG + ph[1, i])
    # Bilinear sample.
    x0 = np.clip(np.floor(xr).astype(int), 0, IMG - 2)
    y0 = np.clip(np.floor(yr).astype(int), 0, IMG - 2)
    wx = np.clip(xr - x0, 0.0, 1.0)
    wy = np.clip(yr - y0, 0.0, 1.0)
    img = ((1 - wy) * (1 - wx) * proto[y0, x0]
           + (1 - wy) * wx * proto[y0, x0 + 1]
           + wy * (1 - wx) * proto[y0 + 1, x0]
           + wy * wx * proto[y0 + 1, x0 + 1])
    img = gain * img + rng.normal(size=img.shape).astype(np.float32) * 0.15
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def synth_femnist(n_clients: int, seed: int = 0,
                  min_samples: int = 200, max_samples: int = 350,
                  eval_samples: int = 64, dirichlet_alpha: float = 1.0
                  ) -> FederatedDataset:
    """Generate the federated dataset for a constellation of `n_clients`."""
    root = np.random.default_rng(np.random.SeedSequence([1234, seed]))
    proto = _class_prototypes(np.random.default_rng(4242))  # shared glyphs

    N = max_samples
    x = np.zeros((n_clients, N, IMG, IMG, 1), np.float32)
    y = np.zeros((n_clients, N), np.int32)
    n = np.zeros((n_clients,), np.int32)
    xe = np.zeros((n_clients, eval_samples, IMG, IMG, 1), np.float32)
    ye = np.zeros((n_clients, eval_samples), np.int32)
    ne = np.full((n_clients,), eval_samples, np.int32)

    for k in range(n_clients):
        rng = np.random.default_rng(np.random.SeedSequence([seed, k]))
        style = _writer_warp(rng)
        probs = rng.dirichlet(np.full(N_CLASSES, dirichlet_alpha))
        nk = int(rng.integers(min_samples, max_samples + 1))
        labels = rng.choice(N_CLASSES, size=nk + eval_samples, p=probs)
        for i, c in enumerate(labels[:nk]):
            x[k, i, :, :, 0] = _render(proto[c], style, rng)
            y[k, i] = c
        n[k] = nk
        for i, c in enumerate(labels[nk:]):
            xe[k, i, :, :, 0] = _render(proto[c], style, rng)
            ye[k, i] = c
    return FederatedDataset(x=x, y=y, n=n, x_eval=xe, y_eval=ye, n_eval=ne)
