"""Embedding and loss-curve plots (counterpart of
``ssrg_tpu/train/visualize.py``): a 2-D t-SNE scatter of node features and
a training-loss curve, drawn with headless matplotlib (Agg) into files the
caller names. matplotlib and scikit-learn are imported inside the
functions, so the rest of the port needs neither.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def tsne_plot(
    features: np.ndarray,
    labels: Optional[np.ndarray] = None,
    out_path: str = "tsne.png",
    perplexity: float = 30.0,
    seed: int = 0,
) -> np.ndarray:
    """2-D t-SNE of node features or embeddings; saves a scatter coloured by
    label and returns the 2-D coordinates."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    feats = np.asarray(features)
    perplexity = min(perplexity, max(2.0, (feats.shape[0] - 1) / 3.0))
    coords = TSNE(n_components=2, perplexity=perplexity, random_state=seed,
                  init="pca").fit_transform(feats)
    fig, ax = plt.subplots(figsize=(8, 8))
    if labels is not None:
        k = int(np.asarray(labels).max()) + 1
        sc = ax.scatter(coords[:, 0], coords[:, 1], c=np.asarray(labels), cmap="tab10", s=6,
                        vmin=-0.5, vmax=max(k - 0.5, 9.5))
        fig.colorbar(sc, ticks=range(k))
    else:
        ax.scatter(coords[:, 0], coords[:, 1], s=6)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return coords


def loss_curve_plot(losses: Sequence[float], out_path: str = "loss.png") -> None:
    """The training-loss curve, one point an epoch."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(list(losses))
    ax.set_xlabel("epoch")
    ax.set_ylabel("train loss")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
