"""Population plots (the port's copy of
``ananke_abm_tpu/models/gen_schedule/viz/plots.py``): unaries mean±std
curves, minutes-share bars, ToD marginal curves per purpose, bigram-delta
heatmap. matplotlib is imported when a plot is drawn, not with the module,
so the port imports on a machine without it."""
from __future__ import annotations

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend (files only, no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_unaries_mean_std(U_mean, U_std, purpose_names, out_png):
    """U_mean/U_std: (T, P) logits stats across generated individuals."""
    plt = pyplot()
    T, P = U_mean.shape
    fig, ax = plt.subplots(figsize=(10, 5))
    t = np.arange(T)
    for p in range(P):
        ax.plot(t, U_mean[:, p], label=purpose_names[p])
        ax.fill_between(
            t, U_mean[:, p] - U_std[:, p], U_mean[:, p] + U_std[:, p],
            alpha=0.15,
        )
    ax.set_xlabel("time bin")
    ax.set_ylabel("logit")
    ax.set_title("Decoder unaries mean ± std")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_minutes_share(share_syn, share_ref, purpose_names, out_png):
    plt = pyplot()
    P = len(purpose_names)
    x = np.arange(P)
    fig, ax = plt.subplots(figsize=(8, 4))
    w = 0.38
    ax.bar(x - w / 2, share_syn, w, label="synthetic")
    if share_ref is not None:
        ax.bar(x + w / 2, share_ref, w, label="reference")
    ax.set_xticks(x)
    ax.set_xticklabels(purpose_names, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("share of person-minutes")
    ax.set_title("Minutes share per purpose")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_tod_marginals(m_syn, m_ref, purpose_names, out_png):
    """m_syn/m_ref: (T, P). One subplot per purpose."""
    plt = pyplot()
    T, P = m_syn.shape
    ncols = min(4, P)
    nrows = -(-P // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(3.2 * ncols, 2.4 * nrows), squeeze=False
    )
    t = np.arange(T)
    for p in range(P):
        ax = axes[p // ncols][p % ncols]
        ax.plot(t, m_syn[:, p], label="syn")
        if m_ref is not None:
            ax.plot(t, m_ref[:, p], "--", label="ref")
        ax.set_title(purpose_names[p], fontsize=9)
        ax.set_ylim(0, 1)
    for q in range(P, nrows * ncols):
        axes[q // ncols][q % ncols].axis("off")
    axes[0][0].legend(fontsize=7)
    fig.suptitle("Time-of-day marginals")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_bigram_delta(b_syn, b_ref, purpose_names, out_png):
    plt = pyplot()
    delta = b_syn - b_ref
    fig, ax = plt.subplots(figsize=(6, 5))
    lim = max(1e-9, np.abs(delta).max())
    im = ax.imshow(delta, cmap="coolwarm", vmin=-lim, vmax=lim)
    ax.set_xticks(range(len(purpose_names)))
    ax.set_yticks(range(len(purpose_names)))
    ax.set_xticklabels(purpose_names, rotation=45, ha="right", fontsize=7)
    ax.set_yticklabels(purpose_names, fontsize=7)
    ax.set_title("Bigram delta (syn - ref)")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
