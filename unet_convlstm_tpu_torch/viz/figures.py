"""Metric figures — the get_metrics.py output suite (counterpart of
unet_convlstm_tpu/viz/figures.py).

Balanced scatter with the identity line, MAE per time step, GT/pred
overlay and error histograms, the global statistics, and all of them in
one 3x2 summary grid (``<prefix>_summary_grid.png``), drawn from an
``eval.metrics.EvalReport``.
"""

from __future__ import annotations

import os
from typing import Dict

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from ..eval.metrics import EvalReport  # noqa: E402


def plot_balanced_scatter(report: EvalReport, ax=None, lim: float = 8.0):
    ax = ax or plt.gca()
    ax.scatter(report.scatter_gt, report.scatter_pred, s=2, alpha=0.25,
               color="tab:blue", rasterized=True)
    ax.plot([-lim, lim], [-lim, lim], "r--", lw=1, label="identity")
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_xlabel("GT velocity [m/s]")
    ax.set_ylabel("Predicted velocity [m/s]")
    ax.set_title("Balanced scatter (≤1000 pts / 0.05 m/s bin)")
    ax.legend(loc="upper left", fontsize=8)
    return ax


def plot_mae_over_time(report: EvalReport, ax=None):
    ax = ax or plt.gca()
    t = np.arange(len(report.mae_over_time))
    ax.plot(t, report.mae_over_time, "o-", color="tab:orange")
    ax.set_xlabel("time step")
    ax.set_ylabel("MAE [m/s]")
    ax.set_title("MAE over time step")
    ax.grid(alpha=0.3)
    return ax


def plot_histograms(report: EvalReport, ax_gt=None, ax_err=None):
    ax_gt = ax_gt or plt.gca()
    centers = 0.5 * (report.hist_bins[:-1] + report.hist_bins[1:])
    ax_gt.step(centers, report.gt_hist, where="mid", label="GT")
    ax_gt.step(centers, report.pred_hist, where="mid", label="pred")
    ax_gt.set_yscale("log")
    ax_gt.set_xlabel("velocity [m/s]")
    ax_gt.set_title("GT vs predicted histogram")
    ax_gt.legend(fontsize=8)
    if ax_err is not None:
        ec = 0.5 * (report.err_bins[:-1] + report.err_bins[1:])
        ax_err.step(ec, report.err_hist, where="mid", color="tab:red")
        ax_err.set_yscale("log")
        ax_err.set_xlabel("error [m/s]")
        ax_err.set_title("Error histogram")
    return ax_gt


def plot_global_stats(report: EvalReport, ax=None):
    ax = ax or plt.gca()
    ax.axis("off")
    lines = [f"MAE   = {report.mae:.4f} m/s",
             f"RMSE  = {report.rmse:.4f} m/s",
             f"bias  = {report.bias:+.4f} m/s",
             f"σ_err = {report.err_std:.4f} m/s",
             f"pixels = {int(report.n_pixels):,}"]
    ax.text(0.05, 0.9, "\n".join(lines), va="top", family="monospace",
            fontsize=12)
    ax.set_title("Global statistics")
    return ax


def save_metrics_figures(report: EvalReport, out_dir: str,
                         prefix: str = "metrics",
                         formats=("pdf",)) -> Dict[str, str]:
    """Write the per-figure files plus the 3x2 summary grid PNG. Returns
    {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}

    singles = {
        "scatter": plot_balanced_scatter,
        "mae_over_time": plot_mae_over_time,
        "stats": plot_global_stats,
    }
    for name, fn in singles.items():
        fig, ax = plt.subplots(figsize=(6, 5))
        fn(report, ax)
        for ext in formats:
            path = os.path.join(out_dir, f"{prefix}_{name}.{ext}")
            fig.savefig(path, bbox_inches="tight")
            written[f"{name}.{ext}"] = path
        plt.close(fig)

    fig, ax = plt.subplots(1, 2, figsize=(12, 5))
    plot_histograms(report, ax[0], ax[1])
    for ext in formats:
        path = os.path.join(out_dir, f"{prefix}_histograms.{ext}")
        fig.savefig(path, bbox_inches="tight")
        written[f"histograms.{ext}"] = path
    plt.close(fig)

    fig, axes = plt.subplots(3, 2, figsize=(14, 16))
    plot_balanced_scatter(report, axes[0, 0])
    plot_mae_over_time(report, axes[0, 1])
    plot_histograms(report, axes[1, 0], axes[1, 1])
    plot_global_stats(report, axes[2, 0])
    axes[2, 1].axis("off")
    fig.tight_layout()
    grid_path = os.path.join(out_dir, f"{prefix}_summary_grid.png")
    fig.savefig(grid_path, dpi=120)
    plt.close(fig)
    written["summary_grid.png"] = grid_path
    return written
