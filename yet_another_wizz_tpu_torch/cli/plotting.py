"""Automatic check plots for pipeline outputs.

Ported from the JAX package's ``cli/plotting.py`` (the reference's
``yaw.cli.plotting``, yaw/cli/plotting.py:39-246): tomographic grid figures
of the unknown autocorrelations, the reference autocorrelation, and the
recovered n(z) against the true redshift histogram.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

from yet_another_wizz_tpu_torch.utils.plotting import PLOTTING_ENABLED

if TYPE_CHECKING:
    from yet_another_wizz_tpu_torch.cli.directory import ProjectDirectory

__all__ = [
    "make_checkplots",
]

logger = logging.getLogger(__name__)


def _bin_grid_figure(num_bins: int):
    import matplotlib.pyplot as plt

    ncols = min(3, num_bins)
    nrows = -(-num_bins // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False,
        sharex=True,
    )
    return fig, axes.ravel()


def plot_auto_ref(project: ProjectDirectory) -> bool:
    """Reference autocorrelation amplitude w_ss(z)."""
    handle = project.estimate.auto_ref
    if not handle.exists():
        return False
    import matplotlib.pyplot as plt

    data = handle.load()
    ax = data.plot(indicate_zero=True)
    ax.set_xlabel("z")
    ax.set_ylabel(r"$w_{\rm ss}$")
    ax.figure.tight_layout()
    ax.figure.savefig(project.plot_path / "auto_ref.png")
    plt.close(ax.figure)
    return True


def plot_auto_unk(project: ProjectDirectory) -> bool:
    """Grid of unknown-sample autocorrelation amplitudes w_pp(z)."""
    handles = project.estimate.auto_unk
    if not handles.exists() or len(handles) == 0:
        return False
    import matplotlib.pyplot as plt

    fig, axes = _bin_grid_figure(len(handles))
    for ax, (index, handle) in zip(axes, handles.items()):
        handle.load().plot(ax=ax, indicate_zero=True)
        ax.set_title(f"bin {index}")
        ax.set_xlabel("z")
    fig.tight_layout()
    fig.savefig(project.plot_path / "auto_unk.png")
    plt.close(fig)
    return True


def plot_redshift_estimates(project: ProjectDirectory) -> bool:
    """Grid of recovered n(z), with the true histogram when available."""
    handles = project.estimate.nz_est
    if not handles.exists() or len(handles) == 0:
        return False
    import matplotlib.pyplot as plt

    hist_handles = project.true.nz_true
    fig, axes = _bin_grid_figure(len(handles))
    for ax, (index, handle) in zip(axes, handles.items()):
        nz_est = handle.load()
        if hist_handles[index].exists():
            hist = hist_handles[index].load().normalised()
            hist.plot(ax=ax, label="true n(z)")
            nz_est = nz_est.normalised(hist)
        nz_est.plot(ax=ax, indicate_zero=True, label="estimate")
        ax.set_title(f"bin {index}")
        ax.set_xlabel("z")
        ax.legend()
    fig.tight_layout()
    fig.savefig(project.plot_path / "nz_estimate.png")
    plt.close(fig)
    return True


def plot_histograms(project: ProjectDirectory) -> bool:
    """Grid of true redshift histograms (when no estimate exists — the
    estimate plot already overlays them)."""
    handles = project.true.nz_true
    if not handles.exists() or len(handles) == 0:
        return False
    estimates = project.estimate.nz_est
    if estimates.exists() and len(estimates) > 0:
        return False
    import matplotlib.pyplot as plt

    fig, axes = _bin_grid_figure(len(handles))
    for ax, (index, handle) in zip(axes, handles.items()):
        handle.load().normalised().plot(ax=ax)
        ax.set_title(f"bin {index}")
        ax.set_xlabel("z")
    fig.tight_layout()
    fig.savefig(project.plot_path / "nz_true.png")
    plt.close(fig)
    return True


def make_checkplots(project: ProjectDirectory) -> None:
    """Generate all check plots for which outputs exist."""
    if not PLOTTING_ENABLED:
        logger.warning("matplotlib not available, skipping check plots")
        return
    made = []
    for plot_fn in (
        plot_auto_ref, plot_auto_unk, plot_redshift_estimates,
        plot_histograms,
    ):
        if plot_fn(project):
            made.append(plot_fn.__name__)
    logger.info("created %d check plot(s)", len(made))
