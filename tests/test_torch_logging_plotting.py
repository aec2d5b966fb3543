"""The port's logging and plotting against the JAX package's.

- ``CLIENT`` is the JAX package's level number, and ``init_file_logging``
  writes the JAX package's line format; a second project log replaces the
  first;
- ``profile_trace`` on the CPU writes a non-empty Chrome trace;
- with matplotlib's Agg backend, ``CorrData.plot`` in each ``PlotStyle``
  and ``plot_corr`` draw as many artists as the JAX package's on the same
  committed example estimate;
- the pipeline's check plots log a warning and skip without matplotlib.
"""

import json
import logging
import re

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from yet_another_wizz_tpu.examples import _PACKAGE_PRODUCTS as JAX_PRODUCTS  # noqa: E402
from yet_another_wizz_tpu.redshifts import RedshiftData as JaxRedshiftData  # noqa: E402
from yet_another_wizz_tpu.utils import logging as jax_logging  # noqa: E402
from yet_another_wizz_tpu_torch.examples import _PACKAGE_PRODUCTS  # noqa: E402
from yet_another_wizz_tpu_torch.options import PlotStyle  # noqa: E402
from yet_another_wizz_tpu_torch.redshifts import RedshiftData  # noqa: E402
from yet_another_wizz_tpu_torch.utils import logging as port_logging  # noqa: E402

LINE = re.compile(
    r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} CLIENT (\S+) running task 'x'$"
)


def test_client_level_is_the_jax_level():
    assert port_logging.CLIENT == jax_logging.CLIENT == logging.INFO + 5
    assert logging.getLevelName(port_logging.CLIENT) == "CLIENT"


def _file_handlers(name):
    return [h for h in logging.getLogger(name).handlers if isinstance(h, logging.FileHandler)]


def _detach(name, handlers):
    for handler in handlers:
        logging.getLogger(name).removeHandler(handler)
        handler.close()


def test_init_file_logging_writes_the_jax_line_format(tmp_path):
    jax_before = _file_handlers("yet_another_wizz_tpu")
    port_before = _file_handlers("yet_another_wizz_tpu_torch")
    try:
        jax_logging.init_file_logging(tmp_path / "jax.log")
        port_logging.init_file_logging(tmp_path / "port.log")
        logging.getLogger("yet_another_wizz_tpu.cli.pipeline").log(
            jax_logging.CLIENT, "running task '%s'", "x"
        )
        logging.getLogger("yet_another_wizz_tpu_torch.cli.pipeline").log(
            port_logging.CLIENT, "running task '%s'", "x"
        )
        # a second project's log replaces the first: the first stays as it was
        port_logging.init_file_logging(tmp_path / "port2.log")
        logging.getLogger("yet_another_wizz_tpu_torch.cli.tasks").info("second")
    finally:
        _detach("yet_another_wizz_tpu", [
            h for h in _file_handlers("yet_another_wizz_tpu") if h not in jax_before
        ])
        for name in ("yawt", "yawt_torch", "yet_another_wizz_tpu_torch"):
            _detach(name, [
                h for h in _file_handlers(name)
                if h not in jax_before and h not in port_before
            ])
    (jax_line,) = (tmp_path / "jax.log").read_text().splitlines()
    (port_line,) = (tmp_path / "port.log").read_text().splitlines()
    assert LINE.match(jax_line).group(1) == "yet_another_wizz_tpu.cli.pipeline"
    assert LINE.match(port_line).group(1) == "yet_another_wizz_tpu_torch.cli.pipeline"
    assert (tmp_path / "port2.log").read_text().endswith(
        "INFO yet_another_wizz_tpu_torch.cli.tasks second\n"
    )


def test_profile_trace_on_the_cpu_writes_a_trace(tmp_path):
    import torch

    with port_logging.profile_trace(tmp_path / "profile") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = tmp_path / "profile" / port_logging.TRACE_FILE
    assert trace.stat().st_size > 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::mm" in event.get("name", "") for event in events)
    assert any(event.key == "aten::mm" for event in prof.key_averages())


@pytest.fixture(scope="module")
def estimates():
    return (
        RedshiftData.from_files(_PACKAGE_PRODUCTS / "estimate"),
        JaxRedshiftData.from_files(JAX_PRODUCTS / "estimate"),
    )


def _artists(draw) -> int:
    fig, ax = plt.subplots()
    try:
        draw(ax)
        return len(ax.get_children()) + len(fig.axes)
    finally:
        plt.close(fig)


@pytest.mark.parametrize("style", [None, *PlotStyle])
def test_plot_draws_as_many_artists_as_jax(estimates, style):
    ours, theirs = estimates
    kwargs = dict(style=style, indicate_zero=True, label="n(z)")
    count = _artists(lambda ax: ours.plot(ax=ax, **kwargs))
    assert count == _artists(lambda ax: theirs.plot(ax=ax, **kwargs))
    assert count > _artists(lambda ax: None)


@pytest.mark.parametrize("redshift", [False, True])
def test_plot_corr_draws_as_many_artists_as_jax(estimates, redshift):
    ours, theirs = estimates
    count = _artists(lambda ax: ours.plot_corr(ax=ax, redshift=redshift))
    assert count == _artists(lambda ax: theirs.plot_corr(ax=ax, redshift=redshift))
    # the image and its colour bar
    fig, ax = plt.subplots()
    try:
        ours.plot_corr(ax=ax, redshift=redshift)
        (image,) = ax.get_images()
        assert np.array_equal(image.get_array(), np.flipud(ours.correlation))
        assert len(fig.axes) == 2
    finally:
        plt.close(fig)


def test_check_plots_skip_without_matplotlib(tmp_path, monkeypatch, caplog):
    from yet_another_wizz_tpu_torch.cli import plotting
    from yet_another_wizz_tpu_torch.cli.directory import ProjectDirectory

    monkeypatch.setattr(plotting, "PLOTTING_ENABLED", False)
    project = ProjectDirectory(tmp_path / "project", (1,))
    with caplog.at_level(logging.WARNING, "yet_another_wizz_tpu_torch"):
        plotting.make_checkplots(project)
    assert "matplotlib not available" in caplog.text
    assert not (tmp_path / "project" / "plots").exists()
