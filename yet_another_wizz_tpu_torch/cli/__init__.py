"""Batch pipeline and command-line interface.

Ported from the JAX package's ``cli/`` (the reference's ``yaw_cli`` tool,
yaw/cli/): YAML-driven project setups describing the
input catalogs (with tomographic unknown bins), the correlation
configuration and a task list; a project directory layout with cached
catalogs, pair counts, estimates and plots; a task scheduler with
dependency resolution and resume support; and an argparse front end,
run as ``python -m yet_another_wizz_tpu_torch.cli <project> <setup.yml>``.
Setup files and project directories are those of the JAX package: a
setup runs unchanged in either package, and a project begun by one
resumes in the other.
"""

from yet_another_wizz_tpu_torch.cli.pipeline import Pipeline, run_setup
from yet_another_wizz_tpu_torch.cli.config import ProjectConfig

__all__ = [
    "Pipeline",
    "ProjectConfig",
    "run_setup",
]
