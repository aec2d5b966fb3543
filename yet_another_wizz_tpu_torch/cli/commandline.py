"""Argparse front end of the pipeline tool.

Ported from the JAX package's ``cli/commandline.py`` (the reference's
``yaw_cli`` entry point, yaw/cli/commandline.py:20-193): positional
project directory and setup file, ``--dump`` for a fully commented default
setup, and flags for cache location, workers, dropping caches, overwrite,
resume, verbosity, progress display and profiling. ``--device`` (default
``cuda``) picks the device the tasks run on; it is not a setup key, so
setup files stay those of the JAX package. Run it as::

    python -m yet_another_wizz_tpu_torch.cli <project> <setup.yml> [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from yet_another_wizz_tpu_torch._version import __version__

__all__ = [
    "main",
]

DUMP_TEMPLATE = """# yet_another_wizz_tpu_torch v{version} configuration

# Correlation measurement configuration.
correlation:
    scales:
        # lower scale limit(s)
        rmin: 100.0
        # upper scale limit(s)
        rmax: 1000.0
        # unit of the scales (kpc, Mpc, rad, deg, arcmin, arcsec, kpc/h, Mpc/h)
        unit: kpc
        # optional power-law exponent for weighting counts by separation
        # rweight: null
        # number of log bins used to approximate the separation weighting
        # resolution: 50
        # device counting formulation for weighted configurations
        # (auto, cumulative, direct)
        # counting: auto
    binning:
        # lowest redshift edge
        zmin: 0.1
        # highest redshift edge
        zmax: 1.0
        # number of redshift bins
        num_bins: 30
        # binning generation method (linear, comoving, logspace, custom)
        method: linear
        # custom bin edges (implies method: custom)
        # edges: [0.1, 0.2, 0.3]
        # which side of the bin edges is closed (left, right)
        closed: right
    # cosmological model used for scale conversions (registered name)
    cosmology: Planck15
    # limit the number of parallel workers
    # max_workers: null

# Input catalogs.
inputs:
    reference:
        # path to the data catalog (FITS, Parquet or HDF5)
        path_data: reference_data.pqt
        # path to the random catalog (optional)
        path_rand: reference_rand.pqt
        # column names
        ra: ra
        dec: dec
        redshift: z
        # weight: weight
        # patches: patch_id
    unknown:
        # tomographic bins: mapping of bin index to file path
        path_data:
            1: unknown_data_1.pqt
        path_rand:
            1: unknown_rand_1.pqt
        ra: ra
        dec: dec
        # redshift: z     # required for the 'hist' and 'auto_unk' tasks
        # weight: weight
    # number of spatial patches (generated with kmeans if no patch column)
    num_patches: 64
    # store the cached catalogs outside the project directory
    # cache_path: null

# Optional execution knobs (defaults shown commented out).
# execution:
#     # number of devices in the measurement mesh; default: automatic
#     # (all local cards, or the global mesh of a multi-process job);
#     # 1 = single device
#     devices: null
#     # catalog distribution over the mesh (replicated, columns, ring)
#     data_sharding: replicated
#     # recompute float32 bin-boundary pairs with the float64 oracle
#     audit: false
#     # bound device/host memory: stream blocks of at most this many
#     # patches through the engine (enables lazy catalog loading)
#     max_resident_patches: null
#     # reopen cached catalogs lazily (defaults to true when
#     # max_resident_patches is set)
#     lazy: null

# Tasks to execute (cache_ref/cache_unk are linked automatically).
# A task may carry options as a single-key mapping, e.g.
#   - estimate:
#       method: bootstrap   # resampling (jackknife, bootstrap)
#       num_samples: 500    # bootstrap realisations
#       estimator: DP       # force an estimator (DP, LS)
tasks:
  - auto_ref
  - cross_corr
  - estimate
  # requires inputs.unknown.redshift:
  # - hist
  - plot
"""


class DumpConfigAction(argparse.Action):
    def __init__(self, *args, nargs=0, **kwargs):
        super().__init__(*args, nargs=nargs, **kwargs)

    def __call__(self, parser, *args, **kwargs):
        print(DUMP_TEMPLATE.format(version=__version__))
        parser.exit()


def create_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m yet_another_wizz_tpu_torch.cli",
        description=(
            "yet_another_wizz_tpu_torch: clustering redshift pipeline in "
            "PyTorch on NVIDIA cards."
        ),
    )
    parser.add_argument(
        "wdir", metavar="<project path>",
        help="project directory to create or resume",
    )
    parser.add_argument(
        "setup", metavar="<setup file>", nargs="?", default=None,
        help="YAML setup (optional when resuming an existing project)",
    )
    parser.add_argument(
        "--dump", action=DumpConfigAction,
        help="print a fully commented default setup and exit",
    )
    parser.add_argument(
        "--cache-path", metavar="<path>", default=None,
        help="store cached catalogs at this external location",
    )
    parser.add_argument(
        "--workers", type=int, metavar="<int>", default=None,
        help="limit the number of parallel workers",
    )
    parser.add_argument(
        "--drop", action="store_true",
        help="drop the cached catalogs after the pipeline finishes",
    )
    parser.add_argument(
        "--overwrite", action="store_true",
        help="overwrite an existing project directory",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="skip tasks whose outputs already exist",
    )
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="increase logging verbosity",
    )
    parser.add_argument(
        "--quiet", action="store_true", help="disable terminal logging"
    )
    parser.add_argument(
        "--progress", action="store_true",
        help="show progress on the terminal",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="write a torch profiler trace (Chrome format) of the task "
             "loop to <project>/profile",
    )
    parser.add_argument(
        "--device", metavar="<device>", default="cuda",
        help="torch device the tasks run on (default: cuda, which fails "
             "without a card; cpu runs the plain PyTorch engine)",
    )
    parser.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    return parser


def main(args: list[str] | None = None) -> int:
    from yet_another_wizz_tpu_torch.cli.pipeline import run_setup
    from yet_another_wizz_tpu_torch.parallel import initialize

    parsed = create_parser().parse_args(args)
    # the JAX package enables its persistent XLA compile cache here; eager
    # PyTorch compiles no programs, so the port has no such cache
    # multi-process launches: one process per card or host with
    # YAWT_COORDINATOR / YAWT_NUM_PROCESSES / YAWT_PROCESS_ID exported
    # (no-op in one process)
    initialize()
    try:
        run_setup(
            parsed.wdir,
            parsed.setup,
            cache_path=parsed.cache_path,
            workers=parsed.workers,
            drop=parsed.drop,
            overwrite=parsed.overwrite,
            resume=parsed.resume,
            progress=parsed.progress,
            verbose=parsed.verbose,
            quiet=parsed.quiet,
            profile=parsed.profile,
            device=parsed.device,
        )
    except Exception as err:  # pragma: no cover - smoke tested via API
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
