"""The port's batch pipeline (``yet_another_wizz_tpu_torch.cli``) against the
JAX package's, on the same setup and the same FITS inputs.

Both command lines run the tomographic task graph (``auto_ref``,
``cross_corr`` per bin, ``estimate``, ``hist``, ``plot``) over a mock
survey of a few thousand points in two tomographic bins and 8 grid patches
(``tests/torch_cli_cases.py``); the port on the CPU (``--device cpu``),
its plain PyTorch engine. The JAX package runs with float lanes
(``YAWT_LANE_ENCODING=float``), as in the other parity tests. Checked:

- the same product files; pair counts within 1e-6 relative; n(z)
  ``.dat/.smp/.cov`` within 1e-6; the ``hist`` outputs bit for bit;
- each package's ``.hdf`` opens in the other, and a project begun by one
  package resumes in the other;
- the JAX package's invalid setups (``tests/test_setups.py::
  TestInvalidSetups``) raise the same errors in the port; the dumped
  template parses to the same setup in both;
- the port's counterparts of the cheap JAX pipeline tests: the lock file,
  the cache lifecycle, task options, the task order, the blocked lazy
  path and a mesh of 4 against in memory and one device, ``--resume``,
  kmeans patches, and two processes over gloo on one project.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from numpy.testing import assert_allclose
from torch_cli_cases import (
    base_setup,
    product_files,
    write_inputs,
    write_setup,
)

from yet_another_wizz_tpu.cli.commandline import main as jax_main
from yet_another_wizz_tpu.cli.pipeline import run_setup as jax_run_setup
from yet_another_wizz_tpu.config import ConfigError as JaxConfigError
from yet_another_wizz_tpu.correlation import load_corrfunc as jax_load_corrfunc
from yet_another_wizz_tpu_torch.cli.commandline import main as port_main
from yet_another_wizz_tpu_torch.cli.pipeline import run_setup
from yet_another_wizz_tpu_torch.config import ConfigError
from yet_another_wizz_tpu_torch.correlation import load_corrfunc

TASKS = ["auto_ref", "cross_corr", "estimate", "hist", "plot"]
RTOL = 1e-6
COUNT_NAMES = ("dd", "dr", "rd", "rr")
WORKER = Path(__file__).parent / "torch_cli_worker.py"
REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """One torch thread for this module's pipelines: beside the test
    runner's other workers, each with all the cores' threads, the CPU is
    oversubscribed, and a CPU mesh of four entries ran 100 times slower
    than alone."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("inputs"))


@pytest.fixture(scope="module")
def projects(inputs, tmp_path_factory):
    """The same setup through the JAX command line and the port's."""
    root = tmp_path_factory.mktemp("projects")
    setup = write_setup(root / "setup.yml", base_setup(inputs, TASKS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        assert jax_main([str(root / "jax"), setup, "--quiet"]) == 0
    assert port_main([str(root / "port"), setup, "--quiet", "--device", "cpu"]) == 0
    return root


def run(tmp_path, setup, **kwargs):
    """The port's ``run_setup`` on the CPU, quiet (the JAX tests' ``run``)."""
    setup_path = write_setup(tmp_path / "setup.yml", setup)
    kwargs.setdefault("quiet", True)
    kwargs.setdefault("device", "cpu")
    return run_setup(tmp_path / "project", setup_path, **kwargs)


def counts_of(corr) -> dict:
    """Pair counts and weight sums of every count type a CorrFunc holds."""
    result = {}
    for name in COUNT_NAMES:
        counts = getattr(corr, name)
        if counts is not None:
            result[name] = (
                np.asarray(counts.counts.get_array()),
                np.asarray(counts.sum_weights.get_array()),
            )
    return result


def assert_counts_close(actual: dict, desired: dict) -> None:
    assert set(actual) == set(desired)
    for name, (counts, sum_weights) in desired.items():
        assert_allclose(
            actual[name][0], counts, rtol=RTOL, atol=RTOL * np.abs(counts).max(),
            err_msg=name,
        )
        assert_allclose(actual[name][1], sum_weights, rtol=1e-12, err_msg=name)


def assert_counts_equal(actual: dict, desired: dict) -> None:
    assert set(actual) == set(desired)
    for name, (counts, sum_weights) in desired.items():
        assert np.array_equal(actual[name][0], counts), name
        assert np.array_equal(actual[name][1], sum_weights), name


def assert_table_close(actual_path, desired_path) -> None:
    actual, desired = np.loadtxt(actual_path), np.loadtxt(desired_path)
    assert actual.shape == desired.shape
    assert_allclose(actual, desired, rtol=RTOL, atol=RTOL * np.abs(desired).max())


# -- the JAX command line against the port's ----------------------------------


def test_same_product_files(projects):
    jax_files = product_files(projects / "jax")
    assert jax_files == product_files(projects / "port")
    assert "paircounts/cross_2.hdf" in jax_files
    assert "estimate/nz_est_2.cov" in jax_files


def test_plot_task_writes_the_jax_png_names(projects):
    names = sorted(path.name for path in (projects / "jax" / "plots").glob("*.png"))
    assert names == ["auto_ref.png", "nz_estimate.png"]
    assert sorted(
        path.name for path in (projects / "port" / "plots").glob("*.png")
    ) == names


@pytest.mark.parametrize("name", ["auto_ref", "cross_1", "cross_2"])
def test_pair_counts_agree(projects, name):
    ours = counts_of(load_corrfunc(projects / "port" / "paircounts" / f"{name}.hdf"))
    theirs = counts_of(
        jax_load_corrfunc(projects / "jax" / "paircounts" / f"{name}.hdf")
    )
    assert_counts_close(ours, theirs)


@pytest.mark.parametrize("suffix", ["dat", "smp", "cov"])
@pytest.mark.parametrize("name", ["nz_est_1", "nz_est_2", "auto_ref", "cross_1"])
def test_estimates_agree(projects, name, suffix):
    assert_table_close(
        projects / "port" / "estimate" / f"{name}.{suffix}",
        projects / "jax" / "estimate" / f"{name}.{suffix}",
    )


@pytest.mark.parametrize("suffix", ["dat", "smp", "cov"])
@pytest.mark.parametrize("index", [1, 2])
def test_hist_outputs_bitwise(projects, index, suffix):
    name = f"true/nz_true_{index}.{suffix}"
    assert (projects / "port" / name).read_bytes() == (
        projects / "jax" / name
    ).read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf_files_read_across_packages(projects, writer):
    path = projects / writer / "paircounts" / "cross_1.hdf"
    assert_counts_equal(counts_of(load_corrfunc(path)), counts_of(jax_load_corrfunc(path)))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_project_resumes_across_packages(projects, tmp_path, first):
    """A project whose caches and pair counts one package wrote, resumed by
    the other: it skips the caches and counts, and its estimates and
    histograms equal those of the first package's own run bit for bit."""
    project = tmp_path / "project"
    shutil.copytree(projects / first, project)
    for sub in ("estimate", "true", "plots"):
        shutil.rmtree(project / sub)
    if first == "jax":
        pipeline = run_setup(project, resume=True, quiet=True, device="cpu")
    else:
        pipeline = jax_run_setup(project, resume=True, quiet=True)
    assert [task.name for task in pipeline.tasks] == ["hist", "estimate", "plot"]
    assert product_files(project) == product_files(projects / first)
    for name in product_files(project):
        if name.startswith(("estimate/", "true/")):
            assert (project / name).read_bytes() == (
                projects / first / name
            ).read_bytes(), name


# -- configuration parity -------------------------------------------------------


def _drop(*keys):
    def mutate(setup, paths):
        section = setup
        for key in keys[:-1]:
            section = section[key]
        del section[keys[-1]]

    return mutate


def _set(value, *keys):
    def mutate(setup, paths):
        section = setup
        for key in keys[:-1]:
            section = section[key]
        section[keys[-1]] = value(paths) if callable(value) else value

    return mutate


def _both(*mutations):
    def mutate(setup, paths):
        for mutation in mutations:
            mutation(setup, paths)

    return mutate


INVALID_SETUPS = {
    # name: (tasks, mutation, error, match), after tests/test_setups.py's
    # TestInvalidSetups
    "missing_scales": (["cross_corr"], _drop("correlation", "scales"), "config", "scales"),
    "missing_binning": (["cross_corr"], _drop("correlation", "binning"), "config", "binning"),
    "extra_key_rejected": (
        ["cross_corr"], _set(1, "correlation", "scales", "spam"), "config", "scales"),
    "unknown_task": (["correlate_everything"], None, "config", "unknown task"),
    "no_tasks": ([], None, "config", "task"),
    "auto_ref_without_randoms": (
        ["auto_ref"], _drop("inputs", "reference", "path_rand"), "config", "path_rand"),
    "cross_without_any_randoms": (
        ["cross_corr"],
        _both(_drop("inputs", "reference", "path_rand"),
              _drop("inputs", "unknown", "path_rand")),
        "config", "randoms"),
    "hist_without_redshifts": (
        ["hist"], _drop("inputs", "unknown", "redshift"), "config", "redshift"),
    "reference_missing_redshift": (
        ["cross_corr"], _drop("inputs", "reference", "redshift"), "config", "redshift"),
    "missing_patch_source": (
        ["cross_corr"], _drop("inputs", "num_patches"), "config", "patch source"),
    "invalid_num_patches": (
        ["cross_corr"], _set("plenty", "inputs", "num_patches"), "config", "num_patches"),
    "zero_num_patches": (
        ["cross_corr"], _set(0, "inputs", "num_patches"), "config", "num_patches"),
    "colliding_bin_indices": (
        ["cross_corr"],
        _both(_set(lambda p: {"1": p["unknown"][1], 1: p["unknown"][1]},
                   "inputs", "unknown", "path_data"),
              _drop("inputs", "unknown", "path_rand")),
        "config", "not unique"),
    "mismatched_tomographic_rand_bins": (
        ["cross_corr"],
        _set(lambda p: {2: p["randoms"]}, "inputs", "unknown", "path_rand"),
        "config", "bin indices"),
    "missing_input_file": (
        ["cross_corr"],
        _set("/does/not/exist.fits", "inputs", "reference", "path_data"),
        "file", None),
    "auto_unk_without_randoms": (
        ["auto_unk"], _drop("inputs", "unknown", "path_rand"), "config", "randoms"),
    "auto_unk_without_redshifts": (
        ["auto_unk"], _drop("inputs", "unknown", "redshift"), "config", "redshift"),
    "reference_missing_coordinate_column": (
        ["cross_corr", "estimate"], _drop("inputs", "reference", "dec"), "config", None),
    "cross_with_all_randoms_removed": (
        ["cross_corr", "estimate"],
        _both(_drop("inputs", "reference", "path_rand"),
              _drop("inputs", "unknown", "path_rand")),
        "config", "random"),
    "reference_without_unknown_for_cross": (
        ["cross_corr"], _drop("inputs", "unknown"), "config", "unknown"),
}


@pytest.mark.parametrize("case", sorted(INVALID_SETUPS))
def test_invalid_setups_raise_as_in_jax(inputs, tmp_path, case):
    """Each invalid setup of the JAX package's tests raises the same error,
    with the same message (the ConfigError's key path included), in the
    port as in the JAX package."""
    tasks, mutation, kind, match = INVALID_SETUPS[case]
    setup = base_setup(inputs, tasks, patches=False)
    if mutation is not None:
        mutation(setup, inputs)
    errors = {}
    for package, runner, config_error in (
        ("jax", jax_run_setup, JaxConfigError),
        ("port", run_setup, ConfigError),
    ):
        root = tmp_path / package
        root.mkdir()
        setup_path = write_setup(root / "setup.yml", setup)
        kwargs = dict(device="cpu") if package == "port" else {}
        expected = config_error if kind == "config" else FileNotFoundError
        with pytest.raises(expected, match=match) as info:
            runner(root / "project", setup_path, quiet=True, **kwargs)
        errors[package] = str(info.value)
    assert errors["port"] == errors["jax"]


def _dumped(main, capsys) -> str:
    with pytest.raises(SystemExit):
        main(["--dump"])
    return capsys.readouterr().out


def test_dump_template_parses_to_the_same_setup(tmp_path, capsys, monkeypatch):
    """The dumped template of either package parses, in either package, to
    the same setup, and every task's requirements hold."""
    import yaml

    from yet_another_wizz_tpu.cli.config import ProjectConfig as JaxProjectConfig
    from yet_another_wizz_tpu_torch.cli.commandline import DUMP_TEMPLATE
    from yet_another_wizz_tpu_torch.cli.config import ProjectConfig
    from yet_another_wizz_tpu_torch.cli.directory import ProjectDirectory
    from yet_another_wizz_tpu_torch.cli.tasks import TaskList

    ours = yaml.safe_load(_dumped(port_main, capsys))
    theirs = yaml.safe_load(_dumped(jax_main, capsys))
    assert ours == theirs
    assert DUMP_TEMPLATE.startswith("# yet_another_wizz_tpu_torch v")
    monkeypatch.chdir(tmp_path)
    for section in ours["inputs"].values():
        if not isinstance(section, dict):
            continue
        for key in ("path_data", "path_rand"):
            value = section.get(key)
            for path in value.values() if isinstance(value, dict) else [value]:
                Path(path).touch()
    config = ProjectConfig.from_dict(ours)
    assert config.to_dict() == JaxProjectConfig.from_dict(theirs).to_dict()
    project = ProjectDirectory(tmp_path / "proj", config.bin_indices)
    TaskList(project, config, device="cpu")  # every task's check passes


# -- the port's counterparts of the JAX pipeline tests ----------------------------


def test_cli_needs_a_card_unless_asked_for_the_cpu(inputs, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    setup = write_setup(tmp_path / "setup.yml", base_setup(inputs, ["hist"]))
    assert port_main([str(tmp_path / "project"), setup, "--quiet"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "project").exists()


def test_module_entry_point(inputs, tmp_path):
    """``python -m yet_another_wizz_tpu_torch.cli`` runs a setup."""
    setup = write_setup(tmp_path / "setup.yml", base_setup(inputs, ["hist"]))
    done = subprocess.run(
        [sys.executable, "-m", "yet_another_wizz_tpu_torch.cli",
         str(tmp_path / "project"), setup, "--quiet", "--device", "cpu"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert done.returncode == 0, done.stdout + done.stderr
    assert (tmp_path / "project" / "true" / "nz_true_2.dat").exists()


def test_cli_error_reporting(tmp_path, capsys):
    assert port_main([str(tmp_path / "project"), "--quiet", "--device", "cpu"]) == 1
    assert "ERROR" in capsys.readouterr().err


def test_concurrent_run_blocked(inputs, tmp_path):
    from yet_another_wizz_tpu_torch.cli.pipeline import Pipeline

    setup_path = write_setup(tmp_path / "setup.yml", base_setup(inputs, ["hist"]))
    pipeline = Pipeline.create(tmp_path / "project", setup_path, device="cpu")
    # a crashed or concurrent run holding the lock
    pipeline.project.lock_path.write_text("12345:hist")
    with pytest.raises(RuntimeError, match="lock"):
        pipeline.run()
    pipeline.project.lock_path.unlink()
    pipeline.run()  # released lock allows the run
    assert not pipeline.project.lock_path.exists()


def test_partial_resume_runs_missing_tasks(inputs, tmp_path):
    run(tmp_path, base_setup(inputs, ["hist"]))
    resumed = run_setup(
        tmp_path / "project", setup_file=None, resume=True, quiet=True,
        device="cpu",
    )
    assert all(task.name != "hist" for task in resumed.tasks)


def test_overwrite_clears_external_cache(inputs, tmp_path):
    setup = base_setup(inputs, ["hist"], patches=False)
    setup["inputs"]["cache_path"] = str(tmp_path / "extcache")
    run(tmp_path, setup)
    stale = tmp_path / "extcache" / "patch_centers.npy"
    assert stale.exists()
    mtime = stale.stat().st_mtime_ns
    run(tmp_path, setup, overwrite=True)
    assert stale.stat().st_mtime_ns != mtime  # re-derived, not reused


def test_resume_reingests_truncated_cache(inputs, tmp_path):
    pipeline = run(tmp_path, base_setup(inputs, ["hist"]))
    handle = pipeline.project.cache.unknown[1]
    assert handle.exists()
    handle._sentinel.unlink()
    (handle.data.path / "patch_ids.bin").unlink()
    assert not handle.exists()
    resumed = run_setup(
        tmp_path / "project", setup_file=None, resume=True, quiet=True,
        device="cpu",
    )
    assert any(task.name == "cache_unk" for task in resumed.tasks)
    assert handle.exists()


def test_estimate_options(inputs, tmp_path):
    tasks = [
        "cross_corr",
        {"estimate": {"method": "bootstrap", "num_samples": 100, "estimator": "DP"}},
    ]
    pipeline = run(tmp_path, base_setup(inputs, tasks))
    nz = pipeline.project.estimate.nz_est[1].load()
    assert nz.method == "bootstrap"
    assert nz.samples.shape[0] == 100


@pytest.mark.parametrize(
    "tasks, match",
    [
        (["cross_corr", {"estimate": {"bogus": 1}}], "bogus"),
        ([{"cross_corr": None, "estimate": None}], "single-key"),
    ],
    ids=["unknown_option", "malformed_entry"],
)
def test_task_option_errors(inputs, tmp_path, tasks, match):
    with pytest.raises(ConfigError, match=match):
        run(tmp_path, base_setup(inputs, tasks))


def test_task_order_is_deterministic(inputs, tmp_path):
    """cache_ref comes before cache_unk whatever the hash seed (the first
    cached catalog defines the kmeans patch centers), and the queue is the
    JAX package's."""
    from yet_another_wizz_tpu.cli.config import ProjectConfig as JaxProjectConfig
    from yet_another_wizz_tpu.cli.directory import (
        ProjectDirectory as JaxProjectDirectory,
    )
    from yet_another_wizz_tpu.cli.tasks import TaskList as JaxTaskList
    from yet_another_wizz_tpu_torch.cli.config import ProjectConfig
    from yet_another_wizz_tpu_torch.cli.directory import ProjectDirectory
    from yet_another_wizz_tpu_torch.cli.tasks import TaskList

    setup = base_setup(inputs, TASKS, patches=False)
    config = ProjectConfig.from_dict(setup)
    project = ProjectDirectory(tmp_path / "port", config.bin_indices)
    names = [task.name for task in TaskList(project, config, device="cpu")]
    jax_config = JaxProjectConfig.from_dict(setup)
    jax_project = JaxProjectDirectory(tmp_path / "jax", jax_config.bin_indices)
    assert names == [task.name for task in JaxTaskList(jax_project, jax_config)]
    assert names.index("cache_ref") < names.index("cache_unk")
    assert set(names) == {"cache_ref", "cache_unk", *TASKS}


def test_resume_skips_every_task(projects, tmp_path):
    """``--resume`` on a finished project runs no task but ``plot``, which
    the JAX package regenerates on every run."""
    project = tmp_path / "project"
    shutil.copytree(projects / "port", project)
    before = {
        name: (project / name).read_bytes() for name in product_files(project)
        if not name.startswith("plots/")
    }
    pipeline = run_setup(project, resume=True, quiet=True, device="cpu")
    assert [task.name for task in pipeline.tasks] == ["plot"]
    for name, content in before.items():
        assert (project / name).read_bytes() == content


def test_blocked_lazy_execution_matches_in_memory(inputs, projects, tmp_path, monkeypatch):
    """``execution: {max_resident_patches, lazy}`` (the blocked engine over
    lazy catalogs, one session tile cache for the task list) gives the
    in-memory counts within 1e-6, and the session cache is hit."""
    from yet_another_wizz_tpu_torch.correlation import blocked

    caches = []
    original = blocked.measurement_tile_cache

    def spying(*args, **kwargs):
        context = original(*args, **kwargs)

        class Spy:
            def __enter__(self):
                caches.append(context.__enter__())
                return caches[-1]

            def __exit__(self, *exc):
                return context.__exit__(*exc)

        return Spy()

    monkeypatch.setattr(blocked, "measurement_tile_cache", spying)
    setup = base_setup(
        inputs, ["auto_ref", "cross_corr", "estimate"],
        execution=dict(max_resident_patches=3, lazy=True),
    )
    pipeline = run(tmp_path, setup)
    assert len(caches) == 1 and caches[0].hits > 0
    for name in ("auto_ref", "cross_1", "cross_2"):
        assert_counts_close(
            counts_of(load_corrfunc(pipeline.project.paircounts.path / f"{name}.hdf")),
            counts_of(load_corrfunc(projects / "port" / "paircounts" / f"{name}.hdf")),
        )
    for suffix in ("dat", "cov"):
        assert_table_close(
            pipeline.project.estimate.path / f"nz_est_1.{suffix}",
            projects / "port" / "estimate" / f"nz_est_1.{suffix}",
        )


def test_mesh_of_four_matches_one_device(inputs, tmp_path):
    """``execution: {devices: 4}`` (a mesh of four entries of the CPU)
    against ``devices: 1``."""
    results = {}
    for devices in (1, 4):
        root = tmp_path / f"devices_{devices}"
        root.mkdir()
        setup = base_setup(
            inputs, ["auto_ref", "cross_corr"], execution=dict(devices=devices)
        )
        project = run(root, setup).project
        results[devices] = {
            name: counts_of(load_corrfunc(project.paircounts.path / f"{name}.hdf"))
            for name in ("auto_ref", "cross_1", "cross_2")
        }
    for name, counts in results[1].items():
        assert_counts_close(results[4][name], counts)


def test_kmeans_patches(inputs, tmp_path):
    """With ``num_patches`` and no patch column the first cached catalog
    (the reference randoms) defines kmeans centers on the device, which
    every later catalog takes."""
    from yet_another_wizz_tpu_torch.catalog import Catalog

    pipeline = run(tmp_path, base_setup(inputs, ["cross_corr", "estimate"], patches=False))
    project = pipeline.project
    centers = project.cache.get_patch_centers()
    assert len(centers) == 8
    for handle in (project.cache.reference.data, project.cache.unknown[2].data):
        catalog = Catalog(handle.path)
        assert catalog.num_patches == 8
        # the same centers, up to the round trip through unit vectors
        assert_allclose(catalog.get_centers().data, centers.data, rtol=0, atol=1e-12)
    nz = project.estimate.nz_est[1].load()
    assert nz.samples.shape == (8, 5)
    assert np.all(np.isfinite(nz.data))


# -- two processes over gloo -------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _worker_pair(project: Path, setup: str) -> list[str]:
    """Two workers (``tests/torch_cli_worker.py``) running ``run_setup`` on
    one project over gloo; a hang or a taken port is retried once."""
    for attempt in range(2):
        port = _free_port()
        procs = []
        for rank in range(2):
            env = {
                key: value for key, value in os.environ.items()
                if not key.startswith(("YAWT_", "OMPI_"))
            }
            # one thread each, as in this module (see few_threads)
            env.update(
                OMP_NUM_THREADS="1",
                PYTHONPATH=str(REPO_ROOT), YAWT_COORDINATOR=f"localhost:{port}",
                YAWT_NUM_PROCESSES="2", YAWT_PROCESS_ID=str(rank),
            )
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(project), setup], env=env,
                cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        outputs = []
        try:
            for proc in procs:
                try:
                    outputs.append(proc.communicate(timeout=120)[0])
                except subprocess.TimeoutExpired:
                    proc.kill()
                    outputs.append(proc.communicate()[0] + "\n<timed out>")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        if all(proc.returncode == 0 for proc in procs):
            return outputs
        text = "".join(outputs)
        if attempt == 0 and any(
            word in text for word in ("<timed out>", "DistNetworkError", "EADDRINUSE")
        ):
            shutil.rmtree(project, ignore_errors=True)
            continue
        raise AssertionError(f"worker pair failed:\n{text}")
    raise AssertionError("worker pair failed twice")


def test_two_processes_run_one_project(inputs, tmp_path):
    """Two processes over gloo run the pipeline on one project (a global
    mesh of 2 shards); its products equal, bit for bit, those of one
    process on a mesh of 2 entries of the CPU."""
    setup = base_setup(
        inputs, ["auto_ref", "cross_corr", "estimate", "hist"],
        execution=dict(devices=2),
    )
    single = run(tmp_path, setup).project.path
    setup_path = write_setup(tmp_path / "setup_mp.yml", setup)
    outputs = _worker_pair(tmp_path / "mp", setup_path)
    assert all("CLI OK" in out for out in outputs)
    files = product_files(single)
    assert files and files == product_files(tmp_path / "mp")
    for name in files:
        if name.endswith(".hdf"):
            assert_counts_equal(
                counts_of(load_corrfunc(tmp_path / "mp" / name)),
                counts_of(load_corrfunc(single / name)),
            )
        else:
            assert (tmp_path / "mp" / name).read_bytes() == (single / name).read_bytes()
