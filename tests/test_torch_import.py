"""The PyTorch port stands on its own: it imports neither ``jax`` nor the
JAX package, and the CUDA backend never falls back to the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

SLICE_MODULES = [
    "yet_another_wizz_tpu_torch",
    "yet_another_wizz_tpu_torch.options",
    "yet_another_wizz_tpu_torch.utils",
    "yet_another_wizz_tpu_torch.utils.abc",
    "yet_another_wizz_tpu_torch.utils.misc",
    "yet_another_wizz_tpu_torch.parallel.distributed",
    "yet_another_wizz_tpu_torch.binning",
    "yet_another_wizz_tpu_torch.coordinates",
    "yet_another_wizz_tpu_torch.cosmology",
    "yet_another_wizz_tpu_torch.config",
    "yet_another_wizz_tpu_torch.datachunk",
    "yet_another_wizz_tpu_torch._native",
    "yet_another_wizz_tpu_torch.ops.kmeans",
    "yet_another_wizz_tpu_torch.catalog",
    "yet_another_wizz_tpu_torch.ops.gweight",
    "yet_another_wizz_tpu_torch.ops.thresholds",
    "yet_another_wizz_tpu_torch.ops.tiles",
    "yet_another_wizz_tpu_torch.ops.linkage",
    "yet_another_wizz_tpu_torch.ops.paircount",
    "yet_another_wizz_tpu_torch.ops.cuda_paircount",
    "yet_another_wizz_tpu_torch.ops.cpu_oracle",
    "yet_another_wizz_tpu_torch.models.estimators",
    "yet_another_wizz_tpu_torch.correlation",
    "yet_another_wizz_tpu_torch.correlation.measurements",
    "yet_another_wizz_tpu_torch.redshifts",
    "yet_another_wizz_tpu_torch.examples",
    "yet_another_wizz_tpu_torch.interop",
    "yet_another_wizz_tpu_torch.utils.healpix",
    "yet_another_wizz_tpu_torch.utils.logging",
    "yet_another_wizz_tpu_torch.randoms",
    "yet_another_wizz_tpu_torch.catalog.patch",
    "yet_another_wizz_tpu_torch.catalog.readers",
    "yet_another_wizz_tpu_torch.catalog.ingest",
    "yet_another_wizz_tpu_torch.catalog.lazy",
    "yet_another_wizz_tpu_torch.catalog.tilestore",
    "yet_another_wizz_tpu_torch.correlation.blocked",
    "yet_another_wizz_tpu_torch.utils.plotting",
    "yet_another_wizz_tpu_torch.cli",
    "yet_another_wizz_tpu_torch.cli.config",
    "yet_another_wizz_tpu_torch.cli.directory",
    "yet_another_wizz_tpu_torch.cli.tasks",
    "yet_another_wizz_tpu_torch.cli.pipeline",
    "yet_another_wizz_tpu_torch.cli.plotting",
    "yet_another_wizz_tpu_torch.cli.commandline",
]

BLOCKED_IMPORT = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["yet_another_wizz_tpu"] = None
# optional I/O packages: the main path must not need them
sys.modules["h5py"] = None
sys.modules["yaml"] = None
sys.modules["pandas"] = None
sys.modules["pyarrow"] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
loaded = sorted(
    name for name, module in sys.modules.items()
    if module is not None and (
        name == "jax" or name.startswith(("jax.", "jaxlib"))
        or name == "yet_another_wizz_tpu"
        or name.startswith("yet_another_wizz_tpu.")
    )
)
print(loaded)
"""


def test_port_imports_without_jax():
    root = Path(__file__).resolve().parents[1]
    result = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT, *SLICE_MODULES],
        cwd=root, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "[]"


def test_cuda_backend_refuses_cpu_tensors():
    from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
    from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
    from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set

    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(100, 3))
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    patches = np.zeros(100, dtype=int)
    tiles1 = build_tile_set(
        xyz, patches, 1, zbins=rng.integers(0, 2, 100), num_bins=2,
        tile_size=64,
    )
    tiles2 = build_tile_set(xyz, patches, 1, tile_size=64)
    pairs = TilePairs(
        tile1=np.zeros(2, np.int32), tile2=np.arange(2, dtype=np.int32),
        slot=np.zeros(2, np.int32), slot_patches=np.zeros((1, 2), int),
    )
    table = np.full((2, 2), 0.01, np.float32)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        count_pairs_tiles(
            tiles1, tiles2, pairs, table, backend="cuda", device="cpu"
        )
    with pytest.raises(TypeError, match="Mesh"):
        count_pairs_tiles(
            tiles1, tiles2, pairs, table, device="cpu", mesh=object()
        )
    # the audit runs on the device asked for, and needs the edges
    with pytest.raises(ValueError, match="edges_radian"):
        count_pairs_tiles(tiles1, tiles2, pairs, table, device="cpu", audit=True)
    edges = np.full((2, 2), 0.1)
    audited = count_pairs_tiles(
        tiles1, tiles2, pairs, table, device="cpu", audit=True,
        edges_radian=edges,
    )
    assert audited.shape == (1, 2, 2) and audited.dtype == np.float64
    # direct counting runs; a table without room for its parameter block
    # has no counting edges
    with pytest.raises(ValueError, match="no counting edges"):
        count_pairs_tiles(
            tiles1, tiles2, pairs, table, device="cpu", direct=(10, 0, 0)
        )
