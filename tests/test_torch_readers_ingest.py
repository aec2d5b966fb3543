"""The dataframe and random-generator readers and the streaming ingestion
against the JAX package, on the CPU.

The same columns (a pandas frame) and the same seeded generators go through
both packages' ``DataFrameReader`` and ``RandomReader``: every chunk and the
probe are equal. ``write_patches_streaming`` with ``keep_data=False``
returns no data and writes patch files byte-identical to the JAX package's
for the same reader and patch centers, with a ``buffersize`` small enough
that every patch flushes several times; with ``keep_data=True`` it writes
the same files and returns the rows of the cache, and without a cache it
skips the disk. Neither package ingests with no cache and no
``keep_data``. ``PatchWriter(buffersize=)`` flushes when its buffer holds
that many rows, as the JAX package's does, and the collective writer in a
one-process job writes the streaming writer's cache.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per test process)
from pathlib import Path

import numpy as np
import pytest
from numpy.testing import assert_array_equal

from yet_another_wizz_tpu.catalog import ingest as jax_ingest
from yet_another_wizz_tpu.catalog import patch as jax_patch
from yet_another_wizz_tpu.catalog import readers as jax_readers
from yet_another_wizz_tpu import randoms as jax_randoms
from yet_another_wizz_tpu_torch import randoms
from yet_another_wizz_tpu_torch.catalog import Catalog, ingest, patch, readers
from yet_another_wizz_tpu_torch.coordinates import radec_to_xyz

NAMES = dict(ra_name="RA", dec_name="DEC", weight_name="W", redshift_name="Z")
NUM_ROWS = 3000
NUM_CENTERS = 6
BUFFERSIZE = 100


@pytest.fixture(scope="module")
def frame():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(5)
    return pd.DataFrame(dict(
        RA=rng.uniform(10, 30, 1000), DEC=rng.uniform(-5, 5, 1000),
        W=rng.uniform(0.5, 2.0, 1000), Z=rng.uniform(0.1, 1.0, 1000),
    ))


def assert_same_chunks(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("chunksize", [300, 1000])
def test_dataframe_reader_equals_jax(frame, chunksize):
    with readers.DataFrameReader(frame, **NAMES, chunksize=chunksize) as ours, \
            jax_readers.DataFrameReader(frame, **NAMES, chunksize=chunksize) as theirs:
        assert (ours.num_records, ours.num_chunks) == (theirs.num_records, theirs.num_chunks)
        assert_same_chunks(list(ours), list(theirs))
        assert_same_chunks([ours.get_probe(100)], [theirs.get_probe(100)])


def generators(kind: str, package):
    """A seeded generator of ``package`` (the port's or the JAX package's
    ``randoms`` module) drawing weights and redshifts."""
    rng = np.random.default_rng(9)
    attrs = dict(weights=rng.uniform(0.5, 2.0, 500), redshifts=rng.uniform(0.1, 1.0, 500))
    if kind == "box":
        return package.BoxRandoms(10, 30, -5, 5, seed=3, **attrs)
    nside = 8
    mask = np.zeros(12 * nside**2)
    mask[100:300] = 1.0
    return package.HealPixRandoms(mask, seed=3, **attrs)


@pytest.mark.parametrize("kind", ["box", "healpix"])
def test_random_reader_equals_jax(kind):
    ours = readers.RandomReader(generators(kind, randoms), 1000, chunksize=256)
    theirs = jax_readers.RandomReader(generators(kind, jax_randoms), 1000, chunksize=256)
    chunks = list(ours)
    assert_same_chunks(chunks, list(theirs))
    assert [len(c) for c in chunks] == [256, 256, 256, 232]
    assert set(chunks[0].dtype.names) == {"ra", "dec", "weights", "redshifts"}


def random_reader(package_readers, package_randoms):
    return package_readers.RandomReader(
        generators("box", package_randoms), NUM_ROWS, chunksize=700
    )


@pytest.fixture(scope="module")
def centers():
    ra = np.deg2rad(np.linspace(12, 28, NUM_CENTERS))
    dec = np.deg2rad(np.tile([-2.5, 2.5], NUM_CENTERS // 2))
    return radec_to_xyz(ra, dec)


def cache_files(root: Path) -> dict:
    return {
        p.relative_to(root).as_posix(): p.read_bytes()
        for p in sorted(root.rglob("*")) if p.is_file()
    }


def test_streaming_without_kept_data_equals_jax(tmp_path, centers, monkeypatch):
    flushes = []
    flush = patch.PatchWriter.flush

    def counted(writer):
        flushes.append(writer.num_buffered)
        flush(writer)

    monkeypatch.setattr(patch.PatchWriter, "flush", counted)
    num, assembled = ingest.write_patches_streaming(
        random_reader(readers, randoms), tmp_path / "port", centers,
        buffersize=BUFFERSIZE, device="cpu",
    )
    jax_num, jax_assembled = jax_ingest.write_patches_streaming(
        random_reader(jax_readers, jax_randoms), tmp_path / "jax", centers,
        buffersize=BUFFERSIZE,
    )
    assert assembled is None and jax_assembled is None
    assert num == jax_num == NUM_CENTERS
    ours = cache_files(tmp_path / "port")
    assert ours == cache_files(tmp_path / "jax")
    assert len(ours) == 2 * NUM_CENTERS + 1  # data.bin, meta.yml; patch_ids.bin
    # several flushes per patch, each of at least buffersize rows but the last
    assert len(flushes) >= 3 * NUM_CENTERS
    assert sum(n >= BUFFERSIZE for n in flushes) >= 2 * NUM_CENTERS
    assert len(Catalog(tmp_path / "port").ra) == NUM_ROWS


def test_kept_data_writes_the_same_cache_and_returns_its_rows(tmp_path, centers):
    ingest.write_patches_streaming(
        random_reader(readers, randoms), tmp_path / "streamed", centers,
        buffersize=BUFFERSIZE, device="cpu",
    )
    num, (chunk, patch_ids) = ingest.write_patches_streaming(
        random_reader(readers, randoms), tmp_path / "kept", centers,
        buffersize=BUFFERSIZE, keep_data=True, device="cpu",
    )
    assert cache_files(tmp_path / "kept") == cache_files(tmp_path / "streamed")
    cached = Catalog(tmp_path / "streamed")
    assert num == cached.num_patches
    for name in ("ra", "dec", "weights", "redshifts"):
        assert_array_equal(chunk[name], getattr(cached, name))
    assert_array_equal(patch_ids, cached.patch_ids)


def test_kept_data_without_a_cache_skips_the_disk(tmp_path, centers, monkeypatch):
    monkeypatch.chdir(tmp_path)
    num, (chunk, patch_ids) = ingest.write_patches_streaming(
        random_reader(readers, randoms), None, centers, keep_data=True, device="cpu",
    )
    jax_num, (jax_chunk, jax_ids) = jax_ingest.write_patches_streaming(
        random_reader(jax_readers, jax_randoms), None, centers, keep_data=True,
    )
    assert list(tmp_path.iterdir()) == []
    assert num == jax_num
    assert chunk.tobytes() == jax_chunk.tobytes()
    assert_array_equal(patch_ids, jax_ids)


def test_neither_cache_nor_kept_data_raises(centers):
    with pytest.raises(ValueError, match="cache_directory or keep_data"):
        ingest.write_patches_streaming(
            random_reader(readers, randoms), None, centers, device="cpu"
        )
    with pytest.raises(ValueError, match="cache_directory or keep_data"):
        jax_ingest.write_patches_streaming(
            random_reader(jax_readers, jax_randoms), None, centers
        )


def test_patch_writer_flushes_at_its_buffersize(tmp_path):
    chunk = generators("box", randoms)(40)
    sizes = []
    for package, name in ((patch, "port"), (jax_patch, "jax")):
        info = package.DataChunk.get_info(chunk)
        writer = package.PatchWriter(tmp_path / name, info, buffersize=10)
        assert writer.buffersize == 10
        written = []
        for start in range(0, 40, 4):
            writer.process_chunk(chunk[start : start + 4])
            written.append(writer.data_path.stat().st_size if writer.data_path.exists() else 0)
        writer.finalize()
        sizes.append(written)
    assert sizes[0] == sizes[1]
    assert sizes[0][:3] == [0, 0, 1 + 12 * chunk.itemsize]  # a flush at 12 rows
    assert (tmp_path / "port" / "data.bin").read_bytes() == (
        tmp_path / "jax" / "data.bin"
    ).read_bytes()
    default = patch.PatchWriter(tmp_path / "default", patch.DataChunk.get_info(chunk))
    assert default.buffersize == patch.DEFAULT_BUFFERSIZE == jax_patch.DEFAULT_BUFFERSIZE


def test_collective_writer_in_one_process_equals_streaming(tmp_path, centers):
    num = ingest.write_patches_collective(
        random_reader(readers, randoms), tmp_path / "collective", centers,
        buffersize=BUFFERSIZE, device="cpu",
    )
    ingest.write_patches_streaming(
        random_reader(readers, randoms), tmp_path / "streamed", centers,
        buffersize=BUFFERSIZE, device="cpu",
    )
    assert num == NUM_CENTERS
    assert cache_files(tmp_path / "collective") == cache_files(tmp_path / "streamed")
