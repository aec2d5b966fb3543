"""Chunked, out-of-memory readers for catalog input files.

Capability parity with the reference ``yaw.catalog.readers``
(yaw/catalog/readers.py:61-759): iterate FITS / HDF5 /
Parquet / CSV files in bounded-memory chunks, select and rename
columns, convert degrees to radian, draw sparse probe subsamples, and
dispatch on the file extension (:func:`new_filereader`).

The reference reads FITS through astropy; a minimal pure-numpy FITS
binary-table reader is implemented here instead (2880-byte header blocks,
BINTABLE extensions, big-endian numeric TFORM columns) — sufficient for the
tabular catalogs this framework consumes.

Ported from the JAX package's ``catalog/readers.py``, with its
dataframe (:class:`DataFrameReader`) and random-generator
(:class:`RandomReader`) readers. ``pandas``, ``pyarrow`` and ``h5py`` are
imported only inside the readers that need them, so FITS files and random
generators ingest without any of them.
"""

from __future__ import annotations

import logging
import re
from abc import ABC, abstractmethod
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.datachunk import DataChunk

if TYPE_CHECKING:
    from collections.abc import Iterator

    from numpy.typing import NDArray

__all__ = [
    "CHUNKSIZE",
    "CsvReader",
    "DataFrameReader",
    "FitsReader",
    "HDFReader",
    "ParquetReader",
    "RandomReader",
    "new_filereader",
    "prefetch_chunks",
]

logger = logging.getLogger(__name__)

CHUNKSIZE = 16_777_216
"""Default maximum number of rows per chunk."""


class BaseReader(ABC):
    """Iterate a data source in chunks of structured catalog arrays."""

    def __init__(
        self,
        *,
        ra_name: str,
        dec_name: str,
        weight_name: str | None = None,
        redshift_name: str | None = None,
        kappa_name: str | None = None,
        patch_name: str | None = None,
        chunksize: int | None = None,
        degrees: bool = True,
        **_ignored,
    ) -> None:
        self.columns = {
            "ra": ra_name,
            "dec": dec_name,
            "weights": weight_name,
            "redshifts": redshift_name,
            "kappa": kappa_name,
            "patch_ids": patch_name,
        }
        self.chunksize = int(chunksize or CHUNKSIZE)
        self.degrees = degrees
        self._num_records = None

    def __enter__(self):
        return self

    def __exit__(self, *args) -> None:
        self.close()

    def close(self) -> None:
        """Release any open file handles."""

    @property
    def num_records(self) -> int:
        """Total number of rows in the source."""
        return self._num_records

    @property
    def num_chunks(self) -> int:
        """Number of chunks the source splits into."""
        return -(-self.num_records // self.chunksize)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(num_records={self._num_records}, "
            f"num_chunks={self.num_chunks})"
        )

    @abstractmethod
    def _load_range(
        self, start: int, stop: int, columns: dict | None = None
    ) -> dict[str, NDArray]:
        """Load the raw named columns for a row range. ``columns``
        overrides the reader's configured column mapping — an explicit
        parameter, so a narrowed read (the probe pass) never mutates
        shared reader state observable by concurrent iterations."""

    def _to_chunk(
        self, raw: dict[str, NDArray], columns: dict | None = None
    ) -> NDArray:
        kwargs = {}
        for attr, name in (columns or self.columns).items():
            if name is not None:
                kwargs[attr] = raw[attr]
        ra = kwargs.pop("ra")
        dec = kwargs.pop("dec")
        return DataChunk.create(ra, dec, degrees=self.degrees, **kwargs)

    def __iter__(self) -> Iterator[NDArray]:
        for start in range(0, self.num_records, self.chunksize):
            stop = min(start + self.chunksize, self.num_records)
            yield self._to_chunk(self._load_range(start, stop))

    PROBE_ATTRS = ("ra", "dec", "weights")
    """The probe feeds patch-center generation, which only needs
    positions and weights: other configured columns are not read during
    the probe pass (a real I/O saving for column stores like HDF5 and
    Parquet; row stores still read full rows but skip the parsing)."""

    def get_probe(self, probe_size: int) -> NDArray:
        """A sparse, approximately uniform subsample of ``probe_size`` rows
        (used to bound the patch-center generation cost)."""
        probe_columns = {
            attr: (name if attr in self.PROBE_ATTRS else None)
            for attr, name in self.columns.items()
        }
        if probe_size >= self.num_records:
            rows = np.arange(self.num_records, dtype=np.int64)
        else:
            stride = self.num_records / probe_size
            rows = (np.arange(probe_size) * stride).astype(np.int64)
        parts = []
        for start in range(0, self.num_records, self.chunksize):
            stop = min(start + self.chunksize, self.num_records)
            local = rows[(rows >= start) & (rows < stop)] - start
            if len(local) == 0:
                continue
            raw = self._load_range(start, stop, probe_columns)
            parts.append(
                self._to_chunk(
                    {k: np.asarray(v)[local] for k, v in raw.items()},
                    probe_columns,
                )
            )
        return np.concatenate(parts)


class DataFrameReader(BaseReader):
    """Chunked reader over an in-memory (pandas-like) dataframe: anything
    with ``len``, ``.iloc`` row slices and columns by ``[name]``."""

    def __init__(self, dataframe, **kwargs) -> None:
        super().__init__(**kwargs)
        self._frame = dataframe
        self._num_records = len(dataframe)

    def _load_range(self, start, stop, columns=None):
        view = self._frame.iloc[start:stop]
        return {
            attr: np.asarray(view[name])
            for attr, name in (columns or self.columns).items()
            if name is not None
        }


class RandomReader(BaseReader):
    """Chunked sampling of a random point generator (duck-typed: a callable
    producing structured chunks, see :mod:`yet_another_wizz_tpu_torch.
    randoms`). Coordinates are in radian (``degrees=False``); weights and
    redshifts are carried where the generator draws them."""

    def __init__(self, generator, num_randoms: int, **kwargs) -> None:
        kwargs.setdefault("ra_name", "ra")
        kwargs.setdefault("dec_name", "dec")
        kwargs.setdefault("degrees", False)
        super().__init__(**kwargs)
        self._generator = generator
        self._num_records = int(num_randoms)

    def _load_range(self, start, stop, columns=None):
        chunk = self._generator(stop - start)
        raw = {"ra": chunk["ra"], "dec": chunk["dec"]}
        for attr in ("weights", "redshifts"):
            value = DataChunk.getattr(chunk, attr)
            if value is not None:
                raw[attr] = value
        return raw

    def _to_chunk(self, raw, columns=None):
        raw = dict(raw)
        return DataChunk.create(
            raw.pop("ra"), raw.pop("dec"), degrees=False, **raw
        )


class CsvReader(BaseReader):
    """Reader for delimited text catalogs (loaded in memory via pandas;
    CSV is not a chunkable format, so bounded-memory streaming applies
    only to the patch-assignment stage downstream)."""

    def __init__(self, path: Path | str, **kwargs) -> None:
        import pandas as pd

        super().__init__(**kwargs)
        self.path = Path(path)
        usecols = [n for n in (
            kwargs.get("ra_name"), kwargs.get("dec_name"),
            kwargs.get("weight_name"), kwargs.get("redshift_name"),
            kwargs.get("kappa_name"), kwargs.get("patch_name"),
        ) if n is not None]
        self._frame = pd.read_csv(self.path, usecols=usecols)
        self._num_records = len(self._frame)

    def _load_range(self, start, stop, columns=None):
        view = self._frame.iloc[start:stop]
        return {
            attr: np.asarray(view[name])
            for attr, name in (columns or self.columns).items()
            if name is not None
        }


class ParquetReader(BaseReader):
    """Chunked Parquet reader (row-group aware, via pyarrow)."""

    def __init__(self, path: Path | str, **kwargs) -> None:
        import pyarrow.parquet as pq

        super().__init__(**kwargs)
        self.path = Path(path)
        # memory-mapped reads skip the buffered-read copy (a fresh
        # multi-MB allocation per row group, which is expensive to fault
        # in); pages come straight from the OS cache
        self._file = pq.ParquetFile(self.path, memory_map=True)
        self._num_records = self._file.metadata.num_rows
        # prefix sums of row-group sizes for range slicing
        sizes = [
            self._file.metadata.row_group(i).num_rows
            for i in range(self._file.num_row_groups)
        ]
        self._rg_offsets = np.concatenate([[0], np.cumsum(sizes)])

    def close(self) -> None:
        self._file.close()

    def _load_range(self, start, stop, columns=None):
        columns = columns or self.columns
        first = int(np.searchsorted(self._rg_offsets, start, "right")) - 1
        last = int(np.searchsorted(self._rg_offsets, stop, "left"))
        names = [n for n in columns.values() if n is not None]
        table = self._file.read_row_groups(
            list(range(first, last)), columns=names
        )
        offset = start - self._rg_offsets[first]
        table = table.slice(offset, stop - start)
        return {
            attr: np.asarray(table[name])
            for attr, name in columns.items()
            if name is not None
        }


class HDFReader(BaseReader):
    """Chunked HDF5 reader (one dataset per column, via h5py)."""

    def __init__(self, path: Path | str, **kwargs) -> None:
        import h5py

        super().__init__(**kwargs)
        self.path = Path(path)
        self._file = h5py.File(self.path, mode="r")
        lengths = {
            len(self._file[name])
            for name in self.columns.values()
            if name is not None
        }
        if len(lengths) != 1:
            raise ValueError("columns do not have equal length")
        (self._num_records,) = lengths

    def close(self) -> None:
        self._file.close()

    def _load_range(self, start, stop, columns=None):
        return {
            attr: self._file[name][start:stop]
            for attr, name in (columns or self.columns).items()
            if name is not None
        }


class FitsReader(BaseReader):
    """Chunked FITS binary-table reader, implemented in pure numpy.

    Parses the primary header and extension headers (2880-byte blocks of
    80-character cards), locates the first BINTABLE extension, and maps
    fixed-width big-endian numeric columns (TFORM L/B/I/J/K/E/D including
    repeat counts) onto a numpy structured dtype read with ``np.memmap``.

    Column semantics follow the FITS standard the way astropy/cfitsio apply
    them for the reference (yaw/catalog/readers.py:481-560):
    ``TSCALn``/``TZEROn`` linear scaling is applied to produce physical
    values (including the unsigned-integer convention TZERO=2^(bits-1)),
    and logical columns decode 'T'/'F' bytes. Rows matching an integer
    ``TNULLn`` sentinel are rejected loudly (catalog coordinates admit no
    missing values; filter nulls before ingestion). Selected columns must
    be scalar (repeat count 1); array columns and unsupported TFORM codes
    raise instead of being misread.
    """

    _TFORM_DTYPES = {
        "L": "u1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
        "E": ">f4", "D": ">f8",
    }

    def __init__(self, path: Path | str, *, hdu: int = 1, **kwargs) -> None:
        super().__init__(**kwargs)
        self.path = Path(path)
        header, data_offset = self._find_table_hdu(hdu)
        self._dtype, self._num_records = self._parse_table_header(header)
        self._offset = data_offset

    def _read_header_blocks(self, f) -> dict:
        """Read one header (sequence of 2880-byte blocks up to END)."""
        cards = {}
        while True:
            block = f.read(2880)
            if len(block) < 2880:
                raise ValueError("truncated FITS header")
            for i in range(0, 2880, 80):
                card = block[i : i + 80].decode("ascii", errors="replace")
                key = card[:8].strip()
                if key == "END":
                    return cards
                if "=" not in card[8:10]:
                    continue
                raw = card[10:]
                if raw.lstrip().startswith("'"):
                    # quoted string: take up to the closing quote ('' escapes)
                    body = raw.lstrip()[1:]
                    out, i = [], 0
                    while i < len(body):
                        if body[i] == "'":
                            if body[i : i + 2] == "''":
                                out.append("'")
                                i += 2
                                continue
                            break
                        out.append(body[i])
                        i += 1
                    value = "".join(out).strip()
                else:
                    value = raw.split("/")[0].strip()
                cards[key] = value

    def _find_table_hdu(self, hdu_index: int):
        with self.path.open("rb") as f:
            if f.read(6) != b"SIMPLE":
                raise ValueError(f"not a FITS file: {self.path}")
            f.seek(0)
            index = 0
            while True:
                cards = self._read_header_blocks(f)
                # size of the data unit that follows
                bitpix = abs(int(cards.get("BITPIX", 8)))
                naxis = int(cards.get("NAXIS", 0))
                size = 1 if naxis else 0
                for ax in range(1, naxis + 1):
                    size *= int(cards.get(f"NAXIS{ax}", 0))
                nbytes = bitpix // 8 * size * int(cards.get("GCOUNT", 1))
                nbytes += int(cards.get("PCOUNT", 0))
                data_start = f.tell()
                if index == hdu_index:
                    xtension = cards.get("XTENSION", "")
                    if xtension == "TABLE":
                        # ASCII tables use Fortran formats (F10.4, ...)
                        # that the binary-table parser would misreport as
                        # variable-length columns
                        raise ValueError(
                            f"HDU {hdu_index} is an ASCII table; only "
                            "binary tables (BINTABLE) are supported"
                        )
                    if xtension != "BINTABLE":
                        raise ValueError(
                            f"HDU {hdu_index} is not a binary table"
                        )
                    return cards, data_start
                f.seek(data_start + -(-nbytes // 2880) * 2880)
                index += 1

    def _parse_table_header(self, cards: dict):
        num_fields = int(cards["TFIELDS"])
        num_rows = int(cards["NAXIS2"])
        row_bytes = int(cards["NAXIS1"])
        fields = []
        self._column_meta: dict[str, tuple] = {}
        for i in range(1, num_fields + 1):
            name = cards.get(f"TTYPE{i}", f"col{i}")
            tform = cards[f"TFORM{i}"].strip()
            match = re.match(r"^(\d*)([A-Z])(.*)$", tform)
            if match is None or match.group(3):
                # trailing text = variable-length 'rPt(max)' or malformed
                raise ValueError(
                    f"unsupported FITS column format '{tform}' for column "
                    f"'{name}' (variable-length and descriptor columns are "
                    "not supported)"
                )
            repeat = int(match.group(1)) if match.group(1) else 1
            code = match.group(2)
            if code == "A":
                fields.append((name, f"S{repeat}"))
                self._column_meta[name] = ("A", repeat, 1.0, 0.0, None)
                continue
            if code not in self._TFORM_DTYPES:
                raise ValueError(
                    f"unsupported FITS column format '{tform}' for column "
                    f"'{name}' (supported: scalar/array L, B, I, J, K, E, D "
                    "and character A)"
                )
            tscale = float(cards.get(f"TSCAL{i}", 1.0))
            tzero = float(cards.get(f"TZERO{i}", 0.0))
            tnull_card = cards.get(f"TNULL{i}")
            tnull = int(tnull_card) if tnull_card is not None else None
            if tnull is not None and code in ("E", "D"):
                raise ValueError(
                    f"invalid TNULL{i} on floating-point column '{name}' "
                    "(FITS uses NaN for floating-point nulls)"
                )
            self._column_meta[name] = (code, repeat, tscale, tzero, tnull)
            base = self._TFORM_DTYPES[code]
            fields.append((name, base, (repeat,)) if repeat > 1 else (name, base))
        dtype = np.dtype(fields)
        if dtype.itemsize != row_bytes:
            raise ValueError(
                "FITS table row size mismatch "
                f"({dtype.itemsize} != {row_bytes})"
            )
        return dtype, num_rows

    def _physical_values(self, rows: NDArray, name: str) -> NDArray:
        """Stored -> physical values for one selected column."""
        try:
            code, repeat, tscale, tzero, tnull = self._column_meta[name]
        except KeyError:
            raise KeyError(
                f"column '{name}' not present in FITS table "
                f"(available: {', '.join(self._column_meta)})"
            ) from None
        if code == "A":
            raise ValueError(
                f"FITS column '{name}' holds character data, not numbers"
            )
        if repeat != 1:
            raise ValueError(
                f"FITS column '{name}' is an array column (repeat {repeat}); "
                "only scalar columns can be used as catalog attributes"
            )
        stored = rows[name]
        if code == "L":
            # logical bytes 'T'/'F' (0 = undefined -> NaN)
            values = (stored == ord("T")).astype(np.float64)
            values[stored == 0] = np.nan
            return values
        values = stored.astype(np.float64)
        if tnull is not None and np.any(null_mask := stored == tnull):
            raise ValueError(
                f"FITS column '{name}' contains {int(null_mask.sum())} null "
                f"(TNULL={tnull}) entries; filter them before ingestion"
            )
        if tscale != 1.0 or tzero != 0.0:
            values = tzero + tscale * values
        return values

    def _load_range(self, start, stop, columns=None):
        rows = np.fromfile(
            self.path,
            dtype=self._dtype,
            count=stop - start,
            offset=self._offset + start * self._dtype.itemsize,
        )
        if len(rows) != stop - start:
            # np.fromfile silently returns fewer rows past EOF
            raise ValueError(
                f"truncated FITS table: {self.path} header claims "
                f"{self.num_records} rows but the data section ends at row "
                f"{start + len(rows)}"
            )
        return {
            attr: self._physical_values(rows, name)
            for attr, name in (columns or self.columns).items()
            if name is not None
        }


_READERS = {
    ".csv": CsvReader,
    ".fits": FitsReader,
    ".fit": FitsReader,
    ".cat": FitsReader,
    ".hdf5": HDFReader,
    ".hdf": HDFReader,
    ".h5": HDFReader,
    ".pqt": ParquetReader,
    ".parquet": ParquetReader,
}


def new_filereader(path: Path | str, **kwargs) -> BaseReader:
    """Create the appropriate reader for a file, dispatching on the
    extension (FITS / HDF5 / Parquet)."""
    ext = Path(path).suffix.lower()
    try:
        reader_cls = _READERS[ext]
    except KeyError:
        raise ValueError(f"unrecognized file extension '{ext}'") from None
    return reader_cls(path, **kwargs)


def prefetch_chunks(reader, depth: int = 1):
    """Iterate a chunked reader with background read-ahead: up to ``depth``
    chunks are loaded in a worker thread while the consumer processes the
    current one (overlaps file I/O with downstream work).

    If the consumer abandons the generator mid-stream (an ingestion error
    downstream), the producer is told to stop instead of blocking forever
    on the full queue — which would leak a thread pinning chunk-sized
    buffers and keep reading a reader the caller may already have closed.
    """
    import queue
    import threading

    work: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    errors: list[BaseException] = []
    abandoned = threading.Event()

    def producer() -> None:
        try:
            for chunk in reader:
                while True:
                    if abandoned.is_set():
                        return
                    try:
                        work.put(chunk, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as err:
            errors.append(err)
        finally:
            # deliver the sentinel unless the consumer abandoned us (then
            # nothing is waiting for it)
            while not abandoned.is_set():
                try:
                    work.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = work.get()
            if item is sentinel:
                break
            yield item
    finally:
        abandoned.set()
        # unblock a producer waiting to put by draining pending items
        while True:
            try:
                work.get_nowait()
            except queue.Empty:
                break
        # bounded join: the (daemon) producer may be mid-read of a large
        # chunk and only checks abandonment between chunks; error
        # propagation must not wait tens of seconds for that read
        thread.join(timeout=1.0)
    if errors:
        raise errors[0]
