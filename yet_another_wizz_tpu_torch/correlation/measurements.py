"""Cross- and autocorrelation measurement functions.

Ported from the JAX package's ``correlation/measurements.py``:
:func:`autocorrelate`, :func:`crosscorrelate` and
their scalar-field variants, the patch-consistency checks, and the
:class:`PatchLinkage` scheduling helper, mirroring the reference
``yaw.correlation.measurements`` (yaw/correlation/measurements.py:65-794),
including the autocorrelation conventions (same-patch counts halved, only
ordered patch pairs with ``id2 >= id1``).

Execution model: the linked patch grid is expanded into a tile-pair list
and pushed through the pair-count engine (:mod:`yet_another_wizz_tpu_torch.ops`)
on one torch device; results come back as a cumulative (slot, bin, edge)
tensor that is mapped to per-scale patch-pair count tensors on the host in
float64. Every count of a measurement is queued on the device before the
first result is read: each result is copied to pinned host memory without
blocking, and the host waits for one count at a time while it
post-processes the previous one.

While a torch profiler records, the stages are spans
(:mod:`~yet_another_wizz_tpu_torch.utils.tracing`): the call itself
(``crosscorrelate``, ``autocorrelate`` and the scalar variants), the patch
linkage and edge tables (``linkage``), and per count type
``count.<dd|dr|rd|rr>``, once while the count is queued (the tile lookup
``tiles``, the pair list ``pairs``, ``engine.queue`` from the threshold
table to the queued copy of the result) and once while it is finished
(``finalize``, with the wait for the result, ``fetch``).

With ``max_resident_patches`` the counts stream through the blocked
out-of-core path instead (:mod:`yet_another_wizz_tpu_torch.correlation.
blocked`), which also takes a disk-backed
:class:`~yet_another_wizz_tpu_torch.catalog.lazy.LazyCatalog`; the count
types of one measurement share one tile cache.

With ``audit=True`` every count passes the exact-boundary audit
(:func:`~yet_another_wizz_tpu_torch.ops.paircount.audit_boundary_counts`):
it counts with the union edges (no direct mode), synchronously, and
recounts in float64 the patch-pair slots that hold a pair within float32
resolution of an edge.

With ``mesh`` (a :class:`~yet_another_wizz_tpu_torch.parallel.sharded.
Mesh`, ``"single"``, or None for the automatic pool) every count runs
sharded over the mesh in the layout ``data_sharding``
(:func:`~yet_another_wizz_tpu_torch.parallel.count_pairs_sharded`), in
memory or per block pair.
"""

from __future__ import annotations

import contextlib
import logging
from typing import TYPE_CHECKING

import numpy as np
import torch

from yet_another_wizz_tpu_torch.catalog.catalog import (
    Catalog,
    InconsistentPatchesError,
)
from yet_another_wizz_tpu_torch.correlation.corrfunc import (
    CorrFunc,
    ScalarCorrFunc,
)
from yet_another_wizz_tpu_torch.correlation.paircounts import (
    NormalisedCounts,
    NormalisedScalarCounts,
    PatchedCounts,
    PatchedSumWeights,
)
from yet_another_wizz_tpu_torch.ops.linkage import (
    Linkage,
    build_linkage,
    build_tile_pairs,
)
from yet_another_wizz_tpu_torch.ops.paircount import (
    count_pairs_tiles,
    resolve_device,
)
from yet_another_wizz_tpu_torch.ops.thresholds import (
    AngularEdges,
    build_angular_edges,
)
from yet_another_wizz_tpu_torch.ops.tiles import preferred_tile_layout
from yet_another_wizz_tpu_torch.utils.tracing import span, spanned

if TYPE_CHECKING:
    from collections.abc import Callable

    from numpy.typing import NDArray

    from yet_another_wizz_tpu_torch.config import Configuration

__all__ = [
    "PatchLinkage",
    "autocorrelate",
    "autocorrelate_scalar",
    "compute_scalar_normalisation",
    "crosscorrelate",
    "crosscorrelate_scalar",
]

logger = logging.getLogger(__name__)

LINKAGE_SLACK = 1.0 + 1e-9
"""Relative slack on the linkage cutoff so pairs exactly at the maximum
angular scale are never pruned."""


@contextlib.contextmanager
def _measurement_cache(max_resident_patches):
    """The tile cache the count types of one blocked measurement share
    (:func:`~yet_another_wizz_tpu_torch.correlation.blocked.
    measurement_tile_cache`): the caller's ambient cache when one is open,
    else a new one for this measurement; None for the in-memory path."""
    if max_resident_patches is None:
        yield None
        return
    from yet_another_wizz_tpu_torch.correlation.blocked import (
        active_tile_cache,
        measurement_tile_cache,
    )

    ambient = active_tile_cache()
    if ambient is not None:
        yield ambient
        return
    with measurement_tile_cache() as cache:
        yield cache


def _preferred_tile_layout(
    catalog, num_bins: int, edges, *, equal_bin_counting: bool
) -> str:
    """Measurement-facing shim over
    :func:`yet_another_wizz_tpu_torch.ops.tiles.preferred_tile_layout` (see
    there for the zmajor-vs-spatial policy rationale) that extracts the
    maximum angle from a threshold-edge table."""
    return preferred_tile_layout(
        catalog, num_bins, edges.max_angle if num_bins > 0 else 0.0,
        equal_bin_counting=equal_bin_counting,
    )


def _copy_to_host(result: NDArray | torch.Tensor) -> Callable[[], NDArray]:
    """Start moving an engine result to the host; the returned callable
    waits for it (the span ``fetch``) and returns float64 numpy. A CUDA
    result is copied into pinned memory without blocking, after the work
    already queued on the current stream."""
    if isinstance(result, np.ndarray):
        return lambda: result
    if result.device.type != "cuda":

        def read() -> NDArray:
            with span("fetch"):
                host = result.numpy()
            return host.astype(np.float64)

        return read
    host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
    host.copy_(result, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(result.device))

    def wait() -> NDArray:
        with span("fetch"):
            done.synchronize()
        return host.numpy().astype(np.float64)

    return wait


def check_patch_consistency(catalog: Catalog, *catalogs: Catalog, rtol: float = 0.5):
    """Verify that all catalogs share (approximately) the same patch
    centers, within ``rtol`` times the patch radius."""
    centers = catalog.get_centers()
    radii = catalog.get_radii()
    for other in catalogs:
        if other.num_patches != catalog.num_patches:
            raise InconsistentPatchesError("patch IDs do not match")
        distance = centers.distance(other.get_centers())
        if np.any(distance.data / np.maximum(radii.data, 1e-12) > rtol):
            raise InconsistentPatchesError("patch centers are not aligned")


def ensure_unique_catalogs(*catalogs: Catalog | None) -> None:
    """Each catalog instance may appear only once per measurement (the
    reference enforces distinct cache directories; in-memory catalogs are
    compared by identity)."""
    seen = [cat for cat in catalogs if cat is not None]
    if len({id(cat) for cat in seen}) != len(seen):
        raise ValueError(
            "each catalog must be a separate instance to avoid interference"
        )


class PatchLinkage:
    """Patch-pair pruning shared by all pair counts of one measurement.

    Bundles the measurement configuration, the per-bin angular edge tables
    and the patch-level linkage computed from the largest input catalog.
    """

    def __init__(
        self,
        config: Configuration,
        edges: AngularEdges,
        linkage: Linkage,
    ) -> None:
        self.config = config
        self.edges = edges
        self.linkage = linkage
        logger.debug(
            "created patch linkage with %d patch pairs", self.num_links
        )

    @classmethod
    @spanned("linkage")
    def from_catalogs(
        cls,
        config: Configuration,
        catalog: Catalog,
        *catalogs: Catalog,
    ) -> PatchLinkage:
        """Build the linkage: angular edge tables at the bin centers, patch
        geometry from the best-constrained (largest) catalog, and the cap
        cutoff at the largest angular scale."""
        edges = build_angular_edges(
            config.scales.scales,
            config.binning.binning.mids,
            config.cosmology,
            weight_scale=config.scales.rweight,
            weight_res=config.scales.resolution,
            counting=getattr(config.scales, "counting", "auto"),
        )
        logger.debug(
            "computing patch linkage with max. separation of %.2e rad",
            edges.max_angle,
        )

        ref_cat, *others = sorted(
            [catalog, *catalogs],
            key=lambda cat: sum(cat.get_num_records()),
            reverse=True,
        )
        check_patch_consistency(ref_cat, *others)

        linkage = build_linkage(
            ref_cat.patch_centers_xyz,
            ref_cat.patch_radii,
            edges.max_angle * LINKAGE_SLACK,
        )
        return cls(config, edges, linkage)

    @property
    def num_total(self) -> int:
        """Number of patch pairs without the angular cutoff."""
        return self.linkage.num_patches ** 2

    @property
    def num_links(self) -> int:
        """Number of linked patch pairs."""
        return self.linkage.num_links

    @property
    def density(self) -> float:
        """Fraction of patch pairs that are linked."""
        return self.linkage.density

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(num_links={self.num_links}, "
            f"density={self.density:.0%})"
        )

    def count_pairs(
        self,
        main_catalog: Catalog,
        *optional_catalog: Catalog,
        mode: str = "nn",
        binned2: bool | None = None,
        backend: str = "auto",
        device: torch.device | str = "cuda",
        max_resident_patches: int | None = None,
        progress: bool = False,
        max_workers: int | None = None,
        count_type_info: str | None = None,
        audit: bool = False,
        mesh=None,
        data_sharding: str = "replicated",
        _defer: bool = False,
        _tile_cache=None,
    ) -> list[NormalisedCounts]:
        """Count pairs between two catalogs (or within one for an
        autocorrelation), one :class:`NormalisedCounts` per scale, on
        ``device``. With ``max_resident_patches`` the count runs through the
        blocked path (:meth:`_run_blocked`), sharing ``_tile_cache`` (a
        measurement's tile cache) when given.

        ``binned2`` controls whether the second catalog is resolved into
        redshift bins (requiring equal bins on both sides of a pair); by
        default only autocorrelations bin both sides, mirroring the
        reference's binned/unbinned tree building.

        ``_defer`` (internal) returns a zero-argument callable producing
        the result instead: the device work and the copy of its result to
        the host are queued immediately, the wait and the host-side
        post-processing happen at call time.

        ``max_workers`` bounds the HOST worker pools this count creates
        (the float64 ``oracle`` backend processes and the threads of the
        audit's float64 recount). ``progress`` shows the blocked path's
        progress; it has no effect on the in-memory path. ``audit`` runs the exact-boundary
        audit (see the module docstring). ``mesh`` and ``data_sharding``
        select the devices (see the module docstring).
        """
        from yet_another_wizz_tpu_torch.utils.misc import thread_limit

        if count_type_info is not None:
            logger.info("counting %s from patch pairs", count_type_info)

        auto = len(optional_catalog) == 0
        catalog1 = main_catalog
        catalog2 = main_catalog if auto else optional_catalog[0]
        if binned2 is None:
            binned2 = auto
        # the span of the count type: "count.dd" for "DD", "DD (nn)", ...
        name = "count"
        if count_type_info:
            name += "." + count_type_info.split()[0].lower()

        if max_resident_patches is not None:
            with span(name), thread_limit(max_workers):
                counts, sum_weights = self._run_blocked(
                    catalog1, catalog2, auto=auto, binned2=binned2, mode=mode,
                    backend=backend, device=device,
                    max_resident_patches=max_resident_patches,
                    progress=progress, tile_cache=_tile_cache, audit=audit,
                    mesh=mesh, data_sharding=data_sharding,
                )
            result = [
                NormalisedCounts(per_scale, sum_weights) for per_scale in counts
            ]
            return (lambda: result) if _defer else result

        with span(name), thread_limit(max_workers):
            finalize_engine = self._run_engine(
                catalog1, catalog2, auto=auto, binned2=binned2, mode=mode,
                backend=backend, device=device, audit=audit, mesh=mesh,
                data_sharding=data_sharding,
            )

        def finish() -> list[NormalisedCounts]:
            with span(name), thread_limit(max_workers):
                counts, sum_weights = finalize_engine()
            return [
                NormalisedCounts(per_scale, sum_weights)
                for per_scale in counts
            ]

        return finish if _defer else finish()

    def count_pairs_optional(
        self,
        main_catalog: Catalog | None,
        *optional_catalog: Catalog | None,
        **kwargs,
    ) -> list[NormalisedCounts | None]:
        """Like :meth:`count_pairs` but propagates missing catalogs."""
        if any(cat is None for cat in (main_catalog, *optional_catalog)):
            result = [None] * self.config.scales.num_scales
            return (lambda: result) if kwargs.get("_defer") else result
        return self.count_pairs(main_catalog, *optional_catalog, **kwargs)

    def count_scalar_pairs(
        self,
        main_catalog: Catalog,
        *optional_catalog: Catalog,
        mode: str = "kn",
        **kwargs,
    ) -> list[NormalisedScalarCounts]:
        """Scalar-field pair counts: the requested kappa mode normalised by
        a plain number-count pass.

        Both passes are queued on the device before either result is
        fetched (the same defer/finalize overlap the measurement
        functions use across count types)."""
        outer_defer = kwargs.pop("_defer", False)
        count_type_info = kwargs.pop("count_type_info", None)
        kappa_deferred = self.count_pairs(
            main_catalog, *optional_catalog, mode=mode, **kwargs,
            count_type_info=count_type_info, _defer=True,
        )
        number_deferred = self.count_pairs(
            main_catalog, *optional_catalog, mode="nn", **kwargs,
            count_type_info=(
                None if count_type_info is None
                else f"{count_type_info} normalisation (nn)"
            ),
            _defer=True,
        )

        def finish() -> list[NormalisedScalarCounts]:
            return [
                NormalisedScalarCounts(kk.counts, nn.counts)
                for kk, nn in zip(kappa_deferred(), number_deferred())
            ]

        return finish if outer_defer else finish()

    def _run_blocked(
        self, catalog1, catalog2, *, auto, binned2, mode, backend, device,
        max_resident_patches, progress=False, tile_cache=None, audit=False,
        mesh=None, data_sharding="replicated",
    ):
        """The device-memory-bounded path: stream patch blocks through the
        engine (:func:`~yet_another_wizz_tpu_torch.correlation.blocked.
        count_pairs_blocked`); the normalisation comes from the catalogs'
        own per-bin weight sums, so a ``LazyCatalog`` works as well."""
        from yet_another_wizz_tpu_torch.correlation.blocked import (
            count_pairs_blocked,
        )

        binning = self.config.binning.binning
        num_bins = len(binning)
        per_scale = count_pairs_blocked(
            self.edges, self.linkage, catalog1, catalog2, binning,
            auto=auto, binned2=binned2, mode=mode,
            max_resident_patches=max_resident_patches, backend=backend,
            device=device, progress=progress, cache=tile_cache, audit=audit,
            mesh=mesh, data_sharding=data_sharding,
        )
        counts = [
            PatchedCounts(binning, scale_counts, auto=auto)
            for scale_counts in per_scale
        ]
        sum_weights = PatchedSumWeights(
            binning,
            catalog1.bin_sum_weights(binning, num_bins),
            catalog2.bin_sum_weights(binning if binned2 else None, num_bins),
            auto=auto,
        )
        return counts, sum_weights

    def _build_engine_inputs(
        self, catalog1, catalog2, *, auto=False, binned2=False, mode="nn"
    ):
        """The tile sets and pruned tile-pair list exactly as the engine
        will process them (layout choice and per-tile pruning included);
        the defaults are a crosscorrelation count."""
        binning = self.config.binning.binning
        num_bins = len(binning)

        with span("tiles"):
            tiles1 = catalog1.get_tiles(
                binning, mode=mode[0],
                layout=_preferred_tile_layout(
                    catalog1, num_bins, self.edges, equal_bin_counting=binned2
                ),
            )
            tiles2 = catalog2.get_tiles(
                binning if binned2 else None, mode=mode[1],
                layout=(
                    _preferred_tile_layout(
                        catalog2, num_bins, self.edges, equal_bin_counting=True
                    )
                    if binned2
                    else "spatial"
                ),
            )
        with span("pairs"):
            pairs = build_tile_pairs(
                tiles1, tiles2, self.linkage, auto=auto,
                bin_max_angles=self.edges.edges.max(axis=1),
            )
        return tiles1, tiles2, pairs

    def num_candidate_pairs(
        self,
        catalog1: Catalog,
        catalog2: Catalog | None = None,
        *,
        binned2: bool | None = None,
        mode: str = "nn",
    ) -> int:
        """Candidate pairs the engine actually evaluates for this count:
        ``num_tile_pairs * tile_size**2`` of the SAME pruned tile-pair list
        the measurement processes (tile layout choice and per-tile
        redshift-bin pruning included) — the honest work statistic for
        throughput reporting."""
        return self.engine_work_stats(
            catalog1, catalog2, binned2=binned2, mode=mode
        )["candidate_pairs"]

    def engine_work_stats(
        self,
        catalog1: Catalog,
        catalog2: Catalog | None = None,
        *,
        binned2: bool | None = None,
        mode: str = "nn",
    ) -> dict:
        """Work statistics of one count for performance models:
        ``candidate_pairs`` as in :meth:`num_candidate_pairs`,
        ``tile_pairs`` (the length of the pair list, one block of kernel A
        each), ``slot_transitions`` (changes of the output slot along the
        slot-sorted list) and ``fetch_bytes`` (the float32 ``(num_slots, B,
        E)`` result copied to the host). ``catalog2=None`` is an
        autocorrelation count."""
        auto = catalog2 is None
        if binned2 is None:
            binned2 = auto
        tiles1, _, pairs = self._build_engine_inputs(
            catalog1, catalog1 if auto else catalog2,
            auto=auto, binned2=binned2, mode=mode,
        )
        transitions = 0
        if pairs.num_pairs:
            transitions = int(np.count_nonzero(np.diff(pairs.slot) != 0)) + 1
        num_bins = len(self.config.binning.binning)
        num_edges = self.edges.num_counting_edges
        return {
            "candidate_pairs": int(pairs.num_pairs) * tiles1.tile_size ** 2,
            "tile_pairs": int(pairs.num_pairs),
            "slot_transitions": transitions,
            "fetch_bytes": int(pairs.num_slots) * num_bins * num_edges * 4,
        }

    def engine_table(self, backend: str = "auto", audit: bool = False):
        """``(table, edges_radian, direct_spec, mapper)`` of the engine:
        the direct-mode tables when the edges carry them, except for the
        ``oracle`` backend and the ``audit``, which need the union-edge
        cumulative representation (both are the same in float64, see
        :class:`~yet_another_wizz_tpu_torch.ops.thresholds.DirectEdges`)."""
        direct = self.edges.direct
        if direct is not None and backend != "oracle" and not audit:
            return direct.combined_table(), direct.edges, direct.spec, direct
        return self.edges.chord2_table, self.edges.edges, None, self.edges

    def _run_engine(
        self, catalog1, catalog2, *, auto, binned2, mode, backend, device,
        audit=False, mesh=None, data_sharding="replicated",
    ):
        binning = self.config.binning.binning
        num_bins = len(binning)
        num_patches = catalog1.num_patches

        tiles1, tiles2, pairs = self._build_engine_inputs(
            catalog1, catalog2, auto=auto, binned2=binned2, mode=mode
        )
        logger.debug(
            "processing %d tile pairs in %d patch pairs",
            pairs.num_pairs,
            pairs.num_slots,
        )
        with span("engine.queue"):
            table, edges_radian, direct_spec, mapper = self.engine_table(
                backend, audit
            )
            # the audit returns its repaired float64 counts synchronously
            cumulative = count_pairs_tiles(
                tiles1, tiles2, pairs, table,
                backend=backend, device=device, edges_radian=edges_radian,
                audit=audit, mesh=mesh, data_sharding=data_sharding, defer=True,
                direct=direct_spec,
            )
            fetch = _copy_to_host(cumulative)

        def finalize():
            with span("finalize"):
                per_scale = mapper.counts_to_scales(fetch())  # (S, slots, B)
                slot_ids1 = pairs.slot_patches[:, 0]
                slot_ids2 = pairs.slot_patches[:, 1]
                if auto:
                    same = slot_ids1 == slot_ids2
                    per_scale[:, same, :] *= 0.5  # ordered pairs double-count

                counts = []
                for scale_values in per_scale:
                    patched = PatchedCounts.zeros(binning, num_patches, auto=auto)
                    patched.counts[:, slot_ids1, slot_ids2] = scale_values.T
                    counts.append(patched)

                sum_weights = PatchedSumWeights(
                    binning,
                    tiles1.bin_sum_weights(num_bins),
                    tiles2.bin_sum_weights(num_bins),
                    auto=auto,
                )
            return counts, sum_weights

        return finalize


@spanned("autocorrelate")
def autocorrelate(
    config: Configuration,
    data: Catalog,
    random: Catalog,
    *,
    count_rr: bool = True,
    backend: str = "auto",
    device: torch.device | str = "cuda",
    max_resident_patches: int | None = None,
    progress: bool = False,
    max_workers: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[CorrFunc]:
    """Measure the angular autocorrelation amplitude of a catalog in bins
    of redshift.

    Returns one :class:`CorrFunc` per configured scale, holding DD, DR and
    (optionally) RR pair counts; with RR present the Landy-Szalay estimator
    becomes available. The pair counts run on ``device``, in memory or
    with ``max_resident_patches`` blocked, as in :func:`crosscorrelate`.
    """
    device = resolve_device(device)
    ensure_unique_catalogs(data, random)
    kwargs = dict(
        progress=progress, max_workers=max_workers, backend=backend,
        device=device, max_resident_patches=max_resident_patches, audit=audit,
        mesh=mesh, data_sharding=data_sharding,
    )

    logger.info(
        "computing auto-correlation from DD, DR%s", ", RR" if count_rr else ""
    )
    links = PatchLinkage.from_catalogs(config, data, random)
    logger.debug(
        "using %d scales %s weighting",
        config.scales.num_scales,
        "with" if config.scales.rweight else "without",
    )

    # queue all count types on the device first, then finalize in order:
    # the host waits for one count while later ones still run
    with _measurement_cache(max_resident_patches) as tile_cache:
        kwargs["_tile_cache"] = tile_cache
        dd = links.count_pairs(
            data, **kwargs, count_type_info="DD", _defer=True
        )
        # data x random pairs are counted between matching redshift bins on
        # both sides, like the reference's binned random trees
        dr = links.count_pairs(
            data, random, binned2=True, **kwargs, count_type_info="DR",
            _defer=True,
        )
        optional_random = random if count_rr else None
        rr = links.count_pairs_optional(
            optional_random, **kwargs, count_type_info="RR", _defer=True
        )
        dd, dr, rr = dd(), dr(), rr()
    return [CorrFunc(a, b, None, c) for a, b, c in zip(dd, dr, rr)]


@spanned("crosscorrelate")
def crosscorrelate(
    config: Configuration,
    reference: Catalog,
    unknown: Catalog,
    *,
    ref_rand: Catalog | None = None,
    unk_rand: Catalog | None = None,
    backend: str = "auto",
    device: torch.device | str = "cuda",
    max_resident_patches: int | None = None,
    progress: bool = False,
    max_workers: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[CorrFunc]:
    """Measure the angular cross-correlation amplitude between the unknown
    sample and redshift slices of the reference sample.

    At least one random catalog is required; with both randoms present RR
    is counted and the Landy-Szalay estimator becomes available. Returns
    one :class:`CorrFunc` per configured scale.

    The pair counts run on ``device`` (default ``"cuda"``, which raises
    when CUDA is not available): the CUDA kernels on a CUDA device, their
    plain PyTorch versions with ``device="cpu"``. With
    ``max_resident_patches`` they stream through the blocked out-of-core
    path (catalogs may then be ``LazyCatalog`` objects), with one tile cache
    shared by the count types. ``audit=True`` audits every count against
    float32 misclassification at the bin edges (see the module docstring);
    ``max_workers`` bounds the threads of its float64 recount.
    """
    device = resolve_device(device)
    ensure_unique_catalogs(reference, unknown, ref_rand, unk_rand)
    count_dr = unk_rand is not None
    count_rd = ref_rand is not None
    if not count_dr and not count_rd:
        raise ValueError("at least one random dataset must be provided")

    kwargs = dict(
        progress=progress, max_workers=max_workers, backend=backend,
        device=device, max_resident_patches=max_resident_patches, audit=audit,
        mesh=mesh, data_sharding=data_sharding,
    )
    logger.info(
        "computing cross-correlation from DD%s%s%s",
        ", DR" if count_dr else "",
        ", RD" if count_rd else "",
        ", RR" if (count_dr and count_rd) else "",
    )

    catalogs = [cat for cat in (ref_rand, unk_rand) if cat is not None]
    links = PatchLinkage.from_catalogs(config, reference, unknown, *catalogs)
    logger.debug(
        "using %d scales %s weighting",
        config.scales.num_scales,
        "with" if config.scales.rweight else "without",
    )

    # queue all count types, then finalize in order (the host waits for
    # one count while later ones still run on the device)
    with _measurement_cache(max_resident_patches) as tile_cache:
        kwargs["_tile_cache"] = tile_cache
        dd = links.count_pairs(
            reference, unknown, **kwargs, count_type_info="DD", _defer=True
        )
        dr = links.count_pairs_optional(
            reference, unk_rand, **kwargs, count_type_info="DR", _defer=True
        )
        rd = links.count_pairs_optional(
            ref_rand, unknown, **kwargs, count_type_info="RD", _defer=True
        )
        rr = links.count_pairs_optional(
            ref_rand, unk_rand, **kwargs, count_type_info="RR", _defer=True
        )
        dd, dr, rd, rr = dd(), dr(), rd(), rr()
    return [CorrFunc(a, b, c, d) for a, b, c, d in zip(dd, dr, rd, rr)]


def compute_scalar_normalisation(
    catalog: Catalog, config: Configuration
) -> NormalisedScalarCounts:
    """Normalisation for scalar counts from the mean kappa per patch (used
    when no randoms are provided to :func:`crosscorrelate_scalar`)."""
    binning = config.binning.binning
    tiles = catalog.get_tiles(binning, mode="n")
    if tiles.sum_kappa is None:
        raise ValueError("missing required 'kappa' values")

    num_bins, num_patches = tiles.sum_kappa.shape
    sum_kappa = np.zeros((num_bins, num_patches, num_patches))
    sum_weights = np.zeros_like(sum_kappa)
    diag = np.arange(num_patches)
    sum_kappa[:, diag, diag] = tiles.sum_kappa
    sum_weights[:, diag, diag] = tiles.sum_weights

    return NormalisedScalarCounts(
        PatchedCounts(binning, sum_kappa, auto=False),
        PatchedCounts(binning, sum_weights, auto=False),
    )


@spanned("autocorrelate_scalar")
def autocorrelate_scalar(
    config: Configuration,
    data: Catalog,
    *,
    backend: str = "auto",
    device: torch.device | str = "cuda",
    progress: bool = False,
    max_workers: int | None = None,
    max_resident_patches: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[ScalarCorrFunc]:
    """Measure the angular autocorrelation amplitude of a scalar (kappa)
    field in bins of redshift, on ``device`` (in memory or with
    ``max_resident_patches`` blocked) as in :func:`autocorrelate`."""
    device = resolve_device(device)
    logger.info("computing scalar auto-correlation with DD")
    links = PatchLinkage.from_catalogs(config, data)
    with _measurement_cache(max_resident_patches) as tile_cache:
        dd = links.count_scalar_pairs(
            data, mode="kk", backend=backend, device=device,
            progress=progress, max_workers=max_workers,
            max_resident_patches=max_resident_patches, audit=audit,
            mesh=mesh, data_sharding=data_sharding, count_type_info="DD",
            _tile_cache=tile_cache,
        )
    return [ScalarCorrFunc(counts) for counts in dd]


@spanned("crosscorrelate_scalar")
def crosscorrelate_scalar(
    config: Configuration,
    reference: Catalog,
    unknown: Catalog,
    *,
    unk_rand: Catalog | None = None,
    backend: str = "auto",
    device: torch.device | str = "cuda",
    progress: bool = False,
    max_workers: int | None = None,
    max_resident_patches: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[ScalarCorrFunc]:
    """Measure the angular cross-correlation amplitude between a scalar
    (kappa) field carried by the REFERENCE sample and the unknown sample
    (the reference's ``crosscorrelate_scalar`` semantics: counting mode
    ``kn`` weights the redshift-binned reference side by kappa * weight,
    yaw/correlation/measurements.py:709-800), on ``device`` as in
    :func:`crosscorrelate` (in memory or with ``max_resident_patches``
    blocked).

    Without unknown randoms the counts are normalised by the mean kappa
    over the footprint instead of a DR term (from the in-memory tiles, so
    a ``LazyCatalog`` reference needs ``unk_rand``)."""
    device = resolve_device(device)
    ensure_unique_catalogs(reference, unknown, unk_rand)
    count_dr = unk_rand is not None
    logger.info(
        "computing scalar cross-correlation with DD%s",
        ", DR" if count_dr else "",
    )

    catalogs = [cat for cat in (unk_rand,) if cat is not None]
    links = PatchLinkage.from_catalogs(config, reference, unknown, *catalogs)

    kwargs = dict(
        backend=backend, device=device, progress=progress,
        max_workers=max_workers, max_resident_patches=max_resident_patches,
        audit=audit, mesh=mesh, data_sharding=data_sharding,
    )
    # queue both count types on the device before finalizing either, the
    # same defer/finalize overlap crosscorrelate applies across DD..RR
    with _measurement_cache(max_resident_patches) as tile_cache:
        kwargs["_tile_cache"] = tile_cache
        dd = links.count_scalar_pairs(
            reference, unknown, mode="kn", **kwargs, count_type_info="DD",
            _defer=True,
        )
        dr = (
            links.count_scalar_pairs(
                reference, unk_rand, mode="kn", **kwargs,
                count_type_info="DR", _defer=True,
            )
            if count_dr
            else None
        )
        dd = dd()  # finalize in queue order: the DR counts still run
        dr = (
            dr()
            if dr is not None
            else [compute_scalar_normalisation(reference, config)] * len(dd)
        )
    return [ScalarCorrFunc(a, b) for a, b in zip(dd, dr)]
