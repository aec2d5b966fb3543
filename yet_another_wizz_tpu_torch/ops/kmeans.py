"""Spherical kmeans for patch center generation and assignment.

Replaces the reference's native dependencies for patch handling:
``treecorr`` C++ kmeans for center creation
(yaw/catalog/catalog.py:183-226) and
``scipy.cluster.vq.vq`` for nearest-center assignment (same file :229-249).

Center generation runs on a bounded probe subsample with deterministic
kmeans++ seeding and vectorised Lloyd iterations on the host (like the
reference's treecorr call, the clustering itself is a small host-side
problem); the O(N * P) assignment of the full catalog runs on the host
below :data:`DEVICE_ASSIGN_THRESHOLD` and on the caller's torch device
above it (default ``"cuda"``, which raises when CUDA is not available).
Unlike treecorr (whose centers are non-deterministic, reference docs
``concepts.rst:109-111``), results are reproducible for a fixed seed.

Both paths score a point against every center in float64, as
``scipy.cluster.vq.vq`` does, with the same operations (one product per
axis, summed in axis order) and take the first greatest score, so a
catalog's assignment does not depend on its size. A float32 score moves
points that lie within its rounding of a boundary between two patches:
among 1.25e7 points over 2,000 deg2 and 128 patches, enough to move the
patches' sums of weights by ~3e-5.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "assign_patches",
    "kmeans_patch_centers",
]

DEFAULT_KMEANS_ITERATIONS = 30


def _seed_centers_plusplus(
    xyz: NDArray, weights: NDArray, num_patches: int, rng
) -> NDArray:
    """Deterministic kmeans++ seeding: each new center is drawn with
    probability proportional to the weighted squared distance to the
    nearest existing center."""
    from yet_another_wizz_tpu_torch import _native

    centers = np.empty((num_patches, 3))
    centers[0] = xyz[rng.integers(len(xyz))]
    min_d2 = np.full(len(xyz), np.inf)
    xyz_c = np.ascontiguousarray(xyz, dtype=np.float64)
    for idx in range(1, num_patches):
        if _native.enabled():
            _native.min_dist2_update(xyz_c, centers[idx - 1], min_d2)
        else:
            d2 = np.sum((xyz - centers[idx - 1]) ** 2, axis=1)
            np.minimum(min_d2, d2, out=min_d2)
        probs = min_d2 * weights
        total = probs.sum()
        if total <= 0:
            centers[idx] = xyz[rng.integers(len(xyz))]
            continue
        centers[idx] = xyz[rng.choice(len(xyz), p=probs / total)]
    return centers


def kmeans_patch_centers(
    xyz: NDArray,
    num_patches: int,
    *,
    weights: NDArray | None = None,
    probe_size: int | None = None,
    seed: int = 12345,
    iterations: int = DEFAULT_KMEANS_ITERATIONS,
    device: torch.device | str = "cuda",
) -> NDArray:
    """Generate ``num_patches`` patch centers on the unit sphere.

    A uniform random probe subsample (the reference's ``probe_size``
    logic) bounds the clustering cost for large catalogs. ``device`` is
    passed to :func:`assign_patches`.

    Returns float64 unit vectors of shape ``(num_patches, 3)``.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    if len(xyz) < num_patches:
        raise ValueError("catalog has fewer points than requested patches")
    weights = (
        np.ones(len(xyz)) if weights is None else np.asarray(weights, float)
    )

    rng = np.random.default_rng(seed)
    if probe_size is not None and probe_size < len(xyz):
        # the probe must still over-determine the centers, or the
        # kmeans++ seeding draws duplicates and leaves patches
        # permanently empty with no error raised
        if probe_size < num_patches:
            raise ValueError(
                f"'probe_size' ({probe_size}) must be at least "
                f"'num_patches' ({num_patches})"
            )
        idx = rng.choice(len(xyz), probe_size, replace=False)
        xyz, weights = xyz[idx], weights[idx]

    centers = _seed_centers_plusplus(xyz, weights, num_patches, rng)
    weighted_xyz = np.ascontiguousarray(xyz * weights[:, None])
    for _ in range(iterations):
        labels = assign_patches(xyz, centers, device=device)
        sums = np.stack(
            [
                np.bincount(
                    labels, weights=weighted_xyz[:, dim],
                    minlength=num_patches,
                )
                for dim in range(3)
            ],
            axis=1,
        )
        norms = np.linalg.norm(sums, axis=1)
        # empty clusters keep their previous center
        update = norms > 0
        centers[update] = sums[update] / norms[update, None]

    return centers / np.linalg.norm(centers, axis=1, keepdims=True)


DEVICE_SCORES = 1 << 26
"""Float64 scores one step of the device assignment holds at most (512
MiB, twice over with the product being added)."""


def _assign_device(xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Index of each point's first greatest float64 score: the host path's
    products and sums, elementwise, in steps of at most
    :data:`DEVICE_SCORES` scores."""
    out = torch.empty(len(xyz), dtype=torch.int64, device=xyz.device)
    step = max(1, DEVICE_SCORES // max(len(centers), 1))
    for start in range(0, len(xyz), step):
        block = xyz[start : start + step]
        scores = block[:, 0, None] * centers[:, 0]
        scores += block[:, 1, None] * centers[:, 1]
        scores += block[:, 2, None] * centers[:, 2]
        out[start : start + step] = torch.argmax(scores, dim=1)
    return out


DEVICE_ASSIGN_THRESHOLD = 2e9
"""Below this ``num_points * num_centers`` product the host matmul wins
over the device round trip."""


def assign_patches(
    xyz: NDArray,
    centers: NDArray,
    chunk: int = 4_000_000,
    *,
    device: torch.device | str = "cuda",
) -> NDArray:
    """Assign each point to its nearest patch center (greatest dot
    product), the analogue of ``scipy.cluster.vq.vq`` on unit vectors.

    Small problems run on the host; large catalogs stream through
    ``device`` in chunks, scored in float64 as on the host. A CUDA ``device``
    raises when CUDA is not available; pass ``device="cpu"`` to run the
    large-catalog path on the CPU."""
    xyz = np.asarray(xyz)
    if len(xyz) * len(centers) < DEVICE_ASSIGN_THRESHOLD:
        from yet_another_wizz_tpu_torch import _native

        if _native.enabled():
            return _native.assign_patches(xyz, centers)
        # bounded temporaries: the (chunk, centers) float64 score matrix
        # plus one equal-size broadcast temporary stay within ~100 MB
        # (the bound counts BYTES: 2 arrays x 8 B per element); scores
        # via broadcast ufuncs — BLAS gemm with an inner dimension of 3
        # is pathologically slow on some builds
        host_chunk = max(
            1, int(100_000_000 / (16 * max(len(centers), 1)))
        )
        centers_t = np.asarray(centers, np.float64).T
        out = np.empty(len(xyz), dtype=np.int32)
        for start in range(0, len(xyz), host_chunk):
            block = xyz[start : start + host_chunk]
            scores = block[:, 0, None] * centers_t[0]
            scores += block[:, 1, None] * centers_t[1]
            scores += block[:, 2, None] * centers_t[2]
            out[start : start + host_chunk] = np.argmax(scores, axis=1)
        return out

    from yet_another_wizz_tpu_torch.ops.paircount import resolve_device

    device = resolve_device(device)
    centers_dev = torch.as_tensor(
        np.asarray(centers, np.float64), device=device
    )
    out = np.empty(len(xyz), dtype=np.int32)
    for start in range(0, len(xyz), chunk):
        block = torch.as_tensor(
            np.asarray(xyz[start : start + chunk], np.float64), device=device
        )
        out[start : start + chunk] = (
            _assign_device(block, centers_dev).cpu().numpy()
        )
    return out
