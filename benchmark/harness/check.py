"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference computed from the same inputs.

The program counts in float32: a pair whose squared chord lies within
float32 resolution of an edge may land on either side, and its slot's
count then moves by that pair's weight (times the change of its scale
weight across the edge). The reference counts in float64 and also weighs,
per slot, the pairs within a relative band (``edge_band``) of an edge; a
slot's tolerance is that weight plus ``slot_rtol`` of the slot (float32
sums). Each of the program's counts is held against the reference's within
that tolerance, and the reference's counts, each moved within its tolerance
as near to the program's as it allows, give the n(z) and covariance that
the program's are held against. Four numbers, each against its limit
(``limits/<cell>.json``):

- ``counts``: the widest gap of a slot beyond its tolerance, as a share of
  the largest slot of its count and scale (the engine layer);
- ``norm``: the widest gap of the sums of weights that normalise the counts,
  as a share of the largest;
- ``nz`` and ``cov``: the widest gap of n(z) and of its jackknife
  covariance per scale, as a share of the largest value (the post layer). A
  bin that is NaN on one side only reads as infinitely far.
"""

from __future__ import annotations

import numpy as np

from harness import reference as ref

NUMBERS = ("counts", "norm", "nz", "cov")


def bin_edges(binning: dict):
    return np.linspace(binning["zmin"], binning["zmax"], binning["num_bins"] + 1)


def reference_measurement(config: dict, traffic: dict, inputs: dict, device,
                          dtype=None, bands=(), centers=None) -> tuple[dict, list]:
    """The reference's result of one measurement, in the layout of
    :func:`harness.session.extract` plus, per count, how far each slot can
    move for every band of ``bands`` (``moves``) and what the post layer
    needs; and the work of each count (pairs in reach, points, edges) for
    the roofline. The patches are the benchmark's centres, or ``centers``
    where the traffic has the program make them."""
    import torch

    from harness.session import kinds_of

    dtype = dtype or torch.float64
    edges_z = bin_edges(config["binning"])
    num_bins, num_patches = len(edges_z) - 1, config["num_patches"]
    scales = config["scales"][traffic["scales"]]
    edges = ref.build_edges(scales, 0.5 * (edges_z[1:] + edges_z[:-1]))
    if centers is None:
        centers = inputs["centers"]
    samples = {name: ref.make_sample(cols, centers, edges_z)
               for name, cols in inputs["catalogs"].items()}
    result = dict(counts={}, sum_weights={}, moves={}, carried={}, auto={},
                  post=[], dz=np.diff(edges_z), steps=traffic["post"])
    works = []
    for call in traffic["calls"]:
        roles = call["catalogs"]
        binned2 = call["fn"] == "auto"
        for kind, (first, second) in kinds_of(call).items():
            key = f"{call['name']}_{kind}"
            auto = binned2 and first == second
            rows, cols = samples[roles[first]], samples[roles[second]]
            counted = ref.count_pairs(
                rows, cols, edges, num_patches, binned2=binned2, auto=auto,
                device=device, dtype=dtype, bands=bands)
            result["counts"][key], result["moves"][key], result["carried"][key] = (
                ref.to_scales(counted, edges, auto))
            result["sum_weights"][key] = (
                ref.sum_weights(rows, num_bins, num_patches, True, dtype),
                ref.sum_weights(cols, num_bins, num_patches, binned2, dtype))
            result["auto"][key] = auto
            works.append(dict(
                count=key, pairs_in_reach=counted.pairs_in_reach,
                num_points=counted.num_points, binned=binned2,
                union_edges=edges.angles.shape[1],
                scale_edges=edges.num_scale_edges,
                weighted=scales.get("rweight") is not None,
                max_angle=float(edges.angles.max()),
                num_bins=num_bins, num_patches=num_patches,
            ))
    result["post"] = post(result, result["counts"])
    return result, works


def post(desired: dict, counts: dict) -> list:
    """Per post step of the traffic, ``[(values, covariance)]`` per scale
    from ``counts`` (per count, as ``(S, B, P, P)``) with the reference's
    sums of weights: n(z) for an ``nz`` step, the call's estimate for a
    ``corr`` step."""
    num_scales = len(next(iter(counts.values())))
    out = []
    for step in desired["steps"]:
        per_scale = []
        for s in range(num_scales):
            terms = {}
            for key, values in counts.items():
                call, kind = key.rsplit("_", 1)
                terms.setdefault(call, {})[kind] = ref.normalised(
                    values[s], *desired["sum_weights"][key], desired["auto"][key])
            if "nz" in step:
                data, _, cov = ref.redshift_estimate(
                    terms[step["nz"]],
                    terms[step["ref_corr"]] if step.get("ref_corr") else None,
                    desired["dz"])
            else:
                data, _, cov = ref.correlation_estimate(terms[step["corr"]])
            per_scale.append((data, cov))
        out.append(per_scale)
    return out


def relative_gap(actual, desired) -> float:
    """Widest ``|actual - desired|`` as a share of the largest ``|desired|``;
    a NaN on one side only is infinitely far, NaN on both sides agrees."""
    actual = np.asarray(actual, dtype=np.float64)
    desired = np.asarray(desired, dtype=np.float64)
    if actual.shape != desired.shape:
        return float("inf")
    nan_a, nan_d = np.isnan(actual), np.isnan(desired)
    if np.any(nan_a != nan_d):
        return float("inf")
    gap = np.abs(actual - desired)[~nan_d]
    if gap.size == 0:
        return 0.0
    scale = np.abs(desired[~nan_d]).max()
    if scale == 0.0:
        return 0.0 if gap.max() == 0.0 else float("inf")
    return float(gap.max() / scale)


def compare(actual: dict, desired: dict, limits: dict, level: int = 0) -> dict:
    """The four numbers of one measurement (see the module docstring), with
    the tolerance of band ``level`` of the reference's ``moves``."""
    if set(actual["counts"]) != set(desired["counts"]) or [
            len(step) for step in actual["post"]] != [
            len(step) for step in desired["post"]] or any(
            actual["counts"][k].shape != v.shape for k, v in desired["counts"].items()):
        return dict.fromkeys(NUMBERS, float("inf"))
    numbers = dict.fromkeys(NUMBERS, 0.0)
    moved = {}
    for key, want in desired["counts"].items():
        have = actual["counts"][key]
        if not np.all(np.isfinite(have)):
            return dict.fromkeys(NUMBERS, float("inf"))
        tolerance = (desired["moves"][key][level]
                     + limits["slot_rtol"] * desired["carried"][key])
        moved[key] = np.clip(have, want - tolerance, want + tolerance)
        for s in range(len(want)):
            gap = np.abs(have[s] - moved[key][s]).max()
            scale = np.abs(want[s]).max()
            numbers["counts"] = max(numbers["counts"], float(gap / scale) if scale > 0
                                    else (0.0 if gap == 0 else float("inf")))
        for have_w, want_w in zip(actual["sum_weights"][key], desired["sum_weights"][key]):
            numbers["norm"] = max(numbers["norm"], relative_gap(have_w, want_w))
    for step_a, step_d in zip(actual["post"], post(desired, moved)):
        for (nz_a, cov_a), (nz_d, cov_d) in zip(step_a, step_d):
            numbers["nz"] = max(numbers["nz"], relative_gap(nz_a, nz_d))
            numbers["cov"] = max(numbers["cov"], relative_gap(cov_a, cov_d))
    return numbers


def widest_count_gap(actual: dict, desired: dict) -> float:
    """The widest gap of one slot with no tolerance, as a share of the
    largest slot of its count and scale (logged, not compared)."""
    widest = 0.0
    for key, want in desired["counts"].items():
        for s in range(len(want)):
            widest = max(widest, relative_gap(actual["counts"][key][s], want[s]))
    return widest


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[name] <= limits[name] for name in NUMBERS)
