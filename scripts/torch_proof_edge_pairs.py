#!/usr/bin/env python3
"""The pairs behind a survey proof's departure from the float64 oracle.

Rebuilds the stride-``--downsample`` sample of ``scripts/torch_survey_proof.py``
at ``--rows`` (the same mock, randoms and patch centres, without Parquet or
caches) and counts its DD and RD pairs with the port's engine, with the
engine under ``audit=True`` and with the float64 oracle. It prints the
per-scale relative error of both against the oracle, and for every slot
whose engine count departs from the oracle's by more than 0.3 of a pair
weight, the pairs of that slot that lie within 1e-6 of the edge in
squared chord: their float64 squared chord, the edge's, and the float32
threshold the engine compares with. The pairs go to ``--out`` as JSON.

    python scripts/torch_proof_edge_pairs.py --rows 100000000 --downsample 64 \\
        [--device cuda] [--out pairs.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "scripts")]

import torch_survey_proof as proof  # noqa: E402
from torch_proof_common import require_device  # noqa: E402


def downsampled_catalogs(rows: int, stride: int, patches: int, device: str) -> dict:
    """The survey proof's three samples at ``rows``, every ``stride``-th
    row, in the patches of the proof's kmeans centres."""
    from yet_another_wizz_tpu_torch.catalog import Catalog

    samples = proof.make_samples(rows, proof.PARQUET_CHUNK)
    reference = samples["reference"]
    probe = max(1, len(reference["ra"]) // proof.PROBE_ROWS)
    centers = Catalog.from_arrays(
        reference["ra"][::probe], reference["dec"][::probe], degrees=False,
        patch_num=patches, device=device,
    ).get_centers()
    return {
        name: Catalog.from_arrays(
            sample["ra"][::stride], sample["dec"][::stride], degrees=False,
            weights=sample["weights"][::stride], redshifts=sample["redshifts"][::stride],
            patch_centers=centers, device=device,
        )
        for name, sample in samples.items()
    }


def edge_pairs(oracle, engine, tiles1, tiles2, pairs, edges, table, label) -> list:
    """The pairs within 1e-6 of an edge in the slots where ``engine``
    departs from ``oracle`` by more than 0.3 of a pair weight."""
    from yet_another_wizz_tpu_torch.ops.paircount import _unpack_tileset

    xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
    xyz2, w2, _, p2 = _unpack_tileset(tiles2)
    found = []
    for slot, b, e in zip(*np.nonzero(np.abs(engine - oracle) > 0.3)):
        pa, pb = pairs.slot_patches[slot]
        print(f"{label} slot {slot} (patches {pa}, {pb}) bin {b} edge {e}: engine "
              f"{engine[slot, b, e]:.6f}, oracle {oracle[slot, b, e]:.6f}")
        rows, cols = np.nonzero((p1 == pa) & (z1 == b))[0], np.nonzero(p2 == pb)[0]
        diff = xyz1[rows, None, :] - xyz2[None, cols, :]
        chord2 = np.einsum("ijk,ijk->ij", diff, diff)
        edge_chord2 = (2 * np.sin(edges[b, e] / 2)) ** 2
        for i, j in np.argwhere(np.abs(chord2 / edge_chord2 - 1) < 1e-6):
            pair = dict(
                count=label, bin=int(b), edge=int(e), xyz1=xyz1[rows[i]].tolist(),
                xyz2=xyz2[cols[j]].tolist(), w1=float(w1[rows[i]]), w2=float(w2[cols[j]]),
                chord2=float(chord2[i, j]), edge_chord2=float(edge_chord2),
                edge_radian=float(edges[b, e]), threshold=float(table[b, e]),
            )
            print(f"  pair: chord2 {pair['chord2']:.17e}, edge {edge_chord2:.17e}, float32 "
                  f"threshold {pair['threshold']:.9e}, weights {pair['w1']!r} x {pair['w2']!r}")
            found.append(pair)
    return found


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=100_000_000)
    parser.add_argument("--downsample", type=int, default=64)
    parser.add_argument("--patches", type=int, default=128)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    require_device(args.device)

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops.cpu_oracle import count_pairs_oracle_multiprocess
    from yet_another_wizz_tpu_torch.ops.linkage import build_tile_pairs
    from yet_another_wizz_tpu_torch.ops.paircount import _unpack_tileset, count_pairs_tiles

    catalogs = downsampled_catalogs(args.rows, args.downsample, args.patches, args.device)
    config = proof.configuration()
    links = PatchLinkage.from_catalogs(config, *catalogs.values())
    edges, table = links.edges.edges, links.edges.chord2_table
    found = []
    for label, rows, cols in (("DD", "reference", "unknown"), ("RD", "randoms", "unknown")):
        tiles1 = catalogs[rows].get_tiles(config.binning.binning)
        tiles2 = catalogs[cols].get_tiles(None)
        pairs = build_tile_pairs(tiles1, tiles2, links.linkage, auto=False)
        xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
        xyz2, w2, _, p2 = _unpack_tileset(tiles2)
        oracle = count_pairs_oracle_multiprocess(
            xyz1, w1, z1, p1, xyz2, w2, None, p2, pairs.slot_patches, edges
        )
        engine = count_pairs_tiles(tiles1, tiles2, pairs, table, device=args.device)
        audited = count_pairs_tiles(tiles1, tiles2, pairs, table, device=args.device,
                                    audit=True, edges_radian=edges)
        expected = links.edges.counts_to_scales(oracle).sum(axis=1)
        for name, counts in (("engine", engine), ("engine, audit=True", audited)):
            ours = links.edges.counts_to_scales(counts).sum(axis=1)
            rel = np.abs(ours - expected) / np.abs(expected)
            print(f"{label} {name}: per-scale relative error by bin "
                  f"{np.array2string(rel[0], precision=2)}; max {rel.max():.3e}")
        found += edge_pairs(oracle, engine, tiles1, tiles2, pairs, edges, table, label)
    if args.out:
        Path(args.out).write_text(json.dumps(found, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
