"""The entry layout of the direct-mode kernels against the weight it replaces.

The direct-mode kernels take a pair's base weight from a per-(bin,
sub-interval) table and walk only the below/above entries of the pair's own
sub-interval (``ops/gweight.py::entry_layout``), and they skip the weight of
a pair that no counting edge of its row reaches. Held here on the port's
tables of the benchmark's configuration B, the wide grid and a
configuration with more than 16 entries per side, each equal to the JAX
package's: the layout holds exactly the table's entries of each
sub-interval, in table order; the weight evaluated from it is
``torch.equal`` to ``apply_direct_weight`` wherever a pair reaches an edge
(on seeded squared chords that include every entry threshold and values
beyond the last edge); and it agrees with the JAX package's
``apply_direct_weight`` within that test's tolerance. The kernels' wrapper
derives the layout from the table it is given, once per table.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import gc

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from yet_another_wizz_tpu.cosmology import new_scales as jax_new_scales
from yet_another_wizz_tpu.ops import gweight as jax_gweight
from yet_another_wizz_tpu.ops.thresholds import (
    build_angular_edges as jax_build_angular_edges,
)
from yet_another_wizz_tpu_torch.cosmology import new_scales
from yet_another_wizz_tpu_torch.ops import cuda_paircount, gweight
from yet_another_wizz_tpu_torch.ops import tiles as tile_ops
from yet_another_wizz_tpu_torch.ops.paircount import _device_table
from yet_another_wizz_tpu_torch.ops.thresholds import build_angular_edges

ZMIDS = 0.15 + (np.arange(11) + 0.5) * (1.0 - 0.15) / 11
CONFIGS = {
    # name: (rmin, rmax, unit, resolution)
    "config_b": ([100, 300, 500], [300, 500, 1000], "kpc", 32),
    "wide_grid": ([0.05, 0.4], [0.5, 1.35], "rad", 24),
    "many_entries": (
        [100, 120, 150, 180, 220, 260, 300, 350, 400, 450],
        [1000, 1100, 1200, 1300, 1400, 1500, 1600, 1700, 1800, 2000],
        "kpc", 32,
    ),
}


def direct_tables(name):
    """The port's and the JAX package's direct-mode tables of a
    configuration."""
    rmin, rmax, unit, resolution = CONFIGS[name]
    kwargs = dict(weight_scale=-1.0, weight_res=resolution, counting="direct")
    edges = build_angular_edges(new_scales(rmin, rmax, unit=unit), ZMIDS, **kwargs)
    jax_edges = jax_build_angular_edges(
        jax_new_scales(rmin, rmax, unit=unit), ZMIDS, **kwargs
    )
    return edges.direct, jax_edges.direct


def layout_of(direct):
    """The entry layout of a direct-mode table, as the kernels' wrapper
    derives it."""
    return gweight.entry_layout(
        direct.gtable, num_sub=direct.num_sub, num_below=direct.num_below,
        num_above=direct.num_above,
    )


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_holds_each_sub_interval_entries_in_table_order(name):
    direct, jax_direct = direct_tables(name)
    assert_array_equal(direct.gtable, jax_direct.gtable)
    assert direct.spec == jax_direct.spec
    assert (max(direct.num_below, direct.num_above) > 16) is (
        name == "many_entries"
    )
    layout = layout_of(direct)
    assert layout.spans.dtype == np.int32 and layout.entries.dtype == np.float32
    assert layout.spans.shape == (len(ZMIDS), direct.num_sub, 3)
    nb, na = direct.num_below, direct.num_above
    expected = 0
    for b, params in enumerate(direct.gtable):
        below = params[4 : 4 + 3 * nb].reshape(-1, 3)
        above = params[4 + 3 * nb : 4 + 3 * (nb + na)].reshape(-1, 3)
        for k in range(direct.num_sub):
            start, split, stop = layout.spans[b, k]
            assert_array_equal(layout.entries[start:split], below[below[:, 0] == k, 1:])
            assert_array_equal(layout.entries[split:stop], above[above[:, 0] == k, 1:])
        expected += np.sum(below[:, 0] >= 0) + np.sum(above[:, 0] >= 0)
    # every entry of the table once, padding (k = -1) left out
    assert len(layout.entries) == expected
    assert layout.spans[-1, -1, 2] == expected
    assert_array_equal(layout.spans[..., 0].ravel()[1:], layout.spans[..., 2].ravel()[:-1])
    packed = layout.packed()
    assert packed.dtype == np.int32
    assert len(packed) == layout.spans.size + layout.entries.size
    # the layout of the JAX package's table is the same
    jax_layout = gweight.entry_layout(
        jax_direct.gtable, num_sub=jax_direct.num_sub,
        num_below=jax_direct.num_below, num_above=jax_direct.num_above,
    )
    assert packed.tobytes() == jax_layout.packed().tobytes()


def sub_interval(chord2, row_params, direct):
    """``log10(theta)`` and the sub-interval index of each pair, in the
    operations of ``apply_direct_weight``."""
    y = 0.25 * chord2
    if direct.spec[3]:
        p = gweight._H_POLY[4] * y
        for a in (gweight._H_POLY[3], gweight._H_POLY[2], gweight._H_POLY[1]):
            p = (p + a) * y
        p = p + gweight._H_POLY[0]
        log10_theta = (0.5 * gweight._INV_LN10) * torch.log(
            torch.clamp(chord2, min=1e-37)
        ) + p * y
    else:
        s = torch.clamp(0.5 * torch.sqrt(chord2), max=1.0)
        theta = 2.0 * gweight._asin_f32(s)
        log10_theta = torch.log(torch.clamp(theta, min=1e-30)) * gweight._INV_LN10
    return torch.clamp(
        torch.floor(log10_theta * row_params[:, 0:1] - row_params[:, 1:2]),
        0.0, float(direct.num_sub - 1),
    ).long()


def layout_weight(chord2, rows, weights, direct):
    """The kernels' weight evaluation in torch: ``log10(theta)`` and the
    sub-interval index as ``apply_direct_weight`` computes them, the base
    weight from the per-(bin, sub-interval) table, then the sub-interval's
    below- and above-entries from the layout, in order."""
    params = torch.from_numpy(direct.gtable)
    layout = layout_of(direct)
    idx = sub_interval(chord2, params[rows], direct)
    sub = torch.arange(direct.num_sub, dtype=torch.float32)
    g_table = torch.exp(params[:, 2:3] + params[:, 3:4] * sub)  # (B, S)
    g = g_table[rows[:, None], idx]
    spans = torch.from_numpy(layout.spans).long()[rows[:, None], idx]
    entries = torch.from_numpy(layout.entries)
    longest = int((spans[..., 2] - spans[..., 0]).max())
    last = max(len(entries) - 1, 0)
    for n in range(longest):
        below = spans[..., 0] + n
        thr, value = entries[below.clamp(max=last)].unbind(-1)
        g = torch.where((below < spans[..., 1]) & (chord2 <= thr), value, g)
    for n in range(longest):
        above = spans[..., 1] + n
        thr, value = entries[above.clamp(max=last)].unbind(-1)
        g = torch.where((above < spans[..., 2]) & (chord2 > thr), value, g)
    return weights * g


def pair_inputs(direct, seed):
    """Seeded squared chords over the grid, every entry threshold and
    counting edge exactly, and values beyond the last edge; signed column
    weights; row bins."""
    rng = np.random.default_rng(seed)
    lo, hi = direct.edges.min() * 0.5, direct.edges.max() * 1.2
    theta = np.exp(rng.uniform(np.log(lo), np.log(hi), (256, 256)))
    chord2 = ((2 * np.sin(theta / 2)) ** 2).astype(np.float32)
    exact = np.concatenate([
        layout_of(direct).entries[:, 0], direct.chord2_table.ravel(),
        np.nextafter(direct.chord2_table.ravel(), np.float32(np.inf)),
        np.minimum(direct.chord2_table.max() * 1.5, 4.0)[None],
    ]).astype(np.float32)
    flat = chord2.reshape(-1)
    flat[rng.choice(flat.size, len(exact), replace=False)] = exact
    weights = rng.normal(0.0, 1.0, (256, 256)).astype(np.float32)
    rows = rng.integers(0, len(ZMIDS), 256)
    return chord2, weights, rows


def first_difference(chord2, rows, weights, actual, plain, counted, direct):
    """The first counted pair whose two weights differ: its squared chord,
    row bin, the sub-interval index of each side (the layout's, and the
    plain weight's from a second evaluation of its operations on a copy of
    the inputs), the column weight and both weights, bit patterns
    included."""
    differ = counted & ~(actual == plain)
    if not differ.any():
        return "no counted pair differs"
    r, c = (int(i) for i in torch.nonzero(differ)[0])
    params = torch.from_numpy(direct.gtable)[rows]
    idx_layout = sub_interval(chord2, params, direct)[r, c].item()
    idx_plain = sub_interval(chord2.clone(), params.clone(), direct)[r, c].item()

    def bits(x):
        return f"{x.item()!r} (0x{x.view(torch.int32).item() & 0xFFFFFFFF:08x})"

    return (
        f"{int(differ.sum())} counted pairs differ; first at ({r}, {c}): "
        f"chord2 {bits(chord2[r, c])}, row bin {int(rows[r])}, idx layout "
        f"{idx_layout}, idx plain {idx_plain}, column weight "
        f"{bits(weights[r, c])}, layout weight {bits(actual[r, c])}, plain "
        f"weight {bits(plain[r, c])}"
    )


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_weight_equals_plain_weight_where_an_edge_reaches(name):
    direct, _ = direct_tables(name)
    chord2, weights, rows = pair_inputs(direct, seed=len(name))
    spec = dict(
        num_sub=direct.num_sub, num_below=direct.num_below,
        num_above=direct.num_above, small_angle=direct.spec[3],
    )
    chord2_t, weights_t = torch.from_numpy(chord2), torch.from_numpy(weights)
    rows_t = torch.from_numpy(rows)
    plain = gweight.apply_direct_weight(
        chord2_t, torch.from_numpy(direct.gtable)[rows_t], weights_t, **spec
    )
    actual = layout_weight(chord2_t, rows_t, weights_t, direct)
    # the kernels skip the weight beyond the row's largest counting edge:
    # there it adds 0 to every count whatever its value
    reach = torch.from_numpy(direct.chord2_table.max(axis=1))[rows_t][:, None]
    counted = chord2_t <= reach
    assert 0.1 < counted.float().mean() < 0.99
    assert torch.equal(actual[counted], plain[counted]), first_difference(
        chord2_t, rows_t, weights_t, actual, plain, counted, direct
    )
    # the exact entry thresholds and edges are among the counted pairs
    on_entry = np.isin(chord2, layout_of(direct).entries[:, 0])
    assert on_entry.any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_weight_matches_jax(name):
    """Within the tolerance of ``test_direct_weight_matches_jax``: a pair
    within float32 resolution of a sub-edge may take the neighbouring
    weight."""
    direct, jax_direct = direct_tables(name)
    chord2, weights, rows = pair_inputs(direct, seed=len(name) + 1)
    expected = np.asarray(jax_gweight.apply_direct_weight(
        chord2, jax_direct.gtable[rows], weights,
        num_sub=jax_direct.num_sub, num_below=jax_direct.num_below,
        num_above=jax_direct.num_above, small_angle=jax_direct.spec[3],
    ))
    actual = layout_weight(
        torch.from_numpy(chord2), torch.from_numpy(rows),
        torch.from_numpy(weights), direct,
    ).numpy()
    reach = direct.chord2_table.max(axis=1)[rows][:, None]
    counted = chord2 <= reach
    close = np.isclose(actual, expected, rtol=1e-6, atol=0.0)
    assert close[counted].mean() > 0.999
    ratio = np.abs(actual[counted & ~close] / expected[counted & ~close])
    step = np.exp(abs(direct.gtable[:, 3]).max()) * 1.01
    assert np.all((ratio < step) & (ratio > 1 / step))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_layout_is_derived_from_its_table_and_cached(name):
    """The wrapper derives the layout the kernel reads from the table it is
    given, once per table, and derives it again after an in-place change."""
    direct, _ = direct_tables(name)
    table = torch.from_numpy(direct.combined_table())
    num_edges = direct.chord2_table.shape[1]
    first = cuda_paircount._device_layout(table, num_edges, direct.spec)
    assert first.dtype == torch.int32 and first.device == table.device
    assert_array_equal(first.numpy(), layout_of(direct).packed())
    assert cuda_paircount._device_layout(table, num_edges, direct.spec) is first
    # a changed entry threshold changes the layout's entries
    column = num_edges + 4 + 1  # the first entry's threshold
    table[:, column] *= 0.5
    changed = cuda_paircount._device_layout(table, num_edges, direct.spec)
    assert changed is not first
    expected = gweight.entry_layout(
        table[:, num_edges:].numpy(), num_sub=direct.num_sub,
        num_below=direct.num_below, num_above=direct.num_above,
    )
    assert_array_equal(changed.numpy(), expected.packed())
    key = id(table)
    assert key in cuda_paircount._layouts
    del table
    gc.collect()
    assert key not in cuda_paircount._layouts


@pytest.mark.parametrize("cache", ["layouts", "caps"])
def test_cache_entry_of_a_freed_tensor_is_not_served_to_its_successor(cache):
    """The layout and chunk-cap caches are keyed by ``id`` of the tensor
    they were derived from and drop an entry when that tensor is freed. A
    new tensor of other content often takes the freed ``id``: what the
    cache returns for it must be derived from the new content."""
    from yet_another_wizz_tpu_torch.ops.tiles import chunk_caps

    direct, _ = direct_tables("config_b")
    num_edges = direct.chord2_table.shape[1]
    rng = np.random.default_rng(5)
    seen = []
    for round_ in range(12):
        if cache == "layouts":
            table = torch.from_numpy(direct.combined_table())
            # move every entry threshold: another layout per round
            for col in range(num_edges + 5, table.shape[1], 3):
                table[:, col] *= 1.0 + 0.01 * round_
            got = cuda_paircount._device_layout(table, num_edges, direct.spec)
            expected = gweight.entry_layout(
                table[:, num_edges:].numpy(), num_sub=direct.num_sub,
                num_below=direct.num_below, num_above=direct.num_above,
            ).packed()
            keys = cuda_paircount._layouts
        else:
            table = torch.from_numpy(
                rng.normal(0.0, 1.0, (3, 8, 64)).astype(np.float32)
            )
            got = tile_ops._device_caps(table)
            expected = chunk_caps(table).numpy()
            keys = tile_ops._caps
        assert_array_equal(got.numpy(), expected)
        key = id(table)
        seen.append(key)
        assert key in keys
        del table, got
        gc.collect()
        assert key not in keys
    # the test saw a freed id taken by a new tensor
    assert len(set(seen)) < len(seen)


def test_count_pairs_tiles_uploads_one_table_per_content():
    direct, _ = direct_tables("config_b")
    table = direct.combined_table()
    device = torch.device("cpu")
    first = _device_table(table.tobytes(), table.shape, device)
    again = _device_table(table.copy().tobytes(), table.shape, device)
    assert again is first
    assert_array_equal(first.numpy(), table)
    other = table.copy()
    other[0, 0] *= 0.5
    assert _device_table(other.tobytes(), other.shape, device) is not first
