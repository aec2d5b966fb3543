"""The port's public surface holds the JAX package's, read with ``ast``.

Neither package is imported: both are parsed from their sources. For every
module of ``yet_another_wizz_tpu`` the port has a module of the same path;
every name of the module's ``__all__`` is in the port module's ``__all__``;
every public function and class of the module exists in the port module;
every public method of each such class (also of classes outside
``__all__``, such as ``HandlesDataChunk``; the constructor and ``__call__``
count as public) exists on the port's class or on one of its bases; and
every parameter of each such function or method is in the port's
signature. The only exceptions are :data:`RETIRED`, each naming the
``ROADMAP.md`` item ("Not to port") that retires it.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per test process)
import ast
import re
from functools import cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "yet_another_wizz_tpu"
PORT = ROOT / "yet_another_wizz_tpu_torch"

RETIRED = {
    # the Pallas kernels: csrc/paircount.cu behind ops/cuda_paircount.py
    "ops/pallas_paircount.py": "R10",
    # the TPU compile-cache workaround and the TPU device-memory ledger
    "utils/compile_cache.py": "R1",
    "utils/devicemem.py": "R2",
    # shape bucketing and padded slots of the TPU engine
    "ops/tiles.py::bucket_size": "R3",
    "ops/tiles.py::build_tile_set(device_pad_base)": "R3",
    "catalog/tilestore.py::PackedTileStore.open(device_pad_base)": "R3",
    "ops/paircount.py::count_pairs_tiles(padded_slots)": "R3",
    "parallel/sharded.py::count_pairs_sharded(chunk_size)": "R3",
    "parallel/sharded.py::count_pairs_sharded(engine)": "R3",
    # the fixed-point lanes and host-lane uploads (K2.2, retired by M5.5)
    "ops/tiles.py::encode_fixedpoint_lanes": "R6",
    "ops/tiles.py::decode_fixedpoint_lanes": "R6",
    "ops/tiles.py::lane_encoding": "R6",
    "ops/tiles.py::lane_quantisation_scale": "R6",
    "ops/tiles.py::uniform_weight_fill": "R6",
    "ops/tiles.py::HostLanes": "R6",
    "ops/tiles.py::TileSet.host_lanes": "R6",
    "ops/tiles.py::fuse_host_lanes": "R6",
    "ops/tiles.py::lane_upload_mode": "R6",
    "_native/__init__.py::encode_fixedpoint": "R6",
    # host ingestion helpers whose work the port does on the card or in numpy
    "_native/__init__.py::assign_patches_radec": "R7",
    "_native/__init__.py::counting_argsort_ids": "R7",
    "_native/__init__.py::gather_rows": "R7",
    "_native/__init__.py::gather_i32_to_f64": "R7",
    "_native/__init__.py::NATIVE_ENABLED": "R7",
    # one tile pair per call against the port's batched lanes1 / lanes2
    "ops/paircount.py::pair_block_counts(lane1)": "R8",
    "ops/paircount.py::pair_block_counts(lane2)": "R8",
    # the XLA scan engine (K2.4): the port's plain engine replaces it
    "ops/paircount.py::scan_scatter_counts": "R9",
    # the blocked path's phase timers: the port's spans and counters
    "correlation/blocked.py::reset_phase_totals": "R11",
}
"""JAX package names without a counterpart in the port: the module, the
``module::name``, the ``module::Class.method`` or the ``name(parameter)``,
and the ``ROADMAP.md`` item that retires it."""

PUBLIC_DUNDERS = ("__init__", "__call__")


def _statements(body):
    """Module-level statements, also those inside ``if`` and ``try``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody):
                yield from _statements(part)
            for handler in node.handlers:
                yield from _statements(handler.body)
        else:
            yield node


def _parameters(function) -> frozenset:
    args = function.args
    names = [a.arg for a in (*args.posonlyargs, *args.args, *args.kwonlyargs)]
    return frozenset(n for n in names if n not in ("self", "cls"))


def _class_info(node: ast.ClassDef) -> dict:
    methods = {}
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[item.name] = _parameters(item)
    for item in node.body:  # aliases such as ``build_trees = get_tiles``
        if isinstance(item, ast.Assign) and isinstance(item.value, ast.Name):
            for target in item.targets:
                if isinstance(target, ast.Name):
                    methods[target.id] = methods.get(item.value.id, frozenset())
    bases = [
        base.id if isinstance(base, ast.Name) else base.attr
        for base in node.bases
        if isinstance(base, (ast.Name, ast.Attribute))
    ]
    return {"methods": methods, "bases": bases}


@cache
def module_info(path: Path) -> dict:
    """``__all__`` (None without one), functions with their parameters and
    classes with their methods and bases, of one source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    info = {"all": None, "functions": {}, "classes": {}}
    for node in _statements(tree.body):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                info["all"] = list(ast.literal_eval(node.value))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info["functions"][node.name] = _parameters(node)
        elif isinstance(node, ast.ClassDef):
            info["classes"][node.name] = _class_info(node)
    return info


def modules(root: Path) -> list[str]:
    return sorted(
        p.relative_to(root).as_posix()
        for p in root.rglob("*.py")
        if "__pycache__" not in p.parts
    )


def _port_classes(name: str, module: str, infos: dict) -> list[dict]:
    """The port's class ``name`` as seen from ``module`` (that module's
    class first, else any port module's of that name)."""
    own = infos[module]["classes"].get(name)
    if own is not None:
        return [own]
    return [info["classes"][name] for info in infos.values() if name in info["classes"]]


def _port_methods(name: str, module: str, infos: dict, seen=None) -> dict:
    """Methods of a port class with those of its bases (the class's own
    definition wins)."""
    seen = set() if seen is None else seen
    methods: dict = {}
    for cls in _port_classes(name, module, infos):
        if id(cls) in seen:
            continue
        seen.add(id(cls))
        for base in cls["bases"]:
            methods.update(_port_methods(base, module, infos, seen))
        methods.update(cls["methods"])
    return methods


def surface_gaps(module: str, jax: dict, port: dict | None, port_infos: dict) -> list[str]:
    """The JAX module's public names, methods and parameters that the port
    module lacks, as :data:`RETIRED` keys."""
    if port is None:
        return [module]
    gaps = []
    port_all = set(port["all"] or ())
    for name in jax["all"] or ():
        if name not in port_all:
            gaps.append(f"{module}::{name}")
    for name, params in jax["functions"].items():
        if name.startswith("_"):
            continue
        if name not in port["functions"]:
            gaps.append(f"{module}::{name}")
            continue
        gaps += [
            f"{module}::{name}({p})"
            for p in sorted(params - port["functions"][name])
        ]
    for cls, info in jax["classes"].items():
        if cls.startswith("_"):
            continue
        if cls not in port["classes"]:
            gaps.append(f"{module}::{cls}")
            continue
        methods = _port_methods(cls, module, {**port_infos, module: port})
        for name, params in info["methods"].items():
            if name.startswith("_") and name not in PUBLIC_DUNDERS:
                continue
            if name not in methods:
                gaps.append(f"{module}::{cls}.{name}")
                continue
            gaps += [
                f"{module}::{cls}.{name}({p})"
                for p in sorted(params - methods[name])
            ]
    return sorted(set(gaps))


@cache
def port_infos() -> dict:
    return {m: module_info(PORT / m) for m in modules(PORT)}


def gaps_of(module: str) -> list[str]:
    infos = port_infos()
    return surface_gaps(module, module_info(JAX / module), infos.get(module), infos)


@pytest.mark.parametrize("module", modules(JAX))
def test_port_module_holds_the_jax_surface(module):
    unexplained = [gap for gap in gaps_of(module) if gap not in RETIRED]
    assert not unexplained, f"missing in the port: {unexplained}"


def test_every_retired_name_is_missing_and_names_a_roadmap_item():
    """No stale exception: each one is still a gap, and ``ROADMAP.md``
    holds its item."""
    gaps = {gap for module in modules(JAX) for gap in gaps_of(module)}
    assert sorted(set(RETIRED) - gaps) == []
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for key, item in RETIRED.items():
        assert re.search(rf"\*\*{re.escape(item)}\*\*", roadmap), (key, item)


ONCE_MISSING = [
    "catalog/readers.py::DataFrameReader",
    "catalog/readers.py::RandomReader",
    "catalog/catalog.py::Catalog.build_trees",
    "catalog/lazy.py::LazyCatalog.build_trees",
    "datachunk.py::HandlesDataChunk.copy_chunk_info",
    "catalog/ingest.py::write_patches_streaming(keep_data)",
    "catalog/ingest.py::write_patches_streaming(buffersize)",
    "catalog/ingest.py::write_patches_collective(buffersize)",
    "catalog/patch.py::PatchWriter.__init__(buffersize)",
]
"""Names of the JAX package that an earlier port lacked."""


def _without(port: dict, name: str) -> dict:
    """A copy of a parsed port module without ``name`` (a class, a
    ``Class.method``, a ``function(parameter)`` or a
    ``Class.method(parameter)``)."""
    port = {
        "all": [n for n in port["all"] or () if n != name],
        "functions": dict(port["functions"]),
        "classes": {
            cls: {"methods": dict(info["methods"]), "bases": info["bases"]}
            for cls, info in port["classes"].items()
        },
    }
    target, _, param = name.rstrip(")").partition("(")
    owner, _, member = target.rpartition(".")
    if param and owner:
        port["classes"][owner]["methods"][member] -= {param}
    elif param:
        port["functions"][target] -= {param}
    elif owner:
        del port["classes"][owner]["methods"][member]
    else:
        del port["classes"][target]
    return port


@pytest.mark.parametrize("gap", ONCE_MISSING)
def test_a_name_removed_from_the_port_is_reported(gap):
    """Each name the port once lacked is reported as a gap when it is
    taken out of the parsed port again."""
    module, _, name = gap.partition("::")
    infos = port_infos()
    jax = module_info(JAX / module)
    assert gap not in surface_gaps(module, jax, infos[module], infos)
    port = _without(infos[module], name)
    assert gap in surface_gaps(module, jax, port, {**infos, module: port})
