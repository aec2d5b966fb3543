"""The system under test, driven by a configuration and a traffic mix.

One general driver reads both data files: the configuration says what the
catalogs are; the traffic mix says what one measurement is. A mix lists its
``calls`` in order, each a ``crosscorrelate`` (``"fn": "cross"``, catalogs
by role: ``reference``, ``unknown``, ``ref_rand``) or an ``autocorrelate``
(``"fn": "auto"``: ``data``, ``random``), with keyword arguments of its own
(``kwargs``, such as ``audit``). Its ``post`` steps follow: ``{"nz": <cross
call>, "ref_corr": <auto call>}`` (``ref_corr`` optional) for
``RedshiftData.from_corrfuncs``, or ``{"corr": <call>}`` for the call's own
estimate (``CorrFunc.sample()``). ``catalogs`` is ``setup`` (built once) or
``each_measurement``; ``patches`` is ``benchmark`` (the benchmark's centres,
the default) or ``program`` (the program's own k-means on the reference
catalog, with the configuration's ``num_patches``, whose centres the others
take). Spans of the benchmark's own mark each call into a layer.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import numpy as np

ROLES = {"cross": (("reference", "unknown"), ("ref_rand",)),
         "auto": (("data", "random"), ())}
"""Per kind of call: the catalogs it takes by position, then by keyword."""


def kinds_of(call: dict) -> dict:
    """The pair counts a call produces: ``{kind: (rows' role, columns'
    role)}``, in the program's names."""
    if call["fn"] == "auto":
        return {"dd": ("data", "data"), "dr": ("data", "random"),
                "rr": ("random", "random")}
    return {"dd": ("reference", "unknown"), "rd": ("ref_rand", "unknown")}


class Spans:
    """The benchmark's spans: while a profiler records, each call into a
    layer appears in its trace as a ``bench/<name>`` range."""

    def __init__(self) -> None:
        self.profiling = False

    @contextmanager
    def span(self, name: str, synchronize: bool = False):
        import torch

        with (torch.profiler.record_function(f"bench/{name}") if self.profiling
              else nullcontext()):
            yield
            if synchronize and torch.cuda.is_available():
                torch.cuda.synchronize()


@dataclass
class Output:
    """What one measurement returned: per call its correlation functions
    (one per scale), per post step its results (one per scale), and, where
    the program made the patches, their centres."""

    calls: dict
    post: list
    centers: np.ndarray | None


class Session:
    """Builds the system from ``config`` and ``inputs`` and runs the
    measurement ``traffic`` describes."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, device: str,
                 spans: Spans) -> None:
        self.config, self.traffic, self.inputs = config, traffic, inputs
        self.device, self.spans = device, spans
        self.catalogs = None

    def setup(self) -> None:
        from yet_another_wizz_tpu_torch.config import Configuration

        self.configuration = Configuration.create(
            **self.config["scales"][self.traffic["scales"]], **self.config["binning"]
        )
        if self.traffic["catalogs"] == "setup":
            self.catalogs = self._build_catalogs()

    def _build_catalogs(self) -> dict:
        from yet_another_wizz_tpu_torch.catalog import Catalog

        def build(name, **patches):
            columns = self.inputs["catalogs"][name]
            return Catalog.from_arrays(
                ra=columns["ra"], dec=columns["dec"],
                redshifts=columns["redshifts"], weights=columns["weights"],
                degrees=False, device=self.device, **patches)

        catalogs = {}
        if self.traffic.get("patches", "benchmark") == "program":
            catalogs["reference"] = build("reference",
                                          patch_num=self.config["num_patches"])
            centers = catalogs["reference"]
        else:
            centers = self.inputs["centers"]
        for name in self.inputs["catalogs"]:
            if name not in catalogs:
                catalogs[name] = build(name, patch_centers=centers)
        return catalogs

    def measure(self) -> Output:
        """One measurement, synchronised at its end."""
        import torch

        from yet_another_wizz_tpu_torch.correlation.measurements import (
            autocorrelate,
            crosscorrelate,
        )
        from yet_another_wizz_tpu_torch.redshifts import RedshiftData

        functions = {"cross": crosscorrelate, "auto": autocorrelate}
        catalogs = self.catalogs
        if catalogs is None:
            with self.spans.span("catalog", synchronize=True):
                catalogs = self._build_catalogs()
        calls = {}
        for call in self.traffic["calls"]:
            positional, keywords = ROLES[call["fn"]]
            roles = call["catalogs"]
            args = [catalogs[roles[role]] for role in positional]
            kwargs = {role: catalogs[roles[role]] for role in keywords}
            with self.spans.span("count"):
                calls[call["name"]] = functions[call["fn"]](
                    self.configuration, *args, device=self.device, **kwargs,
                    **call.get("kwargs", {}))
        post = []
        with self.spans.span("nz", synchronize=True):
            for step in self.traffic["post"]:
                if "nz" in step:
                    auto = calls[step["ref_corr"]] if step.get("ref_corr") else None
                    post.append([
                        RedshiftData.from_corrfuncs(
                            w_sp, ref_corr=None if auto is None else auto[s])
                        for s, w_sp in enumerate(calls[step["nz"]])])
                else:
                    post.append([corr.sample() for corr in calls[step["corr"]]])
        if self.device != "cpu":
            torch.cuda.synchronize()
        centers = None
        if self.traffic.get("patches", "benchmark") == "program":
            centers = np.asarray(catalogs["reference"].get_centers().to_3d())
        return Output(calls=calls, post=post, centers=centers)

    def close(self) -> None:
        """Free the program's state."""
        self.catalogs = None


def extract(output: Output, traffic: dict) -> dict:
    """The numbers of one measurement that the check compares, as NumPy
    arrays: counts and sums of weights per call and kind (``<call>_<kind>``,
    scales first), each post step's values and covariance per scale, and the
    program's patch centres (None with the benchmark's)."""
    result = {"counts": {}, "sum_weights": {}, "post": [],
              "centers": output.centers}
    for call in traffic["calls"]:
        corrs = output.calls[call["name"]]
        for kind in kinds_of(call):
            key = f"{call['name']}_{kind}"
            result["counts"][key] = np.array(
                [getattr(corr, kind).counts.counts for corr in corrs])
            sums = getattr(corrs[0], kind).sum_weights
            result["sum_weights"][key] = (np.array(sums.sum_weights1),
                                          np.array(sums.sum_weights2))
    for step in output.post:
        result["post"].append([(np.array(item.data), np.array(item.covariance))
                               for item in step])
    return result
