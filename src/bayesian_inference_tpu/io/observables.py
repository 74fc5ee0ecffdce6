"""Observable naming, ordering, filtering, and (design, feature) matrix assembly.

Observable labels follow the table-filename convention
``{sqrts}__{system}__{observable_type}__{observable}__{subobservable}__{centrality}``.

The fixed deterministic sort (by type, observable, subobservable, centrality,
sqrts — after a plain lexicographic pre-sort) is the contract that makes the
stacked (n_design, n_features) matrices reproducible across stages; it matches
the reference convention (data_IO.py:509-553) exactly.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import logging
from typing import Any, Mapping, Sequence

import numpy as np
import numpy.typing as npt

from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

logger = logging.getLogger(__name__)

# Field order within a label.
_LABEL_FIELDS = ("sqrts", "system", "observable_type", "observable", "subobservable", "centrality")
# Sort precedence: observable_type, observable, subobservable, centrality, sqrts.
_SORT_PRECEDENCE = (2, 3, 4, 5, 0)


def observable_label_to_keys(observable_label: str) -> tuple[str, str, str, str, str, str]:
    """Split a label into (sqrts, system, observable_type, observable, subobservable, centrality)."""
    parts = observable_label.split("__")
    return tuple(parts[:6])  # type: ignore[return-value]


def sort_observable_labels(labels: Sequence[str]) -> list[str]:
    """Deterministically order observable labels.

    Lexicographic pre-sort for unambiguous ordering, then a stable sort by
    (observable_type, observable, subobservable, centrality, sqrts).
    """
    pre = sorted(labels)
    keyed = [observable_label_to_keys(lbl) for lbl in pre]
    keyed.sort(key=lambda t: tuple(t[i] for i in _SORT_PRECEDENCE))
    return ["__".join(t) for t in keyed]


def sorted_observable_list_from_dict(
    observables: Mapping[str, Any],
    observable_filter: "ObservableFilter | None" = None,
) -> list[str]:
    """Sorted observable labels from an observables dict (or its 'Prediction' subdict)."""
    keys = list(observables["Prediction"].keys()) if "Prediction" in observables else list(observables.keys())
    if observable_filter is not None:
        keys = [k for k in keys if observable_filter.accept_observable(k)]
    return sort_observable_labels(keys)


def _matches_any(name: str, patterns: Sequence[str], use_glob: bool) -> bool:
    if use_glob:
        return any("*" in p and fnmatch.fnmatch(name, f"*{p}*") for p in patterns)
    return any(p in name for p in patterns)


@dataclasses.dataclass
class ObservableFilter:
    """Include/exclude lists with substring and fnmatch-glob matching.

    Semantics match the reference ObservableFilter (data_IO.py:588-634): a name
    is accepted when it matches the include list (substring or glob) and does
    not match the exclude list (substring or glob).
    """

    include_list: list[str]
    exclude_list: list[str] = dataclasses.field(default_factory=list)

    def accept_observable(self, observable_name: str) -> bool:
        included = _matches_any(observable_name, self.include_list, use_glob=False) or _matches_any(
            observable_name, self.include_list, use_glob=True
        )
        excluded = _matches_any(observable_name, self.exclude_list, use_glob=False) or _matches_any(
            observable_name, self.exclude_list, use_glob=True
        )
        return included and not excluded


def predictions_matrix_from_h5(
    output_dir: str,
    filename: str,
    validation_set: bool = False,
    observable_filter: ObservableFilter | None = None,
    observables: dict[str, Any] | None = None,
) -> npt.NDArray[np.float64]:
    """Stack per-observable prediction bins into one (n_design, n_features) matrix.

    Pass a pre-read ``observables`` dict to skip the full-file h5 read —
    callers assembling several filtered matrices from one file (emulation
    groups) pay the read once instead of per group (~0.2 s/read at
    production width on this host).
    """
    if observables is None:
        observables = read_dict_from_h5(output_dir, filename, verbose=False)
    labels = sorted_observable_list_from_dict(observables, observable_filter=observable_filter)
    key = "Prediction_validation" if validation_set else "Prediction"
    blocks = [np.atleast_2d(observables[key][lbl]["y"]).T for lbl in labels]
    if not blocks or sum(b.shape[1] for b in blocks) == 0:
        raise ValueError(f"No observables found in the prediction file for {observable_filter}")
    Y = np.concatenate(blocks, axis=1)
    logger.info(f"Prediction matrix ({key}) shape (n_samples, n_features): {Y.shape}")
    return Y


def design_array_from_h5(output_dir: str, filename: str, validation_set: bool = False) -> npt.NDArray[np.float64]:
    """Read the (n_design, n_params) design matrix."""
    observables = read_dict_from_h5(output_dir, filename, verbose=False)
    return observables["Design_validation" if validation_set else "Design"]


def data_dict_from_h5(output_dir: str, filename: str, observable_table_dir: str | None = None) -> dict[str, Any]:
    """Read the experimental-data dict, optionally cross-checking vs. the original tables."""
    observables = read_dict_from_h5(output_dir, filename, verbose=False)
    data = observables["Data"]
    if observable_table_dir:
        import os

        for label, entry in data.items():
            table = np.loadtxt(os.path.join(observable_table_dir, "Data", f"Data__{label}.dat"), ndmin=2)
            for col, key in enumerate(("xmin", "xmax", "y", "y_err")):
                assert np.allclose(entry[key], table[:, col])
    return data


def data_array_from_h5(
    output_dir: str,
    filename: str,
    pseudodata_index: int = -1,
    observable_filter: ObservableFilter | None = None,
    rng: np.random.Generator | None = None,
) -> dict[str, npt.NDArray[np.float64]]:
    """Assemble the stacked experimental data vector {'y','y_err'} of shape (n_features,).

    With ``pseudodata_index >= 0`` (closure test), the validation-set prediction
    at that index is smeared with N(0, sigma_exp) and the experimental
    uncertainties are attached — matching the reference's closure pseudodata
    construction (data_IO.py:345-388).
    """
    observables = read_dict_from_h5(output_dir, filename, verbose=False)
    labels = sorted_observable_list_from_dict(observables, observable_filter=observable_filter)
    if rng is None:
        rng = np.random.default_rng()

    ys, yerrs = [], []
    for lbl in labels:
        if pseudodata_index < 0:
            y = np.atleast_1d(observables["Data"][lbl]["y"])
            y_err = np.atleast_1d(observables["Data"][lbl]["y_err"])
        else:
            exp_err = np.atleast_1d(observables["Data"][lbl]["y_err"])
            central = np.atleast_2d(observables["Prediction_validation"][lbl]["y"])[:, pseudodata_index]
            y = central + rng.normal(loc=0.0, scale=exp_err)
            y_err = exp_err
        ys.append(y)
        yerrs.append(y_err)

    data = {"y": np.concatenate(ys), "y_err": np.concatenate(yerrs)}
    logger.info(f"Data vector shape (n_features,): {data['y'].shape}")
    return data


def observable_dict_from_matrix(
    Y: npt.NDArray[np.float64],
    observables: Mapping[str, Any],
    cov: npt.NDArray[np.float64] | None = None,
    validation_set: bool = False,
    observable_filter: ObservableFilter | None = None,
) -> dict[str, dict[str, npt.NDArray[np.float64]]]:
    """Unstack a (n_samples, n_features) matrix into per-observable blocks.

    Returns {'central_value': {label: (n_samples, n_bins)}, 'cov': {label: (n_samples, n_bins, n_bins)}}
    (cov only when provided; off-diagonal cross-observable terms are dropped, as
    in the reference — they exist but are only needed stacked).
    """
    if cov is not None and isinstance(cov, np.ndarray) and cov.size == 0:
        cov = None
    key = "Prediction_validation" if validation_set else "Prediction"
    labels = sorted_observable_list_from_dict(observables, observable_filter=observable_filter)

    out: dict[str, dict[str, npt.NDArray[np.float64]]] = {"central_value": {}}
    if cov is not None:
        out["cov"] = {}

    start = 0
    for lbl in labels:
        n_bins = np.atleast_2d(observables[key][lbl]["y"]).shape[0]
        out["central_value"][lbl] = Y[:, start : start + n_bins]
        if cov is not None:
            out["cov"][lbl] = cov[:, start : start + n_bins, start : start + n_bins]
        start += n_bins
    assert start == Y.shape[1], f"bin count mismatch: {start} != {Y.shape[1]}"
    return out


def observable_matrix_from_dict(
    Y_dict: Mapping[str, Mapping[str, npt.NDArray[np.float64]]],
    values_to_return: str = "central_value",
) -> npt.NDArray[np.float64]:
    """Re-stack per-observable blocks (already in sorted order) into one matrix."""
    blocks = [np.asarray(v) for v in Y_dict[values_to_return].values()]
    return np.concatenate(blocks, axis=1)
