"""Nested dict-of-ndarray <-> artifact file round trip.

Artifacts keep the reference's file names (observables.h5, mcmc.h5, ...) and
its nested key layout: groups are '/'-separated paths down to leaf arrays, as
in the silx ``dicttoh5``/``h5todict`` files the reference writes (reference
data_IO.py:217-257). The container is a zip archive with one ``.npy`` member
per leaf, so numpy alone reads and writes it and no HDF5 library is needed.

Streamed time series (``append_time_series``) are stored as numbered slabs
``<key>@<n>`` that readers concatenate in order; appending adds a member
without rewriting the file.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Any, Iterable, Mapping

import numpy as np

logger = logging.getLogger(__name__)

_SLAB = "@"


def _flatten(data: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for key, value in data.items():
        if value is None:
            # The reference stores e.g. autocorrelation_time=None when emcee
            # fails to estimate it; silx drops None leaves, and so do we.
            continue
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            arr = np.asarray(value)
            if arr.dtype.kind == "O":
                arr = arr.astype(str)
            flat[path] = arr
    return flat


def _base(name: str) -> str:
    return name.split(_SLAB, 1)[0]


def _members(zf: zipfile.ZipFile) -> list[str]:
    return [n[: -len(".npy")] for n in zf.namelist()]


def _read_array(zf: zipfile.ZipFile, name: str) -> np.ndarray:
    with zf.open(name + ".npy") as fh:
        return np.lib.format.read_array(fh, allow_pickle=False)


def _write(path: str, flat: Mapping[str, np.ndarray], mode: str) -> None:
    with zipfile.ZipFile(path, mode, zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in flat.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asarray(arr, order="C"), allow_pickle=False)


def _read_flat(path: str, keys: Iterable[str] | None = None) -> dict[str, np.ndarray]:
    """Leaf arrays by key, time-series slabs joined; ``keys`` limits the read."""
    wanted = None if keys is None else set(keys)
    with zipfile.ZipFile(path) as zf:
        names = [n for n in _members(zf) if wanted is None or _base(n) in wanted]
        parts: dict[str, list[tuple[int, np.ndarray]]] = {}
        for n in names:
            idx = int(n.split(_SLAB, 1)[1]) if _SLAB in n else -1
            parts.setdefault(_base(n), []).append((idx, _read_array(zf, n)))
    out = {}
    for key, slabs in parts.items():
        arrays = [a for _, a in sorted(slabs, key=lambda s: s[0])]
        out[key] = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
    return out


def _rewrite(path: str, flat: dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    _write(tmp, flat, "w")
    os.replace(tmp, path)


def _leaf(arr: np.ndarray) -> Any:
    if arr.ndim == 0:
        return str(arr[()]) if arr.dtype.kind == "U" else arr[()]
    return arr


def write_dict_to_h5(results: Mapping[str, Any], output_dir: str, filename: str, verbose: bool = True) -> None:
    """Write a nested dictionary of ndarrays to an artifact file.

    Existing leaves with the same path are replaced ("modify" semantics, as in
    the reference's silx update_mode="modify").
    """
    if verbose:
        logger.info(f"Writing results to {output_dir}/{filename}...")
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    flat = _flatten(results)
    if not os.path.exists(path):
        _write(path, flat, "w")
        return
    with zipfile.ZipFile(path) as zf:
        clash = {_base(n) for n in _members(zf)} & set(flat)
    if not clash:
        _write(path, flat, "a")
        return
    old = {k: v for k, v in _read_flat(path).items() if k not in flat}
    _rewrite(path, {**old, **flat})


def read_dict_from_h5(input_dir: str, filename: str, verbose: bool = True) -> dict[str, Any]:
    """Read a nested dictionary of ndarrays from an artifact file."""
    if verbose:
        logger.info(f"Loading results from {input_dir}/{filename}...")
    out: dict[str, Any] = {}
    for key, arr in sorted(_read_flat(os.path.join(input_dir, filename)).items()):
        *groups, leaf = key.split("/")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = _leaf(arr)
    return out


def read_datasets(input_dir: str, filename: str, keys: Iterable[str]) -> dict[str, np.ndarray]:
    """Top-level leaf arrays by key (time series joined), reading only those."""
    return _read_flat(os.path.join(input_dir, filename), keys)


def append_time_series(
    output_dir: str,
    filename: str,
    slabs: Mapping[str, np.ndarray],
    truncate_to: int | None = None,
) -> int:
    """Append slabs along axis 0 to streamed datasets (creating them on first
    use), so long MCMC chains stream to disk chunk by chunk instead of being
    concatenated in host memory. ``truncate_to`` first cuts every named
    dataset down to that length (resume support: drops slabs written after the
    last durable checkpoint). Returns the resulting length of the first
    dataset. Datasets created this way read back identically through
    ``read_dict_from_h5``.
    """
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    slabs = {k: np.asarray(v) for k, v in slabs.items()}
    if truncate_to is not None and os.path.exists(path):
        flat = _read_flat(path)
        for key in slabs:
            if key in flat:
                flat[key] = flat[key][:truncate_to]
        _rewrite(path, flat)
    lengths = {k: time_series_length(output_dir, filename, k) for k in slabs}
    counts: dict[str, int] = {}
    if os.path.exists(path):
        with zipfile.ZipFile(path) as zf:
            for n in _members(zf):
                counts[_base(n)] = counts.get(_base(n), 0) + 1
    _write(
        path,
        {f"{k}{_SLAB}{counts.get(k, 0):06d}": v for k, v in slabs.items()},
        "a" if os.path.exists(path) else "w",
    )
    first = next(iter(slabs))
    return lengths[first] + slabs[first].shape[0]


def time_series_length(output_dir: str, filename: str, key: str) -> int:
    """Length of a streamed dataset (0 when the file or dataset is missing)."""
    path = os.path.join(output_dir, filename)
    if not os.path.exists(path):
        return 0
    length = 0
    with zipfile.ZipFile(path) as zf:
        for n in _members(zf):
            if _base(n) != key:
                continue
            with zf.open(n + ".npy") as fh:
                version = np.lib.format.read_magic(fh)
                read_header = (
                    np.lib.format.read_array_header_1_0
                    if version == (1, 0)
                    else np.lib.format.read_array_header_2_0
                )
                shape = read_header(fh)[0]
            length += shape[0] if shape else 1
    return length
