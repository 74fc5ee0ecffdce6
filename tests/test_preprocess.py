"""Preprocessing tests: outlier finders on synthetic cases with known answers,
the consecutive-run quality gate, and the end-to-end smoothing on the fixture."""

import numpy as np
import pytest

from bayesian_inference_tpu.preprocess import outliers as outl
from conftest import make_analysis_yaml


def test_large_statistical_uncertainty_points():
    # 4 features x 5 design points; one point has a 10x relative error
    rng = np.random.default_rng(0)
    values = np.ones((4, 5))
    y_err = np.full((4, 5), 0.1)
    y_err[2, 3] = 1.0
    feats, designs = outl.find_large_statistical_uncertainty_points(values, y_err, n_RMS=2.0)
    assert (2, 3) in set(zip(feats.tolist(), designs.tolist()))
    # the spike dominates the rms of its own row; others stay below 2x their row rms
    assert all(f == 2 for f in feats)


def test_central_value_outliers_interior_point():
    # smooth curve with one huge interior spike at feature 5, design 2
    n_f, n_d = 10, 6
    values = np.tile(np.linspace(1.0, 2.0, n_f)[:, None], (1, n_d))
    values[5, 2] = 10.0
    feats, designs = outl.find_outliers_based_on_central_values(values, n_RMS=2.0)
    assert (5, 2) in set(zip(feats.tolist(), designs.tolist()))
    # the spike's neighbors are not flagged (AND-of-neighbors rule)
    assert (4, 2) not in set(zip(feats.tolist(), designs.tolist()))
    assert (6, 2) not in set(zip(feats.tolist(), designs.tolist()))


def test_consecutive_gate():
    # design 0: isolated outliers at 1, 5 -> both interpolatable
    # design 1: run of 3 consecutive (2,3,4) with max 2 -> unfixable
    outliers = (np.array([1, 5, 2, 3, 4]), np.array([0, 0, 1, 1, 1]))
    interp, unfix = outl.gate_consecutive_outliers(outliers, max_consecutive=2)
    assert interp[0] == [1, 5]
    assert interp[1] == []
    assert unfix[1] == {2, 3, 4}

    # run of exactly 2 is allowed (strictly-greater rule)
    interp2, unfix2 = outl.gate_consecutive_outliers(
        (np.array([2, 3]), np.array([0, 0])), max_consecutive=2
    )
    assert interp2[0] == [2, 3]
    assert not unfix2


def test_linear_interpolation_replaces_outlier():
    """End-to-end: plant a spike in a fixture observable and verify smoothing."""
    import shutil
    from pathlib import Path
    import tempfile
    from bayesian_inference_tpu.io import hdf5
    from bayesian_inference_tpu.pipeline.configs import PreprocessingConfig, load_yaml

    with tempfile.TemporaryDirectory() as td:
        tmp_path = Path(td)
        config_path, analysis_name, param = make_analysis_yaml(tmp_path)
        run_dir = tmp_path / "output" / f"{analysis_name}_{param}"

        label = "2760__PbPb__hadron__pt_ch_atlas____0-5"  # 21 bins
        obs = hdf5.read_dict_from_h5(str(run_dir), "observables.h5", verbose=False)
        y = obs["Prediction"][label]["y"]
        orig = y[10, 7]
        y[10, 7] = 50.0 * np.abs(y).max()  # interior spike at bin 10, design 7
        hdf5.write_dict_to_h5(
            {"Prediction": {label: {"y": y}}}, str(run_dir), "observables.h5", verbose=False
        )

        cfg = PreprocessingConfig(
            analysis_name=analysis_name, parameterization=param,
            analysis_config=load_yaml(config_path)["analyses"][analysis_name],
            config_file=str(config_path),
        )
        smoothed = outl.preprocess(cfg)

        y_s = smoothed["Prediction"][label]["y"]
        # spike is gone: interpolated value is between its neighbors' scale
        assert abs(y_s[10, 7]) < 5 * np.abs(y).mean()
        assert np.isclose(
            y_s[10, 7], 0.5 * (y_s[9, 7] + y_s[11, 7]), rtol=0.35
        )  # roughly linear between neighbors (bins uneven)
        # untouched entries preserved
        assert y_s[10, 8] == y[10, 8]
        # carried-over keys exist
        for key in ("Data", "Design", "Design_validation", "Prediction_validation"):
            assert key in smoothed


def test_physics_motivated_outliers():
    obs = {
        "Prediction": {
            "5020__PbPb__hadron__pt_ch_x____0-5": {
                "y": np.array([[0.5, 1.5], [0.6, -0.5]]), "y_err": np.ones((2, 2)) * 0.01,
            },
            "5020__PbPb__chjet__zg_x____0-5": {  # substructure: exempt from RAA bounds
                "y": np.array([[5.0, -3.0]]), "y_err": np.ones((1, 2)) * 0.01,
            },
        }
    }
    suspects = outl.find_physics_motivated_outliers(obs)
    assert suspects == {"5020__PbPb__hadron__pt_ch_x____0-5": {1}}
