"""Closure-test machinery: pseudodata construction, per-point MCMC artifacts,
and closure plots."""

import os
from pathlib import Path

import numpy as np
import pytest
import yaml

from bayesian_inference_tpu import io
from bayesian_inference_tpu.mcmc.runner import run_mcmc
from bayesian_inference_tpu.models import emulator
from bayesian_inference_tpu.pipeline.configs import EmulationConfig, MCMCConfig, load_yaml
from conftest import make_analysis_yaml


@pytest.fixture(scope="module")
def closure_setup(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("closure")
    groups = {"default_group": {"n_pc": 2, "observable_list": ["hadron__pt_"]}}
    config_path, analysis_name, param = make_analysis_yaml(
        tmp_path, groups=groups, n_walkers=12, n_burn_steps=16, n_sampling_steps=40, n_restarts=1
    )
    analysis_config = load_yaml(config_path)["analyses"][analysis_name]
    emu_config = EmulationConfig.from_config_file(
        analysis_name=analysis_name, parameterization=param,
        config_file=str(config_path), analysis_config=analysis_config,
    )
    emulator.fit_emulators(emu_config, n_opt_iters=20)
    return config_path, analysis_name, param, analysis_config


def test_pseudodata_smearing(closure_setup):
    """Closure pseudodata = validation prediction + N(0, sigma_exp), with
    experimental uncertainties attached (reference data_IO.py:365-372)."""
    config_path, analysis_name, param, analysis_config = closure_setup
    run_dir = str(Path(config_path).parent / "output" / f"{analysis_name}_{param}")

    rng = np.random.default_rng(7)
    pseud = io.data_array_from_h5(run_dir, "observables.h5", pseudodata_index=3, rng=rng)
    real = io.data_array_from_h5(run_dir, "observables.h5")
    obs = io.read_dict_from_h5(run_dir, "observables.h5", verbose=False)

    np.testing.assert_allclose(pseud["y_err"], real["y_err"])  # exp errors attached
    # central values near the validation prediction (within a few sigma)
    val = io.predictions_matrix_from_h5(run_dir, "observables.h5", validation_set=True)
    resid = (pseud["y"] - val[3]) / real["y_err"]
    assert np.abs(resid).max() < 6
    assert np.abs(resid).mean() < 2


@pytest.mark.slow
def test_closure_mcmc_and_plots(closure_setup):
    config_path, analysis_name, param, analysis_config = closure_setup
    for idx in (0, 1):
        cfg = MCMCConfig(
            analysis_name=analysis_name, parameterization=param,
            analysis_config=analysis_config, config_file=str(config_path),
            closure_index=idx,
        )
        out = run_mcmc(cfg, closure_index=idx, seed=idx)
        assert "design_point" in out
        stored = io.read_dict_from_h5(cfg.mcmc_output_dir, "mcmc.h5", verbose=False)
        assert stored["design_point"].shape == (6,)
        assert "experimental_pseudodata" in stored
        assert f"closure/results/{idx}" in cfg.mcmc_output_dir

    from bayesian_inference_tpu.plots import closure as plot_closure

    mcmc_cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    plot_closure.plot(mcmc_cfg)
    plot_dir = Path(mcmc_cfg.output_dir) / "plot_closure"
    assert (plot_dir / "closure_summary.pdf").exists()
    assert (plot_dir / "closure_summary_ET.pdf").exists()
    assert (plot_dir / "closure_summary_parameters.pdf").exists()
    # HPDI + holdout-truth pairplot per closure point (reference plot_mcmc.py:236-290)
    assert (plot_dir / "point_0" / "pairplot_holdout.pdf").exists()
    assert (plot_dir / "point_1" / "pairplot_holdout.pdf").exists()


def test_pairplot_holdout_containment_logic(tmp_path):
    """The pairplot returns the theta-space closure verdict: True when the
    truth lies in every marginal HPDI, False when any component is outside."""
    from bayesian_inference_tpu.plots.mcmc import _plot_pairplot

    rng = np.random.default_rng(0)
    chain = rng.normal(0.0, 1.0, (400, 8, 3))  # (steps, walkers, ndim)
    names = ["a", "b", "c"]
    inside = _plot_pairplot(
        chain, names, str(tmp_path), confidence=0.9,
        holdout_point=np.zeros(3), filename="in.pdf",
    )
    outside = _plot_pairplot(
        chain, names, str(tmp_path), confidence=0.9,
        holdout_point=np.array([0.0, 0.0, 9.0]), filename="out.pdf",
    )
    assert inside is True
    assert outside is False
    assert (tmp_path / "in.pdf").exists() and (tmp_path / "out.pdf").exists()


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_batched_closure_matches_sequential(closure_setup, tmp_path, mode):
    """run_closure_batch (all validation points vmapped into one program)
    reproduces the sequential per-point runner exactly — in BOTH likelihood
    modes (lowrank rebuilds the d0-dependent Woodbury pieces per point from
    the cached d0-independent factorization): same pseudodata, same key
    derivation, same chains and artifacts."""
    import shutil

    from bayesian_inference_tpu.mcmc.runner import run_closure_batch

    config_path, analysis_name, param, analysis_config = closure_setup
    indices = [0, 2]

    seq = {}
    for i in indices:
        cfg = MCMCConfig(
            analysis_name=analysis_name, parameterization=param,
            analysis_config=analysis_config, config_file=str(config_path),
            closure_index=i,
        )
        seq[i] = run_mcmc(cfg, closure_index=i, seed=i, mode=mode)
        shutil.rmtree(cfg.mcmc_output_dir)

    base_cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    batched = run_closure_batch(base_cfg, indices, seed=0, mode=mode)

    for i in indices:
        assert batched[i]["chain"].shape == seq[i]["chain"].shape
        np.testing.assert_allclose(
            batched[i]["experimental_pseudodata"]["y"],
            seq[i]["experimental_pseudodata"]["y"],
        )
        np.testing.assert_allclose(batched[i]["chain"], seq[i]["chain"])
        np.testing.assert_allclose(batched[i]["log_prob"], seq[i]["log_prob"])
        np.testing.assert_allclose(
            batched[i]["acceptance_fraction"], seq[i]["acceptance_fraction"]
        )
        # artifact on disk in the sequential location/format
        cfg_i = MCMCConfig(
            analysis_name=analysis_name, parameterization=param,
            analysis_config=analysis_config, config_file=str(config_path),
            closure_index=i,
        )
        stored = io.read_dict_from_h5(cfg_i.mcmc_output_dir, "mcmc.h5", verbose=False)
        np.testing.assert_allclose(stored["chain"], batched[i]["chain"])
        assert stored["design_point"].shape == (6,)


@pytest.mark.slow
def test_batched_closure_sharded_over_mesh(closure_setup):
    """The closure P axis shards over the device mesh (with pad points when P
    isn't a mesh multiple); results match the unsharded batch."""
    import shutil

    import jax

    from bayesian_inference_tpu.mcmc.runner import run_closure_batch
    from bayesian_inference_tpu.parallel.mesh import get_mesh

    config_path, analysis_name, param, analysis_config = closure_setup
    indices = [0, 1, 2]  # pads to 8 on the virtual 8-device mesh

    base_cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    plain = run_closure_batch(base_cfg, indices, seed=0)
    for i in indices:
        cfg_i = MCMCConfig(
            analysis_name=analysis_name, parameterization=param,
            analysis_config=analysis_config, config_file=str(config_path),
            closure_index=i,
        )
        shutil.rmtree(cfg_i.mcmc_output_dir)

    mesh = get_mesh(len(jax.devices()))
    sharded = run_closure_batch(base_cfg, indices, seed=0, mesh=mesh)
    for i in indices:
        np.testing.assert_allclose(sharded[i]["chain"], plain[i]["chain"], rtol=1e-10)
        np.testing.assert_allclose(
            sharded[i]["acceptance_fraction"], plain[i]["acceptance_fraction"]
        )


def test_batched_closure_checkpoint_resume(closure_setup, monkeypatch):
    """An interrupted batched closure run resumes from its checkpoint and
    produces bit-identical chains to an uninterrupted run (streamed per-point
    h5 slabs kept, sampler state restored from the snapshot)."""
    import shutil

    from bayesian_inference_tpu.mcmc.runner import run_closure_batch

    config_path, analysis_name, param, analysis_config = closure_setup
    indices = [0, 1]
    base_cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )

    # uninterrupted run (chunked the same way)
    full = run_closure_batch(
        base_cfg, indices, seed=0, dispatch_chunk=10, checkpoint_every=10
    )
    for i in indices:
        cfg_i = MCMCConfig(
            analysis_name=analysis_name, parameterization=param,
            analysis_config=analysis_config, config_file=str(config_path),
            closure_index=i,
        )
        shutil.rmtree(cfg_i.mcmc_output_dir)

    # interrupted after 2 of 4 chunks, then resumed
    monkeypatch.setenv("BIQ_CLOSURE_ABORT_AFTER_CHUNKS", "2")
    with pytest.raises(RuntimeError, match="aborted by"):
        run_closure_batch(base_cfg, indices, seed=0, dispatch_chunk=10, checkpoint_every=10)
    ckpt = Path(base_cfg.output_dir) / "closure" / "closure_checkpoint.pkl"
    assert ckpt.exists()
    monkeypatch.delenv("BIQ_CLOSURE_ABORT_AFTER_CHUNKS")
    resumed = run_closure_batch(
        base_cfg, indices, seed=0, dispatch_chunk=10, checkpoint_every=10
    )
    assert not ckpt.exists()  # consumed on completion

    for i in indices:
        np.testing.assert_array_equal(resumed[i]["chain"], full[i]["chain"])
        np.testing.assert_array_equal(resumed[i]["log_prob"], full[i]["log_prob"])
        np.testing.assert_allclose(
            resumed[i]["acceptance_fraction"], full[i]["acceptance_fraction"]
        )


@pytest.mark.slow
def test_batched_closure_checkpoint_double_interrupt(closure_setup, monkeypatch):
    """A resume that is ITSELF interrupted stays resumable: the checkpoint
    rewrite preserves the prior run's records, the second resume appends to
    them, and the final run matches an uninterrupted one bit-exactly. Also
    guards the torn-artifact path: a streamed chain shorter than the
    checkpoint step must raise instead of being silently zero-filled."""
    import pickle

    from bayesian_inference_tpu.mcmc.runner import run_closure_batch

    config_path, analysis_name, param, analysis_config = closure_setup
    indices = [0, 1]
    base_cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    kw = dict(seed=0, dispatch_chunk=10, checkpoint_every=10)
    full = run_closure_batch(base_cfg, indices, **kw)
    for i in indices:
        cfg_i = MCMCConfig(
            analysis_name=analysis_name, parameterization=param,
            analysis_config=analysis_config, config_file=str(config_path),
            closure_index=i,
        )
        import shutil

        shutil.rmtree(cfg_i.mcmc_output_dir)

    ckpt = Path(base_cfg.output_dir) / "closure" / "closure_checkpoint.pkl"
    monkeypatch.setenv("BIQ_CLOSURE_ABORT_AFTER_CHUNKS", "2")
    with pytest.raises(RuntimeError, match="aborted by"):
        run_closure_batch(base_cfg, indices, **kw)
    monkeypatch.setenv("BIQ_CLOSURE_ABORT_AFTER_CHUNKS", "1")
    with pytest.raises(RuntimeError, match="aborted by"):
        run_closure_batch(base_cfg, indices, **kw)  # resume, then abort again

    # header + the 2 preserved records + the 1 new one survive on disk
    with open(ckpt, "rb") as f:
        header = pickle.load(f)
        records = []
        while True:
            try:
                records.append(pickle.load(f))
            except EOFError:
                break
    assert header["n_walkers"] == base_cfg.n_walkers and header["n_pad"] == 0
    assert [r["steps_done"] for r in records] == [10, 20, 30]

    monkeypatch.delenv("BIQ_CLOSURE_ABORT_AFTER_CHUNKS")
    resumed = run_closure_batch(base_cfg, indices, **kw)
    assert not ckpt.exists()
    for i in indices:
        np.testing.assert_array_equal(resumed[i]["chain"], full[i]["chain"])
        np.testing.assert_array_equal(resumed[i]["log_prob"], full[i]["log_prob"])

    # torn-artifact guard: chain shorter than the checkpoint step -> error
    monkeypatch.setenv("BIQ_CLOSURE_ABORT_AFTER_CHUNKS", "2")
    with pytest.raises(RuntimeError, match="aborted by"):
        run_closure_batch(base_cfg, indices, **kw)
    monkeypatch.delenv("BIQ_CLOSURE_ABORT_AFTER_CHUNKS")
    from bayesian_inference_tpu.io import hdf5

    cfg_0 = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
        closure_index=indices[0],
    )
    # torn write: chain shorter than the checkpoint
    hdf5.append_time_series(
        cfg_0.mcmc_output_dir, "mcmc.h5",
        {"chain": np.zeros((0, *full[indices[0]]["chain"].shape[1:]))}, truncate_to=5,
    )
    with pytest.raises(RuntimeError, match="inconsistent"):
        run_closure_batch(base_cfg, indices, **kw)


def test_closure_checkpoint_header_compatibility(tmp_path):
    """_read_closure_checkpoint rejects checkpoints whose shape-defining
    header fields (mesh pad width, walker count, ...) differ from the
    resuming run's, so a mesh change restarts fresh with a clear message
    instead of a broadcast error deep in the vmapped sampler."""
    import pickle

    from bayesian_inference_tpu.mcmc.runner import _read_closure_checkpoint

    header = {"version": 2, "n_total": 40, "indices": [0, 1], "seed": 0,
              "n_walkers": 8, "ndim": 6, "n_pad": 4}
    record = {"steps_done": 10}
    path = tmp_path / "closure_checkpoint.pkl"
    with open(path, "wb") as f:
        pickle.dump(header, f)
        pickle.dump(record, f)

    assert _read_closure_checkpoint(str(path), dict(header)) == [record]
    for k, v in [("n_pad", 0), ("n_walkers", 16), ("ndim", 4), ("seed", 1),
                 ("version", 1), ("indices", [0, 2])]:
        assert _read_closure_checkpoint(str(path), {**header, k: v}) is None


def test_closure_batch_return_chains_false(closure_setup):
    """return_chains=False keeps chains out of the returned dicts (production
    memory bound) while the on-disk artifacts stay complete.

    Uses the same batch shape (P=2) and dispatch chunking as the
    checkpoint-resume test above so the batched init/chunk programs hit the
    in-process jit cache instead of recompiling (the compile is the entire
    cost of these tests on the CPU backend)."""
    from bayesian_inference_tpu.mcmc.runner import run_closure_batch

    config_path, analysis_name, param, analysis_config = closure_setup
    base_cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    out = run_closure_batch(
        base_cfg, [3, 4], seed=0, return_chains=False,
        dispatch_chunk=10, checkpoint_every=10,
    )
    assert "chain" not in out[3] and "log_prob" not in out[3]
    cfg_i = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
        closure_index=3,
    )
    stored = io.read_dict_from_h5(cfg_i.mcmc_output_dir, "mcmc.h5", verbose=False)
    assert stored["chain"].shape == (base_cfg.n_sampling_steps, base_cfg.n_walkers, 6)
    assert stored["log_prob"].shape == (base_cfg.n_sampling_steps, base_cfg.n_walkers)
    assert "split_rhat" in stored and "experimental_pseudodata" in stored


def test_batched_closure_bounded_dispatch_window(closure_setup, monkeypatch):
    """Above the HBM budget, run_closure_batch dispatches a bounded window of
    chunks (freeing each slab after its per-point write) instead of pinning
    the whole batch on device. The dispatch ORDER and RNG path are unchanged,
    so results must be bit-identical to dispatch-all."""
    from bayesian_inference_tpu.mcmc.runner import run_closure_batch

    config_path, analysis_name, param, analysis_config = closure_setup
    indices = [0, 2]
    base_cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    full = run_closure_batch(base_cfg, indices, seed=0, dispatch_chunk=10)

    monkeypatch.setenv("BIQ_CLOSURE_HBM_BUDGET_MB", "0")  # force window=2
    windowed = run_closure_batch(base_cfg, indices, seed=0, dispatch_chunk=10)
    for i in indices:
        np.testing.assert_array_equal(windowed[i]["chain"], full[i]["chain"])
        np.testing.assert_array_equal(windowed[i]["log_prob"], full[i]["log_prob"])
        np.testing.assert_array_equal(
            windowed[i]["acceptance_fraction"], full[i]["acceptance_fraction"]
        )


def test_batched_closure_uint16_transfer_parity(closure_setup, monkeypatch):
    """Batched closure with chain_transfer=uint16: sampling unchanged
    (acceptance bit-identical to a lossless run), archived chains within half
    a prior-box quantization step, archived log-prob within half a per-chunk
    min/span step (the slab spans ALL points, so the bound uses the slab's
    own span)."""
    from bayesian_inference_tpu.mcmc.runner import run_closure_batch

    config_path, analysis_name, param, analysis_config = closure_setup
    kw = dict(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    out_plain = run_closure_batch(MCMCConfig(**kw), [3, 4], seed=0, dispatch_chunk=10)
    chains_p = {i: out_plain[i]["chain"].copy() for i in (3, 4)}
    logps_p = {i: out_plain[i]["log_prob"].copy() for i in (3, 4)}

    monkeypatch.setenv("BIQ_CHAIN_TRANSFER", "uint16")
    cfg_q = MCMCConfig(**kw)
    assert cfg_q.chain_transfer == "uint16"
    out_q = run_closure_batch(cfg_q, [3, 4], seed=0, dispatch_chunk=10)

    pspec = analysis_config["parameterization"][param]
    bound = (np.asarray(pspec["max"], float) - np.asarray(pspec["min"], float)) / 131070.0
    saw_quantization = False
    for i in (3, 4):
        np.testing.assert_array_equal(
            out_q[i]["acceptance_fraction"], out_plain[i]["acceptance_fraction"]
        )
        err = np.abs(out_q[i]["chain"] - chains_p[i])
        saw_quantization |= err.max() > 0
        assert np.all(err <= bound * (1 + 1e-12))
    assert saw_quantization
    # log-prob: per-dispatch-chunk bound from the ALL-points slab span
    lp_p = np.stack([logps_p[3], logps_p[4]], axis=1)  # (n, P, W)
    lp_q = np.stack([out_q[3]["log_prob"], out_q[4]["log_prob"]], axis=1)
    n = lp_p.shape[0]
    for s0 in range(0, n, 10):
        sl = slice(s0, s0 + 10)
        fin = np.isfinite(lp_p[sl])
        np.testing.assert_array_equal(np.isfinite(lp_q[sl]), fin)
        span = lp_p[sl][fin].max() - lp_p[sl][fin].min()
        assert np.all(np.abs(lp_q[sl][fin] - lp_p[sl][fin]) <= span / 131068.0 * (1 + 1e-12))
