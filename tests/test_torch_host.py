"""The port's host-side copies (config, data pipeline, graph supports)
give array-equal results to the JAX package's, for the ``smoke`` and
``default`` presets."""

import numpy as np
import pytest
import torch

from stmgcn_tpu import config as jax_config
from stmgcn_tpu import experiment as jax_experiment
from stmgcn_tpu_torch import config as port_config
from stmgcn_tpu_torch import experiment as port_experiment

torch.set_num_threads(1)

PRESETS = ["smoke", "default"]


@pytest.fixture(scope="module", params=PRESETS)
def built(request):
    jcfg = jax_config.preset(request.param)
    pcfg = port_config.preset(request.param)
    jds = jax_experiment.build_dataset(jcfg)
    pds = port_experiment.build_dataset(pcfg)
    return jcfg, pcfg, jds, pds


def test_preset_reads_the_jax_config_dict(built):
    jcfg, pcfg, _, _ = built
    read = port_config.ExperimentConfig.from_dict(jcfg.to_dict())
    assert read == pcfg
    for section in ("data", "model", "serving"):
        jsec, psec = getattr(jcfg, section), getattr(pcfg, section)
        for name, value in vars(psec).items():
            assert getattr(jsec, name) == value, (section, name)
    assert pcfg.model.n_supports == jcfg.model.n_supports


def test_supports_equal(built):
    jcfg, pcfg, jds, pds = built
    want = np.asarray(jax_experiment.build_supports(jcfg, jds))
    got = port_experiment.build_supports(pcfg, pds)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["train", "validate", "test"])
def test_windows_and_split_indices_equal(built, mode):
    _, _, jds, pds = built
    assert pds.split.range_for(mode) == jds.split.range_for(mode)
    assert np.array_equal(pds.mode_targets(mode), jds.mode_targets(mode))
    for got, want in zip(pds.arrays(mode), jds.arrays(mode)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_normalizer_statistics_equal(built):
    _, _, jds, pds = built
    assert pds.normalizer.to_dict() == jds.normalizer.to_dict()
    assert np.array_equal(pds.series(), jds.series())


def test_serving_config_contract_matches():
    """Same violations, naming the same knobs (wording may differ)."""
    for kw in ({}, {"buckets": (1, 64)}, {"deadline_ms": 1.0},
               {"queue_bound_rows": 8}, {"degrade_rung": 3}):
        want = jax_config.ServingConfig(**kw).violations()
        got = port_config.ServingConfig(**kw).violations()
        assert [v.split()[:2] for v in got] == [v.split()[:2] for v in want], kw
