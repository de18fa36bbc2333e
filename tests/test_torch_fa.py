"""Port parity: factor analysis (``metran_tpu_torch.ops.fa``,
``metran_tpu_torch.models.factoranalysis``) and the data layer
(``metran_tpu_torch.data``, ``metran_tpu_torch.utils``) against the JAX
package's host modules, and the golden example.

The port's modules are copies of the JAX package's numpy/scipy code, so
eigenvalues, the MAP test, factors and ``fep`` agree within 1e-10 (the
same code on the same inputs); against the golden file the bars are
``tests/test_factoranalysis.py``'s and ``tests/test_metran.py``'s.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from metran_tpu import data as jdata
from metran_tpu import utils as jutils
from metran_tpu.models.factoranalysis import FactorAnalysis as JFactorAnalysis
from metran_tpu.ops import fa as jfa
from metran_tpu_torch import data as pdata
from metran_tpu_torch import utils as putils
from metran_tpu_torch.models.factoranalysis import FactorAnalysis
from metran_tpu_torch.ops import fa as pfa

GOLDEN = Path(__file__).parent / "golden" / "metran_example.json"


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def _frame(seed, t=300, n=6, k=2, missing=0.2):
    """A panel with ``k`` AR(1) common factors (a random_ssm-like
    structure: loadings 0.3-0.9, specific noise), NaN-masked."""
    rng = np.random.default_rng(seed)
    common = np.zeros((t, k))
    for i in range(1, t):
        common[i] = 0.9 * common[i - 1] + rng.normal(size=k) * 0.44
    lds = rng.uniform(0.3, 0.9, (n, k)) / np.sqrt(k)
    raw = common @ lds.T + 0.5 * rng.normal(size=(t, n))
    raw[rng.uniform(size=raw.shape) < missing] = np.nan
    idx = pd.date_range("2001-01-01", periods=t, freq="D")
    return pd.DataFrame(raw, index=idx, columns=[f"s{i}" for i in range(n)])


def _close(got, want, bar=1e-10):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bar * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 3)])
def test_factor_analysis_matches_jax(seed, k):
    frame = _frame(seed, k=k)
    corr = pfa.correlation_matrix(frame)
    _close(corr, jfa.correlation_matrix(frame))
    eigval, eigvec = pfa.sorted_scaled_eig(corr)
    j_eigval, j_eigvec = jfa.sorted_scaled_eig(corr)
    _close(eigval, j_eigval)
    _close(eigvec, j_eigvec)
    assert pfa.map_test(corr, eigvec) == jfa.map_test(corr, j_eigvec)
    fa, jfa_model = FactorAnalysis(), JFactorAnalysis()
    got, want = fa.solve(frame), jfa_model.solve(frame)
    _close(got, want)
    _close(fa.eigval, jfa_model.eigval)
    _close(fa.fep, jfa_model.fep)
    _close(fa.get_eigval_weight(), jfa_model.get_eigval_weight())
    for mode in ("reference", "textbook"):
        res = pfa.factor_analysis(corr, mode=mode)
        ref = jfa.factor_analysis(corr, mode=mode)
        assert res.nfactors == ref.nfactors
        _close(res.factors, ref.factors)


def test_factor_analysis_golden(golden, series_list):
    corr = np.array(golden["correlation"])
    eigval, eigvec = pfa.sorted_scaled_eig(corr)
    np.testing.assert_allclose(eigval, golden["eigval"], rtol=1e-12)
    assert list(pfa.map_test(corr, eigvec)) == golden["maptest"]
    result = pfa.factor_analysis(corr)
    np.testing.assert_allclose(result.factors, golden["factors"], rtol=1e-8)
    np.testing.assert_allclose(result.fep, golden["fep"], rtol=1e-10)
    raw = pfa.minres(corr, result.nfactors)
    np.testing.assert_allclose(raw, golden["minres_loadings_raw"], rtol=1e-8)
    # the whole pipeline from the example series
    panel = pdata.build_panel(series_list)
    frame = pdata.panel_to_frame(
        panel, np.where(panel.mask, panel.values, np.nan))
    fa = FactorAnalysis()
    factors = fa.solve(frame)
    np.testing.assert_allclose(factors, golden["factors"], rtol=1e-8)
    np.testing.assert_allclose(np.sum(factors**2, axis=1),
                               golden["communality"], rtol=1e-8)


def test_no_factors_path_matches_jax():
    corr = np.eye(3)
    got, want = pfa.factor_analysis(corr), jfa.factor_analysis(corr)
    assert got.factors is None and want.factors is None
    assert got.nfactors == want.nfactors == 0


def test_data_layer_matches_jax(series_list):
    got = pdata.build_panel(series_list, tmin="1990-01-01")
    want = jdata.build_panel(series_list, tmin="1990-01-01")
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.std, want.std)
    np.testing.assert_array_equal(got.mean, want.mean)
    assert got.names == want.names and got.dt == want.dt
    assert got.index.equals(want.index)
    frame = pdata.combine_series(series_list)
    pd.testing.assert_frame_equal(frame, jdata.combine_series(series_list))
    with pytest.raises(Exception, match="at least 2 series"):
        pdata.combine_series(series_list[:1])
    with pytest.raises(Exception, match="cross-sectional"):
        pdata.test_cross_section(frame, min_pairs=10**6)
    for freq in ("D", "7D", "12h"):
        assert putils.freq_to_days(freq) == jutils.freq_to_days(freq)
    with pytest.raises(ValueError):
        putils.frequency_is_supported("M")
    assert putils.validate_name("a b") == "a b"
    with pytest.raises(ValueError):
        putils.validate_name("a/b", raise_error=True)
    assert putils.get_height_ratios([(0, 1), (0, 3)]) == \
        jutils.get_height_ratios([(0, 1), (0, 3)])
