"""tests/test_torch_sweep_fused.py's cases over ``yr`` (a year: u8 plus
an offset) and ``q`` (1 to 50: u8 without one)."""

import pytest

from test_torch_sweep_fused import (  # noqa: F401 — the fixtures
    AGGS,
    FILTERS,
    SETTINGS,
    check,
    check_cohort,
    fused_dirs,
    setups,
)

OWN_COLUMNS = ("year", "small")


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("aggs", list(AGGS))
@pytest.mark.parametrize("col", OWN_COLUMNS)
@pytest.mark.parametrize("setting", SETTINGS)
def test_fused_surface(setups, setting, col, aggs, filt):
    check(setups, setting, col, aggs, filt)


@pytest.mark.parametrize("aggs", list(AGGS))
@pytest.mark.parametrize("col", OWN_COLUMNS)
def test_fused_surface_in_a_cohort(setups, col, aggs):
    check_cohort(setups, col, aggs)
