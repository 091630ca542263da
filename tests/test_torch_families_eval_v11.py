"""The port's eval path on yolo11n (the v11 head) against the JAX package:
the checks of tests/test_torch_families_eval.py, on this model's fixture."""

import pytest

from test_torch_families_eval import (FIXTURES, make_fixture,  # noqa: F401
                                      test_extract_fit_evaluate_match_jax,
                                      test_fixture_is_non_degenerate, test_predict_matches_jax)
from torch_threads import _two_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_fixture(tmp_path_factory.mktemp("yolo11n"), "yolo11n", *FIXTURES["yolo11n"])
