"""Card-only checks at the bench widths (tests/card_checks.py): they
skip off the GPU; ``python -m pytest tests -m gpu`` runs them on a card.
chip_smoke.py runs the same checks in-process."""

import pytest

import card_checks

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def bench(gpu):
    return card_checks.bench_graph()


def test_window_matches_sequential_at_bench_width(bench):
    card_checks.check_window_matches_sequential(*bench)


def test_phi_beta_match_oracle_at_k256(bench):
    card_checks.check_phi_beta_vs_oracle(*bench)


def test_device_bf_link_bitwise_at_bench_ids(bench):
    card_checks.check_device_bf_bitwise(*bench)
