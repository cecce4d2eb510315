"""The kernel A/B probe (``probes/kernel_ab.py``) on the CPU: its tree
check, its refusal without a card and its summary. Its timings need the
card (``chip_smoke.py``'s machine)."""

import pathlib

import pytest
import torch

from grayscott_jl_tpu_torch.probes import kernel_ab

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_refuses_a_tree_without_the_package(tmp_path):
    with pytest.raises(SystemExit):
        kernel_ab.main([str(tmp_path)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_needs_a_card():
    assert kernel_ab.main([str(REPO)]) == 2


def test_summary_is_the_mean_per_tree_and_case():
    rows = [
        {"tree": "a", "cases": {"chain": {"device_ms": 1.0, "ms": 2.0}}},
        {"tree": "b", "cases": {"chain": {"device_ms": 5.0, "ms": None}}},
        {"tree": "b", "cases": {"chain": {"device_ms": 7.0, "ms": None}}},
        {"tree": "a", "cases": {"chain": {"device_ms": 3.0, "ms": 4.0}}},
    ]
    assert kernel_ab.summarize(rows) == {
        "a": {"chain": {"device_ms": 2.0, "ms": 3.0}},
        "b": {"chain": {"device_ms": 6.0, "ms": None}},
    }
