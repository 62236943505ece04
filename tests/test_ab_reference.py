"""A/B parity test: this extraction vs the compiled reference extract_ref.

Compiles the actual reference C++ engine (src/extract_ref_normal_peak.cpp)
and compares interval-level output on a shared fixture — the "prove parity
against the real reference engine" gate. Skips cleanly when the reference
tree or a C++ toolchain is absent (e.g. in a stripped CI image).
"""

import shutil

import pytest

from localhgt_tpu.tools import ab_reference


@pytest.fixture(scope="module")
def ab_report(tmp_path_factory):
    import os

    if not os.path.isfile(ab_reference.REFERENCE_SRC):
        pytest.skip("reference source tree not mounted")
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    work = str(tmp_path_factory.mktemp("ab"))
    report = ab_reference.run_ab(
        work_dir=work, k=22, n_genomes=8, genome_len=80_000, hgt_num=4,
        depth=8, seed=7,
    )
    if "skipped" in report:
        pytest.skip(report["skipped"])
    print("A/B report:", report)
    return report


def test_truth_loci_covered_by_both(ab_report):
    """Every true junction locus must sit inside BOTH engines' extracted
    intervals (evaluation.py:64-76 extraction recall)."""
    assert ab_report["truth_coverage_ours"] >= 0.95
    assert ab_report["truth_coverage_ref"] >= 0.95


def test_interval_agreement(ab_report):
    """The two interval sets must agree at the bp level (deliberate
    divergences documented in tools/ab_reference.py's docstring)."""
    assert ab_report["bp_jaccard"] >= 0.85, ab_report
    assert ab_report["recall_vs_ref"] >= 0.9, ab_report


def test_normalize_merges_and_filters():
    ivs = [("c", 100, 130), ("c", 5, 300), ("c", 250, 400), ("d", 1, 20)]
    out = ab_reference._normalize(ivs, {"c": 350, "d": 500})
    assert out == [("c", 5, 350)]
