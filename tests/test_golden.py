"""Exact-bytes golden regression of the downstream output contract
(the byte-exact output contract).

The e2e recall/FDR gates tolerate silent behavioral drift in
align/rawbkp/accbkp as long as scores stay in-band; these tests pin the
byte-exact acc.csv (the reference's 16-column contract,
scripts/accurate_bkp.py:921-933) and event CSV on a frozen, deterministic
fixture. Any intentional algorithm change must regenerate the goldens
deliberately:

    LHT_REGOLD=1 python -m pytest tests/test_golden.py

and the diff reviewed in the commit. Runs on the CPU backend (conftest), so
bytes are platform-stable.
"""

import os

import pytest

from localhgt_tpu.config import Config, EventConfig, KmerConfig
from localhgt_tpu.sim.simulate import SimParams, simulate_sample

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("golden"))
    pa = SimParams(n_genomes=6, genome_len=30_000, hgt_num=3, depth=8,
                   snp_rate=0.01, seed=33)
    ref, fq1, fq2, _ = simulate_sample(out, "gold", pa)
    return out, ref, fq1, fq2


@pytest.fixture(scope="module")
def pipeline_outputs(fixture_files):
    from localhgt_tpu.pipeline.bkp import detect_breakpoint
    from localhgt_tpu.pipeline.event import detect_event

    out, ref, fq1, fq2 = fixture_files
    cfg = Config().replace(kmer=KmerConfig(k=18))
    acc = detect_breakpoint(ref, fq1, fq2, "gold", out, cfg=cfg)
    ev = os.path.join(out, "gold.events.csv")
    detect_event(ref, out, ev, EventConfig(min_hgt_len=200))
    return acc, ev


def _check(path: str, name: str):
    gold_path = os.path.join(GOLD, name)
    got = open(path, "rb").read()
    if os.environ.get("LHT_REGOLD"):
        os.makedirs(GOLD, exist_ok=True)
        with open(gold_path, "wb") as f:
            f.write(got)
        pytest.skip(f"regenerated {gold_path}")
    assert os.path.isfile(gold_path), (
        f"golden file {gold_path} missing — run with LHT_REGOLD=1 once")
    want = open(gold_path, "rb").read()
    assert got == want, (
        f"{name} drifted from the frozen golden output. If the change is "
        f"intentional, regenerate with LHT_REGOLD=1 and review the diff.")


def test_acc_csv_matches_golden(pipeline_outputs):
    acc, _ = pipeline_outputs
    _check(acc, "gold.acc.csv")


def test_event_csv_matches_golden(pipeline_outputs):
    _, ev = pipeline_outputs
    _check(ev, "gold.events.csv")


def test_cli_bkp_matches_golden(fixture_files, tmp_path):
    """The CLI entry point with its default flags (what chip_smoke.py runs
    on the card) writes the same bytes as detect_breakpoint."""
    from localhgt_tpu import cli

    _, ref, fq1, fq2 = fixture_files
    rc = cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-k", "18",
                   "-s", "gold", "-o", str(tmp_path)])
    assert rc == 0
    _check(str(tmp_path / "gold.acc.csv"), "gold.acc.csv")
