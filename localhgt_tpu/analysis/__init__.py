"""Downstream biology analyses (SURVEY.md section 2.4).

The reference ships ~12 kLoC of cohort-analysis scripts in `paper_results/`
that consume the detection outputs (`*.acc.csv`, event CSVs). This package
re-implements their reusable cores as a library:

- `records`     — acc.csv cohort loading, HGT tags, abundance filter
                  (basic_statistics.py:23-66, evaluation.py:110-133)
- `taxonomy`    — UHGG lineage table + per-level taxon lookup
                  (mechanism_taxonomy.py:10-33, HGT_classifier.py:80-98)
- `microhomology` — junction microhomology vs random expectation, on-device
                  batched global alignment (microhomology.py:147-474)
- `mechanism`   — DSB-repair mechanism classification of events
                  (mechanism.py:195-362)
- `network`     — per-sample HGT networks + topological properties + group
                  comparison (HGT_network.py:78-182,247-409)
- `classifier`  — differential-HGT marker selection + phenotype classifier,
                  device-trained logistic regression (HGT_classifier.py:247-458)
- `stats`       — cohort-level breakpoint statistics & group tests
                  (basic_statistics.py)

Everything cohort-scale runs on host (it is tiny); the sequence-alignment
inner loops (microhomology/mechanism) run batched on device.
"""

from localhgt_tpu.analysis import records  # noqa: F401
