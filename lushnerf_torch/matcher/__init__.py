"""Matchers and match tables for the CTE loss (`api`), and the DKMv3 dense
matcher (`dkm`)."""

from lushnerf_torch.matcher.api import (  # noqa: F401
    GridStubMatcher,
    GroundTruthMatcher,
    MatchTables,
    PrecomputedMatcher,
    build_match_tables,
    match_pairs,
)
