"""HALF's own architecture family (the paper's case study).

Not one fixed config: the topology comes from the NAS genome.  This module
exposes the paper's search-space defaults and the three Table-I reference
objectives for the benchmark harness.
"""
from repro_torch.core.search_space import DEFAULT_SPACE

SPACE = DEFAULT_SPACE
TABLE1_OBJECTIVES = ("energy_max_alpha_j", "energy_min_alpha_j",
                     "power_min_alpha_w")
