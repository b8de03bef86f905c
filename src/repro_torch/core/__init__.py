"""Core of the NAS loop (counterpart of ``repro/core``): the port's own
copies of the reference's numpy modules, the scheduler and the search
loop, and the trainers and the model compiler in PyTorch."""
from repro_torch.core.cost_backend import (  # noqa: F401
    CostBackend,
    FPGAAnalyticBackend,
    TPURooflineBackend,
    get_backend,
)
from repro_torch.core.evolution import (  # noqa: F401
    EvolutionarySearch,
    NASConfig,
)
from repro_torch.core.genome import (  # noqa: F401
    Genome,
    PopulationEncoding,
    mutate,
    random_genome,
)
from repro_torch.core.hw_model import (  # noqa: F401
    estimate,
    estimate_population,
    roofline,
)
from repro_torch.core.search_space import (  # noqa: F401
    DEFAULT_SPACE,
    SearchSpace,
)
from repro_torch.core.trainer_batch import (  # noqa: F401
    bucket_by_signature,
    shape_signature,
    train_candidates_batched,
)
