"""Graph substrate of the PyTorch port: edge sets, semirings, fixpoint
engine, generators, the neighbor sampler and the stable-vertex analysis.

Counterpart of ``repro.graph``: dense, frontier-masked edge-relaxation
sweeps over immutable edge blocks, run by the hand-written CUDA relax
kernels on the card and by their plain PyTorch versions on the CPU.
"""

from repro_torch.graph.semiring import (
    Semiring,
    BFS,
    SSSP,
    SSWP,
    SSNP,
    VITERBI,
    ALL_SEMIRINGS,
)
from repro_torch.graph.edgeset import (
    EdgeBlock,
    EdgeView,
    PAD_SRC,
    concat_views,
    lane_bucket,
)
from repro_torch.graph.engine import (
    FixpointResult,
    QueryState,
    extract_state,
    host_sync,
    init_values,
    relax_sweep,
    run_to_fixpoint,
    incremental_additions,
    incremental_additions_batched,
)
from repro_torch.graph.generators import (
    rmat_edges,
    EvolvingSequence,
    make_evolving_sequence,
)
from repro_torch.graph.sampler import NeighborSampler, SampledSubgraph
from repro_torch.graph.stability import (
    SEED_MODES,
    SeededState,
    seed_mask,
    seed_state,
    stable_fraction_milli,
)

__all__ = [
    "Semiring",
    "BFS",
    "SSSP",
    "SSWP",
    "SSNP",
    "VITERBI",
    "ALL_SEMIRINGS",
    "EdgeBlock",
    "EdgeView",
    "PAD_SRC",
    "concat_views",
    "lane_bucket",
    "FixpointResult",
    "QueryState",
    "extract_state",
    "host_sync",
    "init_values",
    "relax_sweep",
    "run_to_fixpoint",
    "incremental_additions",
    "incremental_additions_batched",
    "rmat_edges",
    "EvolvingSequence",
    "make_evolving_sequence",
    "NeighborSampler",
    "SampledSubgraph",
    "SEED_MODES",
    "SeededState",
    "seed_mask",
    "seed_state",
    "stable_fraction_milli",
]
