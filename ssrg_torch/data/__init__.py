from ssrg_torch.data.graph import Edge, Graph  # noqa: F401
from ssrg_torch.data.synthetic import (  # noqa: F401
    InMemoryDataset,
    planetoid_like,
    powerlaw_graph,
    random_graph,
    sbm_graph,
)
