from ssrg_torch.data.graph import Edge, Graph  # noqa: F401
from ssrg_torch.data.base_dataset import NodeDataset  # noqa: F401
from ssrg_torch.data.synthetic import (  # noqa: F401
    InMemoryDataset,
    community_graph,
    nested_community_graph,
    planetoid_like,
    powerlaw_graph,
    random_graph,
    sbm_graph,
)
