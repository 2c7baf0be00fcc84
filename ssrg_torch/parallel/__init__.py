"""Scaling beyond one device (counterpart of ``ssrg_tpu/parallel``): the
host-side row partitioners (:mod:`ssrg_torch.parallel.partition`), single-card
out-of-core propagation (:mod:`ssrg_torch.parallel.outofcore`), and the
distributed tier on ``torch.distributed``: meshes (:mod:`.mesh`), sharded
K-hop propagation (:mod:`.dist_spmm`), SPMD training (:mod:`.dist_train`)
and per-rank spool loading (:mod:`.multihost`).

Exports are lazy (PEP 562): importing this package imports none of them.
"""

_LAZY = {
    "make_mesh": ("ssrg_torch.parallel.mesh", "make_mesh"),
    "RowPartition": ("ssrg_torch.parallel.partition", "RowPartition"),
    "partition_rows": ("ssrg_torch.parallel.partition", "partition_rows"),
    "ShardedAdj": ("ssrg_torch.parallel.dist_spmm", "ShardedAdj"),
    "dist_propagate": ("ssrg_torch.parallel.dist_spmm", "dist_propagate"),
    "outofcore_propagate": ("ssrg_torch.parallel.outofcore", "outofcore_propagate"),
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'ssrg_torch.parallel' has no attribute {name!r}")
