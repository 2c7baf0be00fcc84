"""Scaling beyond one device's memory (counterpart of ``ssrg_tpu/parallel``).

Ported: the host-side row partitioners (:mod:`ssrg_torch.parallel.partition`)
and single-card out-of-core propagation (:mod:`ssrg_torch.parallel.outofcore`).
The reference's distributed modules (``mesh``, ``dist_spmm``,
``dist_train``, ``multihost``) are ROADMAP.md section 1, item 4: their names
resolve here to a ``NotImplementedError`` that says so.

Exports are lazy (PEP 562): importing this package imports neither module.
"""

_LAZY = {
    "RowPartition": ("ssrg_torch.parallel.partition", "RowPartition"),
    "partition_rows": ("ssrg_torch.parallel.partition", "partition_rows"),
    "outofcore_propagate": ("ssrg_torch.parallel.outofcore", "outofcore_propagate"),
}
# the reference's distributed names, not ported yet
_DISTRIBUTED = ("make_mesh", "ShardedAdj", "dist_propagate")

__all__ = list(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in _DISTRIBUTED:
        raise NotImplementedError(
            f"ssrg_torch.parallel.{name}: the distributed modules (mesh, dist_spmm, "
            "dist_train, multihost) are not ported yet (ROADMAP.md section 1, item 4)")
    raise AttributeError(f"module 'ssrg_torch.parallel' has no attribute {name!r}")
