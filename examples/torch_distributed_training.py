#!/usr/bin/env python
"""Example: SPMD training of the PyTorch port over every rank of a world.

One process per rank: under ``torchrun`` (NCCL with one card a rank, or gloo
with ``--device cpu``), or alone as a world of one rank.

    torchrun --nproc_per_node=4 examples/torch_distributed_training.py --steps 20
    torchrun --nproc_per_node=4 examples/torch_distributed_training.py --device cpu
    python examples/torch_distributed_training.py --device cpu
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--local_engine", default="tiled",
                    choices=("tiled", "hybrid", "coo"),
                    help="per-shard SpMM layout (tiled: dense diagonal-block "
                         "tiles plus the hybrid rest)")
    ap.add_argument("--comm", default="halo",
                    choices=("halo", "all_gather"),
                    help="per-hop exchange: static halo plan (boundary rows "
                         "only) or full all_gather")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch.distributed as dist

    from ssrg_torch.configs.config import ModelConfig
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.parallel.dist_train import build_spmd_context, run_epochs_scan
    from ssrg_torch.parallel.multihost import global_mesh, initialize_multihost

    initialize_multihost(device=args.device)
    mesh = global_mesh(device=args.device)      # every rank on the graph axis
    shards = mesh.shape["graph"]
    # community-structured SBM (communities smaller than a shard block) so
    # the cluster reorder gives the halo plan something to exploit
    ds = planetoid_like(num_node=args.nodes, num_classes=max(2 * shards, 5),
                        num_features=64, p_in=0.3, p_out=0.0004)
    cfg = ModelConfig(model_name="gamlp", prop_steps=3, hidden_dim=64)
    spec = load_model(cfg, ds.num_features, ds.num_classes)
    comm = "all_gather" if args.local_engine == "coo" else args.comm
    if comm != args.comm and mesh.rank == 0:
        print(f"note: --comm {args.comm} needs a hybrid or tiled local engine; "
              f"the coo layout keeps global columns and exchanges by all_gather")
    ctx = build_spmd_context(
        sym_norm(ds.adj, cfg.r), ds.x, ds.y, ds.train_idx, spec.module,
        mesh, cfg.prop_steps, lr=0.01,
        local_engine=args.local_engine, comm=comm,
        reorder=None if args.local_engine == "coo" else "cluster",
        val_idx=ds.val_idx, test_idx=ds.test_idx,
    )
    # the hops propagated once under the mesh, then every epoch of the head
    # with best-val->test tracking
    ctx, res = run_epochs_scan(ctx, args.steps)
    if mesh.rank == 0:
        print(f"{shards}-shard SPMD training ({args.local_engine}/{comm}): "
              f"{args.steps} epochs, "
              f"loss {res.history[0][0]:.4f} -> {res.final_loss:.4f}, "
              f"best val {res.best_val:.4f}, best test {res.best_test:.4f}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
